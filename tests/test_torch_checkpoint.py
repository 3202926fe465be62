"""The port's checkpoints against the JAX package's, on the CPU.

  * the msgpack codec: bytes-equal to flax.serialization.msgpack_serialize
    on payload trees (every int width, floats, strings, bytes, ndarrays of
    several dtypes, numpy scalars, nested dicts), chunked arrays included,
    and reading flax's bytes back to flax's tree;
  * both ways: a file the port wrote loads through the JAX package's
    read_blob + restore_into into its own templates (init_params, the optax
    chain), and is byte for byte the file its save_checkpoint writes for
    those trees; a file the JAX package wrote loads into the port's model
    and Adam;
  * the integrity chain: a torn, bit-flipped or zero-byte newest periodic
    checkpoint is skipped by latest_valid_checkpoint; pruning keeps the
    newest; final_best_payload refuses a final file whose best_acc does not
    match;
  * a resumed P=1 run at dropout 0.5 equals the uninterrupted run bitwise:
    losses, and the checkpoint files both runs write after the resume point;
  * dropout is keyed by (seed, epoch, rank);
  * --dtype bfloat16: bf16 leaves go as flax writes them (dtype name
    'bfloat16', 2 bytes each), bytes-equal to flax, chunked too; a bf16
    model and Adam written by the port is byte for byte the JAX package's
    file for the same trees and restores into its bf16 templates, and a
    JAX bf16 file loads into the port's bf16 model and Adam and writes
    back byte for byte; a resumed bf16 run equals the uninterrupted one
    bitwise.
"""

import os

import flax.serialization as fs
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from bnsgcn_tpu import checkpoint as j_ckpt
from bnsgcn_tpu.config import Config as JConfig
from bnsgcn_tpu.models.gnn import ModelSpec as JModelSpec
from bnsgcn_tpu.models.gnn import init_params as j_init_params
from bnsgcn_tpu.trainer import make_tx as j_make_tx
from bnsgcn_tpu_torch import checkpoint as ckpt
from bnsgcn_tpu_torch.config import Config
from bnsgcn_tpu_torch.models.gnn import GNN, spec_from_config
from bnsgcn_tpu_torch.ops.dropout import dropout
from bnsgcn_tpu_torch.run import run_training
from bnsgcn_tpu_torch.trainer import (dropout_key, make_tx,
                                      opt_state_from_jax, opt_state_to_jax,
                                      params_from_jax, params_to_jax)
from bnsgcn_tpu_torch.utils import msgpack_codec

WD = 5e-4


def _quiet(*a, **k):
    pass


def _rich_tree():
    rng = np.random.default_rng(0)
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 63, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
            -2 ** 31 - 1, -2 ** 63]
    return {
        "z": 1, "ints": ints, "floats": [0.5, -1e300, float("inf")],
        "params": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                   "count": np.asarray(5, np.int32)},
        "s": "x" * 40, "s2": "y" * 300, "s3": "é" * 40000,
        "b": b"\x00" * 300, "none": None, "t": True, "f": False,
        "np": np.float64(2.5), "npi": np.int64(-3), "npb": np.bool_(True),
        "many": {str(i): i for i in range(20)}, "list": list(range(20)),
        "bool_arr": np.array([True, False]),
        "i8": np.arange(7, dtype=np.int8),
        "u16": np.arange(300, dtype=np.uint16).reshape(3, 100),
        "empty": {}, "e0": np.zeros((0, 3), np.float32),
        "f64": np.arange(2.0),
    }


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b), (path, type(a), type(b))
        assert a == b or (a != a and b != b), path


def test_codec_bytes_equal_flax():
    tree = _rich_tree()
    blob = fs.msgpack_serialize(tree)
    assert msgpack_codec.packb(tree) == blob
    _assert_tree_equal(msgpack_codec.unpackb(blob), fs.msgpack_restore(blob))


def test_codec_chunked_arrays_equal_flax(monkeypatch):
    """Arrays above MAX_CHUNK_SIZE bytes go as flax's chunked form (the
    limit lowered here to 64 bytes in both)."""
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack_codec, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"w": rng.normal(size=(10, 7)).astype(np.float32),
            "s": {"q": np.arange(50, dtype=np.int64), "small": np.ones(3)}}
    blob = fs.msgpack_serialize(tree)
    assert msgpack_codec.packb(tree) == blob
    assert b"__msgpack_chunked_array__" in blob
    got = msgpack_codec.unpackb(blob)
    _assert_tree_equal(got, fs.msgpack_restore(blob))
    np.testing.assert_array_equal(got["w"], tree["w"])


def test_codec_refuses_what_flax_refuses():
    for bad in ({"t": (1, 2)}, {"o": object()}):
        with pytest.raises(TypeError):
            msgpack_codec.packb(bad)
        with pytest.raises(TypeError):
            fs.msgpack_serialize(bad)


def _specs(model="graphsage", use_pp=True):
    cfg = Config(model=model, n_layers=3, n_hidden=8, use_pp=use_pp,
                 n_feat=5, n_class=3, weight_decay=WD, lr=0.01)
    spec = spec_from_config(cfg)
    spec_j = JModelSpec(model, (5, 8, 8, 3), norm="layer", use_pp=use_pp)
    return cfg, spec, spec_j


def _trained_port(cfg, spec, steps=2):
    """The port's model and Adam after `steps` updates with random
    gradients: every optimizer leaf holds something."""
    torch.manual_seed(0)
    model = GNN(spec, 4)
    opt = make_tx(cfg, model.parameters())
    for _ in range(steps):
        for p in model.parameters():
            p.grad = torch.randn_like(p)
        opt.step()
    return model, opt


@pytest.mark.parametrize("model,use_pp", [("graphsage", True),
                                          ("graphsage", False),
                                          ("gcn", True)])
def test_port_checkpoint_loads_in_jax(tmp_path, model, use_pp):
    """The port's file restores into the JAX package's own templates with
    its own reader, carries the port's values, and is byte for byte the file
    the JAX package's save_checkpoint writes for the restored trees."""
    cfg, spec, spec_j = _specs(model, use_pp)
    net, opt = _trained_port(cfg, spec)
    path = str(tmp_path / "port.ckpt")
    ckpt.save_checkpoint(path, params=params_to_jax(net.state_dict(), spec),
                         opt_state=opt_state_to_jax(opt, net), epoch=9,
                         best_acc=0.625, seed=77, extra={"retry_nonce": 0})
    params_t, state_t = j_init_params(jax.random.key(0), spec_j)
    opt_t = j_make_tx(JConfig(weight_decay=WD)).init(params_t)
    payload = j_ckpt.read_blob(path)
    p, o, s = j_ckpt.restore_into(payload, jax.device_get(params_t),
                                  jax.device_get(opt_t), state_t)
    assert (payload["epoch"], payload["best_acc"], payload["seed"]) == (
        9, 0.625, 77)
    _assert_tree_equal(jax.tree.map(np.asarray, p),
                       params_to_jax(net.state_dict(), spec))
    adam = o[1][0]
    assert isinstance(adam, optax.ScaleByAdamState) and int(adam.count) == 2
    named = dict(net.named_parameters())
    _assert_tree_equal(jax.tree.map(np.asarray, adam.mu), params_to_jax(
        {n: opt.state[q]["exp_avg"] for n, q in named.items()}, spec))
    _assert_tree_equal(jax.tree.map(np.asarray, adam.nu), params_to_jax(
        {n: opt.state[q]["exp_avg_sq"] for n, q in named.items()}, spec))
    j_path = str(tmp_path / "jax.ckpt")
    j_ckpt.save_checkpoint(j_path, params=p, opt_state=o, bn_state=s,
                           epoch=9, best_acc=0.625, seed=77,
                           extra={"retry_nonce": 0})
    with open(path, "rb") as a, open(j_path, "rb") as b:
        assert a.read() == b.read()


def test_jax_checkpoint_loads_in_port(tmp_path):
    """A file the JAX package wrote (parameters, and an optax state after
    two updates) loads into the port's model and Adam: the weights
    transposed, exp_avg and exp_avg_sq the moments, step the count."""
    cfg, spec, spec_j = _specs()
    params, state = j_init_params(jax.random.key(2), spec_j)
    tx = j_make_tx(JConfig(weight_decay=WD))
    opt_state = tx.init(params)
    rng = np.random.default_rng(3)
    for _ in range(2):
        grads = jax.tree.map(
            lambda x: rng.normal(size=x.shape).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    path = str(tmp_path / "jax.ckpt")
    j_ckpt.save_checkpoint(path, params=params, opt_state=opt_state,
                           bn_state=state, epoch=4, best_acc=0.5, seed=3,
                           extra={"retry_nonce": 0})
    payload = ckpt.read_blob(path)
    net = GNN(spec)
    net.load_state_dict(params_from_jax(payload["params"], spec))
    opt = make_tx(cfg, net.parameters())
    opt_state_from_jax(payload["opt_state"], opt, net)
    params_np = jax.tree.map(np.asarray, jax.device_get(params))
    _assert_tree_equal(params_to_jax(net.state_dict(), spec), params_np)
    back = opt_state_to_jax(opt, net)
    adam = opt_state[1][0]
    assert int(back["1"]["0"]["count"]) == int(adam.count) == 2
    _assert_tree_equal(back["1"]["0"]["mu"], jax.tree.map(np.asarray,
                                                            adam.mu))
    _assert_tree_equal(back["1"]["0"]["nu"], jax.tree.map(np.asarray,
                                                            adam.nu))
    assert (payload["epoch"], payload["best_acc"], payload["seed"]) == (
        4, 0.5, 3)


def _ckpt_cfg(tmp_path, **kw):
    return Config(dataset="sbm", n_partitions=1, sampling_rate=0.1,
                  ckpt_path=str(tmp_path), **kw)


def _write_chain(tmp_path, epochs=(1, 3, 5)):
    cfg = _ckpt_cfg(tmp_path)
    _, spec, _ = _specs()
    net = GNN(spec)
    for e in epochs:
        ckpt.save_checkpoint(ckpt.periodic_path(cfg, e),
                             params=params_to_jax(net.state_dict(), spec),
                             epoch=e, best_acc=e / 10, seed=1)
    return cfg


def _tear(path, how):
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    if how == "torn":
        raw = raw[:len(raw) // 2]
    elif how == "flipped":
        raw[len(raw) - 7] ^= 0x10
    elif how == "header":
        raw = raw[:20]
    else:
        raw = bytearray()
    with open(path, "wb") as f:
        f.write(raw)


@pytest.mark.parametrize("how", ["torn", "flipped", "zero", "header"])
def test_latest_valid_checkpoint_skips_a_corrupt_newest(tmp_path, how):
    cfg = _write_chain(tmp_path)
    assert os.path.basename(ckpt.periodic_path(cfg, 5)) == \
        "sbm-1-metis-vol-trans_p0.10_5.ckpt"
    _tear(ckpt.periodic_path(cfg, 5), how)
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.read_blob(ckpt.periodic_path(cfg, 5))
    with pytest.raises(j_ckpt.CheckpointCorrupt):    # the JAX reader agrees
        j_ckpt.read_blob(ckpt.periodic_path(cfg, 5))
    seen = []
    path, payload = ckpt.latest_valid_checkpoint(cfg, log=seen.append)
    assert path == ckpt.periodic_path(cfg, 3) and payload["epoch"] == 3
    assert len(seen) == 1 and "skipping corrupt checkpoint" in seen[0]


def test_prune_keeps_the_newest_and_the_final(tmp_path):
    cfg = _write_chain(tmp_path, epochs=(1, 3, 5, 7, 11))
    ckpt.save_checkpoint(ckpt.final_path(cfg), params={}, best_acc=0.3)
    ckpt.prune_checkpoints(cfg, 2)
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(p) for p in (ckpt.periodic_path(cfg, 7),
                                      ckpt.periodic_path(cfg, 11),
                                      ckpt.final_path(cfg)))
    assert ckpt.latest_valid_checkpoint(cfg)[1]["epoch"] == 11


def test_final_best_payload_refuses_another_runs_best(tmp_path):
    cfg = _ckpt_cfg(tmp_path)
    assert ckpt.final_best_payload(cfg, 0.5, _quiet) is None     # no file
    ckpt.save_checkpoint(ckpt.final_path(cfg), params={}, best_acc=0.5)
    assert ckpt.final_best_payload(cfg, 0.5, _quiet)["best_acc"] == 0.5
    assert ckpt.final_best_payload(cfg, 0.5 + 1e-6, _quiet) is None
    _tear(ckpt.final_path(cfg), "flipped")
    seen = []
    assert ckpt.final_best_payload(cfg, 0.5, seen.append) is None
    assert "restarting best tracking" in seen[0]


def _run(tmp_path, name, n_epochs, resume=False, dtype="float32"):
    cfg = Config(dataset="sbm", n_partitions=1, model="graphsage",
                 n_layers=2, n_hidden=16, use_pp=True, dropout=0.5,
                 n_epochs=n_epochs, log_every=2, device="cpu", seed=3,
                 resume=resume, ckpt_path=str(tmp_path / name),
                 results_path=str(tmp_path / "res"),
                 graph_name="sbm-1-metis-vol-trans", dtype=dtype)
    return cfg, run_training(cfg, log=_quiet)


def test_resumed_run_equals_the_uninterrupted_run_bitwise(tmp_path):
    """Stop after 4 epochs, resume from the epoch-3 checkpoint to 6: the
    resumed epochs' losses are the uninterrupted run's, bitwise (dropout
    0.5, keyed by epoch); the epoch-5 periodic checkpoint holds the same
    parameters, optimizer state, epoch, seed and extra, bitwise, and the
    final checkpoint file is byte for byte the same. A periodic
    checkpoint's best_acc holds the evals drained before it, as the JAX
    package writes it (bnsgcn_tpu/run.py:1693-1745): the epoch-3 one none
    (the epoch-1 eval is still pending), so the resumed run restarts best
    tracking, and its epoch-5 checkpoint holds 0.0 where the uninterrupted
    run's holds the epoch-1 eval's accuracy."""
    cfg, full = _run(tmp_path, "full", 6)
    _run(tmp_path, "cut", 4)
    cfg_r, res = _run(tmp_path, "cut", 6, resume=True)
    assert res.start_epoch == 4 and full.start_epoch == 0
    assert res.losses == full.losses[4:]
    twin = {p: p.replace(os.sep + "full" + os.sep, os.sep + "cut" + os.sep)
            for p in (ckpt.periodic_path(cfg, 3), ckpt.periodic_path(cfg, 5),
                      ckpt.final_path(cfg))}
    a5, b5 = (ckpt.read_blob(x) for x in (ckpt.periodic_path(cfg, 5),
                                          twin[ckpt.periodic_path(cfg, 5)]))
    assert sorted(a5) == sorted(b5)
    for k in a5:
        if k != "best_acc":
            assert msgpack_codec.packb(a5[k]) == msgpack_codec.packb(b5[k]), k
    assert ckpt.read_blob(twin[ckpt.periodic_path(cfg, 3)])["best_acc"] == 0.0
    assert b5["best_acc"] == 0.0 < a5["best_acc"] <= full.best_val_acc
    with open(ckpt.final_path(cfg), "rb") as a, \
            open(twin[ckpt.final_path(cfg)], "rb") as b:
        assert a.read() == b.read()
    assert res.test_acc == full.test_acc


def test_resume_adopts_the_checkpoint_seed(tmp_path):
    """A resumed run continues the saved streams: the seed main.py drew for
    this launch gives way to the checkpoint's."""
    from bnsgcn_tpu_torch.run import resume_point
    cfg = _write_chain(tmp_path)
    assert resume_point(cfg, _quiet) == (cfg, None)          # no --resume
    got, path = resume_point(cfg.replace(resume=True, seed=999), _quiet)
    assert path == ckpt.periodic_path(cfg, 5) and got.seed == 1


def test_dropout_is_keyed_by_seed_epoch_and_rank():
    def mask(seed, epoch, rank):
        return dropout(torch.ones(64), dropout_key(seed, epoch, rank), 0.5)

    assert torch.equal(mask(3, 5, 1), mask(3, 5, 1))
    others = [mask(4, 5, 1), mask(3, 6, 1), mask(3, 5, 2)]
    assert all(not torch.equal(mask(3, 5, 1), m) for m in others)


# ---------------------------------------------------------------------------
# bfloat16
# ---------------------------------------------------------------------------

def _bf16(x):
    return msgpack_codec.Bfloat16Array(
        np.asarray(x, ml_dtypes.bfloat16).view(np.uint16))


def test_codec_bf16_leaves_equal_flax(monkeypatch):
    """bf16 arrays (as Bfloat16Array) pack as flax packs ml_dtypes
    bfloat16 arrays, plain and chunked (limit lowered to 64 bytes), and
    flax's bytes read back to the same bits."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(6, 9)).astype(ml_dtypes.bfloat16)
    b = rng.normal(size=(40,)).astype(ml_dtypes.bfloat16)
    tree_j = {"a": a, "s": {"b": b, "n": np.asarray(3, np.int32)}}
    tree_p = {"a": _bf16(a), "s": {"b": _bf16(b),
                                   "n": np.asarray(3, np.int32)}}
    for limit in (fs.MAX_CHUNK_SIZE, 64):
        monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", limit)
        monkeypatch.setattr(msgpack_codec, "MAX_CHUNK_SIZE", limit)
        blob = fs.msgpack_serialize(tree_j)
        assert msgpack_codec.packb(tree_p) == blob
        got = msgpack_codec.unpackb(blob)
        assert got["a"] == tree_p["a"] and got["s"]["b"] == tree_p["s"]["b"]
        assert got["a"].shape == (6, 9)
    assert b"__msgpack_chunked_array__" in blob


def _bf16_port(cfg, spec, steps=2):
    """The port's bf16 model and Adam after `steps` random updates."""
    model, opt = _trained_port(cfg, spec, 0)
    model = model.to(torch.bfloat16)
    opt = make_tx(cfg, model.parameters())
    for _ in range(steps):
        for p in model.parameters():
            p.grad = torch.randn_like(p)
        opt.step()
    return model, opt


def test_bf16_checkpoint_is_byte_equal_to_jax_both_ways(tmp_path):
    """--dtype bfloat16 checkpoints (parameters and Adam moments bf16, the
    count int32): the port's file restores into the JAX package's bf16
    templates (init_params(dtype=bfloat16), its optax chain) and is byte
    for byte the file the JAX package writes for the restored trees; a
    JAX bf16 file (after two optax updates) loads into the port's bf16
    model and Adam, bit for bit, and the port writes it back byte for
    byte."""
    cfg, spec, spec_j = _specs()
    net, opt = _bf16_port(cfg, spec)
    assert all(st["exp_avg"].dtype == torch.bfloat16
               for st in opt.state.values())
    path = str(tmp_path / "port.ckpt")
    ckpt.save_checkpoint(path, params=params_to_jax(net.state_dict(), spec),
                         opt_state=opt_state_to_jax(opt, net), epoch=9,
                         best_acc=0.625, seed=77, extra={"retry_nonce": 0})
    params_t, state_t = j_init_params(jax.random.key(0), spec_j,
                                      jnp.bfloat16)
    opt_t = j_make_tx(JConfig(weight_decay=WD)).init(params_t)
    p, o, s = j_ckpt.restore_into(j_ckpt.read_blob(path),
                                  jax.device_get(params_t),
                                  jax.device_get(opt_t), state_t)
    assert jax.tree.leaves(p)[0].dtype == jnp.bfloat16
    j_path = str(tmp_path / "jax.ckpt")
    j_ckpt.save_checkpoint(j_path, params=p, opt_state=o, bn_state=s,
                           epoch=9, best_acc=0.625, seed=77,
                           extra={"retry_nonce": 0})
    with open(path, "rb") as a, open(j_path, "rb") as b:
        assert a.read() == b.read()

    # the JAX package's bf16 file into the port, and back out
    params, state = j_init_params(jax.random.key(2), spec_j, jnp.bfloat16)
    tx = j_make_tx(JConfig(weight_decay=WD))
    opt_state = tx.init(params)
    rng = np.random.default_rng(3)
    for _ in range(2):
        grads = jax.tree.map(lambda x: jnp.asarray(
            rng.normal(size=x.shape), jnp.bfloat16), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    j_path2 = str(tmp_path / "jax2.ckpt")
    j_ckpt.save_checkpoint(j_path2, params=params, opt_state=opt_state,
                           bn_state=state, epoch=4, best_acc=0.5, seed=3,
                           extra={"retry_nonce": 0})
    payload = ckpt.read_blob(j_path2)
    net2 = GNN(spec).to(torch.bfloat16)
    net2.load_state_dict(params_from_jax(payload["params"], spec))
    opt2 = make_tx(cfg, net2.parameters())
    opt_state_from_jax(payload["opt_state"], opt2, net2)
    assert all(st["exp_avg_sq"].dtype == torch.bfloat16
               for st in opt2.state.values())
    p_path = str(tmp_path / "port2.ckpt")
    ckpt.save_checkpoint(p_path,
                         params=params_to_jax(net2.state_dict(), spec),
                         opt_state=opt_state_to_jax(opt2, net2), epoch=4,
                         best_acc=0.5, seed=3, extra={"retry_nonce": 0})
    with open(p_path, "rb") as a, open(j_path2, "rb") as b:
        assert a.read() == b.read()


def test_resumed_bf16_run_equals_the_uninterrupted_run_bitwise(tmp_path):
    """--dtype bfloat16: stop after 4 epochs, resume from the epoch-3
    checkpoint (bf16 parameters and moments) to 6: the resumed losses and
    the final checkpoint file are the uninterrupted run's, bitwise."""
    cfg, full = _run(tmp_path, "full", 6, dtype="bfloat16")
    _run(tmp_path, "cut", 4, dtype="bfloat16")
    _, res = _run(tmp_path, "cut", 6, resume=True, dtype="bfloat16")
    assert res.start_epoch == 4
    assert res.losses == full.losses[4:]
    path = ckpt.final_path(cfg)
    twin = path.replace(os.sep + "full" + os.sep, os.sep + "cut" + os.sep)
    with open(path, "rb") as a, open(twin, "rb") as b:
        assert a.read() == b.read()
    payload = ckpt.read_blob(ckpt.periodic_path(cfg, 5))
    leaf = payload["params"]["layer_0"]["w"]
    assert isinstance(leaf, msgpack_codec.Bfloat16Array)
