"""GAT in the port (models/gnn.py GATLayer, ops/ell_attention.py, the COO
segment softmax of the host eval) against the JAX package, on the CPU.

  * the attention dropout's hash (murmur3-finalized, in int64 torch ops
    masked to 32 bits) bitwise against bnsgcn_tpu/ops/ell_attention.py
    `_hash_keep`, with the head ids the JAX package's `_head_idx` gives,
    a head offset included;
  * build_gat_layouts array-equal to the JAX package's, split backward rows
    included, with the geometry computed or given;
  * the ELL attention's forward, in chunks of 64 gathers, against
    gat_ell_attention with presence and padding, dropout 0, 0.3 and 0.6
    with the same seeds, and its gradients with
    respect to z, el and er against the JAX custom VJP: within 1e-5 of the
    largest value (one f32 pass, another sum order);
  * segment_softmax, and the host eval's logits (the COO path) against
    full_graph_logits (the twin of tests/test_gat.py:37);
  * a 3-epoch P=1 GAT run (2 heads, n_linear 1, LayerNorm, dropout 0) from
    the same parameters: losses within 1e-4 and parameters within 5e-4;
    in bf16 the losses within test_torch_lowp.py's 2e-2 relative;
  * a GAT checkpoint byte-equal to the JAX package's, both ways.
The P=4 cases ride test_torch_dist.py's fixture.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnsgcn_tpu.ops import ell_attention as j_att
from bnsgcn_tpu_torch.ops import ell_attention as t_att

LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=5e-4, atol=1e-5)
BF16_LOSS_RTOL = 2e-2
VALUE_FRAC = 1e-5               # of the largest value
EPOCHS = 3
HEADS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*a, **k):
    pass


def _close(got, want, frac=VALUE_FRAC):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=frac * max(np.abs(want).max(), 1e-30))


def test_hash_keep_is_bitwise_the_jax_hash():
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2 ** 32, size=(64, 1), dtype=np.uint64)
    v = rng.integers(0, 2 ** 32, size=(1, 48), dtype=np.uint64)
    seeds = rng.integers(0, 2 ** 32, size=2, dtype=np.uint64)
    for head_off in (None, 3):
        hj = j_att._head_idx(4, head_off)
        ht = torch.arange(4) + (head_off or 0)
        np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
        for keep in (0.7, 0.5, 0.1):
            want = np.asarray(j_att._hash_keep(
                jnp.asarray(u, jnp.uint32), jnp.asarray(v, jnp.uint32), hj,
                jnp.uint32(seeds[0]), jnp.uint32(seeds[1]), keep))
            got = t_att._hash_keep(
                torch.from_numpy(u.astype(np.int64)),
                torch.from_numpy(v.astype(np.int64)), ht, int(seeds[0]),
                int(seeds[1]), keep).numpy()
            np.testing.assert_array_equal(got, want)
            assert 0 < want.mean() < 1


def _edges(seed=1, P=2, n_dst=40, n_ext=64, e=600, hub=150):
    """Padded per-part edge arrays with a source of `hub` out-edges (so the
    capped backward layout splits a row) and padding (dst == n_dst)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_ext, size=(P, e)).astype(np.int32)
    dst = rng.integers(0, n_dst, size=(P, e)).astype(np.int32)
    src[:, :hub] = 5
    dst[:, :hub] = np.arange(hub) % n_dst
    dst[:, -20:] = n_dst
    return src, dst, n_dst, n_ext


def _equal_layouts(got, want):
    (ts, ta), (js, ja) = got, want
    assert (ts.widths, ts.rows, ts.n_rows, ts.n_src) == (
        js.widths, js.rows, js.n_rows, js.n_src)
    assert ts.bwd.__dict__ == js.bwd.__dict__
    assert sorted(ta) == sorted(ja)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype, k
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)


def test_build_gat_layouts_equal_jax():
    src, dst, n_dst, n_ext = _edges()
    want = j_att.build_gat_layouts(src, dst, n_dst, n_ext)
    assert want[0].bwd.n_split > 0
    _equal_layouts(t_att.build_gat_layouts(src, dst, n_dst, n_ext), want)
    # the geometry given, as meta.json gives it to one part
    geo = j_att.gat_geometry(src, dst, n_dst, n_ext)
    assert t_att.gat_geometry(src, dst, n_dst, n_ext) == geo
    from bnsgcn_tpu.ops.ell import compute_geometry
    bwd = compute_geometry(src, dst, n_dst, n_ext, directions=("bwd",))["bwd"]
    want1 = j_att.build_gat_layouts(src[1:], dst[1:], n_dst, n_ext, geo, bwd)
    _equal_layouts(t_att.build_gat_layouts(src[1:], dst[1:], n_dst, n_ext,
                                           geo, bwd), want1)


@functools.lru_cache(maxsize=None)
def _attention_case(drop, F=3, seed=2):
    """(JAX out, grads) and (port out, grads) of one part's attention with
    presence, on random z, el, er and a random cotangent."""
    src, dst, n_dst, n_ext = _edges(seed)
    spec_j, arr_j = j_att.build_gat_layouts(src[:1], dst[:1], n_dst, n_ext)
    spec_t, arr_t = t_att.build_gat_layouts(src[:1], dst[:1], n_dst, n_ext)
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n_ext, HEADS, F)).astype(np.float32)
    el = rng.normal(size=(n_ext, HEADS)).astype(np.float32)
    er = rng.normal(size=(n_dst, HEADS)).astype(np.float32)
    pres = rng.random(n_ext) < 0.7
    pres[:n_dst] = True
    cot = rng.normal(size=(n_dst, HEADS, F)).astype(np.float32)
    key = jax.random.key(7)
    arrays = {k: jnp.asarray(v[0]) for k, v in arr_j.items()}

    def f(z_, el_, er_):
        return j_att.gat_ell_attention(spec_j, arrays, z_, el_, er_,
                                       jnp.asarray(pres), key, None,
                                       drop, True)

    out_j, vjp = jax.vjp(jax.jit(f), jnp.asarray(z), jnp.asarray(el),
                         jnp.asarray(er))
    grads_j = jax.jit(vjp)(jnp.asarray(cot))
    # chunks of 64 gathers: several per bucket (the JAX run takes one)
    op = t_att.GatAttention(spec_t, {k: torch.from_numpy(v[0])
                                     for k, v in arr_t.items()},
                            chunk_gathers=64)
    seeds = torch.from_numpy(np.asarray(jax.random.key_data(key))
                             .astype(np.int64).reshape(-1)[:2])
    zt, elt, ert = (torch.from_numpy(x).requires_grad_(True)
                    for x in (z, el, er))
    out_t = op(zt, elt, ert, torch.from_numpy(pres), seeds, drop, True)
    (out_t * torch.from_numpy(cot)).sum().backward()
    return ((np.asarray(out_j), [np.asarray(g) for g in grads_j]),
            (out_t.detach().numpy(), [x.grad.numpy() for x in (zt, elt, ert)]))


@pytest.mark.parametrize("drop", [0.0, 0.3, 0.6])
def test_attention_forward_and_gradients_match_jax(drop):
    (out_j, g_j), (out_t, g_t) = _attention_case(drop)
    _close(out_t, out_j)
    for name, a, b in zip(("z", "el", "er"), g_t, g_j):
        assert np.abs(b).max() > 0, name
        _close(a, b)
    if drop:
        # the mask really drops: the output differs from dropout 0's
        (out0, _), _ = _attention_case(0.0)
        assert not np.allclose(out_j, out0)


def test_segment_softmax_matches_jax():
    from bnsgcn_tpu.ops.spmm import segment_softmax as j_ss
    from bnsgcn_tpu_torch.ops.spmm import segment_softmax as t_ss
    rng = np.random.default_rng(4)
    n, e = 30, 400
    scores = rng.normal(size=(e, HEADS)).astype(np.float32) * 3
    dst = rng.integers(0, n + 1, size=e).astype(np.int64)   # n: padding
    mask = rng.random(e) < 0.8
    for m in (None, mask):
        want = np.asarray(j_ss(jnp.asarray(scores), jnp.asarray(dst), n,
                               None if m is None else jnp.asarray(m)))
        got = t_ss(torch.from_numpy(scores), torch.from_numpy(dst), n,
                   None if m is None else torch.from_numpy(m), chunk=64)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def _specs(n_feat, n_class, n_linear=1, dtype="float32"):
    from bnsgcn_tpu.models.gnn import ModelSpec as JModelSpec
    from bnsgcn_tpu_torch.config import Config
    from bnsgcn_tpu_torch.models.gnn import spec_from_config
    cfg = Config(model="gat", heads=HEADS, n_layers=3, n_hidden=8,
                 n_linear=n_linear, dropout=0.0, norm="layer", lr=0.01,
                 weight_decay=5e-4, n_partitions=1, n_epochs=EPOCHS,
                 device="cpu", eval=False, log_every=1000, dtype=dtype)
    sizes = (n_feat, 8, 8, n_class)
    spec_j = JModelSpec("gat", sizes, n_linear=n_linear, norm="layer",
                        dropout=0.0, use_pp=True, heads=HEADS)
    spec_t = spec_from_config(cfg.replace(n_feat=n_feat, n_class=n_class))
    return cfg, spec_j, spec_t


def test_host_eval_logits_match_full_graph_logits():
    """The eval forward on the whole graph (COO: the segment softmax and
    the chunked weighted sum) from the JAX parameters."""
    from bnsgcn_tpu.data.graph import synthetic_graph as j_synthetic
    from bnsgcn_tpu.evaluate import full_graph_logits as j_logits
    from bnsgcn_tpu.models.gnn import init_params
    from bnsgcn_tpu_torch.data.graph import synthetic_graph
    from bnsgcn_tpu_torch.evaluate import full_graph_logits
    from bnsgcn_tpu_torch.models.gnn import GNN
    from bnsgcn_tpu_torch.trainer import params_from_jax
    kw = dict(n_nodes=60, avg_degree=5, n_feat=5, n_class=3, seed=51)
    _, spec_j, spec_t = _specs(5, 3)
    params, state = init_params(jax.random.key(2), spec_j)
    want = j_logits(params, state, spec_j, j_synthetic(**kw))
    net = GNN(spec_t)
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                        spec_t))
    got = full_graph_logits(net, synthetic_graph(**kw), "cpu")
    _close(got, want)


def _jax_p1(g_j, spec_j, params_np, dtype="float32"):
    """The JAX package's P=1 GAT run: 3 epochs' losses and parameters."""
    from bnsgcn_tpu.config import Config as JConfig
    from bnsgcn_tpu.data.artifacts import build_artifacts
    from bnsgcn_tpu.parallel.mesh import make_parts_mesh
    from bnsgcn_tpu.trainer import (build_block_arrays, build_step_fns,
                                    init_training, place_blocks,
                                    place_replicated)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    cfg = JConfig(model="gat", heads=HEADS, dropout=0.0, n_linear=1,
                  norm="layer", lr=0.01, weight_decay=5e-4, n_partitions=1,
                  n_train=g_j.n_train, dtype=dtype)
    mesh = make_parts_mesh(1)
    art = build_artifacts(g_j, np.zeros(g_j.n_nodes, np.int32))
    fns, _, tables, tables_full = build_step_fns(cfg, spec_j, art, mesh)
    blk_np = build_block_arrays(art, "gat")
    blk_np.update(fns.extra_blk)
    for k in fns.drop_blk_keys:
        blk_np.pop(k, None)
    blk = place_blocks(blk_np, mesh)
    blk["feat"] = blk["feat"].astype(jdt)
    blk["feat0_ext"] = fns.precompute(
        blk, place_replicated(tables_full, mesh)).astype(jdt)
    tb = place_replicated(tables, mesh)
    p = place_replicated(jax.tree.map(lambda v: jnp.asarray(v, jdt),
                                      params_np), mesh)
    s = place_replicated({}, mesh)
    _, _, opt = init_training(cfg, spec_j, mesh, dtype=jdt)
    losses = []
    for e in range(EPOCHS):
        p, s, opt, loss = fns.train_step(p, s, opt, jnp.uint32(e), blk, tb,
                                         jax.random.key(0),
                                         jax.random.key(1))
        losses.append(float(loss))
    return losses, jax.tree.map(lambda v: np.asarray(v, np.float32),
                                jax.device_get(p))


@pytest.fixture(scope="module")
def p1_runs():
    """The JAX P=1 run in f32 and bf16 from jax.random.key(3)'s parameters,
    and the port's graph and specs."""
    from bnsgcn_tpu.data.graph import sbm_graph as j_sbm
    from bnsgcn_tpu.models.gnn import init_params
    kw = dict(n_nodes=160, n_class=4, n_feat=8, p_in=0.1, p_out=0.01,
              seed=12)
    g_j = j_sbm(**kw)
    _, spec_j, _ = _specs(8, 4)
    params, _ = init_params(jax.random.key(3), spec_j)
    params_np = jax.tree.map(np.asarray, params)
    return dict(kw=kw, params_np=params_np,
                f32=_jax_p1(g_j, spec_j, params_np),
                bf16=_jax_p1(g_j, spec_j, params_np, "bfloat16"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_p1_training_matches_jax(p1_runs, dtype):
    """3 epochs through run_training at P=1 (the ELL attention, its
    two-pass backward, the precompute's feat0_ext, Adam) from the JAX
    parameters: f32 losses within 1e-4 and parameters within 5e-4; bf16
    losses within 2e-2 relative. The loss falls."""
    from bnsgcn_tpu_torch.data.graph import sbm_graph
    from bnsgcn_tpu_torch.run import prepare_run, train_loop
    from bnsgcn_tpu_torch.trainer import params_from_jax, params_to_jax
    cfg, _, spec_t = _specs(8, 4, dtype=dtype)
    pr = prepare_run(cfg.replace(dataset="sbm"), g=sbm_graph(**p1_runs["kw"]),
                     log=_quiet)
    res, model = train_loop(pr, params_from_jax(p1_runs["params_np"],
                                                pr.spec), log=_quiet)
    losses_j, params_j = p1_runs["f32" if dtype == "float32" else "bf16"]
    assert res.losses[-1] < res.losses[0]
    if dtype == "bfloat16":
        np.testing.assert_allclose(res.losses, losses_j, rtol=BF16_LOSS_RTOL)
        assert all(p.dtype == torch.bfloat16 for p in model.parameters())
        return
    np.testing.assert_allclose(res.losses, losses_j, **LOSS_TOL)
    got = params_to_jax(model.state_dict(), pr.spec)
    for name in params_j:
        for k in params_j[name]:
            np.testing.assert_allclose(got[name][k], params_j[name][k],
                                       err_msg=f"{name}/{k}", **PARAM_TOL)


def test_gat_checkpoint_is_byte_equal_to_jax_both_ways(tmp_path):
    """The port's GAT checkpoint (parameters and Adam after 2 updates)
    restores into the JAX package's templates and is byte for byte the file
    the JAX package writes for them; the JAX file loads back into the port
    to the same trees."""
    import optax

    from bnsgcn_tpu import checkpoint as j_ckpt
    from bnsgcn_tpu.config import Config as JConfig
    from bnsgcn_tpu.models.gnn import init_params
    from bnsgcn_tpu.trainer import make_tx as j_make_tx
    from bnsgcn_tpu_torch import checkpoint as ckpt
    from bnsgcn_tpu_torch.models.gnn import GNN
    from bnsgcn_tpu_torch.trainer import (make_tx, opt_state_from_jax,
                                          opt_state_to_jax, params_from_jax,
                                          params_to_jax)
    from tests.test_torch_checkpoint import _assert_tree_equal
    cfg, spec_j, spec_t = _specs(5, 3)
    torch.manual_seed(0)
    net = GNN(spec_t, 4)
    opt = make_tx(cfg, net.parameters())
    for _ in range(2):
        for p in net.parameters():
            p.grad = torch.randn_like(p)
        opt.step()
    path = str(tmp_path / "port.ckpt")
    ckpt.save_checkpoint(path, params=params_to_jax(net.state_dict(), spec_t),
                         opt_state=opt_state_to_jax(opt, net), epoch=9,
                         best_acc=0.5, seed=7, extra={"retry_nonce": 0})
    params_t, state_t = init_params(jax.random.key(0), spec_j)
    opt_t = j_make_tx(JConfig(weight_decay=5e-4)).init(params_t)
    payload = j_ckpt.read_blob(path)
    p, o, s = j_ckpt.restore_into(payload, jax.device_get(params_t),
                                  jax.device_get(opt_t), state_t)
    assert isinstance(o[1][0], optax.ScaleByAdamState)
    _assert_tree_equal(jax.tree.map(np.asarray, p),
                       params_to_jax(net.state_dict(), spec_t))
    j_path = str(tmp_path / "jax.ckpt")
    j_ckpt.save_checkpoint(j_path, params=p, opt_state=o, bn_state=s,
                           epoch=9, best_acc=0.5, seed=7,
                           extra={"retry_nonce": 0})
    with open(path, "rb") as a, open(j_path, "rb") as b:
        assert a.read() == b.read()
    # and back: the JAX file into a fresh port model and Adam
    back = ckpt.read_blob(j_path)
    net2 = GNN(spec_t)
    net2.load_state_dict(params_from_jax(back["params"], spec_t))
    opt2 = make_tx(cfg, net2.parameters())
    opt_state_from_jax(back["opt_state"], opt2, net2)
    _assert_tree_equal(params_to_jax(net2.state_dict(), spec_t),
                       params_to_jax(net.state_dict(), spec_t))
    _assert_tree_equal(opt_state_to_jax(opt2, net2),
                       opt_state_to_jax(opt, net))
