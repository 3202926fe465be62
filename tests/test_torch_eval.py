"""The port's evaluation against the JAX package's, on the CPU.

  * the run loop at P=1 (the 4-rank twin is in test_torch_dist.py's module
    fixture): the port's run and the JAX package's bnsgcn_tpu.run
    .run_training from the same carried-over parameters on the same graph,
    dropout 0, transductive and inductive, and a run shorter than
    log_every: the eval lines (every `Epoch ...` line, `Max Validation
    Accuracy`, `model saved` and the final `Test Result | Accuracy`),
    equal as text; the results file, line for line; the best_acc every
    periodic checkpoint holds, equal (the checkpoint is written before the
    log point's eval, and an eval is the best only above the best so far);
    the final checkpoint's parameters (5e-4) or, with no eval, no final
    checkpoint; the RESULT line's best_val and test fields, equal, and its
    final loss (1e-4);
  * an eval that raises in the eval thread is logged and training carries
    on; the next eval takes the best;
  * `_metric_stats`, `_stats_to_acc` and `gather_parts` array-equal to the
    JAX package's on random single-label and multi-hot arrays; micro_f1,
    calc_acc and standard_scale equal;
  * the eval forward (trainer.StepFns.eval_forward) at P=1 against the JAX
    package's `eval_forward` on the same parameters, and
    `--eval-device mesh` through the CLI.

Tolerances: loss curves 1e-4 and parameters 5e-4, as
test_torch_train.py's 10-epoch curves (XLA:CPU and PyTorch sum in other
orders); accuracies are printed to 0.01% and compared as text.
"""

import contextlib
import io
import os

import jax
import numpy as np
import pytest
import torch

from bnsgcn_tpu import checkpoint as j_ckpt
from bnsgcn_tpu import evaluate as j_evaluate
from bnsgcn_tpu.config import Config as JConfig
from bnsgcn_tpu.data.graph import sbm_graph as j_sbm_graph
from bnsgcn_tpu.models.gnn import init_params as j_init_params
from bnsgcn_tpu.models.gnn import spec_from_config as j_spec_from_config
from bnsgcn_tpu.run import run_training as j_run_training
from bnsgcn_tpu.utils import metrics as j_metrics
from bnsgcn_tpu_torch import checkpoint as ckpt
from bnsgcn_tpu_torch import evaluate
from bnsgcn_tpu_torch import main as t_main
from bnsgcn_tpu_torch.config import Config
from bnsgcn_tpu_torch.data.graph import sbm_graph
from bnsgcn_tpu_torch.models.gnn import spec_from_config
from bnsgcn_tpu_torch.run import run_training
from bnsgcn_tpu_torch.trainer import params_from_jax
from bnsgcn_tpu_torch.utils import metrics

GRAPH = dict(n_nodes=240, n_class=4, n_feat=8, p_in=0.1, p_out=0.005,
             seed=66)
CURVE_TOL = dict(rtol=1e-4, atol=1e-4)
PARAM_TOL = dict(rtol=5e-4, atol=1e-5)
# (inductive, n_epochs, log_every): evals at 1, 3, 5; and none at all
LOOPS = [(False, 6, 2), (True, 6, 2), (False, 2, 3)]
EVAL_PREFIXES = ("Epoch ", "Max Validation Accuracy", "model saved",
                 "Test Result")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(tmp, inductive, n_epochs, log_every, who):
    return dict(dataset="sbm", model="graphsage", n_layers=3, n_hidden=8,
                dropout=0.0, use_pp=True, norm="layer", lr=0.01,
                weight_decay=5e-4, spmm="ell", n_partitions=1, seed=0,
                inductive=inductive, n_epochs=n_epochs, log_every=log_every,
                part_path=str(tmp / f"parts_{who}"),
                ckpt_path=str(tmp / f"ck_{who}"),
                results_path=str(tmp / f"res_{who}"))


def _record(cfg, lines, read_blob, res):
    """What the comparison reads of one finished run: its eval lines, the
    results file, every periodic checkpoint's best_acc, the final
    checkpoint's parameters (None without one), the RESULT fields."""
    from bnsgcn_tpu_torch.run import results_file
    path = results_file(cfg)
    results = (open(path).read().splitlines() if os.path.exists(path)
               else None)
    best = {}
    for e in range(cfg.log_every - 1, cfg.n_epochs, cfg.log_every):
        best[e] = float(read_blob(ckpt.periodic_path(cfg, e))["best_acc"])
    final = (read_blob(ckpt.final_path(cfg))
             if os.path.exists(ckpt.final_path(cfg)) else None)
    return {"lines": [ln for ln in lines if ln.startswith(EVAL_PREFIXES)],
            "results": results, "best": best,
            "final": None if final is None else final["params"],
            "result": "best_val=%.6f test=%.6f" % (res.best_val_acc,
                                                   res.test_acc),
            "losses": list(res.losses)}


def _jax_loop(tmp, g_j, inductive, n_epochs, log_every):
    cfg = JConfig(**_fields(tmp, inductive, n_epochs, log_every, "jax"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = j_run_training(cfg, g=g_j)
    return _record(cfg, buf.getvalue().splitlines(), j_ckpt.read_blob, res)


def _jax_init(tmp, g_j, inductive):
    """The parameters the JAX run initializes from (its init_training:
    init_params(jax.random.key(seed)) for its spec), as numpy."""
    n_train = int(g_j.train_mask.sum()) if inductive else g_j.n_train
    cfg = JConfig(**_fields(tmp, inductive, 1, 1, "")).replace(
        n_feat=g_j.n_feat, n_class=g_j.n_class, n_train=n_train)
    params, _ = j_init_params(jax.random.key(cfg.seed),
                              j_spec_from_config(cfg))
    return jax.tree.map(np.asarray, params)


def _port_loop(tmp, g, params_np, inductive, n_epochs, log_every,
               **over):
    cfg = Config(**_fields(tmp, inductive, n_epochs, log_every, "port"),
                 device="cpu").replace(**over)
    n_train = int(g.train_mask.sum()) if inductive else g.n_train
    spec = spec_from_config(cfg.replace(n_feat=g.n_feat, n_class=g.n_class,
                                        n_train=n_train))
    lines = []
    res = run_training(cfg, g=g, log=lines.append,
                       model_init=params_from_jax(params_np, spec))
    return _record(cfg, lines, ckpt.read_blob, res), spec


def _close_tree(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close_tree(got[k], want[k])
    else:
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want, np.float32),
                                   **PARAM_TOL)


@pytest.mark.parametrize("inductive,n_epochs,log_every", LOOPS)
def test_loop_matches_jax_loop_p1(tmp_path, inductive, n_epochs,
                                  log_every):
    """The P=1 loop against the JAX package's, as the module docstring
    says; the short run (n_epochs < log_every) prints no eval line, writes
    no final checkpoint and ends on RESULT best_val=0 test=0 in both."""
    g_j = j_sbm_graph(**GRAPH)
    g = sbm_graph(**GRAPH)
    params_np = _jax_init(tmp_path, g_j, inductive)
    want = _jax_loop(tmp_path, g_j, inductive, n_epochs, log_every)
    got, _ = _port_loop(tmp_path, g, params_np, inductive, n_epochs,
                        log_every)
    assert got["lines"] == want["lines"]
    assert got["results"] == want["results"]
    assert got["best"] == want["best"]
    assert got["result"] == want["result"]
    np.testing.assert_allclose(got["losses"], want["losses"], **CURVE_TOL)
    if n_epochs < log_every:
        assert got["lines"] == [] and got["final"] is None
        assert got["result"] == "best_val=0.000000 test=0.000000"
        assert want["final"] is None
        return
    _close_tree(got["final"], want["final"])
    assert got["lines"][-1].startswith("Test Result | Accuracy ")
    # the best eval does not come first in every case: the checkpoint at a
    # log point holds only the evals drained before it
    assert list(got["best"].values())[0] == 0.0


def test_short_run_prints_no_test_result(tmp_path, capsys):
    """n_epochs < log_every through the entry point: no eval ran, so no
    Test Result line, no final checkpoint, and RESULT's best_val and test
    are 0, as the JAX CLI prints them."""
    rc = t_main.main(["--dataset", "sbm", "--n-partitions", "1",
                      "--n-layers", "2", "--n-hidden", "8", "--n-epochs",
                      "2", "--log-every", "3", "--device", "cpu",
                      "--ckpt-path", str(tmp_path / "ck"), "--results-path",
                      str(tmp_path / "res")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Test Result" not in out and "model saved" not in out
    assert "best_val=0.000000 test=0.000000" in out
    assert not (tmp_path / "ck").exists() or not os.listdir(tmp_path / "ck")


def test_failing_eval_is_logged_and_training_goes_on(tmp_path, monkeypatch):
    """A raise in the eval thread is logged with its epoch, as the JAX
    package's _drain_eval logs it, and costs that eval only: training runs
    every epoch, the next eval becomes the best, the run ends on its Test
    Result."""
    import bnsgcn_tpu_torch.run as t_run
    real = t_run.evaluate_trans
    calls = []

    def flaky(name, *a, **k):
        calls.append(name)
        if len(calls) == 1:
            raise RuntimeError("eval device lost")
        return real(name, *a, **k)

    monkeypatch.setattr(t_run, "evaluate_trans", flaky)
    g = sbm_graph(**GRAPH)
    lines = []
    cfg = Config(**_fields(tmp_path, False, 4, 2, "port"), device="cpu")
    res = run_training(cfg, g=g, log=lines.append)
    assert calls == ["Epoch 00001", "Epoch 00003"]
    assert ("[resilience] host eval for epoch 1 failed (RuntimeError: eval "
            "device lost); continuing training") in lines
    assert len(res.losses) == 4
    assert any(ln.startswith("Epoch 00003 | Validation Accuracy")
               for ln in lines)
    assert lines[-1].startswith("Test Result | Accuracy ")
    assert res.best_val_acc > 0 and len(res.eval_spans) == 2


def test_eval_overlap_records_its_spans(tmp_path):
    """The loop hands back the overlap's record: one (epoch, start, end)
    per periodic eval, one drain wait each (the last after the loop), an
    epoch start per epoch, and the loop's wall time past its steps."""
    g = sbm_graph(**GRAPH)
    cfg = Config(**_fields(tmp_path, False, 6, 2, "port"), device="cpu")
    res = run_training(cfg, g=g, log=lambda m: None)
    assert [e for e, _, _ in res.eval_spans] == [1, 3, 5]
    assert [e for e, _ in res.drain_waits] == [3, 5, 6]
    assert all(t1 >= t0 for _, t0, t1 in res.eval_spans)
    assert len(res.epoch_starts) == 6 and len(res.eval_seconds) == 4
    assert res.loop_seconds >= sum(res.epoch_times)
    # an eval starts after the log point that submitted it
    for (e, t0, _) in res.eval_spans:
        assert t0 >= res.epoch_starts[e]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("multilabel", [False, True])
def test_metric_stats_match_jax(seed, multilabel):
    """_metric_stats on random logits, labels and masks (an empty mask
    included), _stats_to_acc of their sum, array-equal to the JAX
    package's; the stats' accuracy is calc_acc's on the masked rows."""
    rng = np.random.default_rng(seed)
    n, c = 50, 6
    logits = rng.normal(size=(n, c)).astype(np.float32)
    labels = ((rng.random((n, c)) < 0.3).astype(np.float32) if multilabel
              else rng.integers(0, c, n))
    masks = [rng.random(n) < 0.5, np.zeros(n, bool), np.ones(n, bool)]
    total = np.zeros(3, np.int64)
    for m in masks:
        got = evaluate._metric_stats(logits, labels, m, multilabel)
        want = j_evaluate._metric_stats(logits, labels, m, multilabel)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        total += got
        assert (evaluate._stats_to_acc(got, multilabel)
                == j_evaluate._stats_to_acc(got, multilabel))
        if m.any():
            assert evaluate._stats_to_acc(got, multilabel) == \
                metrics.calc_acc(logits[m], labels[m])
    assert (evaluate._stats_to_acc(total, multilabel)
            == j_evaluate._stats_to_acc(total, multilabel))


@pytest.mark.parametrize("seed", range(2))
def test_metrics_match_jax(seed):
    """micro_f1, calc_acc (both label kinds) and standard_scale equal the
    JAX package's."""
    rng = np.random.default_rng(seed)
    lab = rng.random((40, 5)) < 0.3
    pred = rng.random((40, 5)) < 0.4
    assert metrics.micro_f1(lab, pred) == j_metrics.micro_f1(lab, pred)
    assert metrics.micro_f1(lab & False, pred & False) == 0.0
    logits = rng.normal(size=(40, 5)).astype(np.float32)
    for labels in (lab.astype(np.float32), rng.integers(0, 5, 40)):
        assert (metrics.calc_acc(logits, labels)
                == j_metrics.calc_acc(logits, labels))
    feat = rng.normal(size=(40, 7)).astype(np.float32) * 3 + 1
    feat[:, 2] = 4.0                             # a constant column
    fit = rng.random(40) < 0.5
    got = metrics.standard_scale(feat, fit)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, j_metrics.standard_scale(feat, fit))


def test_gather_parts_matches_jax():
    """[P, pad_inner, ...] rows back to global node order, through
    global_nid and inner_mask, as the JAX package gathers them."""
    from bnsgcn_tpu_torch.data.artifacts import build_artifacts
    from bnsgcn_tpu_torch.data.partitioner import partition_graph
    g = sbm_graph(**GRAPH)
    art = build_artifacts(g, partition_graph(g, 4, method="random", seed=1))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, art.pad_inner, 3)).astype(np.float32)
    got = evaluate.gather_parts(art, x)
    np.testing.assert_array_equal(got, j_evaluate.gather_parts(art, x))
    np.testing.assert_array_equal(evaluate.gather_parts(art, art.label),
                                  g.label)


def _eval_forward_pair(model, use_pp, port_spmm, **flags):
    """(the port's eval forward logits on the P=1 artifacts' inner rows,
    the JAX package's on its 1-device mesh, the port's mesh accuracies,
    the graph) for the same carried-over parameters (bf16 under --dtype
    bfloat16, as the JAX run casts them), the raw features, and `flags`
    (gather and dense codecs, dtype) in both packages' configs."""
    import jax.numpy as jnp
    from bnsgcn_tpu.data.artifacts import build_artifacts as j_build
    from bnsgcn_tpu.parallel.mesh import make_parts_mesh
    from bnsgcn_tpu.trainer import (build_block_arrays as j_blocks,
                                    build_step_fns as j_fns, place_blocks,
                                    place_replicated)
    from bnsgcn_tpu_torch.models.gnn import GNN
    from bnsgcn_tpu_torch.run import prepare_run
    from bnsgcn_tpu_torch.trainer import compute_dtype
    g_j, g = j_sbm_graph(**GRAPH), sbm_graph(**GRAPH)
    art_j = j_build(g_j, np.zeros(g_j.n_nodes, np.int32))
    jcfg = JConfig(model=model, n_layers=3, n_hidden=8, dropout=0.0,
                   use_pp=use_pp, norm="layer", spmm="ell", n_partitions=1,
                   n_feat=art_j.n_feat, n_class=art_j.n_class,
                   n_train=art_j.n_train, **flags)
    jspec = j_spec_from_config(jcfg)
    params, state = j_init_params(jax.random.key(3), jspec)
    if jcfg.dtype == "bfloat16":
        params = jax.tree.map(lambda v: v.astype(jnp.bfloat16), params)
    mesh = make_parts_mesh(1)
    fns, _, _, tbf = j_fns(jcfg, jspec, art_j, mesh)
    blk = j_blocks(art_j, model)
    blk.update(fns.extra_blk)
    for k in fns.drop_blk_keys:
        blk.pop(k, None)
    want = np.asarray(fns.eval_forward(
        place_replicated(params, mesh), place_replicated(state, mesh),
        place_blocks(blk, mesh), place_replicated(tbf, mesh)),
        np.float32)[0]
    cfg = Config(model=model, n_layers=3, n_hidden=8, dropout=0.0,
                 use_pp=use_pp, norm="layer", spmm=port_spmm, block_tile=16,
                 block_occupancy=2, n_partitions=1, device="cpu", **flags)
    pr = prepare_run(cfg, g=g, log=lambda m: None)
    net = GNN(pr.spec)
    net.load_state_dict(params_from_jax(
        jax.tree.map(lambda v: np.asarray(v, np.float32), params), pr.spec))
    net = net.to(compute_dtype(cfg))
    got = pr.fns.eval_forward(net, pr.blk)
    assert got.dtype == torch.float32         # raw f32 features promote
    accs = evaluate.evaluate_mesh("Epoch 00000", pr.fns.eval_forward, net,
                                  pr.blk, pr.art, ("val", "test"),
                                  log=lambda m: None)
    inner = art_j.inner_mask[0]
    return got.numpy()[inner], want[inner], accs, g


@pytest.mark.parametrize("model,use_pp", [("graphsage", True),
                                          ("graphsage", False),
                                          ("gcn", False)])
def test_eval_forward_p1_matches_jax(model, use_pp):
    """StepFns.eval_forward on the P=1 artifacts (hybrid SpMM, the raw
    features) against the JAX package's eval_forward on its 1-device mesh,
    for the same carried-over parameters: logits to 1e-5, and the mesh
    accuracies (evaluate_mesh, no comm) equal to the JAX package's."""
    got, want, accs, g = _eval_forward_pair(model, use_pp, "hybrid")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for mode, mask in (("val", g.val_mask), ("test", g.test_mask)):
        assert accs[mode] == metrics.calc_acc(want[mask], g.label[mask])


@pytest.mark.parametrize("flags", [dict(spmm_gather="int8"),
                                   dict(spmm_gather="fp8"),
                                   dict(dtype="bfloat16")])
def test_eval_forward_uses_the_training_codecs(flags):
    """The eval aggregation is the training SpMM with its codecs, as the
    JAX package's `_aggregate_for` gives its eval forward: int8 or e4m3
    gathers with one scale per call (the quantized payloads, hence the
    logits, the JAX package's: 1e-5 of the largest logit), a bf16 model on
    the raw f32 features in f32 (1e-5); the gathers really quantize (the
    logits move off the native eval's)."""
    got, want, _, _ = _eval_forward_pair("graphsage", True, "ell", **flags)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    if "spmm_gather" in flags:
        native, _, _, _ = _eval_forward_pair("graphsage", True, "ell")
        assert np.abs(native - got).max() > 1e-4 * scale


@pytest.mark.parametrize("inductive", [False, True])
def test_eval_device_mesh_through_the_cli(tmp_path, capsys, inductive):
    """--eval-device mesh is no longer refused: at P=1 through the entry
    point the loop evaluates on the eval forward (inductive: on the
    train+val and full graphs' own artifacts), with the host eval's lines
    and numbers on the same run."""
    flags = ["--dataset", "sbm", "--n-partitions", "1", "--n-layers", "2",
             "--n-hidden", "8", "--use-pp", "--spmm", "hybrid",
             "--block-tile", "64", "--n-epochs", "4", "--log-every", "2",
             "--dropout", "0", "--fix-seed", "--device", "cpu"]
    if inductive:
        flags.append("--inductive")
    outs = []
    for dev in ("mesh", "host"):
        assert t_main.main(flags + [
            "--eval-device", dev, "--ckpt-path", str(tmp_path / dev),
            "--results-path", str(tmp_path / f"res_{dev}")]) == 0
        outs.append([ln for ln in capsys.readouterr().out.splitlines()
                     if ln.startswith(EVAL_PREFIXES + ("RESULT",))])
    assert outs[0] == outs[1]
    assert outs[0][-2].startswith("Test Result | Accuracy ")
