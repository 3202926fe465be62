"""The main path's last knobs in the port against the JAX package, on the
CPU: the JAX package's own initialization and dropout draws, --norm batch
(SyncBatchNorm), --remat and --reorder on P ranks.

Without ranks:
  * init: GNN(spec, seed, dtype) holds the JAX package's
    init_params(jax.random.key(seed), spec, dtype) for GraphSAGE (with and
    without use_pp, a dense tail), GCN and GAT, LayerNorm and BatchNorm, f32
    and bf16: the uniform draws bitwise, GAT's f32 normal draws within
    prng.NORMAL_ULP units in the last place (bf16 bitwise);
  * `_sync_batch_norm` against the JAX package's on one part (the real rows
    of a padded block): forward, gradients and running statistics within
    1e-5 of the largest value in f32; in bf16 within BF16_BN_BOUND (both
    round the moments and the output to bf16, at other points of their sums);
  * a checkpoint with a `bn_state`, byte-equal both ways;
  * whole CLI runs at --dropout 0.5, bnsgcn_tpu_torch.main against
    bnsgcn_tpu.main from the same --seed --fix-seed: P=1 and P=4, GraphSAGE
    (also with --norm batch --remat) and GAT: every epoch's loss within
    1e-4, the last periodic checkpoint's parameters within 5e-4 (PERF.md
    §2's bounds; absolute under --norm batch, PARAM_TOL_BN), its bn_state
    within the same; and at P=2 --replicas 2, --feat 2 and both against the
    JAX CLI's --replicas 2 or its run without them, with the `Mesh:`
    line's shape.

One module fixture spawns 4 gloo ranks once over the skewed 60/30/20/10
partition of tests/test_torch_halo_variants.py, 3 steps per case from the
JAX package's initial parameters (jax.random.key(9)):
  * GraphSAGE and GAT at dropout 0.5 and rate 0.5, and --norm batch there,
    against the JAX package's 4-device run (the masks are jax's own): losses
    rtol 1e-4, parameters rtol 5e-4, the BN state 1e-5;
  * --norm batch at rate 1.0 on 4 ranks equal to P=1 on the same graph
    (tests/test_torch_dist.py's law), and its running statistics bitwise
    equal on every rank;
  * --remat against no --remat, with LayerNorm and with --norm batch
    --overlap split (the recompute reruns the split exchange and BN's
    all-reduce): losses and parameters bitwise, as the JAX package pins
    them close (tests/test_distributed.py:210);
  * --reorder auto and cluster decided by the ranks' all-reduce equal to
    the JAX package's maybe_reorder on the whole partition (verdict and
    coverages), and ELL training on the reordered parts at rate 1.0
    without dropout: global-order logits bitwise, losses within 1e-6 of
    max(|loss|, 1) (tests/test_reorder.py:126).

The P=4 CLI runs and the P=1 GAT one take 20-45 s each and are marked
slow.
"""

import contextlib
import glob
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnsgcn_tpu import checkpoint as j_ckpt
from bnsgcn_tpu.models import gnn as j_gnn
from bnsgcn_tpu_torch import checkpoint as ckpt
from bnsgcn_tpu_torch import main as t_main
from bnsgcn_tpu_torch.config import Config
from bnsgcn_tpu_torch.data.artifacts import (build_artifacts, load_artifacts,
                                             save_artifacts)
from bnsgcn_tpu_torch.data.graph import synthetic_graph
from bnsgcn_tpu_torch.models import gnn as t_gnn
from bnsgcn_tpu_torch.parallel.mesh import launch
from bnsgcn_tpu_torch.run import init_training, prepare_part
from bnsgcn_tpu_torch.trainer import (bn_state_to_jax, dropout_key, make_tx,
                                      opt_state_from_jax, opt_state_to_jax,
                                      params_from_jax, params_to_jax)
from bnsgcn_tpu_torch.utils import prng

P = 4
EPOCHS = 3
SKEW_SIZES = (60, 30, 20, 10)
SKEW_GRAPH = dict(n_nodes=120, avg_degree=7, n_feat=6, seed=41,
                  power_law=True)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=5e-4, atol=1e-5)
BN_TOL = dict(rtol=1e-5, atol=1e-5)
# the CLI's --norm batch runs on the sbm graph: the reference's variance
# estimate sums every real row but divides by n_train, and clamps at 0, so
# some channels normalize by sqrt(eps) alone and multiply f32 sum-order
# differences by ~300; Adam then moves near-zero parameters apart. The
# losses still agree to LOSS_TOL; the parameters to 5e-4 absolute (measured
# 3.8e-4, against 0.16 the largest)
PARAM_TOL_BN = dict(rtol=5e-4, atol=5e-4)
# bf16 SyncBatchNorm against the JAX package's: both sum in f32 and round
# the moments once, then compute in bf16, but the sums reassociate, so a
# moment may land one bf16 step away and move the outputs by about one
# bf16 ulp of the normalized value (2^-8 relative, times |x_hat| <~ 4)
BF16_BN_BOUND = 2.0 ** -6
# the fixture's cases: (name, model, Config fields); JAX runs JAX_CASES
CASES = (("sage", "graphsage", dict(dropout=0.5)),
         ("gat", "gat", dict(dropout=0.5, heads=2)),
         ("bn", "graphsage", dict(dropout=0.5, norm="batch")),
         ("bn_r1", "graphsage", dict(norm="batch", sampling_rate=1.0)),
         ("ln_off", "graphsage", dict(dropout=0.5)),
         ("ln_remat", "graphsage", dict(dropout=0.5, remat=True)),
         ("bn_split", "graphsage", dict(dropout=0.5, norm="batch",
                                        overlap="split")),
         ("bn_split_remat", "graphsage", dict(dropout=0.5, norm="batch",
                                              overlap="split", remat=True)))
JAX_CASES = ("sage", "gat", "bn")
RO_TILE = 16


def _quiet(*a, **k):
    pass


def _skew_pid():
    return np.repeat(np.arange(P), SKEW_SIZES).astype(np.int32)


def _cfg(model="graphsage", **kw):
    base = dict(model=model, n_layers=3, n_hidden=8, dropout=0.0,
                use_pp=True, norm="layer", lr=0.01, weight_decay=5e-4,
                spmm="ell", n_partitions=P, n_epochs=EPOCHS, eval=False,
                device="cpu", dist_backend="gloo", seed=0, sampling_rate=0.5,
                block_tile=RO_TILE)
    base.update(kw)
    return Config(**base)


def _steps(pr, init, rank):
    """EPOCHS steps with the run's dropout keys; (losses, state_dict)."""
    blk, model, opt = init_training(pr, init)
    losses = [float(pr.fns.train_step(model, opt, blk, e,
                                      dropout_key(pr.cfg.seed, e, rank)))
              for e in range(EPOCHS)]
    return losses, {k: v.detach().float().numpy().copy()
                    for k, v in model.state_dict().items()}


def _rank_job(ctx, path, inits):
    from bnsgcn_tpu_torch.data.reorder import maybe_reorder
    torch.set_num_threads(1)
    me, comm = ctx.rank, ctx.comm
    art = load_artifacts(path, parts=[me])
    out = {}
    for name, model, flags in CASES:
        init = {k: torch.from_numpy(v) for k, v in inits[model].items()}
        if flags.get("norm") == "batch":
            init = {k: torch.from_numpy(v) for k, v in
                    inits["batch"].items()}
        pr = prepare_part(_cfg(model, **flags), art, None, ctx.device,
                          _quiet, me, comm)
        out[name] = _steps(pr, init, me)
    for mode in ("auto", "cluster"):
        cfg = _cfg(reorder=mode, sampling_rate=1.0)
        art_ro, resolved, info = maybe_reorder(cfg, art, _quiet, comm, me)
        out["ro", mode] = (resolved, info)
    init = {k: torch.from_numpy(v) for k, v in inits["graphsage"].items()}
    for mode, a in (("off", art), ("cluster", art_ro)):
        pr = prepare_part(_cfg(reorder=mode, sampling_rate=1.0), a, None,
                          ctx.device, _quiet, me, comm)
        blk, model, opt = init_training(pr, init)
        logits = pr.fns.forward(model, blk, 0).detach().numpy()
        losses = [float(pr.fns.train_step(model, opt, blk, e))
                  for e in range(EPOCHS)]
        out["ro_train", mode] = (logits, a.global_nid[0], a.inner_mask[0],
                                 losses)
    return out


def _jax_spec(model, art_j, norm="layer", heads=1, **_):
    return j_gnn.ModelSpec(model, (art_j.n_feat, 8, 8, art_j.n_class),
                           norm=norm, dropout=0.5, use_pp=True, heads=heads,
                           train_size=art_j.n_train)


def _jax_run(art_j, mesh, model, flags):
    """EPOCHS steps of the JAX package on the 4-device mesh from
    jax.random.key(9)'s parameters, sample key(0), dropout key(1) (seed 0's
    key(seed + 1)): (losses, parameters, BN state)."""
    from bnsgcn_tpu.config import Config as JConfig
    from bnsgcn_tpu.trainer import (build_block_arrays, build_step_fns,
                                    init_training as j_init_training,
                                    place_blocks, place_replicated)
    spec = _jax_spec(model, art_j, **flags)
    cfg = JConfig(**{**dict(model=model, dropout=0.0, use_pp=True,
                            norm="layer", n_train=art_j.n_train, lr=0.01,
                            weight_decay=5e-4, sampling_rate=0.5, spmm="ell",
                            n_partitions=P), **flags})
    params, state = j_gnn.init_params(jax.random.key(9), spec)
    fns, _, tb, tbf = build_step_fns(cfg, spec, art_j, mesh)
    blk_np = build_block_arrays(art_j, model)
    blk_np.update(fns.extra_blk)
    for k in fns.drop_blk_keys:
        blk_np.pop(k, None)
    blk = place_blocks(blk_np, mesh)
    blk["feat0_ext" if model == "gat" else "feat"] = fns.precompute(
        blk, place_replicated(tbf, mesh))
    tb = place_replicated(tb, mesh)
    pp, ss = place_replicated(params, mesh), place_replicated(state, mesh)
    _, _, opt = j_init_training(cfg, spec, mesh)
    losses = []
    for e in range(EPOCHS):
        pp, ss, opt, loss = fns.train_step(pp, ss, opt, jnp.uint32(e), blk,
                                           tb, jax.random.key(0),
                                           jax.random.key(1))
        losses.append(float(loss))
    return (losses, jax.tree.map(np.asarray, jax.device_get(pp)),
            jax.tree.map(np.asarray, jax.device_get(ss)))


@pytest.fixture(scope="module")
def knobs4(tmp_path_factory):
    from bnsgcn_tpu.data.artifacts import build_artifacts as j_build
    from bnsgcn_tpu.data.graph import synthetic_graph as j_synthetic
    from bnsgcn_tpu.data.reorder import maybe_reorder as j_maybe_reorder
    from bnsgcn_tpu.parallel.mesh import make_parts_mesh
    from bnsgcn_tpu.config import Config as JConfig

    work = str(tmp_path_factory.mktemp("knobs"))
    g = synthetic_graph(**SKEW_GRAPH)
    art = build_artifacts(g, _skew_pid())
    path = f"{work}/parts/skew"
    save_artifacts(art, path)
    art_j = j_build(j_synthetic(**SKEW_GRAPH), _skew_pid())
    mesh = make_parts_mesh(P)
    inits, specs = {}, {}
    for key, model, norm in (("graphsage", "graphsage", "layer"),
                             ("gat", "gat", "layer"),
                             ("batch", "graphsage", "batch")):
        spec = t_gnn.spec_from_config(_cfg(model, norm=norm, heads=2).replace(
            n_feat=art.n_feat, n_class=art.n_class, n_train=art.n_train))
        params, _ = j_gnn.init_params(jax.random.key(9), _jax_spec(
            model, art_j, norm=norm, heads=2))
        inits[key] = {k: v.numpy() for k, v in params_from_jax(
            jax.tree.map(np.asarray, params), spec).items()}
        specs[key] = spec
    ref = {name: _jax_run(art_j, mesh, model, flags)
           for name, model, flags in CASES if name in JAX_CASES}
    for mode in ("auto", "cluster"):
        ref["ro", mode] = j_maybe_reorder(
            JConfig(reorder=mode, block_tile=RO_TILE), art_j,
            log=_quiet)[1:]
    ranks = launch(_rank_job, P, [(path, inits)] * P, "gloo", "cpu",
                   log=_quiet)
    return dict(g=g, art=art, ranks=ranks, ref=ref, specs=specs,
                inits=inits)


@pytest.mark.parametrize("name", JAX_CASES)
def test_dropout_runs_equal_the_jax_package(knobs4, name):
    """Dropout 0.5 at rate 0.5: every rank draws jax's masks for (seed,
    epoch, rank), so the 4-rank run is the JAX package's."""
    losses_j, params_j, state_j = knobs4["ref"][name]
    spec = knobs4["specs"]["gat" if name == "gat" else
                           "batch" if name == "bn" else "graphsage"]
    for losses, sd in (r[name] for r in knobs4["ranks"]):
        np.testing.assert_allclose(losses, losses_j, **LOSS_TOL)
        want = params_from_jax(params_j, spec, state_j)
        for k, v in want.items():
            tol = BN_TOL if k.endswith((".mean", ".var")) else PARAM_TOL
            np.testing.assert_allclose(sd[k], v.numpy(), err_msg=k, **tol)


def test_sync_batch_norm_p4_equals_p1(knobs4):
    """At rate 1.0 the moments over 4 ranks' real rows are P=1's: losses,
    parameters and running statistics against the port's P=1 run on the
    same graph; the statistics bitwise equal on every rank."""
    cfg = _cfg(norm="batch", sampling_rate=1.0, n_partitions=1)
    art1 = build_artifacts(knobs4["g"], np.zeros(knobs4["g"].n_nodes,
                                                 dtype=np.int32))
    pr = prepare_part(cfg, art1, None, torch.device("cpu"), _quiet)
    init = {k: torch.from_numpy(v) for k, v in
            knobs4["inits"]["batch"].items()}
    losses1, sd1 = _steps(pr, init, 0)
    ranks = [r["bn_r1"] for r in knobs4["ranks"]]
    for losses, sd in ranks:
        np.testing.assert_allclose(losses, losses1, **LOSS_TOL)
        for k, v in sd1.items():
            tol = BN_TOL if k.endswith((".mean", ".var")) else PARAM_TOL
            np.testing.assert_allclose(sd[k], v, err_msg=k, **tol)
    for k in sd1:
        if k.endswith((".mean", ".var")):
            assert all(np.array_equal(sd[k], ranks[0][1][k])
                       for _, sd in ranks)


@pytest.mark.parametrize("off,on", [("ln_off", "ln_remat"),
                                    ("bn_split", "bn_split_remat")])
def test_remat_equals_no_remat(knobs4, off, on):
    """Per-layer recompute changes memory, not math: the recomputed layers
    redraw the same masks, rerun the same collectives (the split exchange,
    BN's all-reduce) and add BN's statistics once."""
    for r in knobs4["ranks"]:
        assert r[off][0] == r[on][0]
        for k, v in r[off][1].items():
            np.testing.assert_array_equal(r[on][1][k], v, err_msg=k)


@pytest.mark.parametrize("mode", ["auto", "cluster"])
def test_reorder_verdict_through_the_ranks_is_jax(knobs4, mode):
    resolved_j, info_j = knobs4["ref"]["ro", mode]
    for r in knobs4["ranks"]:
        resolved, info = r["ro", mode]
        assert resolved == resolved_j
        for k in ("coverage_before", "coverage_after", "resolved"):
            assert info[k] == info_j[k], k


def test_ell_training_is_order_invariant_on_the_ranks(knobs4):
    """tests/test_reorder.py:126 on 4 ranks: the global-order logits of the
    reordered parts bitwise --reorder off's, the losses within 1e-6."""
    art = knobs4["art"]
    got = {}
    for mode in ("off", "cluster"):
        out = np.zeros((int(art.n_inner.sum()), art.n_class), np.float32)
        for r in knobs4["ranks"]:
            logits, gnid, mask, losses = r["ro_train", mode]
            out[gnid[mask]] = logits[mask]
        got[mode] = (out, losses)
    np.testing.assert_array_equal(got["off"][0], got["cluster"][0])
    for a, b in zip(got["off"][1], got["cluster"][1]):
        assert abs(a - b) <= 1e-6 * max(abs(a), 1.0)
    assert any(not np.array_equal(r["ro_train", "off"][1],
                                  r["ro_train", "cluster"][1])
               for r in knobs4["ranks"])


# ---------------------------------------------------------------------------
# without ranks
# ---------------------------------------------------------------------------

INIT_SPECS = [("graphsage", True, 0, "layer"), ("graphsage", False, 1,
                                                "batch"),
              ("gcn", True, 0, "batch"), ("gat", True, 0, "layer")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model,use_pp,n_linear,norm", INIT_SPECS)
def test_init_params_are_the_jax_package_draws(model, use_pp, n_linear,
                                               norm, dtype):
    spec = t_gnn.ModelSpec(model, (12, 16, 16, 5), n_linear=n_linear,
                           norm=norm, use_pp=use_pp, heads=2, train_size=9)
    spec_j = j_gnn.ModelSpec(model, (12, 16, 16, 5), n_linear=n_linear,
                             norm=norm, use_pp=use_pp, heads=2, train_size=9)
    tdt = getattr(torch, dtype)
    params_j, state_j = j_gnn.init_params(jax.random.key(7), spec_j,
                                          getattr(jnp, dtype))
    want = params_from_jax(jax.tree.map(lambda v: np.asarray(
        v.astype(jnp.float32)), params_j), spec)
    got = t_gnn.GNN(spec, 7, tdt).state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = got[k].float().numpy()
        gat_normal = model == "gat" and k.split(".")[-1] in ("w", "attn_l",
                                                            "attn_r")
        if gat_normal and dtype == "float32":
            ulp = np.abs(g.view(np.int32).astype(np.int64)
                         - v.numpy().view(np.int32).astype(np.int64))
            assert ulp.max() <= prng.NORMAL_ULP, k
        else:
            np.testing.assert_array_equal(g, v.numpy(), err_msg=k)
    assert bn_state_to_jax(got, spec).keys() == state_j.keys()


def _bn_pair(dtype, seed=0):
    rng = np.random.default_rng(seed)
    n, d, real = 40, 6, 33
    h = (rng.normal(size=(n, d)) * 2 + 0.5).astype(np.float32)
    mask = np.arange(n) < real
    scale = rng.normal(size=d).astype(np.float32)
    bias = rng.normal(size=d).astype(np.float32)
    mean0 = rng.normal(size=d).astype(np.float32)
    var0 = rng.uniform(0.5, 2, size=d).astype(np.float32)
    cot = rng.normal(size=(n, d)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def j_fwd(hh, sc, bi):
        env = j_gnn.GraphEnv(src=None, dst=None, n_dst=n, in_norm=None,
                             out_norm=None, exchange=None, training=True,
                             inner_mask=jnp.asarray(mask))
        out, st = j_gnn._sync_batch_norm(
            {"scale": sc, "bias": bi}, {"mean": jnp.asarray(mean0),
                                        "var": jnp.asarray(var0)},
            hh, env, whole_size=30)
        return out, st

    args = [jnp.asarray(x, jdt) for x in (h, scale, bias)]
    (out_j, st_j), vjp = jax.vjp(j_fwd, *args)
    grads_j = vjp((jnp.asarray(cot, out_j.dtype),
                   jax.tree.map(jnp.zeros_like, st_j)))
    p = t_gnn.BatchNorm(d).to(tdt)
    with torch.no_grad():
        p.weight.copy_(torch.from_numpy(scale))
        p.bias.copy_(torch.from_numpy(bias))
        p.mean.copy_(torch.from_numpy(mean0))
        p.var.copy_(torch.from_numpy(var0))
    assert p.mean.dtype == torch.float32
    ht = torch.from_numpy(h).to(tdt).requires_grad_(True)
    env = t_gnn.GraphEnv(n_dst=n, in_norm=None, out_norm=None, exchange=None,
                         aggregate=None, inner_mask=torch.from_numpy(mask))
    out_t, st_t = t_gnn._sync_batch_norm(p, ht, env, 30)
    out_t.backward(torch.from_numpy(cot).to(tdt))
    f = lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32))  # noqa
    t = lambda x: x.detach().float().numpy()                      # noqa
    pairs = [(t(out_t), f(out_j)), (t(ht.grad), f(grads_j[0])),
             (t(p.weight.grad), f(grads_j[1])), (t(p.bias.grad),
                                                 f(grads_j[2])),
             (t(st_t[0]), f(st_j["mean"])), (t(st_t[1]), f(st_j["var"]))]
    assert out_t.dtype == tdt and st_t[0].dtype == torch.float32
    return pairs


def test_sync_batch_norm_is_the_jax_package_f32():
    """Forward, the three gradients and the running statistics within 1e-5
    of the largest value."""
    for got, want in _bn_pair("float32"):
        assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(),
                                                      1.0)


def test_sync_batch_norm_is_the_jax_package_bf16():
    """bf16: within BF16_BN_BOUND of the largest value."""
    for got, want in _bn_pair("bfloat16", 1):
        assert np.abs(got - want).max() <= BF16_BN_BOUND * max(
            np.abs(want).max(), 1.0)


def test_bn_state_checkpoint_is_byte_equal_both_ways(tmp_path):
    """A JAX file with SyncBatchNorm's state loads into the port (the
    statistics into BatchNorm's f32 buffers) and the port writes it back
    byte for byte; the port's file restores in the JAX package."""
    from bnsgcn_tpu.config import Config as JConfig
    from bnsgcn_tpu.trainer import make_tx as j_make_tx
    spec = t_gnn.ModelSpec("graphsage", (5, 8, 8, 3), norm="batch",
                           use_pp=True, train_size=4)
    spec_j = j_gnn.ModelSpec("graphsage", (5, 8, 8, 3), norm="batch",
                             use_pp=True, train_size=4)
    params, state = j_gnn.init_params(jax.random.key(2), spec_j)
    rng = np.random.default_rng(5)
    state = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
        np.float32), state)
    opt = j_make_tx(JConfig(weight_decay=5e-4)).init(params)
    j_path = str(tmp_path / "jax.ckpt")
    j_ckpt.save_checkpoint(j_path, params=params, opt_state=opt,
                           bn_state=state, epoch=3, best_acc=0.5, seed=11)
    payload = ckpt.read_blob(j_path)
    net = t_gnn.GNN(spec)
    net.load_state_dict(params_from_jax(payload["params"], spec,
                                        payload["bn_state"]))
    np.testing.assert_array_equal(net.norm_1.var.numpy(),
                                  state["norm_1"]["var"])
    tx = make_tx(Config(weight_decay=5e-4), net.parameters())
    opt_state_from_jax(payload["opt_state"], tx, net)
    t_path = str(tmp_path / "port.ckpt")
    ckpt.save_checkpoint(t_path, params=params_to_jax(net.state_dict(),
                                                      spec),
                         opt_state=opt_state_to_jax(tx, net),
                         bn_state=bn_state_to_jax(net.state_dict(), spec),
                         epoch=3, best_acc=0.5, seed=11)
    with open(j_path, "rb") as a, open(t_path, "rb") as b:
        assert a.read() == b.read()
    _, _, s = j_ckpt.restore_into(j_ckpt.read_blob(t_path), params, opt,
                                  state)
    np.testing.assert_array_equal(np.asarray(s["norm_0"]["mean"]),
                                  state["norm_0"]["mean"])


# ---------------------------------------------------------------------------
# whole CLI runs
# ---------------------------------------------------------------------------

def _cli_args(tmp, who, extra):
    return (["--dataset", "sbm", "--n-layers", "3", "--n-hidden", "16",
             "--use-pp", "--dropout", "0.5", "--n-epochs", "6",
             "--log-every", "3", "--fix-seed", "--seed", "3", "--spmm",
             "ell", "--part-path", f"{tmp}/p_{who}", "--ckpt-path",
             f"{tmp}/c_{who}", "--results-path", f"{tmp}/r_{who}"] + extra)


def _cli_pair(tmp_path, monkeypatch, extra, port_extra):
    import bnsgcn_tpu.main as j_main
    got = {}
    orig = j_main.run_training

    def capture(cfg, *a, **k):
        got["res"] = orig(cfg, *a, **k)
        return got["res"]

    monkeypatch.setattr(j_main, "run_training", capture)
    with contextlib.redirect_stdout(io.StringIO()):
        j_main.main(_cli_args(tmp_path, "j", extra))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert t_main.main(_cli_args(tmp_path, "t", extra) + port_extra) == 0
    line = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith("LOSSES ")][-1]
    losses_t = [float(x) for x in line.split()[2].split(",")]
    np.testing.assert_allclose(losses_t, got["res"].losses, **LOSS_TOL)
    a, b = (j_ckpt.read_blob(glob.glob(f"{tmp_path}/c_{w}/*_5.ckpt")[0])
            for w in ("j", "t"))
    tol = PARAM_TOL_BN if "batch" in extra else PARAM_TOL
    for x, y in zip(jax.tree.leaves(b["params"]),
                    jax.tree.leaves(a["params"])):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **tol)
    assert jax.tree.structure(b["bn_state"]) == jax.tree.structure(
        a["bn_state"])
    # the running statistics average activations of those parameters
    for x, y in zip(jax.tree.leaves(b["bn_state"]),
                    jax.tree.leaves(a["bn_state"])):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **tol)
    return buf.getvalue()


@pytest.mark.parametrize("extra", [[], ["--norm", "batch", "--remat"]],
                         ids=["graphsage", "batch-remat"])
def test_cli_p1_at_dropout_half_is_the_jax_cli(tmp_path, monkeypatch, extra):
    _cli_pair(tmp_path, monkeypatch, ["--n-partitions", "1"] + extra,
              ["--device", "cpu"])


@pytest.mark.parametrize("axes,port_axes,mesh", [
    (["--replicas", "2"], [], "Mesh: 2x2 replicas x parts = 4 ranks"),
    ([], ["--feat", "2"], "Mesh: 2x2 parts x feat = 4 ranks"),
    (["--replicas", "2"], ["--feat", "2"],
     "Mesh: 2x2x2 replicas x parts x feat = 8 ranks")],
    ids=["replicas2", "feat2", "replicas2-feat2"])
def test_cli_p2_axes_are_the_jax_cli(tmp_path, monkeypatch, axes, port_axes,
                                     mesh):
    """--replicas 2 against the JAX CLI's --replicas 2; --feat 2 against
    the JAX CLI without it (its feat=2 step is refused by this jax): the
    keys fold no feat index and dropout draws at full width, so the runs
    agree within the bounds above; every checkpoint holds full arrays."""
    out = _cli_pair(tmp_path, monkeypatch,
                    ["--n-partitions", "2", "--sampling-rate", "0.5"] + axes,
                    ["--device", "cpu", "--dist-backend", "gloo"]
                    + port_axes)
    assert mesh in out


@pytest.mark.slow
def test_cli_p1_gat_at_dropout_half_is_the_jax_cli(tmp_path, monkeypatch):
    """~45 s, most of it the JAX package's GAT run."""
    _cli_pair(tmp_path, monkeypatch, ["--n-partitions", "1", "--model",
                                      "gat", "--heads", "2"],
              ["--device", "cpu"])


@pytest.mark.slow
@pytest.mark.parametrize("extra", [["--norm", "batch", "--remat"],
                                   ["--model", "gat", "--heads", "2"]],
                         ids=["graphsage-batch-remat", "gat"])
def test_cli_p4_at_dropout_half_is_the_jax_cli(tmp_path, monkeypatch, extra):
    _cli_pair(tmp_path, monkeypatch,
              ["--n-partitions", "4", "--sampling-rate", "0.5"] + extra,
              ["--device", "cpu", "--dist-backend", "gloo"])
