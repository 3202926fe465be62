"""--overlap split (the interior/frontier aggregation) and --spmm segment
with --edge-chunk in the port, on the CPU, against the JAX package and
against --overlap off.

Without ranks:
  * the split layouts array-equal to the JAX package's layout functions on the
    skewed 4-part graph of tests/test_overlap.py (split_row_partition,
    split_coo, build_split_layouts, and build_split_block_layouts from the
    same cluster order, small tiles), and on its degenerate 2-part graph
    (a part with zero interior rows, a part with zero frontier rows);
  * on every part of both graphs, the split operator pair recombined
    (SplitSpmm) equal to the fused operator, forward and backward, within
    1e-5 of the largest value, on ELL, hybrid and segment;
  * agg_sum with --edge-chunk against the JAX package's agg_sum (its
    lax.scan over chunks) within 1e-5, forward and backward;
  * P=1 (the empty frontier, tests/test_overlap.py:250): 3 steps of split
    equal to off on ELL and hybrid; GAT falls back to off with the JAX
    package's line.

One module fixture spawns 4 gloo ranks over the skewed graph, and runs the
JAX package on 4 of conftest's 8 virtual devices:
  * the seam: HaloFlight's start, the interior operator, finish, the
    frontier operator and the merge against halo_apply and the fused
    operator, forward and gradient within 1e-5 (of the largest value),
    for every strategy x wire at rates 1.0 and 0.5 (tests/test_overlap.py
    :76);
  * end to end, 3 steps from the JAX package's initial parameters
    (jax.random.key(5), tests/test_overlap.py's model: 2 layers, H=16, no
    use_pp, dropout 0): split against off (logits 1e-4 of the largest,
    losses 1e-5 relative, parameters 1e-4 of the largest) for ELL at rate
    0.5, GCN on hybrid with ragged and int8 at rate 1.0, segment with
    shift, bf16 and --edge-chunk at rate 0.5, and ELL with --halo-refresh
    2; the first three also against the JAX package's split run at
    tests/test_torch_dist.py's tolerances (logits 1e-5, losses rtol 1e-4,
    parameters rtol 5e-4);
  * the CLI at P=4: --overlap split --spmm segment --edge-chunk trains and
    labels its Mesh line '+ovl'.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bnsgcn_tpu_torch import main as t_main
from bnsgcn_tpu_torch.config import Config
from bnsgcn_tpu_torch.data.artifacts import (build_artifacts, load_artifacts,
                                             save_artifacts)
from bnsgcn_tpu_torch.data.graph import Graph, synthetic_graph
from bnsgcn_tpu_torch.ops import block_spmm as t_blk
from bnsgcn_tpu_torch.ops import ell as t_ell
from bnsgcn_tpu_torch.ops import spmm as t_spmm
from bnsgcn_tpu_torch.parallel import halo
from bnsgcn_tpu_torch.parallel.mesh import launch
from bnsgcn_tpu_torch.run import init_training, prepare_part, prepare_run
from bnsgcn_tpu_torch.utils import prng

P = 4
STRATEGIES = ("padded", "shift", "ragged")
WIRES = ("native", "bf16", "int8", "fp8")
RATES = (1.0, 0.5)
EPOCHS = 3
D = 5
TILE = dict(tile_r=16, tile_c=16, occupancy_min=2)
SKEW_SIZES = (60, 30, 20, 10)
SKEW_GRAPH = dict(n_nodes=120, avg_degree=7, n_feat=6, seed=41,
                  power_law=True)
SEAM_TOL = 1e-5                         # of the largest value
OFF_LOGIT, OFF_LOSS, OFF_PARAM = 1e-4, 1e-5, 1e-4   # tests/test_overlap.py
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=5e-4, atol=1e-5)
# the end-to-end cases: (name, Config fields); JAX runs the first three
E2E = (("ell", dict(spmm="ell", sampling_rate=0.5)),
       ("hybrid", dict(model="gcn", spmm="hybrid", halo_exchange="ragged",
                       halo_wire="int8", sampling_rate=1.0)),
       ("segment", dict(spmm="segment", halo_exchange="shift",
                        halo_wire="bf16", sampling_rate=0.5, edge_chunk=8)),
       ("refresh", dict(spmm="ell", sampling_rate=0.5, halo_refresh=2)))
JAX_E2E = ("ell", "hybrid", "segment")


def _quiet(*a, **k):
    pass


def _skew():
    g = synthetic_graph(**SKEW_GRAPH)
    return g, np.repeat(np.arange(P), SKEW_SIZES).astype(np.int32)


def _degenerate():
    """tests/test_overlap.py's 16 nodes in 2 parts of 8: every part-0 row
    has a cross in-edge (zero interior), part 1 receives none (zero
    frontier)."""
    n = 16
    rng = np.random.default_rng(7)
    src = list(range(n)) + [8 + i for i in range(8)] + [8 + i
                                                        for i in range(7)]
    dst = list(range(n)) + list(range(8)) + [9 + i for i in range(7)]
    label = rng.integers(0, 3, size=n)
    feat = rng.normal(size=(n, 5)).astype(np.float32)
    ones = np.ones(n, dtype=bool)
    return (n, np.asarray(src, np.int64), np.asarray(dst, np.int64), feat,
            label.astype(np.int64), ones), np.repeat(np.arange(2),
                                                     8).astype(np.int32)


def _both_arts(which):
    """The port's and the JAX package's artifacts of the same partition."""
    from bnsgcn_tpu.data.artifacts import build_artifacts as j_build
    from bnsgcn_tpu.data.graph import Graph as JGraph
    from bnsgcn_tpu.data.graph import synthetic_graph as j_synthetic
    if which == "skew":
        g, pid = _skew()
        return build_artifacts(g, pid), j_build(j_synthetic(**SKEW_GRAPH),
                                                pid)
    fields, pid = _degenerate()
    return (build_artifacts(Graph(*fields, fields[5], fields[5]), pid),
            j_build(JGraph(*fields, fields[5], fields[5]), pid))


def _perms(art):
    pis, pes = zip(*[t_blk.cluster_order(art.src[p], art.dst[p],
                                         art.pad_inner, art.n_ext, target=16,
                                         log=_quiet)
                     for p in range(art.src.shape[0])])
    return np.stack(pis), np.stack(pes)


def _equal_arrays(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def _equal_spec(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("which", ["skew", "degenerate"])
def test_split_layouts_array_equal_to_jax(which):
    from bnsgcn_tpu.ops import block_spmm as j_blk
    from bnsgcn_tpu.ops import ell as j_ell
    from bnsgcn_tpu.ops import spmm as j_spmm
    art, art_j = _both_arts(which)
    ni, n_ext = art.pad_inner, art.n_ext
    got = t_spmm.split_row_partition(art.src, art.dst, ni)
    want = j_spmm.split_row_partition(art_j.src, art_j.dst, ni)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], want[1])
    for side_t, side_j in zip(got[2:], want[2:]):
        for a, b in zip(side_t, side_j):
            np.testing.assert_array_equal(a, b)
    _equal_arrays(t_spmm.split_coo(art.src, art.dst, ni),
                  j_spmm.split_coo(art_j.src, art_j.dst, ni))
    got = t_ell.build_split_layouts(art.src, art.dst, ni, n_ext)
    want = j_ell.build_split_layouts(art_j.src, art_j.dst, ni, n_ext)
    for side_t, side_j in zip(got[:2], want[:2]):
        for a, b in zip(side_t, side_j):
            _equal_spec(a, b)
    _equal_arrays(got[2], want[2])
    assert got[3:] == want[3:]
    pi, pe = _perms(art)
    got = t_blk.build_split_block_layouts(art.src, art.dst, ni, n_ext, pi,
                                          pe, **TILE)
    want = j_blk.build_split_block_layouts(art_j.src, art_j.dst, ni, n_ext,
                                           pi, pe, **TILE)
    for side_t, side_j in zip(got[:2], want[:2]):
        for a, b in zip(side_t[:2], side_j[:2]):
            _equal_spec(a, b)
        for a, b in zip(side_t[2], side_j[2]):
            _equal_spec(a, b)
    _equal_arrays(got[2], want[2])
    assert got[3:] == want[3:]
    if which == "degenerate":
        masks = t_spmm.split_row_partition(art.src, art.dst, ni)[0]
        assert masks[0].all() and not masks[1].any()
    else:
        assert t_blk.dense_edge_count(got[2]) > 0


def _ops(art, p, kind):
    """(fused, split) operators of part p: ELL, hybrid (small tiles) or
    segment."""
    from bnsgcn_tpu_torch.trainer import _sub, to_device
    ni, n_ext = art.pad_inner, art.n_ext
    src, dst = art.src[p:p + 1], art.dst[p:p + 1]
    if kind == "segment":
        coo = lambda s, d: t_spmm.CooSpmm(torch.from_numpy(s[0]),
                                          torch.from_numpy(d[0]), ni, 16)
        a = t_spmm.split_coo(src, dst, ni)
        return coo(src, dst), t_spmm.SplitSpmm(
            coo(a["seg_int_src"], a["seg_int_dst"]),
            coo(a["seg_fro_src"], a["seg_fro_dst"]), None, ni)
    if kind == "ell":
        f, b, arrays = t_ell.build_layouts(src, dst, ni, n_ext)
        fused = t_ell.EllSpmm(f, b, to_device(arrays, "cpu"))
        (i_f, i_b), (r_f, r_b), arrays, _, _ = t_ell.build_split_layouts(
            src, dst, ni, n_ext)
        return fused, t_spmm.SplitSpmm(
            t_ell.EllSpmm(i_f, i_b, to_device(_sub(arrays, "int_"), "cpu")),
            t_ell.EllSpmm(r_f, r_b, to_device(_sub(arrays, "fro_"), "cpu")),
            torch.from_numpy(arrays["merge_perm"][0]), ni)
    pi, pe = t_blk.cluster_order(src[0], dst[0], ni, n_ext, target=16,
                                 log=_quiet)
    f, b, pair, arrays = t_blk.build_block_layouts(src, dst, ni, n_ext,
                                                   pi[None], pe[None],
                                                   **TILE)
    fused = t_blk.BlockSpmm(f, b, pair, to_device(arrays, "cpu"))
    ints, fros, arrays, _, _ = t_blk.build_split_block_layouts(
        src, dst, ni, n_ext, pi[None], pe[None], **TILE)
    return fused, t_spmm.SplitSpmm(
        t_blk.BlockSpmm(*ints, to_device(_sub(arrays, "int_"), "cpu")),
        t_blk.BlockSpmm(*fros, to_device(_sub(arrays, "fro_"), "cpu")),
        torch.from_numpy(arrays["merge_perm"][0]), ni)


def _close(got, want, tol, what):
    scale = np.abs(want).max() + 1e-9
    assert np.abs(got - want).max() / scale < tol, what


@pytest.mark.parametrize("kind", ["ell", "hybrid", "segment"])
@pytest.mark.parametrize("which", ["skew", "degenerate"])
def test_split_operator_equals_fused(which, kind):
    art, _ = _both_arts(which)
    rng = np.random.default_rng(1)
    for p in range(art.src.shape[0]):
        fused, split = _ops(art, p, kind)
        h = rng.normal(size=(art.n_ext, D)).astype(np.float32)
        cot = rng.normal(size=(art.pad_inner, D)).astype(np.float32)
        outs = []
        for op in (fused, split):
            x = torch.from_numpy(h).requires_grad_(True)
            y = op(x)
            (y * torch.from_numpy(cot)).sum().backward()
            outs.append((y.detach().numpy(), x.grad.numpy()))
        _close(outs[1][0], outs[0][0], SEAM_TOL, (which, kind, p, "fwd"))
        _close(outs[1][1], outs[0][1], SEAM_TOL, (which, kind, p, "bwd"))
        pre = split.apply_dir("fwd", torch.from_numpy(h), "pre",
                              native=True).numpy()
        _close(pre, outs[0][0], SEAM_TOL, (which, kind, p, "compose"))


@pytest.mark.parametrize("edge_chunk", [0, 32, 64])
def test_agg_sum_edge_chunk_matches_jax(edge_chunk):
    import jax
    import jax.numpy as jnp

    from bnsgcn_tpu.ops.spmm import agg_sum as j_agg_sum
    art, _ = _both_arts("skew")
    src, dst = art.src[1], art.dst[1]
    e = (len(src) // 64) * 64           # the JAX scan needs E % chunk == 0
    src, dst = src[:e], dst[:e]
    rng = np.random.default_rng(2)
    h = rng.normal(size=(art.n_ext, D)).astype(np.float32)
    cot = rng.normal(size=(art.pad_inner, D)).astype(np.float32)
    x = torch.from_numpy(h).requires_grad_(True)
    y = t_spmm.agg_sum(x, torch.from_numpy(src).long(),
                       torch.from_numpy(dst).long(), art.pad_inner,
                       edge_chunk)
    (y * torch.from_numpy(cot)).sum().backward()
    f = lambda v: j_agg_sum(v, jnp.asarray(src), jnp.asarray(dst),
                            art.pad_inner, edge_chunk)
    want, vjp = jax.vjp(f, jnp.asarray(h))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(cot))[0]),
                               rtol=1e-5, atol=1e-5)


def _cfg(**kw):
    base = dict(model="graphsage", n_layers=2, n_hidden=16, dropout=0.0,
                use_pp=False, norm="layer", lr=0.01, weight_decay=0.0,
                spmm="ell", n_partitions=P, n_epochs=EPOCHS, eval=False,
                device="cpu", dist_backend="gloo", seed=0, block_tile=16,
                block_occupancy=2)
    base.update(kw)
    return Config(**base)


def _dispatch(fns, model, opt, blk, e, cache):
    if fns.train_step_full is None:
        return fns.train_step(model, opt, blk, e), None
    if cache is None:
        return fns.train_step_full(model, opt, blk, e)
    return fns.train_step_cached(model, opt, blk, e, None, cache)


def _steps(pr, init):
    """Logits at epoch 2 (tests/test_overlap.py's forward), then 3
    steps."""
    blk, model, opt = init_training(pr, init)
    logits = pr.fns.forward(model, blk, 2).detach().numpy()
    losses, cache = [], None
    for e in range(EPOCHS):
        loss, cache = _dispatch(pr.fns, model, opt, blk, e, cache)
        losses.append(float(loss))
    return logits, losses, {k: v.detach().numpy().copy()
                            for k, v in model.state_dict().items()}


def _assert_off_equals_split(off, split, what):
    lo, lso, po = off
    ls, lss, ps = split
    _close(ls, lo, OFF_LOGIT, (what, "logits"))
    for a, b in zip(lso, lss):
        assert abs(a - b) <= OFF_LOSS * max(abs(a), 1.0), (what, lso, lss)
    for k in po:
        _close(ps[k], po[k], OFF_PARAM, (what, k))


@pytest.mark.parametrize("spmm", ["ell", "hybrid"])
def test_p1_split_equals_off(spmm):
    """P=1: no halo in-edge anywhere, the frontier side all padding."""
    g = synthetic_graph(n_nodes=64, avg_degree=5, n_feat=6, seed=9)
    res = {}
    for overlap in ("off", "split"):
        pr = prepare_run(_cfg(spmm=spmm, n_partitions=1, overlap=overlap),
                         g=g, log=_quiet)
        assert pr.fns.overlap == overlap
        res[overlap] = _steps(pr, None)
    _assert_off_equals_split(res["off"], res["split"], spmm)
    masks = t_spmm.split_row_partition(pr.art.src, pr.art.dst,
                                       pr.art.pad_inner)[0]
    assert not masks[0].any()


def test_gat_falls_back_to_off():
    g = synthetic_graph(n_nodes=64, avg_degree=5, n_feat=6, seed=9)
    lines = []
    pr = prepare_run(_cfg(model="gat", heads=2, use_pp=True, n_partitions=1,
                          overlap="split"), g=g, log=lines.append)
    assert pr.fns.overlap == "off"
    assert any(ln.startswith("overlap=split unavailable (model='gat' "
                             "aggregates through the masked edge softmax")
               and ln.endswith("falling back to --overlap off")
               for ln in lines), lines


# ----------------------------------------------------------------------------
# 4 ranks
# ----------------------------------------------------------------------------

def _seam(art, me, comm, strategy, wire, rate, h, cot):
    """(fused output and gradient, split output and gradient) of one
    layer's exchange + ELL aggregation on rank `me`."""
    fused, split = _ops(art, 0, "ell")
    spec, tables = halo.make_halo_spec(art.n_b, art.pad_inner,
                                       art.pad_boundary, rate, strategy, wire)
    plan = halo.make_halo_plan(spec, tables, torch.from_numpy(art.bnd[0]),
                               me, 3, prng.key(42))
    outs = []
    for path in ("fused", "split"):
        x = torch.from_numpy(h).requires_grad_(True)
        if path == "fused":
            y = fused(halo.halo_apply(spec, plan, x, comm))
        else:
            flight = halo.HaloFlight(spec, plan, comm)
            flight.start(x)
            o_int = split.interior(x)
            y = split.merge(o_int, split.frontier(torch.cat([x,
                                                             flight.finish()])))
        (y * torch.from_numpy(cot)).sum().backward()
        outs.append((y.detach().numpy(), x.grad.numpy()))
    return outs


def _rank_job(ctx, path, h, cot, init, part_path):
    torch.set_num_threads(1)
    me = ctx.rank
    art = load_artifacts(path, parts=[me])
    out = {}
    for rate in RATES:
        for strategy in STRATEGIES:
            for wire in WIRES:
                out["seam", strategy, wire, rate] = _seam(
                    art, me, ctx.comm, strategy, wire, rate, h[me], cot[me])
    for name, flags in E2E:
        model = flags.get("model", "graphsage")
        sd = {k: torch.from_numpy(v) for k, v in init[model].items()}
        for overlap in ("off", "split"):
            pr = prepare_part(_cfg(overlap=overlap, **flags), art, None,
                              ctx.device, _quiet, me, ctx.comm)
            assert pr.fns.overlap == overlap
            out[name, overlap] = _steps(pr, sd)
    return out


def _jax_split_run(art_j, mesh, model="graphsage", spmm="ell",
                   halo_exchange="padded", halo_wire="native",
                   sampling_rate=0.5, edge_chunk=0):
    """tests/test_overlap.py's _run_training with --overlap split (and
    small tiles): logits at epoch 2, 3 losses, the parameters, and the
    initial parameters (jax.random.key(5))."""
    import jax
    import jax.numpy as jnp

    from bnsgcn_tpu.config import Config as JConfig
    from bnsgcn_tpu.models.gnn import ModelSpec, init_params
    from bnsgcn_tpu.trainer import (build_block_arrays, build_step_fns,
                                    init_training as j_init_training,
                                    place_blocks, place_replicated)
    cfg = JConfig(model=model, dropout=0.0, use_pp=False, norm="layer",
                  n_train=art_j.n_train, lr=0.01, sampling_rate=sampling_rate,
                  spmm=spmm, halo_exchange=halo_exchange, halo_wire=halo_wire,
                  overlap="split", n_partitions=P, n_feat=art_j.n_feat,
                  n_class=art_j.n_class, block_tile=16, block_occupancy=2,
                  edge_chunk=edge_chunk)
    spec = ModelSpec(model, (art_j.n_feat, 16, art_j.n_class), norm="layer",
                     dropout=0.0, train_size=art_j.n_train)
    fns, _, tables, _ = build_step_fns(cfg, spec, art_j, mesh)
    assert fns.overlap == "split"
    blk_np = build_block_arrays(art_j, model)
    blk_np.update(fns.extra_blk)
    for k in fns.drop_blk_keys:
        blk_np.pop(k, None)
    blk = place_blocks(blk_np, mesh)
    tb = place_replicated(tables, mesh)
    params, state = init_params(jax.random.key(5), spec)
    params_np = jax.tree.map(np.asarray, params)
    pp = place_replicated(params, mesh)
    ss = place_replicated(state, mesh)
    _, _, opt = j_init_training(cfg, spec, mesh)
    logits = np.asarray(fns.forward(pp, ss, jnp.uint32(2), blk, tb,
                                    jax.random.key(0)))
    losses = []
    for e in range(EPOCHS):
        pp, ss, opt, loss = fns.train_step(pp, ss, opt, jnp.uint32(e), blk,
                                           tb, jax.random.key(0),
                                           jax.random.key(1))
        losses.append(float(loss))
    return (logits, losses, jax.tree.map(np.asarray, jax.device_get(pp))
            ), params_np


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from bnsgcn_tpu.parallel.mesh import make_parts_mesh
    from bnsgcn_tpu_torch.models.gnn import spec_from_config
    from bnsgcn_tpu_torch.trainer import params_from_jax
    work = str(tmp_path_factory.mktemp("work"))
    art, art_j = _both_arts("skew")
    path = f"{work}/skew"
    save_artifacts(art, path)
    mesh = make_parts_mesh(P)
    ref, init = {}, {}
    for name, flags in E2E:
        if name not in JAX_E2E:
            continue
        ref[name], params_np = _jax_split_run(art_j, mesh, **flags)
        model = flags.get("model", "graphsage")
        spec = spec_from_config(_cfg(model=model).replace(
            n_feat=art.n_feat, n_class=art.n_class, n_train=art.n_train))
        init.setdefault(model, {k: v.numpy() for k, v in
                                params_from_jax(params_np, spec).items()})
    rng = np.random.default_rng(0)
    h = rng.normal(size=(P, art.pad_inner, D)).astype(np.float32)
    cot = rng.normal(size=(P, art.pad_inner, D)).astype(np.float32)
    ranks = launch(_rank_job, P, [(path, h, cot, init, work)] * P, "gloo",
                   "cpu", log=_quiet)
    return dict(art=art, ranks=ranks, ref=ref)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_seam_split_matches_fused(runs, strategy, wire, rate):
    """The same wire payloads on both sides: only the sums' order
    differs."""
    for r, out in enumerate(runs["ranks"]):
        (of, gf), (os_, gs) = out["seam", strategy, wire, rate]
        _close(os_, of, SEAM_TOL, (strategy, wire, rate, r, "fwd"))
        _close(gs, gf, SEAM_TOL, (strategy, wire, rate, r, "bwd"))


@pytest.mark.parametrize("name", [c[0] for c in E2E])
def test_e2e_split_equals_off(runs, name):
    for out in runs["ranks"]:
        _assert_off_equals_split(out[name, "off"], out[name, "split"], name)
    assert out[name, "split"][1][-1] < out[name, "split"][1][0]


@pytest.mark.parametrize("name", JAX_E2E)
def test_split_matches_jax_split(runs, name):
    from bnsgcn_tpu_torch.models.gnn import spec_from_config
    from bnsgcn_tpu_torch.trainer import params_from_jax
    art = runs["art"]
    flags = dict(E2E)[name]
    spec = spec_from_config(_cfg(**flags).replace(
        n_feat=art.n_feat, n_class=art.n_class, n_train=art.n_train))
    logits_ref, losses_ref, params_ref = runs["ref"][name]
    want = {k: v.numpy() for k, v in params_from_jax(params_ref,
                                                     spec).items()}
    for r, out in enumerate(runs["ranks"]):
        logits, losses, params = out[name, "split"]
        inner = art.inner_mask[r]
        np.testing.assert_allclose(logits[inner], logits_ref[r][inner],
                                   **LOGIT_TOL)
        np.testing.assert_allclose(losses, losses_ref, **LOSS_TOL)
        for k in params:
            np.testing.assert_allclose(params[k], want[k], err_msg=k,
                                       **PARAM_TOL)


def test_cli_trains_split_segment_p4(tmp_path, capsys):
    rc = t_main.main(["--dataset", "sbm", "--model", "gcn", "--n-layers",
                      "2", "--n-hidden", "8", "--n-partitions", "4",
                      "--partition-method", "random", "--device", "cpu",
                      "--dist-backend", "gloo", "--sampling-rate", "0.5",
                      "--overlap", "split", "--spmm", "segment",
                      "--edge-chunk", "128", "--halo-exchange", "shift",
                      "--fix-seed", "--n-epochs", "2", "--log-every", "2",
                      "--part-path", str(tmp_path), "--ckpt-path",
                      str(tmp_path / "ck"), "--results-path",
                      str(tmp_path / "res")])
    out = capsys.readouterr().out
    assert rc == 0, out[-2000:]
    assert "spmm=segment" in out and "halo shift+ovl/native" in out
    assert "RESULT final_loss=" in out
