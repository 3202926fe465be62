"""The halo exchange's variants in the port, on the CPU, against the JAX
package and against each other: --halo-exchange shift|ragged|auto,
--halo-refresh K, --halo-mode grad-only, --sampling-rate 0.0.

One module fixture spawns 4 gloo ranks once over a skewed partition (part
sizes 60/30/20/10 of tests/test_halo_wire.py's power-law graph, so the
three strategies ship different rows) and an SBM graph (the JAX refresh
tests' own), and runs the JAX package on 4 of conftest's 8 virtual
devices:

  * every strategy x wire (native, bf16, int8, fp8) at rates 1.0 and 0.5:
    halo_apply's forward array-equal to padded's on the same plan (the
    same rows are copied and quantized with the same block scales) and to
    the JAX package's padded exchange (fp8 within 1e-6 relative: XLA's
    fused e4m3 decode is an f32 ulp off on some rows), its VJP of a random
    cotangent within 1e-6 of both;
  * the --halo-refresh plans (sel, weight, slots, presence) of every rank
    for K = 2 and 3 at rates 1.0 and 0.5, epochs 0..K, array-equal to the
    JAX package's make_halo_plan_refresh; rate 1.0, K = 3: the chunks of
    epochs 0-2 merged through refresh_row_mask rebuild the full exchange
    bitwise, under every strategy (tests/test_halo_refresh.py:187);
  * --sampling-rate 0.0: every rank's plans for epochs 0-2 array-equal to
    the JAX package's; its halo block is zero forward and backward;
  * 3 steps of GraphSAGE with use_pp on ELL, dropout 0, from the JAX
    package's initial parameters, at the tolerances of
    tests/test_torch_dist.py (logits 1e-5, losses rtol 1e-4, parameters
    rtol 5e-4): K = 2 (a full-refresh step, then cached ones), grad-only
    and rate 0.0 against the JAX 4-device runs of the same flags; K = 2
    with the full-refresh step forced every epoch bitwise the historical
    step (tests/test_halo_refresh.py:277), and K = 1 builds no refresh
    step; rate 0.0 equal to grad-only at rate 1.0 (both zero the halo
    block); shift and ragged training equal to padded's;
  * on the SBM graph, 40 epochs: the staleness bias at rate 1.0 for K = 2
    and 4 within tests/test_halo_refresh.py:286's bound, and grad-only
    converging (:299);
  * a K = 2 run resumed twice from one periodic checkpoint: each resumed
    run logs its full refresh with reason 'resume' and the two agree
    bitwise (tests/test_halo_refresh.py:446);

and without ranks: select_halo_strategy and wire_bytes equal to the JAX
package's on a table of skews, with ragged allowed and not; the refresh
spec's geometry and tables array-equal to make_refresh_spec's; the chunk
draws bitwise the JAX package's chunk_sample; the CLI's halo label and
wire lines for each variant.
"""

import numpy as np
import pytest
import torch

from bnsgcn_tpu_torch import main as t_main
from bnsgcn_tpu_torch.config import Config
from bnsgcn_tpu_torch.data.artifacts import (build_artifacts, load_artifacts,
                                             save_artifacts)
from bnsgcn_tpu_torch.data.graph import sbm_graph, synthetic_graph
from bnsgcn_tpu_torch.data.partitioner import partition_graph
from bnsgcn_tpu_torch.parallel import halo
from bnsgcn_tpu_torch.parallel.mesh import launch
from bnsgcn_tpu_torch.run import init_training, prepare_part
from bnsgcn_tpu_torch.utils import prng

P = 4
STRATEGIES = ("padded", "shift", "ragged")
WIRES = ("native", "bf16", "int8", "fp8")
RATES = (1.0, 0.5)
KS = (2, 3)
EPOCH = 3                       # the exchange matrix's plan epoch
KEY = 42                        # its sample key, jax.random.key(42)
HALO_D = 5
EPOCHS = 3
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=5e-4, atol=1e-5)
SKEW_SIZES = (60, 30, 20, 10)
SKEW_GRAPH = dict(n_nodes=120, avg_degree=7, n_feat=6, seed=41,
                  power_law=True)
SBM_GRAPH = dict(n_nodes=240, n_class=4, n_feat=8, p_in=0.08, p_out=0.004,
                 seed=44)
LONG_EPOCHS = 40
# the training cases on the skewed graph: (name, Config fields); JAX runs
# the first three
CASES = (("k2", dict(halo_refresh=2)),
         ("go", dict(halo_mode="grad-only")),
         ("r0", dict(sampling_rate=0.0)),
         ("go1", dict(halo_mode="grad-only", sampling_rate=1.0)),
         ("shift", dict(halo_exchange="shift", halo_wire="int8")),
         ("ragged", dict(halo_exchange="ragged", halo_wire="int8")),
         ("padded8", dict(halo_wire="int8")))
JAX_CASES = ("k2", "go", "r0")


def _quiet(*a, **k):
    pass


def _skew_pid():
    return np.repeat(np.arange(P), SKEW_SIZES).astype(np.int32)


def _cfg(**kw):
    base = dict(model="graphsage", n_layers=3, n_hidden=8, dropout=0.0,
                use_pp=True, norm="layer", lr=0.01, weight_decay=5e-4,
                spmm="ell", n_partitions=P, n_epochs=EPOCHS, eval=False,
                device="cpu", dist_backend="gloo", seed=0, sampling_rate=0.5)
    base.update(kw)
    return Config(**base)


def _sbm_cfg(**kw):
    return _cfg(**{**dict(n_layers=2, n_hidden=16, n_epochs=LONG_EPOCHS,
                          sampling_rate=1.0), **kw})


def _halo_vjp(spec, plan, h, cot, comm):
    x = torch.from_numpy(h).requires_grad_(True)
    y = halo.halo_apply(spec, plan, x, comm)
    (y * torch.from_numpy(cot)).sum().backward()
    return y.detach().numpy(), x.grad.numpy()


def _plan_np(plan):
    return tuple(a.numpy() for a in (plan.sel, plan.weight, plan.slots,
                                     plan.presence))


def _run(fns, model, opt, blk, epochs, start=0, force_full=False):
    """run.train_loop's step dispatch: the full-refresh step while the
    cache is empty (or every epoch with force_full), the cached one
    after; the historical step without --halo-refresh."""
    cache, losses = None, []
    for e in range(start, start + epochs):
        if fns.train_step_full is None:
            loss = fns.train_step(model, opt, blk, e)
        elif cache is None or force_full:
            loss, cache = fns.train_step_full(model, opt, blk, e)
        else:
            loss, cache = fns.train_step_cached(model, opt, blk, e, None,
                                                cache)
        losses.append(float(loss))
    return losses


def _steps(pr, init, force_full=False, epochs=EPOCHS):
    blk, model, opt = init_training(pr, init)
    logits = pr.fns.forward(model, blk, 0).detach().numpy()
    losses = _run(pr.fns, model, opt, blk, epochs, force_full=force_full)
    return logits, losses, {k: v.detach().numpy().copy()
                            for k, v in model.state_dict().items()}


def _loop_cfg(work, name, n_epochs):
    return _sbm_cfg(halo_refresh=2, n_epochs=n_epochs, log_every=2,
                    sampling_rate=0.5, dataset="sbm",
                    part_path=f"{work}/parts", graph_name="sbm",
                    skip_partition=True, ckpt_path=f"{work}/{name}/ck",
                    results_path=f"{work}/{name}/res")


def _loop(ctx, cfg, resume_from=None):
    """One run through run.py's rank body; rank 0's log lines."""
    from bnsgcn_tpu_torch.parallel.mesh import RankContext
    from bnsgcn_tpu_torch.run import _rank_main, artifacts_dir
    lines = []
    sub = RankContext(ctx.rank, ctx.device, ctx.comm, lines.append)
    rep = _rank_main(sub, cfg, artifacts_dir(cfg), None, None, None,
                     resume_from)
    return lines, rep["losses"]


def _rank_job(ctx, path, sbm_path, h, cot, init, work):
    torch.set_num_threads(1)
    me, comm = ctx.rank, ctx.comm
    art = load_artifacts(path, parts=[me])
    bnd = torch.from_numpy(art.bnd[0])
    ni = art.pad_inner
    out = {}
    for rate in RATES:
        for strategy in STRATEGIES:
            for wire in WIRES:
                spec, tables = halo.make_halo_spec(
                    art.n_b, ni, art.pad_boundary, rate, strategy, wire)
                plan = halo.make_halo_plan(spec, tables, bnd, me, EPOCH,
                                           prng.key(KEY))
                out["x", strategy, wire, rate] = _halo_vjp(
                    spec, plan, h[me], cot[me], comm)
        for K in KS:
            spec, tables = halo.make_refresh_spec(
                art.n_b, ni, art.pad_boundary, rate, K)
            out["rplan", rate, K] = [_plan_np(halo.make_halo_plan_refresh(
                spec, tables, bnd, me, e, prng.key(0), K))
                for e in range(K + 1)]
    # rate 1.0, K=3: the staggered chunks rebuild the full exchange
    feat = torch.from_numpy(art.feat[0])
    for strategy in STRATEGIES:
        sp, tb = halo.make_halo_spec(art.n_b, ni, art.pad_boundary, 1.0,
                                     strategy)
        full = halo.halo_apply(sp, halo.make_halo_plan(sp, tb, bnd, me),
                               feat, comm)[ni:]
        sp_r, tb_r = halo.make_refresh_spec(art.n_b, ni, art.pad_boundary,
                                            1.0, 3, strategy)
        merged = torch.zeros_like(full)
        for e in range(3):
            plan = halo.make_halo_plan_refresh(sp_r, tb_r, bnd, me, e,
                                               prng.key(0), 3)
            tail = halo.halo_apply(sp_r, plan, feat, comm)[ni:]
            merged = torch.where(halo.refresh_row_mask(sp_r, 3, e)[:, None],
                                 tail, merged)
        out["stagger", strategy] = (full.numpy(), merged.numpy())
    # rate 0.0: the plans, and the exchange (zero both ways)
    sp0, tb0 = halo.make_halo_spec(art.n_b, ni, art.pad_boundary, 0.0)
    plans0 = [halo.make_halo_plan(sp0, tb0, bnd, me, e, prng.key(0))
              for e in range(EPOCHS)]
    out["plans0"] = [_plan_np(p) for p in plans0]
    out["x0"] = _halo_vjp(sp0, plans0[1], h[me], cot[me], comm)

    init = {k: torch.from_numpy(v) for k, v in init.items()}
    for name, flags in CASES:
        pr = prepare_part(_cfg(**flags), art, None, ctx.device, _quiet, me,
                          comm)
        out[name] = _steps(pr, init)
        out[name, "has_refresh"] = pr.fns.train_step_full is not None
        if name == "k2":
            out["k2_full"] = _steps(pr, init, force_full=True)
            out["k2_steady_mb"] = halo.wire_bytes(pr.fns.halo_refresh_spec,
                                                  8)
            pr1 = prepare_part(_cfg(halo_refresh=1), art, None, ctx.device,
                               _quiet, me, comm)
            out["k1_hist"] = _steps(pr1, init)
            out["k1", "has_refresh"] = pr1.fns.train_step_full is not None

    sbm = load_artifacts(sbm_path, parts=[me])
    for name, flags in (("exact", {}), ("stale2", dict(halo_refresh=2)),
                        ("stale4", dict(halo_refresh=4)),
                        ("grad_only", dict(halo_mode="grad-only",
                                           sampling_rate=0.5))):
        pr = prepare_part(_sbm_cfg(**flags), sbm, None, ctx.device, _quiet,
                          me, comm)
        blk, model, opt = init_training(pr)
        out["sbm", name] = _run(pr.fns, model, opt, blk, LONG_EPOCHS)

    # a K=2 run, then two runs resumed from its epoch-3 checkpoint
    from bnsgcn_tpu_torch import checkpoint as ckpt
    base = _loop_cfg(work, "base", 4)
    out["loop_base"] = _loop(ctx, base)
    for i in (0, 1):
        out["loop_resumed", i] = _loop(
            ctx, _loop_cfg(work, f"resumed{i}", 6),
            resume_from=ckpt.periodic_path(base, 3))
    return out


def _jax_run(art_j, mesh, **flags):
    """3 steps of the JAX package on the 4-device mesh, dispatched as
    bnsgcn_tpu/run.py dispatches them (the full-refresh step on an empty
    cache): (logits at epoch 0, losses, parameters) from
    jax.random.key(9)'s initial parameters (returned too)."""
    import jax
    import jax.numpy as jnp

    from bnsgcn_tpu.config import Config as JConfig
    from bnsgcn_tpu.models.gnn import ModelSpec, init_params
    from bnsgcn_tpu.trainer import (build_block_arrays, build_step_fns,
                                    init_training as j_init_training,
                                    place_blocks, place_replicated)
    kw = dict(model="graphsage", dropout=0.0, use_pp=True, norm="layer",
              n_train=art_j.n_train, lr=0.01, weight_decay=5e-4,
              sampling_rate=0.5, spmm="ell", n_partitions=P)
    kw.update(flags)
    cfg = JConfig(**kw)
    spec = ModelSpec("graphsage", (art_j.n_feat, 8, 8, art_j.n_class),
                     norm="layer", dropout=0.0, use_pp=True,
                     train_size=art_j.n_train)
    params, state = init_params(jax.random.key(9), spec)
    params_np = jax.tree.map(np.asarray, params)
    fns, _, tb, tbf = build_step_fns(cfg, spec, art_j, mesh)
    blk_np = build_block_arrays(art_j, "graphsage")
    blk_np.update(fns.extra_blk)
    for k in fns.drop_blk_keys:
        blk_np.pop(k, None)
    blk = place_blocks(blk_np, mesh)
    tb = place_replicated(tb, mesh)
    blk["feat"] = fns.precompute(blk, place_replicated(tbf, mesh))
    keys = (jax.random.key(0), jax.random.key(1))
    pp = place_replicated(params, mesh)
    ss = place_replicated(state, mesh)
    logits = np.asarray(fns.forward(pp, ss, jnp.uint32(0), blk, tb, *keys))
    _, _, opt = j_init_training(cfg, spec, mesh)
    tb_r = (place_replicated(fns.tables_refresh, mesh)
            if fns.train_step_full is not None else None)
    cache, losses = None, []
    for e in range(EPOCHS):
        ep = jnp.uint32(e)
        if fns.train_step_full is None:
            pp, ss, opt, loss = fns.train_step(pp, ss, opt, ep, blk, tb,
                                               *keys)
        elif cache is None:
            pp, ss, opt, loss, cache = fns.train_step_full(
                pp, ss, opt, ep, blk, tb, *keys)
        else:
            pp, ss, opt, loss, cache = fns.train_step_cached(
                pp, ss, opt, ep, blk, tb_r, cache, *keys)
        losses.append(float(loss))
    return (logits, losses, jax.tree.map(np.asarray, jax.device_get(pp))
            ), params_np


def _jax_reference(art_j, h, cot):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS

    from bnsgcn_tpu.parallel.halo import (halo_apply as j_apply,
                                          make_halo_plan as j_plan,
                                          make_halo_plan_refresh as j_rplan,
                                          make_halo_spec as j_spec,
                                          make_refresh_spec as j_rspec)
    from bnsgcn_tpu.parallel.mesh import make_parts_mesh, shard_map
    mesh = make_parts_mesh(P)
    ref = {}
    bnd = jnp.asarray(art_j.bnd)
    args = (PS("parts"),) * 3
    for rate in RATES:
        for wire in WIRES:
            sp, tb = j_spec(art_j.n_b, art_j.pad_inner, art_j.pad_boundary,
                            rate, wire=wire)

            def local(b, x, c, sp=sp, tb=tb):
                plan = j_plan(sp, tb, b[0], jnp.uint32(EPOCH),
                              jax.random.key(KEY))
                y, vjp = jax.vjp(lambda v: j_apply(sp, plan, v), x[0])
                return y[None], vjp(c[0])[0][None]

            f = jax.jit(shard_map(local, mesh=mesh, in_specs=args,
                                  out_specs=(PS("parts"),) * 2))
            y, dx = f(bnd, jnp.asarray(h), jnp.asarray(cot))
            ref["x", wire, rate] = (np.asarray(y), np.asarray(dx))
        for K in KS:
            sp, tb = j_rspec(art_j.n_b, art_j.pad_inner, art_j.pad_boundary,
                             rate, K)

            def local_r(b, e, sp=sp, tb=tb, K=K):
                p = j_rplan(sp, tb, b[0], e, jax.random.key(0), K)
                return tuple(a[None] for a in (p.sel, p.weight, p.slots,
                                               p.presence))

            f = jax.jit(shard_map(local_r, mesh=mesh,
                                  in_specs=(PS("parts"), PS()),
                                  out_specs=(PS("parts"),) * 4))
            ref["rplan", rate, K] = [tuple(np.asarray(a) for a in
                                           f(bnd, jnp.uint32(e)))
                                     for e in range(K + 1)]
    sp0, tb0 = j_spec(art_j.n_b, art_j.pad_inner, art_j.pad_boundary, 0.0)

    def local0(b, e):
        p = j_plan(sp0, tb0, b[0], e, jax.random.key(0))
        return tuple(a[None] for a in (p.sel, p.weight, p.slots, p.presence))

    f = jax.jit(shard_map(local0, mesh=mesh, in_specs=(PS("parts"), PS()),
                          out_specs=(PS("parts"),) * 4))
    ref["plans0"] = [tuple(np.asarray(a) for a in f(bnd, jnp.uint32(e)))
                     for e in range(EPOCHS)]
    init = None
    for name, flags in CASES:
        if name in JAX_CASES:
            ref[name], init = _jax_run(art_j, mesh, **flags)
    return ref, init


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from bnsgcn_tpu.data.artifacts import build_artifacts as j_build
    from bnsgcn_tpu.data.graph import synthetic_graph as j_synthetic
    from bnsgcn_tpu_torch.models.gnn import spec_from_config
    from bnsgcn_tpu_torch.trainer import params_from_jax

    work = str(tmp_path_factory.mktemp("work"))
    g = synthetic_graph(**SKEW_GRAPH)
    art = build_artifacts(g, _skew_pid())
    path = f"{work}/parts/skew"
    save_artifacts(art, path)
    sbm = sbm_graph(**SBM_GRAPH)
    save_artifacts(build_artifacts(sbm, partition_graph(
        sbm, P, method="random", seed=2)), f"{work}/parts/sbm")
    rng = np.random.default_rng(0)
    h = rng.normal(size=(P, art.pad_inner, HALO_D)).astype(np.float32)
    cot = rng.normal(size=(P, art.n_ext, HALO_D)).astype(np.float32)
    ref, init_np = _jax_reference(
        j_build(j_synthetic(**SKEW_GRAPH), _skew_pid()), h, cot)
    spec = spec_from_config(_cfg().replace(
        n_feat=art.n_feat, n_class=art.n_class, n_train=art.n_train))
    init = {k: v.numpy() for k, v in params_from_jax(init_np, spec).items()}
    ranks = launch(_rank_job, P, [(path, f"{work}/parts/sbm", h, cot, init,
                                   work)] * P, "gloo", "cpu", log=_quiet)
    return dict(art=art, ranks=ranks, ref=ref, spec=spec, h=h, cot=cot)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_wire_matrix_matches_padded_and_jax(runs, strategy, wire,
                                                     rate):
    """The forward copies and quantizes the same rows under every
    strategy: array-equal to padded and to the JAX package's padded
    exchange (itself equal to its shift and ragged, tests/test_halo_wire.py
    :95); the VJP within 1e-6."""
    y_ref, dx_ref = runs["ref"]["x", wire, rate]
    for r, out in enumerate(runs["ranks"]):
        y, dx = out["x", strategy, wire, rate]
        y_pad, dx_pad = out["x", "padded", wire, rate]
        np.testing.assert_array_equal(y, y_pad)
        if wire == "fp8":
            # XLA's fused e4m3 decode lands an f32 ulp off the unfused
            # product on some rows (the codec alone is bitwise,
            # tests/test_torch_dist.py)
            np.testing.assert_allclose(y, y_ref[r], rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(y, y_ref[r])
        np.testing.assert_allclose(dx, dx_pad, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(dx, dx_ref[r], rtol=1e-6, atol=1e-6)
    assert np.abs(y_ref[:, runs["art"].pad_inner:]).sum() > 0


def test_skewed_partition_makes_the_strategies_differ(runs):
    """The graph really exercises the strategies: shift's rounds and
    ragged's exact rows ship fewer bytes than padded's buffer."""
    art = runs["art"]
    b = {s: halo.wire_bytes(halo.make_halo_spec(
        art.n_b, art.pad_inner, art.pad_boundary, 0.5, s)[0], 8)
        for s in STRATEGIES}
    assert b["ragged"] < b["shift"] < b["padded"], b


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("rate", RATES)
def test_refresh_plans_match_jax(runs, rate, K):
    for r, out in enumerate(runs["ranks"]):
        for e, (got, want) in enumerate(zip(out["rplan", rate, K],
                                            runs["ref"]["rplan", rate, K])):
            for name, a, b in zip(("sel", "weight", "slots", "presence"),
                                  got, want):
                np.testing.assert_array_equal(a, b[r],
                                              err_msg=f"{name} rank {r} "
                                              f"epoch {e}")


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_staggered_chunks_rebuild_the_exact_exchange(runs, strategy):
    for out in runs["ranks"]:
        full, merged = out["stagger", strategy]
        np.testing.assert_array_equal(merged, full)
    assert np.abs(runs["ranks"][0]["stagger", strategy][0]).sum() > 0


def test_rate_zero_plans_match_jax_and_send_nothing(runs):
    ni = runs["art"].pad_inner
    for r, out in enumerate(runs["ranks"]):
        for e, (got, want) in enumerate(zip(out["plans0"],
                                            runs["ref"]["plans0"])):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b[r], err_msg=f"epoch {e}")
        sel, weight, slots, presence = out["plans0"][0]
        assert not weight.any() and not presence[ni:].any()
        # the halo block is zero, and the backward adds nothing to the
        # inner rows' cotangent
        y, dx = out["x0"]
        assert not y[ni:].any()
        np.testing.assert_array_equal(y[:ni], runs["h"][r])
        np.testing.assert_array_equal(dx, runs["cot"][r][:ni])


def _match_jax(runs, name):
    from bnsgcn_tpu_torch.trainer import params_from_jax
    art = runs["art"]
    logits_ref, losses_ref, params_ref = runs["ref"][name]
    want = {k: v.numpy() for k, v in params_from_jax(params_ref,
                                                     runs["spec"]).items()}
    for r, out in enumerate(runs["ranks"]):
        logits, losses, params = out[name]
        inner = art.inner_mask[r]
        np.testing.assert_allclose(logits[inner], logits_ref[r][inner],
                                   **LOGIT_TOL)
        np.testing.assert_allclose(losses, losses_ref, **LOSS_TOL)
        assert sorted(params) == sorted(want)
        for k in params:
            np.testing.assert_allclose(params[k], want[k], err_msg=k,
                                       **PARAM_TOL)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("name", JAX_CASES)
def test_three_steps_match_jax(runs, name):
    """K=2 (full refresh at epoch 0, cached after), grad-only and rate 0.0
    against the JAX 4-device runs of the same flags."""
    _match_jax(runs, name)


def test_forced_full_refresh_is_bitwise_the_historical_step(runs):
    for out in runs["ranks"]:
        _, losses, params = out["k2_full"]
        _, losses1, params1 = out["k1_hist"]
        assert losses == losses1
        for k in params:
            np.testing.assert_array_equal(params[k], params1[k])
        assert out["k2", "has_refresh"] and not out["k1", "has_refresh"]
        # the cached steps really differ from the full ones (staleness)
        assert out["k2"][1][1:] != losses1[1:]


def test_refresh_halves_the_steady_wire(runs):
    art = runs["art"]
    full = halo.wire_bytes(halo.make_halo_spec(
        art.n_b, art.pad_inner, art.pad_boundary, 0.5)[0], 8)
    assert runs["ranks"][0]["k2_steady_mb"] <= 0.6 * full


def test_rate_zero_equals_grad_only(runs):
    for out in runs["ranks"]:
        for a, b in zip(out["r0"], out["go1"]):
            if isinstance(a, dict):
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("strategy", ["shift", "ragged"])
def test_strategies_train_as_padded(runs, strategy):
    for out in runs["ranks"]:
        logits, losses, params = out[strategy]
        logits_p, losses_p, params_p = out["padded8"]
        np.testing.assert_array_equal(logits, logits_p)
        np.testing.assert_allclose(losses, losses_p, **LOSS_TOL)
        for k in params:
            np.testing.assert_allclose(params[k], params_p[k], err_msg=k,
                                       **PARAM_TOL)


def test_staleness_bias_bounded_at_exact_rate(runs):
    """tests/test_halo_refresh.py:286: at rate 1.0 staleness is K's only
    approximation; K in {2, 4} land within 5% of the exact run's first
    loss of its last."""
    out = runs["ranks"][0]
    exact = out["sbm", "exact"]
    eps = 0.05 * abs(exact[0])
    for K in (2, 4):
        stale = out["sbm", f"stale{K}"]
        assert stale[-1] < 0.5 * stale[0], f"K={K} did not learn"
        assert abs(stale[-1] - exact[-1]) < eps, (K, exact[-1], stale[-1])


def test_grad_only_converges(runs):
    traj = runs["ranks"][0]["sbm", "grad_only"]
    assert traj[-1] < 0.5 * traj[0], traj


def test_resumed_refresh_run_starts_full_and_is_deterministic(runs):
    out = runs["ranks"][0]
    lines, base = out["loop_base"]
    assert "  halo cache: full refresh at epoch 0 (start); next 1+ epochs " \
           "reuse cached blocks" in lines
    got = []
    for i in (0, 1):
        lines, losses = out["loop_resumed", i]
        assert "  halo cache: full refresh at epoch 4 (resume); next 1+ " \
               "epochs reuse cached blocks" in lines
        assert sum("full refresh" in ln for ln in lines) == 1
        assert len(losses) == 2
        got.append(losses)
    assert got[0] == got[1]
    assert len(base) == 4


# ----------------------------------------------------------------------------
# without ranks
# ----------------------------------------------------------------------------

def _skews():
    """n_b tables: balanced, random skew, a banded diagonal, the hardware
    profile of tests/test_halo_wire.py, an empty halo, one rank."""
    rng = np.random.default_rng(7)
    bal = np.full((4, 4), 64, np.int64)
    np.fill_diagonal(bal, 0)
    rnd = rng.integers(100, 400, size=(4, 4)).astype(np.int64)
    np.fill_diagonal(rnd, 0)
    band = np.full((4, 4), 8, np.int64)
    np.fill_diagonal(band, 0)
    for p in range(4):
        band[p, (p + 1) % 4] = 512
    base = (50000 / np.arange(1, 8) ** 0.8).astype(np.int64)
    hw = np.zeros((8, 8), np.int64)
    for i in range(8):
        hw[i, np.arange(8) != i] = rng.permutation(base)
    return [("balanced", bal, 64), ("random", rnd, 512), ("band", band, 512),
            ("hw", hw, 50048), ("empty", np.zeros((4, 4), np.int64), 8),
            ("one", np.zeros((1, 1), np.int64), 8)]


@pytest.mark.parametrize("allow_ragged", [True, False])
@pytest.mark.parametrize("rate", [1.0, 0.5, 0.1, 0.0])
@pytest.mark.parametrize("case", _skews(), ids=lambda c: c[0])
def test_select_and_wire_bytes_match_jax(case, rate, allow_ragged):
    from bnsgcn_tpu.parallel import halo as j_halo
    _, n_b, pad_b = case
    assert (halo.select_halo_strategy(n_b, 0, pad_b, rate,
                                      allow_ragged=allow_ragged)
            == j_halo.select_halo_strategy(n_b, 0, pad_b, rate,
                                           allow_ragged=allow_ragged))
    for strategy in STRATEGIES:
        for wire in WIRES:
            sp, tb = halo.make_halo_spec(n_b, 16, pad_b, rate, strategy,
                                         wire)
            jsp, jtb = j_halo.make_halo_spec(n_b, 16, pad_b, rate,
                                             strategy=strategy, wire=wire)
            assert (sp.pad_send, sp.shift_pads, sp.pair_send, sp.exact) == (
                jsp.pad_send, jsp.shift_pads, jsp.pair_send, jsp.exact)
            for nb in (4, 2):
                assert (halo.wire_bytes(sp, 256, nb)
                        == j_halo.wire_bytes(jsp, 256, nb))
            for k in tb:
                np.testing.assert_array_equal(tb[k], np.asarray(jtb[k]))


def test_auto_is_eligible_for_ragged():
    assert halo.ragged_auto_eligible()
    _, n_b, pad_b = _skews()[3]
    assert halo.select_halo_strategy(n_b, 0, pad_b, 0.1)[0] == "ragged"


@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("rate", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_refresh_spec_matches_jax(strategy, rate, K):
    from bnsgcn_tpu.parallel import halo as j_halo
    for _, n_b, pad_b in _skews()[:4]:
        sp, tb = halo.make_refresh_spec(n_b, 16, pad_b, rate, K, strategy)
        jsp, jtb = j_halo.make_refresh_spec(n_b, 16, pad_b, rate, K,
                                            strategy=strategy)
        assert (sp.pad_send, sp.pad_boundary, sp.shift_pads, sp.pair_send,
                sp.exact) == (jsp.pad_send, jsp.pad_boundary, jsp.shift_pads,
                              jsp.pair_send, jsp.exact)
        for k in tb:
            np.testing.assert_array_equal(tb[k], np.asarray(jtb[k]))
        assert halo.wire_bytes(sp, 64, 2) == j_halo.wire_bytes(jsp, 64, 2)
        masks = [halo.refresh_row_mask(sp, K, e).numpy()
                 for e in range(K + 1)]
        import jax.numpy as jnp
        for e, m in enumerate(masks):
            np.testing.assert_array_equal(m, np.asarray(
                j_halo.refresh_row_mask(jsp, K, jnp.uint32(e))))


@pytest.mark.parametrize("chunk,stride", [(0, 2), (1, 2), (2, 3), (0, 1)])
def test_chunk_sample_is_jax_chunk_sample(chunk, stride):
    import jax
    import jax.numpy as jnp

    from bnsgcn_tpu.parallel import sampling as j_sampling
    from bnsgcn_tpu_torch.parallel import sampling as t_sampling
    n = torch.tensor([37, 0, 5, 300], dtype=torch.int64)
    s = torch.tensor([9, 0, 5, 1], dtype=torch.int64)
    keys = t_sampling.pair_key(prng.key(3), 7, torch.arange(4),
                               torch.tensor([1, 2, 3, 0]))
    pos, valid = t_sampling.chunk_sample(keys, n, s, chunk, stride, 320, 16)
    ipos, ivalid = t_sampling.chunk_identity_sample(n, chunk, stride, 16)
    for i in range(4):
        jk = j_sampling.pair_key(jax.random.key(3), 7, i, (i + 1) % 4)
        jp, jv = j_sampling.chunk_sample(jk, jnp.int32(n[i]),
                                         jnp.int32(s[i]), chunk, stride,
                                         320, 16)
        np.testing.assert_array_equal(pos[i].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(jv))
        jp, jv = j_sampling.chunk_identity_sample(jnp.int32(n[i]), chunk,
                                                  stride, 16)
        np.testing.assert_array_equal(ipos[i].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(ivalid[i].numpy(), np.asarray(jv))


@pytest.mark.parametrize("flags,labels", [
    (["--halo-exchange", "shift", "--halo-refresh", "2"],
     ["halo shift+hr2/native", "  halo refresh K=2: peak ",
      "  halo cache: full refresh at epoch 0 (start)"]),
    (["--halo-exchange", "auto", "--halo-mode", "grad-only",
      "--halo-refresh", "2"],
     ["halo-exchange=auto: ", "halo auto->", "+go/native",
      "--halo-refresh has no effect",
      "  halo grad-only: 0.00 MB/exchange steady-state"]),
    (["--halo-exchange", "ragged", "--halo-wire", "int8", "--sampling-rate",
      "0.0"], ["halo ragged/int8 at sampling rate 0: 0.00 MB"]),
])
def test_cli_trains_each_variant_p4(flags, labels, tmp_path, capsys):
    """The entry point at P=4 over gloo: each variant trains and labels
    itself on the Mesh line as the JAX package does."""
    rc = t_main.main(["--dataset", "sbm", "--model", "graphsage",
                      "--n-layers", "2", "--n-hidden", "8", "--use-pp",
                      "--n-partitions", "4", "--partition-method", "random",
                      "--device", "cpu", "--dist-backend", "gloo",
                      "--sampling-rate", "0.5", "--fix-seed", "--n-epochs",
                      "2", "--log-every", "2", "--dropout", "0",
                      "--part-path", str(tmp_path), "--ckpt-path",
                      str(tmp_path / "ck"), "--results-path",
                      str(tmp_path / "res")] + flags)
    out = capsys.readouterr().out
    assert rc == 0, out[-2000:]
    for label in labels:
        assert label in out, label
    assert "RESULT final_loss=" in out
