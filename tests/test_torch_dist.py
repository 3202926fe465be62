"""The port's P-rank path on the CPU: 4 gloo ranks against the JAX package
on 4 of conftest's 8 virtual devices, and against the port's own P=1 run.

  * halo_apply on 4 ranks == JAX halo_apply under shard_map: the forward is
    copies times 1.0, so array-equal; the VJP of a random cotangent to 1e-6
    (sums of a few terms in another order);
  * forward logits (1e-5: one forward, f32, other sum order), 3-step losses
    (rtol 1e-4) and parameters (rtol 5e-4), as tests/test_distributed.py
    holds JAX P=4 to P=1, for GraphSAGE with and without use_pp and GCN with
    use_pp, each on the ELL and on the hybrid SpMM with small tiles (the
    JAX reference runs ELL: the hybrid computes the same sums);
  * the law P=4 == P=1 in the port, at the same tolerances;
  * the CLI trains at --n-partitions 4 on the CPU over gloo; nccl with more
    parts than cards exits 2; a failing or stalled rank makes the run fail
    within the process-group timeout, with the other ranks torn down, while
    a barrier waits past it for work one rank does alone;
  * run_training's rank hook sees each rank's own layout, and the ranks
    hand back their collective seconds;
  * boundary-node sampling at rate 0.5 (sample key jax.random.key(0), the
    port's prng.key(0) from seed 0): every rank's plan (sel, weight, slots)
    for epochs 0-2 array-equal to the JAX package's make_halo_plan under
    shard_map; halo_apply forward array-equal, VJP to 1e-6; GraphSAGE with
    use_pp on ELL and hybrid, dropout 0, against the JAX 4-device run at the
    tolerances above; the precompute exchange is full-rate at any rate; the
    ranks' plans agree pair by pair (chip_smoke.plan_agreement); the sampled,
    1/ratio-scaled aggregation is unbiased (the twin of
    tests/test_distributed.py's test_bns_unbiasedness); the CLI trains at
    --sampling-rate 0.5 over gloo; GCN with use_pp and GraphSAGE without it
    at rate 0.5 against the JAX 4-device run as well;
  * --inductive at rate 0.5: the artifacts of the train subgraph, GraphSAGE
    with use_pp on ELL and hybrid, 3 steps against the JAX 4-device run on
    the JAX package's artifacts of the same subgraph;
  * the halo wire codecs bf16, int8 and fp8 at rate 0.5: halo_apply forward
    array-equal to the JAX 4-device run (both quantize the same rows with
    the same per-block scales), VJP to 1e-6; the quantizers' payloads and
    scales array-equal to the JAX package's `_quant` before any exchange;
  * the TPU recipe's finer knobs at rate 0.5 (--spmm hybrid --use-pallas
    --spmm-dense int8 --spmm-gather int8 --halo-wire int8, f32): GraphSAGE
    with use_pp against the JAX 4-device run of the same flags (the
    FINER_* bounds);
  * the TPU recipe's own knobs at rate 0.5 (--dtype bfloat16 --spmm hybrid
    --use-pallas --halo-wire int8, native gathers and dense tiles; the
    recipe's --spmm auto made hybrid, as auto picks on the Reddit-shaped
    graph): GraphSAGE with use_pp, 3-step losses against the JAX 4-device
    run of the same flags within BF16_LOSS_RTOL, the ranks replicated;
    chip_smoke.py's RECIPE_TPU is the knob list of scripts/reddit.sh.

The rank jobs are functions of this module, which the spawned ranks import:
JAX is imported only inside the functions that build the references, so a
rank starts with torch alone.
"""

import multiprocessing
import time

import numpy as np
import pytest
import torch

from bnsgcn_tpu_torch import main as t_main
from bnsgcn_tpu_torch.config import Config
from bnsgcn_tpu_torch.data.artifacts import (build_artifacts, load_artifacts,
                                             save_artifacts)
from bnsgcn_tpu_torch.data.graph import synthetic_graph
from bnsgcn_tpu_torch.data.partitioner import partition_graph
from bnsgcn_tpu_torch.parallel.halo import (halo_apply, make_halo_plan,
                                            make_halo_spec, wire_bytes)
from bnsgcn_tpu_torch.parallel.mesh import RankFailed, launch
from bnsgcn_tpu_torch.run import (init_training, prepare_part, prepare_run,
                                  run_training)
from bnsgcn_tpu_torch.trainer import build_spmm
from bnsgcn_tpu_torch.utils import prng

GRAPH = dict(n_nodes=90, avg_degree=6, n_feat=6, n_class=4, seed=31)
P = 4
EPOCHS = 3
HALO_D = 5
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=5e-4, atol=1e-5)
MODELS = [("graphsage", False), ("graphsage", True), ("gcn", True)]
SPMMS = ["ell", "hybrid"]
RATE = 0.5                      # the BNS cases' sampling rate
WIRES = ("bf16", "int8", "fp8")   # the quantized halo wires
# the TPU recipe's finer knobs (its int8 gathers and dense tiles) with its
# int8 wire, in f32, and their bounds against the JAX run: the
# port's dense tiles take one int8 scale per call (dense_apply_pallas), the
# JAX package's on the CPU one per slab (its XLA route), so the two
# quantize the slabs differently, by up to half an int8 step (amax/254) per
# value. Logits: 1e-2 of the largest logit, a little over one int8 step
# (1/127) of it (measured 0.5%). Losses: rtol 2e-3 (measured 4.3e-4).
# Parameters: 10 lr absolute, since Adam turns a gradient entry near zero
# whose sign the rounding flips into a step of up to ~lr either way, each
# of the 3 epochs (measured 5.8% of the largest parameter)
FINER_KNOBS = dict(spmm="hybrid", use_pallas=True, spmm_dense="int8",
                   spmm_gather="int8", halo_wire="int8")
FINER_LOGIT_FRAC = 1e-2
FINER_LOSS_RTOL = 2e-3
FINER_PARAM_ATOL = 10 * 0.01
# the TPU recipe's own knobs (scripts/reddit.sh: --dtype bfloat16 --spmm
# auto --use-pallas --halo-wire int8), with the hybrid that auto picks on
# the Reddit-shaped graph forced on this small one. Bound on the losses:
# tests/test_torch_lowp.py's BF16_LOSS_RTOL, with its reasoning: both
# frameworks round activations to bf16 at every layer (2^-8 relative per
# rounding) but at different points, and 3 steps of bf16 Adam at lr 0.01
# compound that; the int8 wire quantizes the same bf16 rows in both
RECIPE_TPU = dict(dtype="bfloat16", spmm="hybrid", use_pallas=True,
                  halo_wire="int8")
BF16_LOSS_RTOL = 2e-2
BNS_MODEL = ("graphsage", True)   # the model of the precompute check
UNBIASED_EPOCHS = 300


def _cfg(model, use_pp, spmm, n_parts, rate=1.0):
    return Config(model=model, n_layers=3, n_hidden=8, dropout=0.0,
                  use_pp=use_pp, norm="layer", lr=0.01, weight_decay=5e-4,
                  spmm=spmm, block_tile=16, block_occupancy=2,
                  n_partitions=n_parts, n_epochs=EPOCHS, eval=False,
                  device="cpu", dist_backend="gloo", seed=0,
                  sampling_rate=rate)


def _quiet(*a, **k):
    pass


def _steps(pr, model_init):
    """Forward logits at the initial parameters, then EPOCHS train steps."""
    blk, model, opt = init_training(pr, model_init)
    logits = pr.fns.forward(model, blk, 0).detach().float().numpy()
    losses = [float(pr.fns.train_step(model, opt, blk, e))
              for e in range(EPOCHS)]
    return logits, losses, {k: v.detach().float().numpy().copy()
                            for k, v in model.state_dict().items()}


def _halo_vjp(spec, plan, h, cot, comm):
    x = torch.from_numpy(h).requires_grad_(True)
    y = halo_apply(spec, plan, x, comm)
    (y * torch.from_numpy(cot)).sum().backward()
    return y.detach().numpy(), x.grad.numpy()


def _aggregate(spec, plan, feat, src, dst, comm):
    """The sum over the part's edges of the exchanged features
    (bnsgcn_tpu/ops/spmm.py agg_sum; dst == pad_inner is padding)."""
    hx = halo_apply(spec, plan, feat, comm)
    out = hx.new_zeros((spec.pad_inner + 1, hx.shape[1]))
    return out.index_add_(0, dst, hx[src])[:-1]


def _unbiased(art, comm, rank):
    """The mean over UNBIASED_EPOCHS epochs of the rate-RATE aggregation
    of the raw features, and the full-rate aggregation."""
    bnd = torch.from_numpy(art.bnd[0])
    feat = torch.from_numpy(art.feat[0])
    src, dst = (torch.from_numpy(art.src[0]).long(),
                torch.from_numpy(art.dst[0]).long())
    full_spec, full_tables = make_halo_spec(art.n_b, art.pad_inner,
                                            art.pad_boundary, 1.0)
    full = _aggregate(full_spec, make_halo_plan(full_spec, full_tables, bnd,
                                                rank), feat, src, dst, comm)
    spec, tables = make_halo_spec(art.n_b, art.pad_inner, art.pad_boundary,
                                  RATE)
    key = prng.key(42)
    acc = torch.zeros_like(full, dtype=torch.float64)
    for e in range(UNBIASED_EPOCHS):
        plan = make_halo_plan(spec, tables, bnd, rank, e, key)
        acc += _aggregate(spec, plan, feat, src, dst, comm)
    return (acc / UNBIASED_EPOCHS).numpy(), full.numpy()


def _rank_job(ctx, path, h, cot, inits, induc_path):
    """One rank: the halo exchange and its VJP, then every (model, spmm);
    then the BNS cases at rate RATE, every model; then the inductive case
    on the train subgraph's artifacts at `induc_path`."""
    torch.set_num_threads(1)
    art = load_artifacts(path, parts=[ctx.rank])
    bnd = torch.from_numpy(art.bnd[0])
    spec, tables = make_halo_spec(art.n_b, art.pad_inner, art.pad_boundary,
                                  1.0)
    plan = make_halo_plan(spec, tables, bnd, ctx.rank)
    out = {"halo": _halo_vjp(spec, plan, h[ctx.rank], cot[ctx.rank],
                             ctx.comm)}
    for (model, use_pp), init in zip(MODELS, inits):
        init = {k: torch.from_numpy(v) for k, v in init.items()}
        for spmm in SPMMS:
            pr = prepare_part(_cfg(model, use_pp, spmm, P), art, None,
                              ctx.device, _quiet, ctx.rank, ctx.comm)
            out[model, use_pp, spmm] = _steps(pr, init)

    # boundary-node sampling at rate RATE
    spec, tables = make_halo_spec(art.n_b, art.pad_inner, art.pad_boundary,
                                  RATE)
    plans = [make_halo_plan(spec, tables, bnd, ctx.rank, e, prng.key(0))
             for e in range(EPOCHS)]
    out["plans"] = [(p.sel.numpy(), p.weight.numpy(), p.slots.numpy())
                    for p in plans]
    out["halo_bns"] = _halo_vjp(spec, plans[1], h[ctx.rank], cot[ctx.rank],
                                ctx.comm)
    for (model, use_pp), init in zip(MODELS, inits):
        init = {k: torch.from_numpy(v) for k, v in init.items()}
        for spmm in SPMMS:
            pre = {}
            for rate in (1.0, RATE):
                pr = prepare_part(_cfg(model, use_pp, spmm, P, rate), art,
                                  None, ctx.device, _quiet, ctx.rank,
                                  ctx.comm)
                if (model, use_pp) == BNS_MODEL:
                    pre[rate] = pr.fns.precompute(pr.blk).numpy()
            out["bns", model, use_pp, spmm] = _steps(pr, init)
            if pre:
                out["pre", spmm] = pre
    out["unbiased"] = _unbiased(art, ctx.comm, ctx.rank)
    for wire in WIRES:
        wspec, _ = make_halo_spec(art.n_b, art.pad_inner, art.pad_boundary,
                                  RATE, wire=wire)
        out["halo_wire", wire] = _halo_vjp(wspec, plans[1], h[ctx.rank],
                                           cot[ctx.rank], ctx.comm)
    init = {k: torch.from_numpy(v)
            for k, v in inits[MODELS.index(BNS_MODEL)].items()}
    for key, flags in (("recipe", FINER_KNOBS), ("recipe_tpu", RECIPE_TPU)):
        pr = prepare_part(_cfg(*BNS_MODEL, "hybrid", P, RATE).replace(
            **flags), art, None, ctx.device, _quiet, ctx.rank, ctx.comm)
        out[key] = _steps(pr, init)

    # --inductive: the train subgraph's artifacts, rate RATE
    art_i = load_artifacts(induc_path, parts=[ctx.rank])
    init = {k: torch.from_numpy(v)
            for k, v in inits[MODELS.index(BNS_MODEL)].items()}
    for spmm in SPMMS:
        cfg = _cfg(*BNS_MODEL, spmm, P, RATE).replace(inductive=True)
        pr = prepare_part(cfg, art_i, None, ctx.device, _quiet, ctx.rank,
                          ctx.comm)
        out["induc", spmm] = _steps(pr, init)
    return out


def _jax_train(art_j, mesh, model, use_pp, rate, **flags):
    """One case of the JAX package on the 4-device mesh: (forward logits,
    EPOCHS losses, final parameters, as f32 numpy) from jax.random.key(9)'s
    initial parameters (returned too, as numpy), sample key
    jax.random.key(0); `flags` add Config fields (the TPU recipe's). Under
    dtype bfloat16 the parameters, the features and the precompute are
    cast as bnsgcn_tpu/run.py casts them."""
    import jax
    import jax.numpy as jnp

    from bnsgcn_tpu.config import Config as JConfig
    from bnsgcn_tpu.models.gnn import ModelSpec, init_params
    from bnsgcn_tpu.trainer import (build_block_arrays, build_step_fns,
                                    init_training as j_init_training,
                                    place_blocks, place_replicated)

    spec = ModelSpec(model, (art_j.n_feat, 8, 8, art_j.n_class),
                     norm="layer", dropout=0.0, use_pp=use_pp,
                     train_size=art_j.n_train)
    cfg = JConfig(**{**dict(
        model=model, dropout=0.0, use_pp=use_pp, norm="layer",
        n_train=art_j.n_train, lr=0.01, weight_decay=5e-4,
        sampling_rate=rate, spmm="ell", n_partitions=P, block_tile=16,
        block_occupancy=2), **flags})
    params, state = init_params(jax.random.key(9), spec)
    params_np = jax.tree.map(np.asarray, params)
    dtype = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
    fns, _, tb, tbf = build_step_fns(cfg, spec, art_j, mesh)
    blk_np = build_block_arrays(art_j, model)
    blk_np.update(fns.extra_blk)
    for k in fns.drop_blk_keys:
        blk_np.pop(k, None)
    blk = place_blocks(blk_np, mesh)
    blk["feat"] = blk["feat"].astype(dtype)
    tb = place_replicated(tb, mesh)
    if use_pp:
        blk["feat"] = fns.precompute(
            blk, place_replicated(tbf, mesh)).astype(dtype)
    keys = (jax.random.key(0), jax.random.key(1))
    pp = place_replicated(jax.tree.map(lambda v: jnp.asarray(v, dtype),
                                       params_np), mesh)
    ss = place_replicated(state, mesh)
    logits = np.asarray(fns.forward(pp, ss, jnp.uint32(0), blk, tb, *keys),
                        np.float32)
    _, _, opt = j_init_training(cfg, spec, mesh, dtype=dtype)
    losses = []
    for e in range(EPOCHS):
        pp, ss, opt, loss = fns.train_step(pp, ss, opt, jnp.uint32(e), blk,
                                           tb, *keys)
        losses.append(float(loss))
    return (logits, losses, jax.tree.map(lambda v: np.asarray(v, np.float32),
                                         jax.device_get(pp))), params_np


def _jax_reference(art_j, h, cot, art_ij):
    """The JAX package on 4 virtual devices: halo_apply + VJP under
    shard_map, and per model the forward logits, EPOCHS train steps and the
    final parameters (with the initial parameters it drew), at rate 1.0
    and RATE; then the inductive case on `art_ij`, the artifacts of the
    train subgraph."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS

    from bnsgcn_tpu.config import Config as JConfig
    from bnsgcn_tpu.models.gnn import ModelSpec, init_params
    from bnsgcn_tpu.parallel.halo import (halo_apply as j_halo_apply,
                                          make_halo_plan as j_plan,
                                          make_halo_spec as j_spec)
    from bnsgcn_tpu.parallel.mesh import make_parts_mesh, shard_map
    from bnsgcn_tpu.trainer import (build_block_arrays, build_step_fns,
                                    init_training as j_init_training,
                                    place_blocks, place_replicated)

    mesh = make_parts_mesh(P)
    hspec, tables = j_spec(art_j.n_b, art_j.pad_inner, art_j.pad_boundary,
                           1.0)

    def local(bnd, x, c):
        plan = j_plan(hspec, tables, bnd[0], jnp.uint32(0), jax.random.key(0))
        y, vjp = jax.vjp(lambda v: j_halo_apply(hspec, plan, v), x[0])
        return y[None], vjp(c[0])[0][None]

    halo = jax.jit(shard_map(local, mesh=mesh, in_specs=(PS("parts"),) * 3,
                             out_specs=(PS("parts"), PS("parts"))))
    y, dx = halo(jnp.asarray(art_j.bnd), jnp.asarray(h), jnp.asarray(cot))
    ref = {"halo": (np.asarray(y), np.asarray(dx))}

    # BNS at rate RATE: each epoch's plan, and halo_apply at epoch 1
    bspec, btables = j_spec(art_j.n_b, art_j.pad_inner, art_j.pad_boundary,
                            RATE)

    def local_plan(bnd, epoch):
        plan = j_plan(bspec, btables, bnd[0], epoch, jax.random.key(0))
        return plan.sel[None], plan.weight[None], plan.slots[None]

    def local_bns(bnd, x, c):
        plan = j_plan(bspec, btables, bnd[0], jnp.uint32(1),
                      jax.random.key(0))
        y, vjp = jax.vjp(lambda v: j_halo_apply(bspec, plan, v), x[0])
        return y[None], vjp(c[0])[0][None]

    plan_fn = jax.jit(shard_map(local_plan, mesh=mesh,
                                in_specs=(PS("parts"), PS()),
                                out_specs=(PS("parts"),) * 3))
    ref["plans"] = [tuple(np.asarray(a) for a in
                          plan_fn(jnp.asarray(art_j.bnd), jnp.uint32(e)))
                    for e in range(EPOCHS)]
    bns = jax.jit(shard_map(local_bns, mesh=mesh, in_specs=(PS("parts"),) * 3,
                            out_specs=(PS("parts"), PS("parts"))))
    y, dx = bns(jnp.asarray(art_j.bnd), jnp.asarray(h), jnp.asarray(cot))
    ref["halo_bns"] = (np.asarray(y), np.asarray(dx))
    ref["bns_spec"] = (bspec.pad_send, jax.tree.map(np.asarray, btables))

    for wire in WIRES:
        wspec, _ = j_spec(art_j.n_b, art_j.pad_inner, art_j.pad_boundary,
                          RATE, wire=wire)

        def local_wire(bnd, x, c, wspec=wspec):
            plan = j_plan(wspec, btables, bnd[0], jnp.uint32(1),
                          jax.random.key(0))
            y, vjp = jax.vjp(lambda v: j_halo_apply(wspec, plan, v), x[0])
            return y[None], vjp(c[0])[0][None]

        f = jax.jit(shard_map(local_wire, mesh=mesh,
                              in_specs=(PS("parts"),) * 3,
                              out_specs=(PS("parts"), PS("parts"))))
        y, dx = f(jnp.asarray(art_j.bnd), jnp.asarray(h), jnp.asarray(cot))
        ref["halo_wire", wire] = (np.asarray(y), np.asarray(dx))

    inits = []
    for model, use_pp in MODELS:
        for rate in (1.0, RATE):
            ref[model, use_pp, rate], params_np = _jax_train(
                art_j, mesh, model, use_pp, rate)
        inits.append(params_np)
    ref["induc"], _ = _jax_train(art_ij, mesh, *BNS_MODEL, RATE)
    ref["recipe"], _ = _jax_train(art_j, mesh, *BNS_MODEL, RATE,
                                  **FINER_KNOBS)
    ref["recipe_tpu"], _ = _jax_train(art_j, mesh, *BNS_MODEL, RATE,
                                      **RECIPE_TPU)
    return ref, inits


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One 4-rank run of every case, its JAX reference and its P=1 twin."""
    from bnsgcn_tpu.data.artifacts import build_artifacts as j_build
    from bnsgcn_tpu.data.graph import synthetic_graph as j_synthetic
    from bnsgcn_tpu_torch.models.gnn import spec_from_config
    from bnsgcn_tpu_torch.trainer import params_from_jax

    g = synthetic_graph(**GRAPH)
    pid = partition_graph(g, P, method="random", seed=3)
    art = build_artifacts(g, pid)
    path = str(tmp_path_factory.mktemp("parts"))
    save_artifacts(art, path)
    train_g = g.subgraph(g.train_mask)
    pid_i = partition_graph(train_g, P, method="random", seed=3)
    art_i = build_artifacts(train_g, pid_i)
    induc_path = str(tmp_path_factory.mktemp("parts_induc"))
    save_artifacts(art_i, induc_path)
    rng = np.random.default_rng(0)
    h = rng.normal(size=(P, art.pad_inner, HALO_D)).astype(np.float32)
    cot = rng.normal(size=(P, art.n_ext, HALO_D)).astype(np.float32)
    g_j = j_synthetic(**GRAPH)
    ref, inits = _jax_reference(
        j_build(g_j, pid), h, cot,
        j_build(g_j.subgraph(g_j.train_mask), pid_i))
    init_sd = []
    for (model, use_pp), params_np in zip(MODELS, inits):
        spec = spec_from_config(_cfg(model, use_pp, "ell", P).replace(
            n_feat=art.n_feat, n_class=art.n_class, n_train=art.n_train))
        init_sd.append({k: v.numpy() for k, v in
                        params_from_jax(params_np, spec).items()})
    t0 = time.perf_counter()
    ranks = launch(_rank_job, P, [(path, h, cot, init_sd, induc_path)] * P,
                   "gloo", "cpu", log=_quiet)
    launch_s = time.perf_counter() - t0
    p1 = {}
    for (model, use_pp), init in zip(MODELS, init_sd):
        for spmm in SPMMS:
            pr = prepare_run(_cfg(model, use_pp, spmm, 1), g=g, log=_quiet)
            p1[model, use_pp, spmm] = _steps(
                pr, {k: torch.from_numpy(v) for k, v in init.items()})
    return dict(art=art, art_i=art_i, ranks=ranks, ref=ref, p1=p1,
                init_sd=init_sd, launch_s=launch_s)


def test_halo_apply_matches_jax(runs):
    y_ref, dx_ref = runs["ref"]["halo"]
    for r, out in enumerate(runs["ranks"]):
        y, dx = out["halo"]
        np.testing.assert_array_equal(y, y_ref[r])
        np.testing.assert_allclose(dx, dx_ref[r], rtol=1e-6, atol=1e-6)
    # the halo slots really carry the peers' rows
    assert np.abs(y_ref[:, runs["art"].pad_inner:]).sum() > 0


def _close_params(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **PARAM_TOL)


def _match_jax(runs, case, model, use_pp, spmm, rate, ref_key=None,
               art_key="art"):
    """Every rank's forward logits, 3-step losses and parameters against
    the JAX 4-device run of the same case."""
    from bnsgcn_tpu_torch.models.gnn import spec_from_config
    from bnsgcn_tpu_torch.trainer import params_from_jax
    art = runs[art_key]
    logits_ref, losses_ref, params_ref = runs["ref"][
        ref_key or (model, use_pp, rate)]
    for r, out in enumerate(runs["ranks"]):
        logits, losses, params = out[case]
        inner = art.inner_mask[r]
        np.testing.assert_allclose(logits[inner], logits_ref[r][inner],
                                   **LOGIT_TOL)
        np.testing.assert_allclose(losses, losses_ref, **LOSS_TOL)
        spec = spec_from_config(_cfg(model, use_pp, spmm, P).replace(
            n_feat=art.n_feat, n_class=art.n_class, n_train=art.n_train))
        _close_params(params, {k: v.numpy() for k, v in
                               params_from_jax(params_ref, spec).items()})
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("spmm", SPMMS)
@pytest.mark.parametrize("model,use_pp", MODELS)
def test_p4_matches_jax_p4(runs, model, use_pp, spmm):
    _match_jax(runs, (model, use_pp, spmm), model, use_pp, spmm, 1.0)


@pytest.mark.parametrize("spmm", SPMMS)
@pytest.mark.parametrize("model,use_pp", MODELS)
def test_p4_equals_p1(runs, model, use_pp, spmm):
    """Sampling rate 1.0: the 4-rank run is the full-graph run."""
    _, losses1, params1 = runs["p1"][model, use_pp, spmm]
    for out in runs["ranks"]:
        _, losses4, params4 = out[model, use_pp, spmm]
        np.testing.assert_allclose(losses4, losses1, **LOSS_TOL)
        _close_params(params4, params1)


def test_ranks_end_replicated(runs):
    """Every rank applied the same updates: bitwise the same parameters."""
    first = runs["ranks"][0]
    cases = ([m + (s,) for m in MODELS for s in SPMMS]
             + [("bns",) + m + (s,) for m in MODELS for s in SPMMS]
             + [("induc", s) for s in SPMMS])
    for out in runs["ranks"][1:]:
        for key in cases:
            for k, v in first[key][2].items():
                np.testing.assert_array_equal(out[key][2][k], v)


def test_bns_plans_match_jax(runs):
    """Rate RATE: every rank's sel, weight and slots for epochs 0-2 are the
    JAX package's, and the epochs draw different samples."""
    for e, ref in enumerate(runs["ref"]["plans"]):
        for r, out in enumerate(runs["ranks"]):
            for got, want, name in zip(out["plans"][e], ref,
                                       ("sel", "weight", "slots")):
                np.testing.assert_array_equal(got, want[r],
                                              err_msg=f"{name} e={e} r={r}")
    sels = [runs["ranks"][0]["plans"][e][0] for e in range(EPOCHS)]
    assert not np.array_equal(sels[0], sels[1])


def test_bns_spec_matches_jax(runs):
    art = runs["art"]
    spec, tables = make_halo_spec(art.n_b, art.pad_inner, art.pad_boundary,
                                  RATE)
    pad_send, ref = runs["ref"]["bns_spec"]
    assert spec.pad_send == pad_send and not spec.exact
    for k in ("n_b", "send_size", "inv_ratio"):
        assert tables[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(tables[k], ref[k], err_msg=k)


def test_bns_halo_apply_matches_jax(runs):
    """Forward: copies times 1/ratio in f32, as in JAX: array-equal. VJP:
    sums of a few terms in another order, to 1e-6."""
    y_ref, dx_ref = runs["ref"]["halo_bns"]
    for r, out in enumerate(runs["ranks"]):
        y, dx = out["halo_bns"]
        np.testing.assert_array_equal(y, y_ref[r])
        np.testing.assert_allclose(dx, dx_ref[r], rtol=1e-6, atol=1e-6)
    assert np.abs(y_ref[:, runs["art"].pad_inner:]).sum() > 0


@pytest.mark.parametrize("spmm", SPMMS)
def test_bns_p4_matches_jax_p4(runs, spmm):
    """GraphSAGE with use_pp at rate RATE, dropout 0: logits, losses and
    parameters against the JAX 4-device run with the same sample key."""
    _match_jax(runs, ("bns",) + BNS_MODEL + (spmm,), *BNS_MODEL, spmm, RATE)


@pytest.mark.parametrize("spmm", SPMMS)
@pytest.mark.parametrize("model,use_pp", [m for m in MODELS
                                          if m != BNS_MODEL])
def test_bns_other_models_match_jax_p4(runs, model, use_pp, spmm):
    """GCN with use_pp and GraphSAGE without it at rate RATE, dropout 0:
    logits, losses and parameters against the JAX 4-device run with the
    same sample key, as test_bns_p4_matches_jax_p4 holds GraphSAGE with
    use_pp."""
    _match_jax(runs, ("bns", model, use_pp, spmm), model, use_pp, spmm,
               RATE)


@pytest.mark.parametrize("spmm", SPMMS)
def test_inductive_p4_matches_jax_p4(runs, spmm):
    """--inductive at rate RATE: the 4 ranks train on the train subgraph's
    artifacts (n_train its train count) as the JAX package does on its own
    artifacts of the same subgraph: logits, 3-step losses and parameters
    at the tolerances above."""
    assert runs["art_i"].n_train == runs["art_i"].n_inner.sum()
    _match_jax(runs, ("induc", spmm), *BNS_MODEL, spmm, RATE,
               ref_key="induc", art_key="art_i")


@pytest.mark.parametrize("spmm", SPMMS)
def test_precompute_exchange_is_full_rate_at_any_rate(runs, spmm):
    """The use_pp features are exchanged at the full rate, whatever the
    training rate: sampled once and frozen they would be biased."""
    for out in runs["ranks"]:
        pre = out["pre", spmm]
        np.testing.assert_array_equal(pre[RATE], pre[1.0])


def test_bns_plans_agree_across_ranks(runs):
    """chip_smoke's [bns] check (b) on the CPU: sender and receiver of every
    pair drew the same rows, and the rows past send_size are trashed."""
    import chip_smoke
    art = runs["art"]
    spec, tables = make_halo_spec(art.n_b, art.pad_inner, art.pad_boundary,
                                  RATE)
    for e in range(EPOCHS):
        plans = [out["plans"][e] for out in runs["ranks"]]
        n = chip_smoke.plan_agreement(spec, tables, plans, art.bnd,
                                      art.global_nid)
        assert n == int(tables["send_size"].sum()) > 0
    # a receiver that drew another epoch's rows is caught
    bad = [runs["ranks"][0]["plans"][0]] + [
        out["plans"][1] for out in runs["ranks"][1:]]
    with pytest.raises(AssertionError, match="drew different rows"):
        chip_smoke.plan_agreement(spec, tables, bad, art.bnd, art.global_nid)


def test_bns_unbiasedness(runs):
    """The twin of tests/test_distributed.py::test_bns_unbiasedness: the
    mean over 300 epochs of the sampled, 1/ratio-scaled aggregation is the
    full-rate aggregation (Monte Carlo tolerance 5%)."""
    for out in runs["ranks"]:
        mean, full = out["unbiased"]
        err = np.abs(mean - full)
        scale = np.abs(full).mean() + 1e-6
        assert err.mean() / scale < 0.05, f"biased? {err.mean() / scale}"


@pytest.mark.parametrize("wire", WIRES)
def test_halo_wire_codecs_match_jax(runs, wire):
    """halo_apply with a quantized wire at rate RATE: the forward is the
    JAX package's to the dequant's rounding (the same rows and payloads;
    XLA computes a block's scale amax/127 inside the fused step as a
    product with the reciprocal, one ulp off the division, so the f32
    dequant may differ by an ulp: rtol 2^-22; the bf16 wire has no scale
    and is array-equal), the VJP (the cotangent quantized with its own
    scales) to 1e-6; the wire really rounds (it differs from the native
    exchange)."""
    y_ref, dx_ref = runs["ref"]["halo_wire", wire]
    y_nat, _ = runs["ref"]["halo_bns"]
    for r, out in enumerate(runs["ranks"]):
        y, dx = out["halo_wire", wire]
        np.testing.assert_allclose(y, y_ref[r], rtol=2.0 ** -22, atol=0)
        if wire == "bf16":
            np.testing.assert_array_equal(y, y_ref[r])
        np.testing.assert_allclose(dx, dx_ref[r], rtol=1e-6, atol=1e-6)
    assert not np.array_equal(y_ref, y_nat)


@pytest.mark.parametrize("wire", WIRES)
def test_wire_quant_payloads_match_jax(wire):
    """The send buffer's codec before the all-to-all: payload and the [P]
    scales array-equal to bnsgcn_tpu/parallel/halo.py `_quant`, an
    all-zero block and a large one included."""
    import jax.numpy as jnp
    from bnsgcn_tpu.parallel.halo import _quant as j_quant
    from bnsgcn_tpu_torch.parallel.halo import wire_quant
    rng = np.random.default_rng(11)
    x = rng.normal(size=(P, 6, HALO_D)).astype(np.float32)
    x[1] = 0.0
    x[2] *= 1e4
    q, s = wire_quant(torch.from_numpy(x), wire)
    jq, js = j_quant(jnp.asarray(x), wire)
    if wire == "fp8":
        np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                      np.asarray(jq).view(np.uint8))
    else:
        np.testing.assert_array_equal(q.float().numpy(),
                                      np.asarray(jq).astype(np.float32))
    if wire == "bf16":
        assert s is None and js is None
    else:
        assert tuple(s.shape) == (P, 1, 1)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_tpu_recipe_p4_matches_jax_p4(runs):
    """The TPU recipe's finer knobs at P=4, rate RATE (hybrid, int8 dense
    tiles, int8 gathers, int8 wire, f32), GraphSAGE with use_pp, dropout 0:
    logits, 3-step losses and parameters against the JAX 4-device run of
    the same flags, within the FINER_* bounds (the dense tiles' scale
    granularity differs, see there), and the ranks end replicated."""
    from bnsgcn_tpu_torch.models.gnn import spec_from_config
    from bnsgcn_tpu_torch.trainer import params_from_jax
    art = runs["art"]
    logits_ref, losses_ref, params_ref = runs["ref"]["recipe"]
    spec = spec_from_config(_cfg(*BNS_MODEL, "hybrid", P).replace(
        n_feat=art.n_feat, n_class=art.n_class, n_train=art.n_train))
    want = {k: v.numpy() for k, v in params_from_jax(params_ref,
                                                      spec).items()}
    first = runs["ranks"][0]["recipe"][2]
    for r, out in enumerate(runs["ranks"]):
        logits, losses, params = out["recipe"]
        ref = logits_ref[r][art.inner_mask[r]]
        np.testing.assert_allclose(
            logits[art.inner_mask[r]], ref, rtol=0,
            atol=FINER_LOGIT_FRAC * np.abs(ref).max())
        np.testing.assert_allclose(losses, losses_ref, rtol=FINER_LOSS_RTOL)
        for k in params:
            np.testing.assert_allclose(params[k], want[k], err_msg=k, rtol=0,
                                       atol=FINER_PARAM_ATOL)
            np.testing.assert_array_equal(params[k], first[k])
    assert losses[-1] < losses[0]


def test_tpu_recipe_own_knobs_p4_matches_jax_p4(runs):
    """The TPU recipe's own knobs at P=4, rate RATE (RECIPE_TPU: bf16
    parameters, activations and Adam moments, K1 on bf16 rows, K2 on bf16
    slabs, the int8 wire), GraphSAGE with use_pp, dropout 0: 3-step losses
    against the JAX 4-device run of the same flags within BF16_LOSS_RTOL;
    every rank ends with rank 0's parameters, and the loss falls in
    both."""
    losses_ref = runs["ref"]["recipe_tpu"][1]
    _, losses0, first = runs["ranks"][0]["recipe_tpu"]
    for out in runs["ranks"]:
        _, losses, params = out["recipe_tpu"]
        np.testing.assert_allclose(losses, losses_ref, rtol=BF16_LOSS_RTOL)
        assert losses == losses0
        assert sorted(params) == sorted(first)
        for k in params:
            np.testing.assert_array_equal(params[k], first[k])
    assert losses0[-1] < losses0[0] and losses_ref[-1] < losses_ref[0]
    # the bf16 arithmetic really ran: the f32 finer-knob run differs
    assert losses0 != runs["ranks"][0]["recipe"][1]


def test_chip_smoke_recipe_is_reddit_sh_knobs():
    """chip_smoke.py's RECIPE_TPU is the knob list that scripts/reddit.sh's
    comment tells a user to append, and the Config fields it sets are
    RECIPE_TPU's here (with --spmm auto)."""
    import os

    import chip_smoke
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "reddit.sh")
    with open(path) as f:
        lines = f.read().splitlines()
    at = next(i for i, ln in enumerate(lines)
              if ln.startswith("#") and ln.rstrip().endswith("append"))
    assert lines[at + 1].lstrip("# ").split() == chip_smoke.RECIPE_TPU
    assert chip_smoke.recipe_fields() == dict(RECIPE_TPU, spmm="auto")


def test_sampling_rate_reduces_payload_not_shapes():
    """The twin of tests/test_distributed.py's test: rate 0.1 sends
    int(0.1 n_b) rows per pair (float64, as the JAX package) in a send
    width no wider than rate 1.0's; the halo slots keep their shape."""
    g = synthetic_graph(n_nodes=60, avg_degree=6, n_feat=4, seed=34)
    art = build_artifacts(g, partition_graph(g, 4, method="random", seed=5))
    h_low, t_low = make_halo_spec(art.n_b, art.pad_inner, art.pad_boundary,
                                  0.1)
    h_hi, t_hi = make_halo_spec(art.n_b, art.pad_inner, art.pad_boundary,
                                1.0)
    assert h_low.pad_send <= h_hi.pad_send
    assert h_low.n_halo == h_hi.n_halo
    assert wire_bytes(h_low, 8) <= wire_bytes(h_hi, 8)
    np.testing.assert_array_equal(t_low["send_size"],
                                  (0.1 * art.n_b).astype(np.int64))
    np.testing.assert_array_equal(t_hi["send_size"], art.n_b)


def test_cli_trains_p4_on_cpu_over_gloo(tmp_path, capsys):
    rc = t_main.main(["--dataset", "synthetic", "--model", "graphsage",
                      "--n-layers", "2", "--n-hidden", "16", "--use-pp",
                      "--n-partitions", "4", "--partition-method", "random",
                      "--device", "cpu", "--dist-backend", "gloo",
                      "--part-path", str(tmp_path), "--n-epochs", "3",
                      "--log-every", "1", "--ckpt-path", str(tmp_path / "ck"),
                      "--results-path", str(tmp_path / "res")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Mesh: 4 ranks | gloo | devices cpu,cpu,cpu,cpu" in out
    assert "MB/exchange/rank" in out
    assert "Process 000 | Epoch 00002 | Time(s)" in out
    assert "Test Result | Validation Accuracy" in out
    assert (tmp_path / "synthetic-4-random-vol-trans" / "part3.npz").exists()


def test_cli_trains_p4_with_bns_on_cpu_over_gloo(tmp_path, capsys):
    """--sampling-rate 0.5 at P=4 over gloo, the seed drawn (no
    --fix-seed): the ranks train on one shared sample stream, the loss
    falls, and every rank ends with rank 0's parameters."""
    rc = t_main.main(["--dataset", "sbm", "--model", "graphsage",
                      "--n-layers", "2", "--n-hidden", "16", "--use-pp",
                      "--n-partitions", "4", "--partition-method", "random",
                      "--sampling-rate", "0.5", "--device", "cpu",
                      "--dist-backend", "gloo", "--part-path", str(tmp_path),
                      "--n-epochs", "6", "--log-every", "3", "--dropout",
                      "0", "--ckpt-path", str(tmp_path / "ck"),
                      "--results-path", str(tmp_path / "res")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "at sampling rate 0.5:" in out
    assert "the precompute's full-rate exchange" in out
    assert "seed " in out and "(drawn;" in out
    losses = [float(line.rsplit("Loss ", 1)[1]) for line in out.splitlines()
              if "| Loss " in line]
    assert len(losses) == 2 and losses[1] < losses[0]
    assert "Test Result | Validation Accuracy" in out


def test_nccl_with_more_parts_than_cards_exits_2(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = t_main.main(["--dataset", "sbm", "--n-partitions", "4",
                      "--part-path", str(tmp_path)])
    err = capsys.readouterr().err
    assert rc == 2
    assert "[config] mesh does not fit" in err and "--dist-backend gloo" in err
    rc = t_main.main(["--dataset", "sbm", "--n-partitions", "4", "--device",
                      "cpu", "--part-path", str(tmp_path)])
    assert rc == 2
    assert "needs --dist-backend gloo" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())          # nothing was partitioned


def _fail_job(ctx):
    if ctx.rank == 1:
        raise ValueError("rank one gives up")
    ctx.comm.all_reduce_(torch.ones(1))


def _stall_job(ctx):
    if ctx.rank == 1:
        time.sleep(120)
    ctx.comm.all_reduce_(torch.ones(1))


@pytest.mark.parametrize("job,why", [(_fail_job, "rank one gives up"),
                                     (_stall_job, "rank 0 of 2 failed")])
def test_failing_rank_fails_the_run_and_tears_down(job, why):
    """A rank that raises, or a peer that stalls past the process-group
    timeout, ends the run with RankFailed; no rank outlives it."""
    t0 = time.perf_counter()
    with pytest.raises(RankFailed, match=why):
        launch(job, 2, [(), ()], "gloo", "cpu", log=_quiet, timeout_s=2)
    assert time.perf_counter() - t0 < 60
    assert not multiprocessing.active_children()


def _slow_lead_job(ctx):
    """Rank 0 works alone for twice the collective timeout (an evaluation)
    while its peer waits at the barrier; then both take one collective."""
    if ctx.rank == 0:
        time.sleep(4)
    ctx.comm.barrier()
    return float(ctx.comm.all_reduce_(torch.ones(1)))


def test_barrier_waits_past_the_collective_timeout():
    """The barrier's group has its own, longer timeout: work one rank does
    alone may outlast the 2 s collective timeout without failing the run."""
    assert launch(_slow_lead_job, 2, [(), ()], "gloo", "cpu", log=_quiet,
                  timeout_s=2, wait_timeout_s=60) == [2.0, 2.0]


def _digest(layout: dict) -> dict:
    return {k: (v.shape, float(np.asarray(v, np.float64).sum()))
            for k, v in layout.items()}


def _layout_hook(pr):
    """A rank hook: a digest of the rank's own hybrid layout."""
    return {"rank": pr.rank, "layout": _digest(pr.fns.layout)}


def test_rank_hook_sees_each_ranks_own_layout(tmp_path):
    """run_training at P=4 runs the hook in every rank on its prepared part:
    each rank's layout is the one build_spmm makes from that part alone.
    With eval on, rank 0 evaluates while its peers wait at the barrier; the
    ranks hand back positive exchange and reduce seconds."""
    cfg = _cfg("graphsage", True, "hybrid", P).replace(
        dataset="synthetic", part_path=str(tmp_path / "parts"), eval=True,
        log_every=1, partition_method="random", n_epochs=2,
        ckpt_path=str(tmp_path / "ck"), results_path=str(tmp_path / "res"))
    res = run_training(cfg, log=_quiet, rank_hook=_layout_hook)
    path = str(next((tmp_path / "parts").iterdir()))
    for r, rep in enumerate(res.ranks):
        assert rep["hook"]["rank"] == r
        _, layout, _ = build_spmm(cfg, load_artifacts(path, parts=[r]),
                                  "cpu", log=_quiet)
        assert rep["hook"]["layout"] == _digest(layout)
        assert all(t > 0 for t in rep["comm_times"] + rep["reduce_times"])
    assert len({str(rep["hook"]["layout"]) for rep in res.ranks}) == P
    assert 0.0 <= res.test_acc <= 1.0 and len(res.losses) == 2
