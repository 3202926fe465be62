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
    --sampling-rate 0.5 over gloo.

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
BNS_MODEL = ("graphsage", True)
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
    blk, model, opt, gen = init_training(pr, model_init)
    logits = pr.fns.forward(model, blk, 0).detach().numpy()
    losses = [float(pr.fns.train_step(model, opt, blk, e, gen))
              for e in range(EPOCHS)]
    return logits, losses, {k: v.detach().numpy().copy()
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


def _rank_job(ctx, path, h, cot, inits):
    """One rank: the halo exchange and its VJP, then every (model, spmm);
    then the BNS cases at rate RATE."""
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
    init = {k: torch.from_numpy(v)
            for k, v in inits[MODELS.index(BNS_MODEL)].items()}
    for spmm in SPMMS:
        pre = {}
        for rate in (1.0, RATE):
            pr = prepare_part(_cfg(*BNS_MODEL, spmm, P, rate), art, None,
                              ctx.device, _quiet, ctx.rank, ctx.comm)
            pre[rate] = pr.fns.precompute(pr.blk).numpy()
        out["bns", spmm] = _steps(pr, init)
        out["pre", spmm] = pre
    out["unbiased"] = _unbiased(art, ctx.comm, ctx.rank)
    return out


def _jax_reference(art_j, h, cot):
    """The JAX package on 4 virtual devices: halo_apply + VJP under
    shard_map, and per model the forward logits, EPOCHS train steps and the
    final parameters (with the initial parameters it drew)."""
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

    inits = []
    for model, use_pp, rate in ([m + (1.0,) for m in MODELS]
                                + [BNS_MODEL + (RATE,)]):
        spec = ModelSpec(model, (GRAPH["n_feat"], 8, 8, GRAPH["n_class"]),
                         norm="layer", dropout=0.0, use_pp=use_pp,
                         train_size=art_j.n_train)
        cfg = JConfig(model=model, dropout=0.0, use_pp=use_pp, norm="layer",
                      n_train=art_j.n_train, lr=0.01, weight_decay=5e-4,
                      sampling_rate=rate, spmm="ell", n_partitions=P)
        params, state = init_params(jax.random.key(9), spec)
        params_np = jax.tree.map(np.asarray, params)
        fns, _, tb, tbf = build_step_fns(cfg, spec, art_j, mesh)
        blk_np = build_block_arrays(art_j, model)
        blk_np.update(fns.extra_blk)
        for k in fns.drop_blk_keys:
            blk_np.pop(k, None)
        blk = place_blocks(blk_np, mesh)
        tb = place_replicated(tb, mesh)
        if use_pp:
            blk["feat"] = fns.precompute(blk, place_replicated(tbf, mesh))
        keys = (jax.random.key(0), jax.random.key(1))
        pp = place_replicated(params_np, mesh)
        ss = place_replicated(state, mesh)
        logits = np.asarray(fns.forward(pp, ss, jnp.uint32(0), blk, tb,
                                        *keys))
        _, _, opt = j_init_training(cfg, spec, mesh)
        losses = []
        for e in range(EPOCHS):
            pp, ss, opt, loss = fns.train_step(pp, ss, opt, jnp.uint32(e),
                                               blk, tb, *keys)
            losses.append(float(loss))
        ref[model, use_pp, rate] = (logits, losses, jax.tree.map(
            np.asarray, jax.device_get(pp)))
        if rate == 1.0:
            inits.append((params_np, spec))
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
    rng = np.random.default_rng(0)
    h = rng.normal(size=(P, art.pad_inner, HALO_D)).astype(np.float32)
    cot = rng.normal(size=(P, art.n_ext, HALO_D)).astype(np.float32)
    ref, inits = _jax_reference(j_build(j_synthetic(**GRAPH), pid), h, cot)
    init_sd = []
    for (model, use_pp), (params_np, _) in zip(MODELS, inits):
        spec = spec_from_config(_cfg(model, use_pp, "ell", P).replace(
            n_feat=art.n_feat, n_class=art.n_class, n_train=art.n_train))
        init_sd.append({k: v.numpy() for k, v in
                        params_from_jax(params_np, spec).items()})
    t0 = time.perf_counter()
    ranks = launch(_rank_job, P, [(path, h, cot, init_sd)] * P, "gloo",
                   "cpu", log=_quiet)
    launch_s = time.perf_counter() - t0
    p1 = {}
    for (model, use_pp), init in zip(MODELS, init_sd):
        for spmm in SPMMS:
            pr = prepare_run(_cfg(model, use_pp, spmm, 1), g=g, log=_quiet)
            p1[model, use_pp, spmm] = _steps(
                pr, {k: torch.from_numpy(v) for k, v in init.items()})
    return dict(art=art, ranks=ranks, ref=ref, p1=p1, init_sd=init_sd,
                launch_s=launch_s)


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


def _match_jax(runs, case, model, use_pp, spmm, rate):
    """Every rank's forward logits, 3-step losses and parameters against
    the JAX 4-device run of the same case."""
    from bnsgcn_tpu_torch.models.gnn import spec_from_config
    from bnsgcn_tpu_torch.trainer import params_from_jax
    art = runs["art"]
    logits_ref, losses_ref, params_ref = runs["ref"][model, use_pp, rate]
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
    cases = [m + (s,) for m in MODELS for s in SPMMS] + [("bns", s)
                                                         for s in SPMMS]
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
    _match_jax(runs, ("bns", spmm), *BNS_MODEL, spmm, RATE)


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
                      "--log-every", "1"])
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
                      "0"])
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
        dataset="synthetic", part_path=str(tmp_path), eval=True, log_every=1,
        partition_method="random", n_epochs=2)
    res = run_training(cfg, log=_quiet, rank_hook=_layout_hook)
    path = str(next(tmp_path.iterdir()))
    for r, rep in enumerate(res.ranks):
        assert rep["hook"]["rank"] == r
        _, layout = build_spmm(cfg, load_artifacts(path, parts=[r]), "cpu",
                               log=_quiet)
        assert rep["hook"]["layout"] == _digest(layout)
        assert all(t > 0 for t in rep["comm_times"] + rep["reduce_times"])
    assert len({str(rep["hook"]["layout"]) for rep in res.ranks}) == P
    assert 0.0 <= res.test_acc <= 1.0 and len(res.losses) == 2
