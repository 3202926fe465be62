"""The replica axis (--replicas R) of the port against the JAX package's,
on the CPU.

Without ranks:
  * `pair_key(..., replica=r)` is bitwise the JAX package's on a grid, and
    `replica=None` the unfolded key; `dropout_key` with the replica and part
    folds is bitwise the JAX step's key (bnsgcn_tpu/trainer.py:817-850);
  * R = T = 1 builds no group (`make_axes` returns None without calling
    torch.distributed.new_group), and a run's ranks map onto (replica,
    part, feat) replica-major with feat innermost;
  * `mesh_desc` and `dedup_replica0` are the JAX package's.

One module fixture spawns 8 gloo ranks once: 2 replicas x 4 parts of the
JAX test's graph (tests/test_replicas.py: synthetic, 80 nodes, random
partition), from the JAX package's initial parameters (jax.random.key(9)):
  * one step's loss and gradients at R = 2 against the JAX package's
    `fns.loss_and_grad` on its make_mesh(4, 2) (loss 1e-5, gradients rtol
    1e-4 / atol 1e-6) and against the sum of its two replica rows trained
    alone (each row's keys folded, over n_train x 2: the mean of the two
    folded single-replica runs), for (graphsage, 1.0), (graphsage, 0.5) and
    (gat, 0.5), the law of tests/test_replicas.py:144; at rate 0.5 the two
    rows' losses differ (independent draws);
  * each replica row alone at R = 1 (no axes: the plain P = 4 path) against
    the JAX package's P = 4 loss_and_grad;
  * --norm batch at R = 2: 3 steps, the running statistics bitwise equal on
    all 8 ranks and within 1e-5 of the JAX R = 2 run's, losses 1e-4;
  * --halo-exchange ragged --halo-refresh 2 at R = 2: 3 steps against the
    JAX R = 2 run (losses rtol 1e-4, parameters rtol 5e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnsgcn_tpu.config import Config as JConfig
from bnsgcn_tpu.data.artifacts import build_artifacts as j_build
from bnsgcn_tpu.data.graph import synthetic_graph as j_synthetic
from bnsgcn_tpu.data.partitioner import partition_graph as j_partition
from bnsgcn_tpu.models import gnn as j_gnn
from bnsgcn_tpu.parallel import replicas as j_replicas
from bnsgcn_tpu.parallel.sampling import pair_key as j_pair_key
from bnsgcn_tpu_torch.config import Config
from bnsgcn_tpu_torch.data.artifacts import build_artifacts, load_artifacts
from bnsgcn_tpu_torch.data.artifacts import save_artifacts
from bnsgcn_tpu_torch.data.graph import synthetic_graph
from bnsgcn_tpu_torch.models import gnn as t_gnn
from bnsgcn_tpu_torch.parallel import replicas as t_replicas
from bnsgcn_tpu_torch.parallel.mesh import Comm, launch
from bnsgcn_tpu_torch.parallel.sampling import pair_key
from bnsgcn_tpu_torch.run import init_training, prepare_part
from bnsgcn_tpu_torch.trainer import dropout_key, params_from_jax
from bnsgcn_tpu_torch.utils import prng

R, P = 2, 4
EPOCHS = 3
GRAPH = dict(n_nodes=80, avg_degree=5, n_feat=5, n_class=3, seed=32)
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
TRAIN_LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=5e-4, atol=1e-5)
BN_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_CASES = (("graphsage", 1.0), ("graphsage", 0.5), ("gat", 0.5))
# 3-step training cases at R = 2: (name, Config fields)
TRAIN_CASES = (("bn", dict(norm="batch")),
               ("ragged_hr2", dict(halo_exchange="ragged", halo_refresh=2)))


def _quiet(*a, **k):
    pass


def _cfg(model="graphsage", **kw):
    base = dict(model=model, n_layers=2, n_hidden=8, dropout=0.5,
                use_pp=True, norm="layer", lr=0.01, weight_decay=0.0,
                spmm="ell", n_partitions=P, n_epochs=EPOCHS, eval=False,
                device="cpu", dist_backend="gloo", seed=0,
                sampling_rate=0.5, heads=2 if model == "gat" else 1)
    base.update(kw)
    return Config(**base)


def _j_spec(model, art_j, norm="layer"):
    return j_gnn.ModelSpec(model, (art_j.n_feat, 8, art_j.n_class),
                           norm=norm, dropout=0.5, use_pp=True,
                           train_size=art_j.n_train,
                           heads=2 if model == "gat" else 1)


def _np(t):
    return {k: v.detach().float().numpy().copy() for k, v in t.items()}


# ---------------------------------------------------------------------------
# without ranks
# ---------------------------------------------------------------------------

def test_pair_key_replica_fold_is_the_jax_key():
    base_t, base_j = prng.key(7), jax.random.key(7)
    for r in (None, 0, 1, 3):
        for e in (0, 5):
            for p in range(3):
                for j in range(3):
                    want = np.asarray(jax.random.key_data(
                        j_pair_key(base_j, e, p, j, replica=r)))
                    got = pair_key(base_t, e, p, j, replica=r).numpy()
                    assert np.array_equal(got.astype(np.uint32), want)
    # replica=None folds nothing: the unfolded key, and replica r is the key
    # of a run from fold_in(base, r)
    assert torch.equal(pair_key(base_t, 2, 1, 0, replica=None),
                       pair_key(base_t, 2, 1, 0))
    assert torch.equal(pair_key(base_t, 2, 1, 0, replica=1),
                       pair_key(prng.fold_in(base_t, 1), 2, 1, 0))


def test_dropout_key_folds_replica_then_epoch_then_part():
    for seed in (0, 3):
        for r in (None, 0, 1):
            for e in (0, 4):
                for p in (0, 2):
                    k = jax.random.key(seed + 1)
                    if r is not None:
                        k = jax.random.fold_in(k, r)
                    want = np.asarray(jax.random.key_data(jax.random.fold_in(
                        jax.random.fold_in(k, e), p)))
                    got = dropout_key(seed, e, p, r).numpy()
                    assert np.array_equal(got.astype(np.uint32), want)


def test_replicas1_builds_no_group(monkeypatch):
    import torch.distributed as dist

    def refuse(*a, **k):
        raise AssertionError("R = T = 1 built a group")

    monkeypatch.setattr(dist, "new_group", refuse)
    comm = Comm(0, P, torch.device("cpu"))
    assert t_replicas.make_axes(comm, 1, P, 1) is None
    assert t_replicas.n_replicas(None) == 1


def test_rank_map_is_replica_major_feat_inner():
    seen = set()
    for g in range(2 * 3 * 2):
        r, p, f = t_replicas.rank_coords(g, 3, 2)
        assert t_replicas.global_rank(r, p, f, 3, 2) == g
        seen.add((r, p, f))
    assert len(seen) == 12
    assert t_replicas.rank_coords(7, 3, 2) == (1, 0, 1)


def test_mesh_desc_and_dedup_are_the_jax_package_s():
    for (Rr, Pp, Tt), want in (((1, 4, 1), "4 parts"),
                               ((2, 4, 1), "2x4 replicas x parts"),
                               ((1, 4, 2), "4x2 parts x feat"),
                               ((2, 4, 2), "2x4x2 replicas x parts x feat")):
        assert t_replicas.mesh_desc(Rr, Pp, Tt) == want
    assert j_replicas.mesh_desc(j_replicas.make_mesh(4, 2)) == \
        t_replicas.mesh_desc(2, 4, 1)
    assert j_replicas.mesh_desc(j_replicas.make_mesh(2, 2, 2)) == \
        t_replicas.mesh_desc(2, 2, 2)
    reports = list(range(2 * 2 * 2))
    out = np.arange(8)
    want = np.asarray(j_replicas.dedup_replica0(out, j_replicas.make_mesh(
        2, 2, 2), 2))
    assert t_replicas.dedup_replica0(reports, 2, 2, 2) == list(want)


# ---------------------------------------------------------------------------
# the spawned group: 2 replicas x 4 parts
# ---------------------------------------------------------------------------

def _grad_step(pr, init, key):
    """One step at epoch 0: (loss, the reduced gradients by name)."""
    blk, model, opt = init_training(pr, init)
    loss = float(pr.fns.train_step(model, opt, blk, 0, key))
    return loss, _np(pr.fns.full_state(
        {n: p.grad for n, p in model.named_parameters()}))


def _train(pr, init, replica):
    """EPOCHS steps, dispatched as run.train_loop dispatches them:
    (losses, state_dict)."""
    blk, model, opt = init_training(pr, init)
    cache, losses = None, []
    for e in range(EPOCHS):
        key = dropout_key(pr.cfg.seed, e, pr.rank, replica)
        if pr.fns.train_step_full is None:
            loss = pr.fns.train_step(model, opt, blk, e, key)
        elif cache is None:
            loss, cache = pr.fns.train_step_full(model, opt, blk, e, key)
        else:
            loss, cache = pr.fns.train_step_cached(model, opt, blk, e, key,
                                                   cache)
        losses.append(float(loss))
    return losses, _np(model.state_dict())


def _rank_job(ctx, path, inits):
    torch.set_num_threads(1)
    axes = t_replicas.make_axes(ctx.comm, R, P, 1)
    r, p = axes.r, axes.p
    # replica r's row alone: its keys folded, its reduce over its own parts
    row = t_replicas.Axes(R, P, 1, r, p, 0, axes.parts, axes.parts)
    art = load_artifacts(path, parts=[p])
    out = {"coords": (r, p, axes.f)}
    for model, rate in GRAD_CASES:
        init = {k: torch.from_numpy(v) for k, v in inits[model].items()}
        for tag, ax in (("r2", axes), ("row", row), ("r1", None)):
            cfg = _cfg(model, sampling_rate=rate,
                       replicas=R if ax is not None else 1)
            pr = prepare_part(cfg, art, None, ctx.device, _quiet, p,
                              axes.parts, axes=ax)
            out[model, rate, tag] = _grad_step(
                pr, init, dropout_key(0, 0, p, ax.replica if ax else None))
    for name, flags in TRAIN_CASES:
        init = {k: torch.from_numpy(v) for k, v in
                inits[flags.get("norm", "layer")].items()}
        cfg = _cfg(replicas=R, weight_decay=5e-4, **flags)
        pr = prepare_part(cfg, art, None, ctx.device, _quiet, p, axes.parts,
                          axes=axes)
        out[name] = _train(pr, init, axes.replica)
    return out


def _j_setup(art_j, mesh, cfg, spec):
    from bnsgcn_tpu.trainer import (build_block_arrays, build_step_fns,
                                    place_blocks, place_replicated)
    fns, _, tb, tbf = build_step_fns(cfg, spec, art_j, mesh)
    blk_np = build_block_arrays(art_j, spec.model)
    blk_np.update(fns.extra_blk)
    for k in fns.drop_blk_keys:
        blk_np.pop(k, None)
    blk = place_blocks(blk_np, mesh)
    blk["feat0_ext" if spec.model == "gat" else "feat"] = fns.precompute(
        blk, place_replicated(tbf, mesh))
    return fns, blk, place_replicated(tb, mesh)


def _j_grads(art_j, mesh, model, rate, replicas):
    from bnsgcn_tpu.trainer import place_replicated
    spec = _j_spec(model, art_j)
    cfg = JConfig(model=model, dropout=0.5, use_pp=True, norm="layer",
                  n_train=art_j.n_train, lr=0.01, sampling_rate=rate,
                  spmm="ell", n_partitions=P, replicas=replicas,
                  heads=spec.heads)
    params, state = j_gnn.init_params(jax.random.key(9), spec)
    fns, blk, tb = _j_setup(art_j, mesh, cfg, spec)
    loss, grads = fns.loss_and_grad(
        place_replicated(params, mesh), place_replicated(state, mesh),
        jnp.uint32(0), blk, tb, jax.random.key(0), jax.random.key(1))
    return float(loss), jax.tree.map(np.asarray, jax.device_get(grads))


def _j_train(art_j, mesh, flags):
    """EPOCHS steps of the JAX package at R = 2, the full-refresh step on
    an empty cache: (losses, parameters, state)."""
    from bnsgcn_tpu.trainer import (init_training as j_init_training,
                                    place_replicated)
    spec = _j_spec("graphsage", art_j, flags.get("norm", "layer"))
    cfg = JConfig(**{**dict(model="graphsage", dropout=0.5, use_pp=True,
                            norm="layer", n_train=art_j.n_train, lr=0.01,
                            weight_decay=5e-4, sampling_rate=0.5,
                            spmm="ell", n_partitions=P, replicas=R),
                     **flags})
    params, state = j_gnn.init_params(jax.random.key(9), spec)
    fns, blk, tb = _j_setup(art_j, mesh, cfg, spec)
    pp, ss = place_replicated(params, mesh), place_replicated(state, mesh)
    _, _, opt = j_init_training(cfg, spec, mesh)
    tb_r = (place_replicated(fns.tables_refresh, mesh)
            if fns.train_step_full is not None else None)
    keys = (jax.random.key(0), jax.random.key(1))
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
    return (losses, jax.tree.map(np.asarray, jax.device_get(pp)),
            jax.tree.map(np.asarray, jax.device_get(ss)))


@pytest.fixture(scope="module")
def rep2(tmp_path_factory):
    from bnsgcn_tpu.parallel.mesh import make_parts_mesh
    work = str(tmp_path_factory.mktemp("replicas"))
    g_j = j_synthetic(**GRAPH)
    pid = np.asarray(j_partition(g_j, P, method="random", seed=3))
    art = build_artifacts(synthetic_graph(**GRAPH), pid)
    path = f"{work}/parts/rep"
    save_artifacts(art, path)
    art_j = j_build(g_j, pid)
    inits, specs = {}, {}
    for key, model, norm in (("graphsage", "graphsage", "layer"),
                             ("gat", "gat", "layer"),
                             ("layer", "graphsage", "layer"),
                             ("batch", "graphsage", "batch")):
        spec = t_gnn.spec_from_config(_cfg(model, norm=norm).replace(
            n_feat=art.n_feat, n_class=art.n_class, n_train=art.n_train))
        params, _ = j_gnn.init_params(jax.random.key(9),
                                      _j_spec(model, art_j, norm))
        inits[key] = {k: v.numpy() for k, v in params_from_jax(
            jax.tree.map(np.asarray, params), spec).items()}
        specs[key] = spec
    mesh2, mesh1 = j_replicas.make_mesh(P, R), make_parts_mesh(P)
    ref = {}
    for model, rate in GRAD_CASES:
        ref[model, rate, "r2"] = _j_grads(art_j, mesh2, model, rate, R)
        ref[model, rate, "r1"] = _j_grads(art_j, mesh1, model, rate, 1)
    for name, flags in TRAIN_CASES:
        ref[name] = _j_train(art_j, mesh2, flags)
    ranks = launch(_rank_job, R * P, [(path, inits)] * (R * P), "gloo",
                   "cpu", log=_quiet)
    return dict(ranks=ranks, ref=ref, specs=specs)


def _as_torch(grads_j, spec):
    return {k: v.numpy() for k, v in params_from_jax(grads_j, spec).items()}


def test_rank_coords_of_the_spawned_ranks(rep2):
    assert [x["coords"] for x in rep2["ranks"]] == [
        (r, p, 0) for r in range(R) for p in range(P)]


@pytest.mark.parametrize("model,rate", GRAD_CASES)
def test_replicas2_loss_and_grads_are_the_jax_step(rep2, model, rate):
    loss_j, grads_j = rep2["ref"][model, rate, "r2"]
    want = _as_torch(grads_j, rep2["specs"][model])
    for x in rep2["ranks"]:
        loss, grads = x[model, rate, "r2"]
        np.testing.assert_allclose(loss, loss_j, **LOSS_TOL)
        assert grads.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(grads[k], v, err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("model,rate", GRAD_CASES)
def test_replicas2_is_the_mean_of_the_folded_rows(rep2, model, rate):
    """The gradient of R = 2 is the sum of its two rows trained alone
    (each over n_train x 2): the mean of the two folded single runs."""
    ranks = rep2["ranks"]
    for p in range(P):
        rows = [ranks[r * P + p][model, rate, "row"] for r in range(R)]
        loss2, grads2 = ranks[p][model, rate, "r2"]
        np.testing.assert_allclose(loss2, rows[0][0] + rows[1][0],
                                   **LOSS_TOL)
        for k in grads2:
            np.testing.assert_allclose(grads2[k],
                                       rows[0][1][k] + rows[1][1][k],
                                       err_msg=k, **GRAD_TOL)
        if rate < 1.0:
            # the replicas drew different samples
            assert abs(rows[0][0] - rows[1][0]) > 1e-9


@pytest.mark.parametrize("model,rate", GRAD_CASES)
def test_each_row_at_replicas1_is_the_jax_p4_step(rep2, model, rate):
    loss_j, grads_j = rep2["ref"][model, rate, "r1"]
    want = _as_torch(grads_j, rep2["specs"][model])
    for x in rep2["ranks"]:
        loss, grads = x[model, rate, "r1"]
        np.testing.assert_allclose(loss, loss_j, **LOSS_TOL)
        for k, v in want.items():
            np.testing.assert_allclose(grads[k], v, err_msg=k, **GRAD_TOL)


def test_sync_batch_norm_under_replicas2(rep2):
    losses_j, params_j, state_j = rep2["ref"]["bn"]
    want = params_from_jax(params_j, rep2["specs"]["batch"], state_j)
    first = rep2["ranks"][0]["bn"][1]
    for x in rep2["ranks"]:
        losses, sd = x["bn"]
        np.testing.assert_allclose(losses, losses_j, **TRAIN_LOSS_TOL)
        for k in ("norm_0.mean", "norm_0.var"):
            # one ordered sum over the world: bitwise on every rank
            np.testing.assert_array_equal(sd[k], first[k])
            np.testing.assert_allclose(sd[k], want[k].numpy(), err_msg=k,
                                       **BN_TOL)


def test_ragged_halo_refresh_under_replicas2(rep2):
    losses_j, params_j, _ = rep2["ref"]["ragged_hr2"]
    want = params_from_jax(params_j, rep2["specs"]["layer"])
    for x in rep2["ranks"]:
        losses, sd = x["ragged_hr2"]
        np.testing.assert_allclose(losses, losses_j, **TRAIN_LOSS_TOL)
        for k, v in want.items():
            np.testing.assert_allclose(sd[k], v.numpy(), err_msg=k,
                                       **PARAM_TOL)
