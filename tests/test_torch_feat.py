"""The feat axis (--feat T) of the port, on the CPU: held to the port's and
the JAX package's feat=1 runs (the JAX package's own feat=2 step does not
run on this jax: its psum over ('parts', 'feat') is refused).

Without ranks:
  * `layer_fin`, `shardable_layers` and the partition table equal the JAX
    package's `layer_fin`, `shardable_layers` and `param_specs_for` on a
    grid of specs: GCN, GraphSAGE with and without use_pp, GAT, a dense
    tail, widths and head counts that do and do not divide T;
  * `shard_state` and `gather_state` (over a stand-in group) are inverse;
  * the mesh-budget refusal names the axis to shrink, and --replicas or
    --feat above 1 across nodes are refused with the JAX package's words.

One module fixture spawns 8 gloo ranks once: 2 replicas x 2 parts x 2
feat shards of the JAX test's graph (tests/test_feat.py: synthetic, 80
nodes, 6 features, random partition), from the JAX package's initial
parameters (jax.random.key(9)). Its groups give every run of the test:
each replica row is a 2 x 2 feat run (R = 1), each (replica, shard) a
plain 2-part run (no axes), each feat column a 2 x 2 replica run (T = 1),
and the whole world the 2 x 2 x 2 run:
  * one step at T = 2 against the port's T = 1 step and the JAX package's
    P = 2 step: loss (1e-5), gradients at full shape (rtol 1e-4 / atol
    1e-6) and training-mode logits (rtol 1e-4 / atol 1e-5), for
    (graphsage, 1.0), (graphsage, 0.5), (gcn without use_pp, 0.5) and
    (gat, 0.5);
  * R = 2 x P = 2 x T = 2 against the port's and the JAX package's R = 2
    x P = 2 x T = 1, at the same bounds;
  * a T = 2 run's periodic checkpoint holds full arrays that the JAX
    package's checkpoint.py reads; a resume at T = 1 from it continues
    bitwise a T = 1 run restored from the same file by hand, and a resume
    at T = 2 from it within 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnsgcn_tpu import checkpoint as j_ckpt
from bnsgcn_tpu.config import Config as JConfig
from bnsgcn_tpu.data.artifacts import build_artifacts as j_build
from bnsgcn_tpu.data.graph import synthetic_graph as j_synthetic
from bnsgcn_tpu.data.partitioner import partition_graph as j_partition
from bnsgcn_tpu.models import gnn as j_gnn
from bnsgcn_tpu.parallel import feat as j_feat
from bnsgcn_tpu.parallel import replicas as j_replicas
from bnsgcn_tpu_torch import checkpoint as ckpt
from bnsgcn_tpu_torch.config import Config, ConfigError, node_ranks
from bnsgcn_tpu_torch.data.artifacts import (build_artifacts, load_artifacts,
                                             save_artifacts)
from bnsgcn_tpu_torch.data.graph import synthetic_graph
from bnsgcn_tpu_torch.models import gnn as t_gnn
from bnsgcn_tpu_torch.parallel import feat as t_feat
from bnsgcn_tpu_torch.parallel import replicas as t_replicas
from bnsgcn_tpu_torch.parallel.mesh import check_mesh_budget, launch
from bnsgcn_tpu_torch.run import init_training, prepare_part, train_loop
from bnsgcn_tpu_torch.trainer import (dropout_key, opt_state_from_jax,
                                      params_from_jax)

R, P, T = 2, 2, 2
GRAPH = dict(n_nodes=80, avg_degree=5, n_feat=6, n_class=3, seed=32)
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
RESUME_TOL = dict(rtol=1e-4, atol=1e-5)
# (model, rate, use_pp): GCN runs without use_pp, so its layer 0 shards
# the raw features' exchange
CASES = (("graphsage", 1.0, True), ("graphsage", 0.5, True),
         ("gcn", 0.5, False), ("gat", 0.5, True))
CK_EPOCHS, RESUME_EPOCHS = 4, 6


def _quiet(*a, **k):
    pass


def _cfg(model="graphsage", **kw):
    base = dict(model=model, n_layers=2, n_hidden=8, dropout=0.5,
                use_pp=True, norm="layer", lr=0.01, weight_decay=0.0,
                spmm="ell", n_partitions=P, n_epochs=1, eval=False,
                device="cpu", dist_backend="gloo", seed=0,
                sampling_rate=0.5, heads=2 if model == "gat" else 1)
    base.update(kw)
    return Config(**base)


def _j_spec(model, n_feat, n_class, n_train, use_pp=True, heads=None,
            layers=(8,), n_linear=0):
    return j_gnn.ModelSpec(model, (n_feat,) + tuple(layers) + (n_class,),
                           norm="layer", dropout=0.5, use_pp=use_pp,
                           train_size=n_train, n_linear=n_linear,
                           heads=heads or (2 if model == "gat" else 1))


def _np(t):
    return {k: v.detach().float().numpy().copy() for k, v in t.items()}


# ---------------------------------------------------------------------------
# without ranks
# ---------------------------------------------------------------------------

SPEC_GRID = [
    (model, layers, use_pp, heads, n_linear, fin)
    for model, use_pp, heads in (("gcn", False, 1), ("gcn", True, 1),
                                 ("graphsage", True, 1),
                                 ("graphsage", False, 1), ("gat", True, 2),
                                 ("gat", True, 4), ("gat", True, 3))
    for layers, n_linear in (((8,), 0), ((8, 12), 1), ((6, 9), 0))
    for fin in (6, 5)]


def _jax_dims(spec, T_):
    """The JAX package's param_specs_for as {path: sharded dim or None}."""
    specs = j_feat.param_specs_for(spec, T_)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    out = {}
    for path, ps in flat:
        dims = [d for d, a in enumerate(ps) if a == j_feat.FEAT_AXIS]
        out[j_feat.param_path(path)] = dims[0] if dims else None
    return out


@pytest.mark.parametrize("T_", [2, 3, 4])
@pytest.mark.parametrize("model,layers,use_pp,heads,n_linear,fin", SPEC_GRID)
def test_shardability_and_partition_table_are_the_jax_package_s(
        model, layers, use_pp, heads, n_linear, fin, T_):
    spec_j = _j_spec(model, fin, 3, 10, use_pp, heads, layers, n_linear)
    spec_t = t_gnn.ModelSpec(model, spec_j.layer_sizes, n_linear=n_linear,
                             norm="layer", dropout=0.5, use_pp=use_pp,
                             heads=heads, train_size=10)
    assert t_feat.shardable_layers(spec_t, T_) == \
        j_feat.shardable_layers(spec_j, T_)
    for i in range(spec_t.n_layers):
        assert t_feat.layer_fin(spec_t, i) == j_feat.layer_fin(spec_j, i)
        assert t_feat.feat_shardable(spec_t, i, T_) == \
            j_feat.feat_shardable(spec_j, i, T_)
    assert t_feat.partition_table(spec_t, T_) == _jax_dims(spec_j, T_)
    for w in (fin, 8, 12):
        for ok in (True, False):
            assert t_feat.shard_width(w, T_, ok) == \
                j_feat.shard_width(w, T_, ok)
    # the torch table names every sharded parameter of the port's model,
    # at a dimension that divides by T
    model_t = t_gnn.GNN(spec_t)
    sd = model_t.state_dict()
    for name, dim in t_feat.torch_dims(spec_t, T_).items():
        assert sd[name].shape[dim] % T_ == 0, name
    n_sharded = sum(d is not None
                    for d in t_feat.partition_table(spec_t, T_).values())
    assert len(t_feat.torch_dims(spec_t, T_)) == n_sharded


class _StandIn:
    """A feat group of T ranks in one process: all_gather of the shards
    each stand-in rank holds."""

    def __init__(self, shards):
        self.world, self.rank, self.shards = len(shards), 0, shards

    def all_gather(self, flat):
        return torch.stack(self.shards)


def test_shard_and_gather_are_inverse():
    spec = t_gnn.ModelSpec("gat", (6, 8, 8, 3), n_linear=1, norm="layer",
                           heads=2, use_pp=True, train_size=10)
    model = t_gnn.GNN(spec, seed=3)
    full = {k: v.detach() for k, v in model.state_dict().items()}
    dims = t_feat.torch_dims(spec, 2)
    assert dims
    shards = [t_feat.shard_state(full, dims, 2, f) for f in range(2)]
    flats = [torch.cat([s[k].reshape(-1) for k in full if k in dims])
             for s in shards]
    back = t_feat.gather_state(shards[0], dims, _StandIn(flats))
    for k, v in full.items():
        assert torch.equal(back[k], v), k


def test_mesh_budget_names_the_axis_to_shrink(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    check_mesh_budget(2, "nccl", "cuda", replicas=2, feat=1)
    with pytest.raises(ConfigError, match=r"mesh does not fit: --replicas 2 "
                       r"x --n-partitions 2 x --feat 2 .* needs 8 CUDA "
                       r"devices .*have 4; shrink --feat to <= 1 or "
                       r"--replicas to <= 1"):
        check_mesh_budget(2, "nccl", "cuda", replicas=2, feat=2)
    with pytest.raises(ConfigError, match="--n-partitions to <= 4"):
        check_mesh_budget(8, "nccl", "cuda", replicas=2, feat=1)
    # gloo shares one card; the CPU needs none
    check_mesh_budget(2, "gloo", "cuda", replicas=2, feat=2)
    check_mesh_budget(2, "nccl", "cpu", replicas=2, feat=2)


@pytest.mark.parametrize("flag", ["replicas", "feat"])
def test_axes_across_nodes_are_refused(flag):
    cfg = Config(n_partitions=4, n_nodes=2, parts_per_node=2,
                 **{flag: 2})
    with pytest.raises(ConfigError, match=r"--replicas/--feat > 1 are "
                       r"single-host for now .*run with --replicas 1 "
                       r"--feat 1 across hosts"):
        node_ranks(cfg)
    assert node_ranks(Config(n_partitions=4, replicas=2, feat=2)) == \
        range(16)


# ---------------------------------------------------------------------------
# the spawned group: 2 replicas x 2 parts x 2 feat shards
# ---------------------------------------------------------------------------

def _step(pr, init, key):
    """Epoch 0 from `init`: (training-mode logits, loss, the reduced
    gradients at full shape)."""
    blk, model, opt = init_training(pr, init)
    logits = pr.fns.forward(model, blk, 0, key).detach().numpy().copy()
    loss = float(pr.fns.train_step(model, opt, blk, 0, key))
    return logits, loss, _np(pr.fns.full_state(
        {n: p.grad for n, p in model.named_parameters()}))


def _restore_by_hand(pr, path, start, epochs):
    """A T = 1 run restored from the checkpoint at `path` without the loop:
    its losses for epochs start..start + epochs - 1."""
    blk, model, opt = init_training(pr)
    payload = ckpt.read_blob(path)
    model.load_state_dict(params_from_jax(payload["params"], pr.spec))
    opt_state_from_jax(payload["opt_state"], opt, model)
    return [float(pr.fns.train_step(model, opt, blk, e,
                                    dropout_key(pr.cfg.seed, e, pr.rank)))
            for e in range(start, start + epochs)]


def _rank_job(ctx, path, inits, work):
    import torch.distributed as dist
    torch.set_num_threads(1)
    ax3 = t_replicas.make_axes(ctx.comm, R, P, T)
    r, p, f = ax3.r, ax3.p, ax3.f
    gr = t_replicas.global_rank
    # the test's own groups, made on every rank in one order: each replica
    # row (a T = 2 run) and each feat column (an R = 2 run)
    rows = [[gr(rr, q, ff, P, T) for q in range(P) for ff in range(T)]
            for rr in range(R)]
    cols = [[gr(rr, q, ff, P, T) for rr in range(R) for q in range(P)]
            for ff in range(T)]
    row_g = [dist.new_group(m) for m in rows]
    col_g = [dist.new_group(m) for m in cols]
    row = t_replicas.Axes(1, P, T, 0, p, f, ctx.comm.sub(rows[r], row_g[r]),
                          ax3.parts, ax3.feat)
    col = t_replicas.Axes(R, P, 1, r, p, 0, ctx.comm.sub(cols[f], col_g[f]),
                          ax3.parts)
    art = load_artifacts(path, parts=[p])
    out = {"coords": (r, p, f)}

    def prep(cfg, ax):
        return prepare_part(cfg, art, None, ctx.device, _quiet, p, ax3.parts,
                            axes=ax)

    for model, rate, use_pp in CASES:
        init = {k: torch.from_numpy(v) for k, v in inits[model].items()}
        for tag, ax in (("t1", None), ("t2", row)):
            cfg = _cfg(model, sampling_rate=rate, use_pp=use_pp,
                       feat=T if ax is not None else 1)
            out[model, rate, tag] = _step(prep(cfg, ax), init,
                                          dropout_key(0, 0, p))
    init = {k: torch.from_numpy(v) for k, v in inits["graphsage"].items()}
    for tag, ax in (("r2t2", ax3), ("r2t1", col)):
        cfg = _cfg(replicas=R, feat=ax.T)
        out[tag] = _step(prep(cfg, ax), init, dropout_key(0, 0, p, r))
    # the checkpoint across T: a T = 2 run per replica row (R = 1), its
    # file resumed at T = 1 by each (row, shard)'s plain run and at T = 2
    ck2 = _cfg(feat=T, n_epochs=CK_EPOCHS, log_every=2, dropout=0.5,
               weight_decay=5e-4, ckpt_path=f"{work}/ck_t2_r{r}")
    res, _ = train_loop(prep(ck2, row), init, _quiet)
    file = ckpt.periodic_path(ck2, CK_EPOCHS - 1)
    ctx.comm.barrier()
    ck1 = ck2.replace(feat=1, n_epochs=RESUME_EPOCHS,
                      ckpt_path=f"{work}/ck_t1_r{r}_f{f}")
    pr1 = prep(ck1, None)
    res1, _ = train_loop(pr1, None, _quiet, resume_from=file)
    by_hand = _restore_by_hand(pr1, file, CK_EPOCHS,
                               RESUME_EPOCHS - CK_EPOCHS)
    res2, _ = train_loop(prep(ck2.replace(
        n_epochs=RESUME_EPOCHS, ckpt_path=f"{work}/ck_t2b_r{r}"), row),
        None, _quiet, resume_from=file)
    out["ckpt"] = dict(file=file, losses=res.losses,
                       resume_t1=(res1.start_epoch, res1.losses),
                       by_hand=by_hand, resume_t2=res2.losses)
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
    if spec.use_pp:
        blk["feat0_ext" if spec.model == "gat" else "feat"] = fns.precompute(
            blk, place_replicated(tbf, mesh))
    return fns, blk, place_replicated(tb, mesh)


def _j_step(art_j, mesh, model, rate, use_pp, replicas=1):
    """The JAX package's epoch-0 (logits [P, pad_inner, C], loss,
    gradients) at feat=1 from key(9)'s parameters."""
    from bnsgcn_tpu.trainer import place_replicated
    spec = _j_spec(model, art_j.n_feat, art_j.n_class, art_j.n_train,
                   use_pp)
    cfg = JConfig(model=model, dropout=0.5, use_pp=use_pp, norm="layer",
                  n_train=art_j.n_train, lr=0.01, sampling_rate=rate,
                  spmm="ell", n_partitions=P, replicas=replicas,
                  heads=spec.heads)
    params, state = j_gnn.init_params(jax.random.key(9), spec)
    fns, blk, tb = _j_setup(art_j, mesh, cfg, spec)
    pp, ss = place_replicated(params, mesh), place_replicated(state, mesh)
    keys = (jax.random.key(0), jax.random.key(1))
    logits = np.asarray(fns.forward(pp, ss, jnp.uint32(0), blk, tb, *keys))
    loss, grads = fns.loss_and_grad(pp, ss, jnp.uint32(0), blk, tb, *keys)
    return logits, float(loss), jax.tree.map(np.asarray,
                                             jax.device_get(grads))


@pytest.fixture(scope="module")
def feat2(tmp_path_factory):
    from bnsgcn_tpu.parallel.mesh import make_parts_mesh
    work = str(tmp_path_factory.mktemp("feat"))
    g_j = j_synthetic(**GRAPH)
    pid = np.asarray(j_partition(g_j, P, method="random", seed=3))
    art = build_artifacts(synthetic_graph(**GRAPH), pid)
    path = f"{work}/parts/feat"
    save_artifacts(art, path)
    art_j = j_build(g_j, pid)
    inits, specs = {}, {}
    for model, _, use_pp in CASES:
        spec = t_gnn.spec_from_config(_cfg(model, use_pp=use_pp).replace(
            n_feat=art.n_feat, n_class=art.n_class, n_train=art.n_train))
        params, _ = j_gnn.init_params(jax.random.key(9), _j_spec(
            model, art_j.n_feat, art_j.n_class, art_j.n_train, use_pp))
        inits[model] = {k: v.numpy() for k, v in params_from_jax(
            jax.tree.map(np.asarray, params), spec).items()}
        specs[model] = spec
    mesh1 = make_parts_mesh(P)
    ref = {(model, rate): _j_step(art_j, mesh1, model, rate, use_pp)
           for model, rate, use_pp in CASES}
    ref["r2"] = _j_step(art_j, j_replicas.make_mesh(P, R), "graphsage", 0.5,
                        True, replicas=R)
    n = R * P * T
    ranks = launch(_rank_job, n, [(path, inits, work)] * n, "gloo", "cpu",
                   log=_quiet)
    return dict(ranks=ranks, ref=ref, specs=specs)


def _check(got, want_logits, want_loss, want_grads, p):
    logits, loss, grads = got
    np.testing.assert_allclose(loss, want_loss, **LOSS_TOL)
    np.testing.assert_allclose(logits, want_logits[p] if want_logits.ndim == 3
                               else want_logits, **LOGIT_TOL)
    assert grads.keys() == want_grads.keys()
    for k, v in want_grads.items():
        assert grads[k].shape == v.shape, k
        np.testing.assert_allclose(grads[k], v, err_msg=k, **GRAD_TOL)


def test_rank_coords_of_the_spawned_ranks(feat2):
    assert [x["coords"] for x in feat2["ranks"]] == [
        (r, p, f) for r in range(R) for p in range(P) for f in range(T)]


@pytest.mark.parametrize("model,rate,use_pp", CASES)
def test_feat2_equals_the_port_s_feat1(feat2, model, rate, use_pp):
    for x in feat2["ranks"]:
        logits, loss, grads = x[model, rate, "t1"]
        _check(x[model, rate, "t2"], logits, loss, grads, x["coords"][1])


@pytest.mark.parametrize("model,rate,use_pp", CASES)
def test_feat2_equals_the_jax_package_s_feat1(feat2, model, rate, use_pp):
    logits_j, loss_j, grads_j = feat2["ref"][model, rate]
    want = {k: v.numpy() for k, v in params_from_jax(
        grads_j, feat2["specs"][model]).items()}
    for x in feat2["ranks"]:
        for tag in ("t1", "t2"):
            _check(x[model, rate, tag], logits_j, loss_j, want,
                   x["coords"][1])


def test_replicas2_feat2_equals_replicas2_feat1(feat2):
    """R = 2 x P = 2 x T = 2 against the port's and the JAX package's
    R = 2 x P = 2 x T = 1 (the JAX forward reports replica 0's logits, so
    replica 1's are held to the port's T = 1 alone)."""
    logits_j, loss_j, grads_j = feat2["ref"]["r2"]
    want = {k: v.numpy() for k, v in params_from_jax(
        grads_j, feat2["specs"]["graphsage"]).items()}
    for x in feat2["ranks"]:
        r, p, _ = x["coords"]
        logits, loss, grads = x["r2t1"]
        _check(x["r2t2"], logits, loss, grads, p)
        _check(x["r2t1"], logits_j if r == 0 else logits, loss_j, want, p)


def test_checkpoint_is_full_and_resumes_across_feat(feat2):
    ranks = feat2["ranks"]
    spec = feat2["specs"]["graphsage"]
    full = t_gnn.GNN(spec).state_dict()
    for r in range(R):
        c = ranks[r * P * T]["ckpt"]
        assert os.path.exists(c["file"])
        blob = j_ckpt.read_blob(c["file"])
        got = params_from_jax(blob["params"], spec)
        mu = params_from_jax(blob["opt_state"]["1"]["0"]["mu"], spec)
        for k, v in full.items():
            assert got[k].shape == v.shape, k
            assert mu[k].shape == v.shape, k
        assert int(blob["epoch"]) == CK_EPOCHS - 1
    for x in ranks:
        c = x["ckpt"]
        start, losses = c["resume_t1"]
        assert start == CK_EPOCHS
        assert losses == c["by_hand"]                   # bitwise
        np.testing.assert_allclose(c["resume_t2"], losses, **RESUME_TOL)
