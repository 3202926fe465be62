"""The port's online serving (bnsgcn_tpu_torch/serve.py) against the JAX
package's (bnsgcn_tpu/serve.py), on the CPU.

Held to the JAX package, on the 300-node sbm graph of tests/test_serve.py
with the JAX `init_params(key(1))` carried across (GCN, GraphSAGE with
use_pp, GAT with 2 heads; 2 layers x 8):
  * DynamicGraph's neighbours, degrees, in_closure, forward_closure and
    mutation state after deltas, and build_arrays at several target sets
    before and after deltas: equal, array-equal;
  * the tier-A table and tier-B scores against `bnsgcn_tpu.serve
    .build_core`'s within 1e-5, and again after add_edges / update_feat
    and a flush, with the same dirty sets;
  * a table written by either package loads in the other, array-equal;
  * --dump-embeddings through both packages' command lines on one
    checkpoint (a JAX-written one, resumed at its last epoch): the port at
    P=1 (host branch) and at P=2 under --eval-device mesh, transductive
    (the ranks' embed_forward, rank 0's gather), against the JAX host
    branch, within 1e-5;
  * the compaction snapshot's payload, array-equal.

The laws of tests/test_serve.py, on the port itself, bitwise where those
are bitwise: (a) tier A is the full eval's logits; (b) tier B equals a
recompute of the mutated graph (1e-5); (c) a request scored alone is
bitwise the same request in a full bucket (and through the batcher and
predict_many); (d) a delta marks exactly the <= L-hop forward closure and
its refresh leaves every clean row bitwise untouched; (e) the subprocess
server: a TCP round trip, and SIGTERM -> drain -> exit 75 with the delta
log flushed, replayed by a relaunch; (f) checkpoint selection, the table's
integrity, the cold start and --dump-embeddings through run_training.
Then the port's own: a missing promotion handshake (exit 2 by name, the
ops answer "not ported yet"), and the fixed-order sum and row tiles its
laws rest on on a card (the card's bitwise twins are in
tests/test_torch_cuda.py).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from functools import lru_cache
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from bnsgcn_tpu import checkpoint as j_ckpt
from bnsgcn_tpu import serve as j_serve
from bnsgcn_tpu import trainer as j_trainer
from bnsgcn_tpu.config import Config as JConfig
from bnsgcn_tpu.config import parse_config as j_parse_config
from bnsgcn_tpu.data.datasets import load_data as j_load_data
from bnsgcn_tpu.data.graph import sbm_graph as j_sbm_graph
from bnsgcn_tpu.models.gnn import init_params as j_init_params
from bnsgcn_tpu.models.gnn import spec_from_config as j_spec_from_config
from bnsgcn_tpu.run import run_training as j_run_training
from bnsgcn_tpu_torch import checkpoint as ckpt
from bnsgcn_tpu_torch import main as t_main
from bnsgcn_tpu_torch import serve
from bnsgcn_tpu_torch.config import Config, ConfigError
from bnsgcn_tpu_torch.data.graph import Graph, sbm_graph
from bnsgcn_tpu_torch.evaluate import (full_graph_embeddings,
                                       full_graph_logits)
from bnsgcn_tpu_torch.models.gnn import GNN, GraphEnv, by_rows
from bnsgcn_tpu_torch.models.gnn import spec_from_config
from bnsgcn_tpu_torch.ops.spmm import FixedOrderSum, agg_sum
from bnsgcn_tpu_torch.resilience import corrupt_file
from bnsgcn_tpu_torch.trainer import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = [("gcn", False, 1), ("graphsage", True, 1), ("gat", False, 2)]
MODEL_IDS = [m[0] for m in MODELS]
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")
QUIET = dict(log=lambda *a, **k: None)


@lru_cache(maxsize=None)
def _setup(model: str, use_pp: bool, heads: int):
    """Both packages' graph, config and parameters (the JAX draw of
    key(1), carried into the port's GNN)."""
    kw = dict(n_nodes=300, n_class=4, n_feat=8, seed=0)
    jg, g = j_sbm_graph(**kw), sbm_graph(**kw)
    common = dict(dataset="sbm", model=model, n_layers=2, n_hidden=8,
                  heads=heads, use_pp=use_pp, n_feat=g.n_feat,
                  n_class=g.n_class, n_train=g.n_train, serve_max_batch=16)
    jcfg, cfg = JConfig(**common), Config(**common)
    params, state = j_init_params(jax.random.key(1), j_spec_from_config(jcfg))
    spec = spec_from_config(cfg)
    net = GNN(spec)
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                        spec))
    return SimpleNamespace(jg=jg, jcfg=jcfg, params=params, state=state,
                           g=g, cfg=cfg, spec=spec, net=net.eval())


def _core(model, use_pp, heads):
    s = _setup(model, use_pp, heads)
    return s, serve.build_core(s.cfg, s.g, s.net, **QUIET)


def _jcore(s):
    return j_serve.build_core(s.jcfg, s.jg, s.params, s.state, **QUIET)


def _appended(g: Graph, edges) -> Graph:
    src = np.concatenate([g.src, [u for u, _ in edges]]).astype(g.src.dtype)
    dst = np.concatenate([g.dst, [v for _, v in edges]]).astype(g.dst.dtype)
    return Graph(g.n_nodes, src, dst, g.feat, g.label, g.train_mask,
                 g.val_mask, g.test_mask, g.multilabel)


def _fwd_closure(src, dst, seeds, hops):
    seen = set(int(s) for s in seeds)
    frontier = set(seen)
    for _ in range(hops):
        nxt = {int(d) for s, d in zip(src, dst) if int(s) in frontier} - seen
        seen |= nxt
        frontier = nxt
    return seen


def _arrays_equal(a, b):
    return len(a) == len(b) and all(
        np.asarray(x).dtype == np.asarray(y).dtype
        and np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


# ----------------------------------------------------------------------------
# held to the JAX package
# ----------------------------------------------------------------------------

def test_dynamic_graph_matches_jax_after_deltas():
    kw = dict(n_nodes=100, n_class=4, n_feat=4, seed=2)
    jdg, dg = j_serve.DynamicGraph(j_sbm_graph(**kw)), serve.DynamicGraph(
        sbm_graph(**kw))
    deltas = [[(9, 5), (9, 5), (3, 77)], [(77, 9), (0, 99)]]
    for step, edges in enumerate([[]] + deltas):
        assert jdg.add_edges(edges) == dg.add_edges(edges)
        if step == 2:
            vec = np.linspace(0, 1, 4).astype(np.float32)
            assert jdg.set_feat(41, vec) == dg.set_feat(41, vec)
        for v in range(100):
            assert jdg.in_nbrs(v) == dg.in_nbrs(v)
            assert jdg.out_nbrs(v) == dg.out_nbrs(v)
        assert np.array_equal(jdg.in_deg, dg.in_deg)
        assert np.array_equal(jdg.out_deg, dg.out_deg)
        assert np.array_equal(jdg.feat, dg.feat)
        for seeds, hops in (([7], 1), ([7], 2), ([5, 9, 77], 2), ([0], 3),
                            ([], 2)):
            assert jdg.in_closure(seeds, hops) == dg.in_closure(seeds, hops)
            assert (jdg.forward_closure(seeds, hops)
                    == dg.forward_closure(seeds, hops))
    js, ps = jdg.mutation_state(), dg.mutation_state()
    assert sorted(js) == sorted(ps)
    assert all(np.array_equal(js[k], ps[k]) for k in js)
    fresh = serve.DynamicGraph(sbm_graph(**kw))
    fresh.restore_mutations(ps)
    assert all(fresh.in_nbrs(v) == dg.in_nbrs(v) for v in range(100))


@pytest.mark.parametrize("model,use_pp,heads", MODELS, ids=MODEL_IDS)
def test_build_arrays_array_equal_to_jax(model, use_pp, heads):
    s = _setup(model, use_pp, heads)
    jdg, dg = j_serve.DynamicGraph(s.jg), serve.DynamicGraph(s.g)
    jsc = j_serve.SubgraphScorer(j_spec_from_config(s.jcfg))
    sc = serve.SubgraphScorer(s.spec)
    targets = ([42], [299, 0, 150] + list(range(16)))
    for edges in ([], [(7, 5), (11, 5), (7, 5), (42, 299)]):
        jdg.add_edges(edges)
        dg.add_edges(edges)
        for t in targets:
            assert _arrays_equal(jsc.build_arrays(jdg, t),
                                 sc.build_arrays(dg, t)), (edges, t)


@pytest.mark.parametrize("model,use_pp,heads", MODELS, ids=MODEL_IDS)
def test_core_matches_jax_before_and_after_deltas(model, use_pp, heads):
    s, core = _core(model, use_pp, heads)
    jcore = _jcore(s)
    try:
        np.testing.assert_allclose(core.logits, jcore.logits, **TOL)
        np.testing.assert_allclose(core.hidden, jcore.hidden, **TOL)
        for v in (42, 299):
            np.testing.assert_allclose(core.predict(v, tier="B")["scores"],
                                       jcore.predict(v, tier="B")["scores"],
                                       **TOL)
        vec = np.full(s.g.n_feat, 0.25, np.float32)
        for c in (core, jcore):
            c.add_edges([(7, 5), (11, 5), (7, 5)])
            c.update_feat(9, vec)
        assert core.dirty == jcore.dirty
        for v in dict.fromkeys(sorted(core.dirty)[:2] + [5, 9]):
            r, jr = core.predict(v), jcore.predict(v)
            assert r["tier"] == jr["tier"] == "B"
            np.testing.assert_allclose(r["scores"], jr["scores"], **TOL)
        assert core.flush() == jcore.flush()
        np.testing.assert_allclose(core.logits, jcore.logits, **TOL)
        np.testing.assert_allclose(core.hidden, jcore.hidden, **TOL)
        assert core.deltas == jcore.deltas
    finally:
        core.close()
        jcore.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_table_written_by_either_package_loads_in_the_other(writer,
                                                              tmp_path):
    rng = np.random.default_rng(5)
    hidden = rng.standard_normal((300, 8)).astype(np.float32)
    logits = rng.standard_normal((300, 4)).astype(np.float32)
    meta = {"graph_name": "g", "model": "gcn", "n_nodes": 300, "epoch": 3,
            "best_acc": 0.25}
    path = str(tmp_path / "emb.tbl")
    save, load = ((j_serve.save_table, serve.load_table) if writer == "jax"
                  else (serve.save_table, j_serve.load_table))
    save(path, hidden, logits, meta=meta)
    h, lg, m = load(path)
    assert np.array_equal(h, hidden) and np.array_equal(lg, logits)
    assert m == meta


def _jax_checkpoint(d, name):
    """A JAX-written run at epoch 3 (periodic + final, best_acc 0.5) and
    the flags that resume it for no further epoch (the standalone export
    of bnsgcn_tpu/run.py's comment)."""
    jc = JConfig(dataset="sbm", model="graphsage", n_layers=2, n_hidden=8,
                 use_pp=True, seed=3, ckpt_path=str(d / "ck"),
                 graph_name=name)
    g, _, _ = j_load_data(jc)
    jc = jc.replace(n_feat=g.n_feat, n_class=g.n_class, n_train=g.n_train)
    params, state = j_init_params(jax.random.key(3), j_spec_from_config(jc))
    opt = j_trainer.make_tx(jc).init(params)
    j_ckpt.save_checkpoint(j_ckpt.periodic_path(jc, 3), params=params,
                           opt_state=opt, bn_state=state, epoch=3,
                           best_acc=0.5, seed=3)
    j_ckpt.save_checkpoint(j_ckpt.final_path(jc), params=params,
                           bn_state=state, epoch=3, best_acc=0.5, seed=3)
    return ["--dataset", "sbm", "--model", "graphsage", "--n-layers", "2",
            "--n-hidden", "8", "--use-pp", "--fix-seed", "--seed", "3",
            "--graph-name", name, "--ckpt-path", str(d / "ck"),
            "--results-path", str(d / "res"), "--resume", "--n-epochs", "4",
            "--log-every", "2", "--no-comm-trace"]


def test_dump_embeddings_through_both_command_lines(tmp_path, capsys):
    """The JAX host branch, the port's host branch (P=1) and its mesh
    branch (P=2, transductive: embed_forward on each rank, rank 0's
    gather) on one checkpoint: the same table within 1e-5, the same meta."""
    base = _jax_checkpoint(tmp_path, "sbmx")
    out = {k: str(tmp_path / f"{k}.tbl") for k in ("jax", "p1", "p2")}
    j_run_training(j_parse_config(base + [
        "--part-path", str(tmp_path / "pj"), "--n-partitions", "1",
        "--dump-embeddings", out["jax"]]), verbose=False)
    assert t_main.main(base + [
        "--part-path", str(tmp_path / "p1"), "--n-partitions", "1",
        "--device", "cpu", "--dump-embeddings", out["p1"]]) == 0
    assert t_main.main(base + [
        "--part-path", str(tmp_path / "p2"), "--n-partitions", "2",
        "--partition-method", "random", "--device", "cpu",
        "--dist-backend", "gloo", "--eval-device", "mesh",
        "--dump-embeddings", out["p2"]]) == 0
    text = capsys.readouterr().out
    assert text.count("[serve] embedding table [2000 x 8] + logits "
                      "[8 classes] -> ") == 2
    jh, jl, jm = j_serve.load_table(out["jax"])
    for k in ("p1", "p2"):
        h, lg, m = serve.load_table(out[k])
        np.testing.assert_allclose(h, jh, **TOL)
        np.testing.assert_allclose(lg, jl, **TOL)
        assert m == jm == {"graph_name": "sbmx", "model": "graphsage",
                           "n_nodes": 2000, "epoch": 3, "best_acc": 0.5}


def test_compaction_snapshot_matches_jax(tmp_path):
    s, core = _core("gcn", False, 1)
    jcore = _jcore(s)
    try:
        for c, d in ((core, tmp_path / "p"), (jcore, tmp_path / "j")):
            c.add_edges([(3, 17), (17, 3)])
            c.update_feat(4, np.ones(s.g.n_feat, np.float32))
            c.compact(str(d))
            c.add_edges([(1, 2)])
            c.flush_delta_log(str(d))
        jp = j_ckpt.read_blob(str(tmp_path / "j" / j_serve.SNAPSHOT))
        pp = ckpt.read_blob(str(tmp_path / "p" / serve.SNAPSHOT))
        assert sorted(jp) == sorted(pp)
        for k in jp:
            if k in ("hidden", "logits"):
                np.testing.assert_allclose(pp[k], jp[k], **TOL)
            else:
                assert np.array_equal(np.asarray(pp[k]), np.asarray(jp[k])), k
        assert ((tmp_path / "p" / serve.DELTA_LOG).read_text()
                == (tmp_path / "j" / serve.DELTA_LOG).read_text())
        # a relaunch resumes from the snapshot plus the tail
        _, again = _core("gcn", False, 1)
        try:
            got = again.load_serving_state(str(tmp_path / "p"))
            assert got == {"folded": 2, "replayed": 1}
            assert again.dirty == core.dirty
            assert again.stats["deltas"] == 3
            assert all(again.graph.in_nbrs(v) == core.graph.in_nbrs(v)
                       for v in (1, 2, 3, 17))
        finally:
            again.close()
    finally:
        core.close()
        jcore.close()


# ----------------------------------------------------------------------------
# (a)-(d): the laws of tests/test_serve.py on the port
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("model,use_pp,heads", MODELS, ids=MODEL_IDS)
def test_tier_a_bitwise_vs_full_eval(model, use_pp, heads):
    s, core = _core(model, use_pp, heads)
    try:
        ref = full_graph_logits(s.net, s.g, CPU)
        for v in (0, 7, 123, s.g.n_nodes - 1):
            r = core.predict(v)
            assert r["tier"] == "A"
            assert np.array_equal(np.asarray(r["scores"], ref.dtype), ref[v])
            assert r["pred"] == int(np.argmax(ref[v]))
    finally:
        core.close()


@pytest.mark.parametrize("model,use_pp,heads", MODELS, ids=MODEL_IDS)
def test_tier_b_matches_scratch_recompute(model, use_pp, heads):
    s, core = _core(model, use_pp, heads)
    try:
        edges = [(7, 5), (11, 5), (7, 5)]      # a multi-edge too
        core.add_edges(edges)
        ref2 = full_graph_logits(s.net, _appended(s.g, edges), CPU)
        for v in set(sorted(core.dirty)[:6] + [5]):
            r = core.predict(v)
            assert r["tier"] == "B", f"node {v} should be dirty"
            np.testing.assert_allclose(np.asarray(r["scores"]), ref2[v],
                                       **TOL)
    finally:
        core.close()


def test_tier_b_exact_after_feature_update():
    s, core = _core("graphsage", True, 1)
    try:
        new_feat = np.full(s.g.n_feat, 0.25, dtype=np.float32)
        core.update_feat(9, new_feat)
        g2 = Graph(s.g.n_nodes, s.g.src, s.g.dst, s.g.feat.copy(),
                   s.g.label, s.g.train_mask, s.g.val_mask, s.g.test_mask)
        g2.feat[9] = new_feat
        ref2 = full_graph_logits(s.net, g2, CPU)
        assert 9 in core.dirty
        r = core.predict(9)
        assert r["tier"] == "B"
        np.testing.assert_allclose(np.asarray(r["scores"]), ref2[9], **TOL)
    finally:
        core.close()


@pytest.mark.parametrize("model,use_pp,heads", MODELS, ids=MODEL_IDS)
def test_batching_invariance_bitwise(model, use_pp, heads):
    s, core = _core(model, use_pp, heads)
    try:
        alone = core.scorer.score(core.graph, s.net, [42])
        full = core.scorer.score(core.graph, s.net, [42] + list(range(16)))
        assert np.array_equal(alone[42][1], full[42][1])
        assert np.array_equal(alone[42][0], full[42][0])
    finally:
        core.close()


def test_predict_many_coalesces_tier_b_into_bucket_steps():
    s, core = _core("gcn", False, 1)
    try:
        core.add_edges([(3, 17)])
        dirty_pick = sorted(core.dirty)[:10]
        clean_pick = [n for n in range(s.g.n_nodes)
                      if n not in core.dirty][:2]
        solo = {n: core.scorer.score(core.graph, s.net, [n])[n][1]
                for n in dirty_pick}
        before = core.snapshot_stats()["refreshed_nodes"]
        out = core.predict_many(dirty_pick + clean_pick)
        tiers = {r["node"]: r for r in out}
        n_b = sum(1 for r in out if r["tier"] == "B")
        assert n_b == len(dirty_pick) and len(out) == 12
        for n, ref in solo.items():
            assert np.array_equal(np.asarray(tiers[n]["scores"], ref.dtype),
                                  ref)
        assert core.snapshot_stats()["refreshed_nodes"] == before + n_b
        assert all(tiers[n]["tier"] == "A" for n in clean_pick)
    finally:
        core.close()


def test_concurrent_requests_coalesce_into_buckets():
    s, core = _core("graphsage", True, 1)
    try:
        targets = list(range(12))
        solo = {t: core.scorer.score(core.graph, s.net, [t])[t][1]
                for t in targets}
        results = {}

        def one(t):
            results[t] = np.asarray(core.predict(t, tier="B")["scores"])

        threads = [threading.Thread(target=one, args=(t,)) for t in targets]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for t in targets:
            assert np.array_equal(results[t], solo[t]), f"node {t}"
        stats = core.snapshot_stats()
        assert stats["batches"] <= len(targets)
        assert stats["batched_requests"] == len(targets)
    finally:
        core.close()


@pytest.mark.parametrize("model,use_pp,heads", MODELS, ids=MODEL_IDS)
def test_delta_refreshes_exactly_the_dirty_set(model, use_pp, heads):
    s, core = _core(model, use_pp, heads)
    try:
        edges = [(3, 17)]
        core.add_edges(edges)
        g2 = _appended(s.g, edges)
        expected = _fwd_closure(g2.src, g2.dst, {3, 17}, core.hops)
        assert core.dirty == expected
        before_logits = core.logits.copy()
        before_hidden = core.hidden.copy()
        assert core.flush() == len(expected)
        assert core.snapshot_stats()["refreshed_nodes"] == len(expected)
        assert not core.dirty
        clean = np.setdiff1d(np.arange(s.g.n_nodes), sorted(expected))
        assert np.array_equal(core.logits[clean], before_logits[clean])
        assert np.array_equal(core.hidden[clean], before_hidden[clean])
        ref2 = full_graph_logits(s.net, g2, CPU)
        ids = sorted(expected)
        np.testing.assert_allclose(core.logits[ids], ref2[ids], **TOL)
        assert core.predict(17)["tier"] == "A"
    finally:
        core.close()


def test_dirty_mark_survives_concurrent_delta_mid_refresh():
    s, core = _core("gcn", False, 1)
    try:
        core.add_edges([(3, 17)])
        orig_run = core.scorer.run_arrays

        def run_then_mutate(*a, **kw):
            out = orig_run(*a, **kw)
            assert 17 in core._refreshing and 17 not in core.dirty
            core.add_edges([(1, 17)])
            return out

        core.scorer.run_arrays = run_then_mutate
        try:
            core._score_batch([17])
        finally:
            core.scorer.run_arrays = orig_run
        assert 17 in core.dirty and 17 not in core._refreshing
        assert core.predict(17)["tier"] == "B"
        core.flush()
        assert not core.dirty and not core._refreshing
    finally:
        core.close()


# ----------------------------------------------------------------------------
# (f) checkpoint selection, the table artifact, the cold start, the dump
# ----------------------------------------------------------------------------

def _ckpt_cfg(tmp_path):
    s = _setup("graphsage", True, 1)
    cfg = s.cfg.replace(ckpt_path=str(tmp_path),
                        graph_name=s.cfg.derive_graph_name())
    return s, cfg


def test_serving_checkpoint_prefers_final_then_walks_chain(tmp_path):
    s, cfg = _ckpt_cfg(tmp_path)
    params = jax.tree.map(np.asarray, s.params)
    ckpt.save_checkpoint(ckpt.periodic_path(cfg, 3), params=params, epoch=3,
                         seed=1)
    assert ckpt.serving_checkpoint(cfg)[0] == ckpt.periodic_path(cfg, 3)
    ckpt.save_checkpoint(ckpt.final_path(cfg), params=params, epoch=9,
                         best_acc=0.7, seed=1)
    path, payload = ckpt.serving_checkpoint(cfg)
    assert path == ckpt.final_path(cfg) and payload["epoch"] == 9
    corrupt_file(ckpt.final_path(cfg))
    logged = []
    path, payload = ckpt.serving_checkpoint(cfg, log=logged.append)
    assert path == ckpt.periodic_path(cfg, 3) and payload["epoch"] == 3
    assert any("final checkpoint unusable" in x for x in logged)
    corrupt_file(ckpt.periodic_path(cfg, 3))
    assert ckpt.serving_checkpoint(cfg, log=logged.append) is None
    assert ckpt.promotion_path("d") == j_ckpt.promotion_path("d")


def test_embedding_table_roundtrip_and_integrity(tmp_path):
    s = _setup("gcn", False, 1)
    hidden, logits = full_graph_embeddings(s.net, s.g, CPU)
    path = str(tmp_path / "emb.tbl")
    serve.save_table(path, hidden, logits, meta={"graph_name": "x",
                                                 "n_nodes": s.g.n_nodes})
    h2, l2, meta = serve.load_table(path)
    assert np.array_equal(h2, hidden) and np.array_equal(l2, logits)
    assert meta["n_nodes"] == s.g.n_nodes
    corrupt_file(path)
    with pytest.raises(ckpt.CheckpointCorrupt):
        serve.load_table(path)
    with pytest.raises(ConfigError):
        serve.ServeCore(s.cfg, s.spec, serve.DynamicGraph(s.g), s.net,
                        hidden[:10], logits[:10], **QUIET)


def test_cold_start_from_table_matches_precompute():
    s = _setup("gcn", False, 1)
    hidden, logits = full_graph_embeddings(s.net, s.g, CPU)
    core = serve.build_core(s.cfg, s.g, s.net, hidden=hidden, logits=logits,
                            **QUIET)
    try:
        ref = full_graph_logits(s.net, s.g, CPU)
        r = core.predict(33)
        assert np.array_equal(np.asarray(r["scores"], ref.dtype), ref[33])
    finally:
        core.close()


def test_dump_embeddings_flag_writes_loadable_table(tmp_path):
    from bnsgcn_tpu_torch.run import run_training
    out = str(tmp_path / "emb.tbl")
    cfg = Config(dataset="sbm", n_partitions=1, model="graphsage",
                 n_layers=2, n_hidden=8, use_pp=True, sampling_rate=1.0,
                 n_epochs=4, log_every=2, fix_seed=True, seed=5,
                 device="cpu", part_path=str(tmp_path / "parts"),
                 ckpt_path=str(tmp_path / "ckpt"),
                 results_path=str(tmp_path / "res"), comm_trace=False,
                 dump_embeddings=out)
    run_training(cfg, log=lambda *a: None)
    hidden, logits, meta = serve.load_table(out)
    assert hidden.shape[0] == logits.shape[0] == 2000
    assert hidden.shape[1] == 8 and meta["model"] == "graphsage"
    assert np.isfinite(hidden).all() and np.isfinite(logits).all()


# ----------------------------------------------------------------------------
# DynamicGraph units
# ----------------------------------------------------------------------------

def test_dynamic_graph_neighbors_and_degrees_track_deltas():
    dg = serve.DynamicGraph(sbm_graph(n_nodes=100, n_class=4, n_feat=4,
                                      seed=2))
    in_before = list(dg.in_nbrs(5))
    od_u, id_v = dg.out_deg[9], dg.in_deg[5]
    dg.add_edges([(9, 5), (9, 5)])
    assert dg.in_nbrs(5) == in_before + [9, 9]
    assert dg.out_deg[9] == od_u + 2 and dg.in_deg[5] == id_v + 2
    with pytest.raises(ValueError):
        dg.add_edges([(0, 100)])
    with pytest.raises(ValueError):
        dg.set_feat(0, np.zeros(3, np.float32))


def test_in_closure_depths_cover_the_computation_subgraph():
    dg = serve.DynamicGraph(sbm_graph(n_nodes=100, n_class=4, n_feat=4,
                                      seed=2))
    depth = dg.in_closure([7], 2)
    assert depth[7] == 0
    for u in dg.in_nbrs(7):
        assert depth[u] <= 1
        for w in dg.in_nbrs(u):
            assert w in depth
    for v, d in depth.items():
        if d <= 1:
            assert all(u in depth for u in dg.in_nbrs(v))


def test_bucket_ladder_is_static_shapes():
    assert serve._bucket(1, 32) == 32
    assert serve._bucket(32, 32) == 32
    assert serve._bucket(33, 32) == 64
    assert serve._bucket(1000, 128) == 1024


# ----------------------------------------------------------------------------
# what the laws rest on: the fixed-order sum and the row tiles
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("budget", [1, 50, 1 << 28])
def test_fixed_order_sum_is_the_cpu_index_add(budget):
    """Each row's terms in edge-list order, whatever the chunking: bitwise
    index_add_'s sequential sum on the CPU (padded edges dropped)."""
    rng = np.random.default_rng(3)
    n, e = 60, 700
    src = torch.from_numpy(rng.integers(0, n, e))
    dst = torch.from_numpy(rng.integers(0, n + 1, e))
    h = torch.randn(n, 7, generator=torch.Generator().manual_seed(1))
    f = FixedOrderSum(src, dst, n, budget_elems=budget)
    assert torch.equal(f.gather_sum(h), agg_sum(h, src, dst, n))
    vals = torch.randn(e, 3, generator=torch.Generator().manual_seed(2))
    ref = torch.zeros(n + 1, 3).index_add_(0, dst, vals)[:n]
    assert torch.equal(f.edge_sum(vals), ref)


def test_row_tiles_give_each_row_the_same_bits_at_any_row_count():
    env = GraphEnv(n_dst=0, in_norm=None, out_norm=None, exchange=None,
                   aggregate=None, training=False, row_tile=16)
    lin = torch.nn.Linear(37, 5)
    x = torch.randn(100, 37, generator=torch.Generator().manual_seed(4))
    whole = by_rows(env, lin, x)
    for lo, hi in ((0, 3), (10, 50), (97, 100)):
        assert torch.equal(by_rows(env, lin, x[lo:hi]), whole[lo:hi])
    np.testing.assert_allclose(whole.detach(), lin(x).detach(), rtol=1e-6,
                               atol=1e-6)


# ----------------------------------------------------------------------------
# the continual handshake, not ported yet
# ----------------------------------------------------------------------------

def test_the_continual_ops_answer_not_ported_yet():
    _, core = _core("gcn", False, 1)
    server = serve.ServeServer(core, 0, "127.0.0.1", **QUIET)
    try:
        for op in ("export_deltas", "promote"):
            r = serve.request(server.port, {"op": op, "path": "x"})
            assert r == {"ok": False, "err": f"{op} is not ported yet"}
        assert serve.request(server.port, {"op": "ping"}) == {"ok": True}
    finally:
        server.drain()
        core.close()


def test_a_promotion_blob_exits_2_by_name(tmp_path, capsys):
    serve_dir = tmp_path / "sd"
    serve_dir.mkdir()
    (serve_dir / ckpt.PROMOTION).write_bytes(b"x")
    rc = t_main.main(["serve", "--dataset", "sbm", "--device", "cpu",
                      "--serve-dir", str(serve_dir)])
    assert rc == 2
    err = capsys.readouterr().err
    assert f"[config] promotion blob {serve_dir / ckpt.PROMOTION} found" in err
    assert "not ported yet" in err


# ----------------------------------------------------------------------------
# (e) e2e through python -m bnsgcn_tpu_torch.main serve
# ----------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_serving_ckpt(tmp_path):
    """A loadable (random-init) JAX-written checkpoint and the flags serve
    launches with."""
    cfg = JConfig(dataset="sbm", model="graphsage", n_layers=2, n_hidden=8,
                  use_pp=True, seed=3, sampling_rate=1.0,
                  ckpt_path=str(tmp_path / "ckpt"))
    cfg = cfg.replace(graph_name=cfg.derive_graph_name())
    g, _, _ = j_load_data(cfg)
    cfg2 = cfg.replace(n_feat=g.n_feat, n_class=g.n_class, n_train=g.n_train)
    params, state = j_init_params(jax.random.key(3),
                                  j_spec_from_config(cfg2))
    j_ckpt.save_checkpoint(j_ckpt.final_path(cfg2), params=params,
                           bn_state=state, epoch=7, best_acc=0.5, seed=3)
    return ["--dataset", "sbm", "--model", "graphsage", "--n-layers", "2",
            "--n-hidden", "8", "--use-pp", "--fix-seed", "--seed", "3",
            "--device", "cpu", "--ckpt-path", str(tmp_path / "ckpt")]


def _launch(args, port):
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.Popen([sys.executable, "-m", "bnsgcn_tpu_torch.main",
                          "serve"] + args + ["--serve-port", str(port)],
                         env=env, cwd=REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + 180
    while time.monotonic() < deadline:
        if p.poll() is not None:
            raise AssertionError(f"server died rc={p.returncode}:\n"
                                 f"{p.stdout.read()[-2000:]}")
        try:
            if serve.request(port, {"op": "ping"}, timeout_s=1.0).get("ok"):
                return p
        except Exception:
            pass
        time.sleep(0.2)
    p.kill()
    raise AssertionError("server never became ready")


def test_e2e_subprocess_server_roundtrip(tmp_path):
    args = _write_serving_ckpt(tmp_path)
    port = _free_port()
    p = _launch(args, port)
    try:
        r = serve.request(port, {"op": "predict", "node": 11})
        assert r["ok"] and r["tier"] == "A" and len(r["scores"]) == 8
        r = serve.request(port, {"op": "add_edges", "edges": [[4, 11]]})
        assert r["ok"] and r["dirty_total"] > 0
        r = serve.request(port, {"op": "predict", "node": 11})
        assert r["ok"] and r["tier"] == "B"
        r = serve.request(port, {"op": "predict_many", "nodes": [1, 2, 3]})
        assert r["ok"] and len(r["results"]) == 3
        assert serve.request(port, {"op": "nope"})["ok"] is False
        stats = serve.request(port, {"op": "stats"})
        assert stats["requests"] >= 5
        assert stats["tier_a"] >= 1 and stats["tier_b"] >= 1
        serve.request(port, {"op": "shutdown"})
        assert p.wait(timeout=120) == 0
    finally:
        if p.poll() is None:
            p.kill()


def test_e2e_sigterm_drains_flushes_delta_log_exit_75(tmp_path):
    args = _write_serving_ckpt(tmp_path)
    serve_dir = str(tmp_path / "servedir")
    args += ["--serve-dir", serve_dir]
    port = _free_port()
    p = _launch(args, port)
    try:
        serve.request(port, {"op": "add_edges", "edges": [[4, 11], [7, 2]]})
        p.send_signal(signal.SIGTERM)
        rc = p.wait(timeout=120)
        out = p.stdout.read()
        assert rc == 75, (rc, out[-2000:])
        assert "delta(s) flushed" in out
        log_path = os.path.join(serve_dir, serve.DELTA_LOG)
        lines = [json.loads(x) for x in open(log_path) if x.strip()]
        assert lines == [{"op": "add_edges", "edges": [[4, 11], [7, 2]]}]
    finally:
        if p.poll() is None:
            p.kill()
    p2 = _launch(args, port)
    try:
        stats = serve.request(port, {"op": "stats"})
        assert stats["deltas"] == 1
        assert serve.request(port, {"op": "flush"}, timeout_s=120)["ok"]
        assert serve.request(port, {"op": "dirty"})["count"] == 0
        serve.request(port, {"op": "shutdown"})
        assert p2.wait(timeout=120) == 0
    finally:
        if p2.poll() is None:
            p2.kill()
