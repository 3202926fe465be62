"""--reorder in the port (bnsgcn_tpu_torch/data/reorder.py) against the JAX
package's data/reorder.py, on the CPU, mirroring tests/test_reorder.py's
laws (its replicas x parts x feat case aside: the port has neither axis).

  * the orders, every permuted artifact array, the coverage before (the
    hybrid's per-build cluster order) and after, and maybe_reorder's
    verdict and info array-equal (the floats equal) to the JAX package's,
    on its 4-part skewed graph, its scrambled community SBM (auto declines)
    and its skew-only power-law graph (auto applies);
  * a rank's own part (a partial load) ordered and permuted alone equals
    that part of the full pass, its n_b row taken by its global id; the
    per-part coverage sums add up, in part order, to the full coverage;
  * apply_reorder's invariants (:231), the order's disk memo keyed on the
    tile (:267), the layout keys never alias (:296), coverage rises on the
    scrambled SBM (:342);
  * P=1 training on the reordered artifacts against --reorder off, as the
    JAX package's :126-:168 hold the 4-part mesh (rate 1.0, dropout 0):
    global-order logits bitwise for ELL, segment and --overlap split,
    within 1e-5 of the largest for the hybrid; losses within 1e-6 (1e-4
    for the hybrid) of max(|loss|, 1).

The P=4 verdict through the ranks' all-reduce, and training under
--reorder on 4 ranks, ride tests/test_torch_knobs.py's group.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from bnsgcn_tpu.config import Config as JConfig
from bnsgcn_tpu.data import reorder as j_reorder
from bnsgcn_tpu.data.artifacts import build_artifacts as j_build
from bnsgcn_tpu.data.graph import Graph as JGraph
from bnsgcn_tpu.data.graph import sbm_graph as j_sbm
from bnsgcn_tpu.data.graph import synthetic_graph as j_synthetic
from bnsgcn_tpu.data.partitioner import partition_graph as j_partition
from bnsgcn_tpu_torch.config import Config
from bnsgcn_tpu_torch.data import reorder
from bnsgcn_tpu_torch.data.artifacts import build_artifacts
from bnsgcn_tpu_torch.data.graph import Graph, sbm_graph, synthetic_graph
from bnsgcn_tpu_torch.data.partitioner import partition_graph
from bnsgcn_tpu_torch.evaluate import gather_parts
from bnsgcn_tpu_torch.ops.block_spmm import effective_occupancy
from bnsgcn_tpu_torch.run import init_training, prepare_part
from bnsgcn_tpu_torch.trainer import (ell_layout_key, gat_layout_key,
                                      hybrid_layout_key)

SKEW = dict(n_nodes=160, avg_degree=7, n_feat=6, seed=43, power_law=True)
FIELDS = ("feat", "label", "train_mask", "val_mask", "test_mask",
          "inner_mask", "in_deg", "out_deg_ext", "src", "dst", "bnd",
          "global_nid", "n_b", "n_inner")


def _quiet(*a, **k):
    pass


def _skew_pid(n):
    pid = np.zeros(n, dtype=np.int32)
    pid[80:120] = 1
    pid[120:144] = 2
    pid[144:] = 3
    return pid


@pytest.fixture(scope="module")
def ro4():
    """The JAX package's 4-part skewed fixture (tests/test_reorder.py:68),
    built by both packages: (port artifacts, JAX artifacts)."""
    g_t, g_j = synthetic_graph(**SKEW), j_synthetic(**SKEW)
    return (build_artifacts(g_t, _skew_pid(g_t.n_nodes)),
            j_build(g_j, _skew_pid(g_j.n_nodes)))


def _scrambled(sbm, graph_cls):
    gs = sbm(n_nodes=8192, n_class=32, n_feat=8, p_in=0.008, p_out=0.0001,
             seed=3)
    perm = np.random.default_rng(0).permutation(gs.n_nodes)
    inv = np.argsort(perm)
    return graph_cls(gs.n_nodes, perm[gs.src], perm[gs.dst], gs.feat[inv],
                     gs.label[inv], gs.train_mask[inv], gs.val_mask[inv],
                     gs.test_mask[inv])


@pytest.fixture(scope="module")
def scrambled():
    """The scrambled 32-community SBM of tests/test_reorder.py:322, P=1,
    both packages."""
    g_t, g_j = _scrambled(sbm_graph, Graph), _scrambled(j_sbm, JGraph)
    return (build_artifacts(g_t, partition_graph(g_t, 1, method="random",
                                                 seed=0)),
            j_build(g_j, j_partition(g_j, 1, method="random", seed=0)))


def _assert_art_equal(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)


@pytest.mark.parametrize("tile", [32, 512])
def test_orders_and_permuted_artifacts_equal_jax(ro4, tile):
    art, art_j = ro4
    orders = reorder.compute_orders(art, tile_r=tile)
    np.testing.assert_array_equal(orders,
                                  j_reorder.compute_orders(art_j, tile))
    _assert_art_equal(reorder.apply_reorder(art, orders),
                      j_reorder.apply_reorder(art_j, orders))


def test_coverage_equals_jax(ro4):
    art, art_j = ro4
    occ = effective_occupancy(0, 32, 32)
    orders = reorder.compute_orders(art, tile_r=32)
    for a, b in ((art, art_j), (reorder.apply_reorder(art, orders),
                                j_reorder.apply_reorder(art_j, orders))):
        assert (reorder.artifact_coverage(a, occ, 2 << 30, 32)
                == j_reorder.artifact_coverage(b, occ, 2 << 30, 32))


def _verdict(art, art_j, mode, tile):
    cfg = Config(reorder=mode, block_tile=tile)
    cfg_j = JConfig(reorder=mode, block_tile=tile)
    got = reorder.maybe_reorder(cfg, art, log=_quiet)
    want = j_reorder.maybe_reorder(cfg_j, art_j, log=_quiet)
    assert got[1] == want[1]
    for k in ("coverage_before", "coverage_after", "resolved", "mode",
              "tile", "algorithm"):
        assert got[2][k] == want[2][k], k
    _assert_art_equal(got[0], want[0])
    return got


@pytest.mark.parametrize("mode", ["auto", "cluster"])
def test_verdict_equals_jax_on_the_skewed_parts(ro4, mode):
    _verdict(*ro4, mode, 32)


def test_auto_declines_when_ldg_baseline_wins(scrambled):
    """tests/test_reorder.py:350: on the scrambled SBM the hybrid's LDG
    order recovers the communities better than the LPA pass, so auto keeps
    the off path; cluster applies unconditionally."""
    art2, resolved, info = _verdict(*scrambled, "auto", 256)
    assert resolved == "off" and art2 is scrambled[0]
    assert info["coverage_after"] <= info["coverage_before"]
    art3, r3, _ = _verdict(*scrambled, "cluster", 256)
    assert r3 == "cluster" and art3 is not scrambled[0]


def test_auto_applies_in_the_skew_only_regime():
    """tests/test_reorder.py:367: structure-free power law, auto applies."""
    kw = dict(n_nodes=8192, avg_degree=12, n_feat=8, seed=7, power_law=True)
    g_t, g_j = synthetic_graph(**kw), j_synthetic(**kw)
    art = build_artifacts(g_t, partition_graph(g_t, 1, method="random",
                                               seed=0))
    art_j = j_build(g_j, j_partition(g_j, 1, method="random", seed=0))
    art2, resolved, info = _verdict(art, art_j, "auto", 256)
    assert resolved == "cluster" and art2 is not art
    assert info["coverage_after"] > info["coverage_before"]


def test_reorder_recovers_scrambled_communities(scrambled):
    art = scrambled[0]
    occ = effective_occupancy(0, 256, 256)
    before = reorder.artifact_coverage(art, occ, 2048 << 20, 256)
    art_ro = reorder.apply_reorder(art, reorder.compute_orders(art, 256))
    after = reorder.artifact_coverage(art_ro, occ, 2048 << 20, 256)
    assert after >= before + 0.15, (before, after)


def _part(art, p):
    """Part p alone, as a rank's load_artifacts(parts=[p]) holds it."""
    rows = ("feat", "label", "train_mask", "val_mask", "test_mask",
            "inner_mask", "in_deg", "out_deg_ext", "src", "dst", "bnd",
            "global_nid")
    return dataclasses.replace(art, **{f: getattr(art, f)[p:p + 1]
                                       for f in rows})


def test_a_ranks_part_alone_equals_its_part_of_the_full_pass(ro4):
    art = ro4[0]
    full = reorder.apply_reorder(art, reorder.compute_orders(art, 32))
    occ = effective_occupancy(0, 32, 32)
    sums = []
    for p in range(art.n_parts):
        one = _part(art, p)
        orders = reorder.compute_orders(one, 32, parts=[p])
        got = reorder.apply_reorder(one, orders, parts=[p])
        _assert_art_equal(got, dataclasses.replace(_part(full, p),
                                                   n_b=art.n_b))
        sums.append(reorder.coverage_sums(one, occ, 2 << 30, 32)[0])
    assert (reorder._fraction(np.array(sums))
            == reorder.artifact_coverage(art, occ, 2 << 30, 32))
    with pytest.raises(ValueError, match="full artifacts"):
        reorder.apply_reorder(_part(art, 1), orders[:1])


def _global_edge_keys(art, p):
    ni = art.pad_inner
    real = art.dst[p] < ni
    s, d = art.src[p][real], art.dst[p][real]
    gs = np.where(s < ni, art.global_nid[p][np.minimum(s, ni - 1)], -1 - s)
    gd = art.global_nid[p][d]
    return np.sort((gs + 2) * np.int64(10 ** 10) + (gd + 2))


def test_apply_reorder_invariants(ro4):
    """tests/test_reorder.py:231: a bijection on the inner rows, identity
    on the padding rows; shapes, pads, n_b and degree multisets unchanged;
    every (node, label) pair and the global-id edge multiset preserved."""
    art = ro4[0]
    orders = reorder.compute_orders(art, 32)
    art_ro = reorder.apply_reorder(art, orders)
    assert any((orders[p] != np.arange(art.pad_inner)).any()
               for p in range(art.n_parts))
    assert (art_ro.pad_inner, art_ro.pad_boundary) == (art.pad_inner,
                                                       art.pad_boundary)
    np.testing.assert_array_equal(art_ro.n_b, art.n_b)
    for p in range(art.n_parts):
        n_i = int(art.n_inner[p])
        np.testing.assert_array_equal(np.sort(orders[p][:n_i]),
                                      np.arange(n_i))
        np.testing.assert_array_equal(orders[p][n_i:],
                                      np.arange(n_i, art.pad_inner))
        np.testing.assert_array_equal(np.sort(art_ro.in_deg[p]),
                                      np.sort(art.in_deg[p]))
        a = dict(zip(art.global_nid[p][art.inner_mask[p]].tolist(),
                     art.label[p][art.inner_mask[p]].tolist()))
        b = dict(zip(art_ro.global_nid[p][art_ro.inner_mask[p]].tolist(),
                     art_ro.label[p][art_ro.inner_mask[p]].tolist()))
        assert a == b
        np.testing.assert_array_equal(_global_edge_keys(art, p),
                                      _global_edge_keys(art_ro, p))


def test_reorder_cache_memoizes_and_keys_on_tile(ro4, tmp_path):
    """tests/test_reorder.py:267, and the same file names as the JAX
    package's for the full artifacts."""
    art, art_j = ro4
    cfg = Config(reorder="cluster", cache_dir=str(tmp_path),
                 graph_name="rotest")
    p512 = reorder.reorder_cache_path(cfg, art, 512)
    assert p512 == j_reorder.reorder_cache_path(
        JConfig(reorder="cluster", cache_dir=str(tmp_path),
                graph_name="rotest"), art_j, 512)
    assert p512 != reorder.reorder_cache_path(cfg, art, 256)
    assert reorder.REORDER_ALGO in p512 and p512.endswith("_t512.pkl")
    assert reorder.reorder_cache_path(cfg.replace(cache_dir=""), art,
                                      512) is None
    a1, r1, i1 = reorder.maybe_reorder(cfg, art, log=_quiet)
    assert r1 == "cluster" and i1["cached"] is False and os.path.exists(p512)
    a2, _, i2 = reorder.maybe_reorder(cfg, art, log=_quiet)
    assert i2["cached"] is True
    _assert_art_equal(a1, a2)
    from bnsgcn_tpu_torch.utils.diskcache import atomic_dump
    atomic_dump(np.zeros((2, 3), np.int64), p512)
    a3, _, i3 = reorder.maybe_reorder(cfg, art, log=_quiet)
    assert i3["cached"] is False
    _assert_art_equal(a3, a1)
    a4, r4, i4 = reorder.maybe_reorder(cfg.replace(reorder="off"), art,
                                       log=_quiet)
    assert a4 is art and r4 == "off" and i4 == {}


def test_more_than_one_node_forces_off(ro4):
    lines = []
    got, resolved, info = reorder.maybe_reorder(
        Config(reorder="cluster", n_nodes=2), ro4[0], log=lines.append)
    assert got is ro4[0] and resolved == "off" and info == {}
    assert lines == ["reorder: multi-host partial loads keep the on-disk "
                     "row order (--reorder forced off)"]


def test_layout_keys_never_alias():
    """tests/test_reorder.py:296: every (tile, overlap, reorder) gets its
    own key, and the keys are the JAX package's."""
    from bnsgcn_tpu import trainer as j_trainer
    keys, n = set(), 0
    for tile in (512, 256):
        for overlap in ("off", "split"):
            for ro in ("off", "cluster"):
                c = dict(block_tile=tile, overlap=overlap, reorder=ro)
                k = hybrid_layout_key(Config(**c))
                assert k == j_trainer.hybrid_layout_key(JConfig(**c))
                keys.add(k)
                n += 1
    for overlap in ("off", "split"):
        for ro in ("off", "cluster"):
            c = dict(overlap=overlap, reorder=ro)
            k = ell_layout_key(Config(**c))
            assert k == j_trainer.ell_layout_key(JConfig(**c))
            keys.add(k)
            n += 1
    for ro in ("off", "cluster"):
        k = gat_layout_key(Config(reorder=ro))
        assert k == j_trainer.gat_layout_key(JConfig(reorder=ro))
        keys.add(k)
        n += 1
    assert len(keys) == n, sorted(keys)


# ---------------------------------------------------------------------------
# training on the reordered artifacts (P=1)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ro1():
    g = synthetic_graph(**SKEW)
    art = build_artifacts(g, np.zeros(g.n_nodes, dtype=np.int32))
    return art, reorder.apply_reorder(art, reorder.compute_orders(art, 32))


def _train(art, reorder_mode, **kw):
    """Logits (global node order) of the training forward at epoch 0 and
    the losses of 2 steps, from seed 5's parameters."""
    cfg = Config(model="graphsage", n_layers=2, n_hidden=16, dropout=0.0,
                 use_pp=False, norm="layer", lr=0.01, n_partitions=1,
                 n_epochs=2, eval=False, device="cpu", seed=5,
                 block_tile=32, reorder=reorder_mode, **kw)
    pr = prepare_part(cfg, art, None, torch.device("cpu"), _quiet)
    blk, model, opt = init_training(pr)
    logits = pr.fns.forward(model, blk, 0).detach().numpy()
    losses = [float(pr.fns.train_step(model, opt, blk, e)) for e in range(2)]
    return gather_parts(art, logits[None]), losses


@pytest.mark.parametrize("kw", [dict(spmm="ell"), dict(spmm="segment"),
                                dict(spmm="ell", overlap="split")],
                         ids=["ell", "segment", "split"])
def test_logits_bitwise_under_reorder(ro1, kw):
    """tests/test_reorder.py:126, :140, :159 at P=1: the per-row sums see
    the same sources in the same slot order."""
    art, art_ro = ro1
    lo, losses_o = _train(art, "off", **kw)
    lr, losses_r = _train(art_ro, "cluster", **kw)
    np.testing.assert_array_equal(lo, lr)
    for a, b in zip(losses_o, losses_r):
        assert abs(a - b) <= 1e-6 * max(abs(a), 1.0)


def test_hybrid_logits_allclose_under_reorder(ro1):
    """tests/test_reorder.py:147: the hybrid's split moves with the order,
    so its sums reassociate; its layout takes identity orders."""
    art, art_ro = ro1
    lo, losses_o = _train(art, "off", spmm="hybrid")
    lr, losses_r = _train(art_ro, "cluster", spmm="hybrid")
    assert np.abs(lr - lo).max() / (np.abs(lo).max() + 1e-9) < 1e-5
    for a, b in zip(losses_o, losses_r):
        assert abs(a - b) <= 1e-4 * max(abs(a), 1.0)
