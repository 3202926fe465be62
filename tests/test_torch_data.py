"""The PyTorch port's host-side data mirrors against the JAX package.

Graph generation, datasets, P=1 partition artifacts, the ELL and hybrid
layouts and cluster_order are numpy in both packages; the port keeps its own
copy, so they must agree exactly: every array bitwise, every spec equal.
"""

import dataclasses

import numpy as np
import pytest

from bnsgcn_tpu.config import Config as JConfig
from bnsgcn_tpu.data import artifacts as j_art
from bnsgcn_tpu.data import datasets as j_ds
from bnsgcn_tpu.data import graph as j_graph
from bnsgcn_tpu.data import partitioner as j_part
from bnsgcn_tpu.ops import block_spmm as j_blk
from bnsgcn_tpu.ops import ell as j_ell
from bnsgcn_tpu_torch.config import Config as TConfig
from bnsgcn_tpu_torch.data import artifacts as t_art
from bnsgcn_tpu_torch.data import datasets as t_ds
from bnsgcn_tpu_torch.data import graph as t_graph
from bnsgcn_tpu_torch.data import partitioner as t_part
from bnsgcn_tpu_torch.ops import block_spmm as t_blk
from bnsgcn_tpu_torch.ops import ell as t_ell

GRAPH_FIELDS = ("src", "dst", "feat", "label", "train_mask", "val_mask",
                "test_mask")


def _assert_graph_equal(a, b):
    assert a.n_nodes == b.n_nodes
    for f in GRAPH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _assert_arrays_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("gen,kw", [
    ("synthetic_graph", dict(n_nodes=300, avg_degree=6, seed=3)),
    ("synthetic_graph", dict(n_nodes=300, avg_degree=6, seed=4,
                             power_law=True)),
    ("sbm_graph", dict(n_nodes=250, n_class=5, seed=7)),
    ("reddit_like_graph", dict(n_nodes=1500, avg_degree=20, n_feat=24,
                               seed=2)),
])
def test_graph_generators_bit_identical(gen, kw):
    _assert_graph_equal(getattr(t_graph, gen)(**kw), getattr(j_graph, gen)(**kw))


@pytest.mark.parametrize("name", ["synthetic", "sbm", "synth-reddit:0.005"])
def test_load_data_bit_identical(name):
    tg, tf, tc = t_ds.load_data(TConfig(dataset=name, seed=1))
    jg, jf, jc = j_ds.load_data(JConfig(dataset=name, seed=1))
    assert (tf, tc) == (jf, jc)
    _assert_graph_equal(tg, jg)


def _graphs():
    kw = dict(n_nodes=260, n_class=4, n_feat=6, p_in=0.12, p_out=0.004,
              seed=11)
    return t_graph.sbm_graph(**kw), j_graph.sbm_graph(**kw)


@pytest.mark.parametrize("n_parts", [1, 4])
def test_artifacts_p1_array_equal(n_parts):
    """P=1 artifacts, and the P=4 ones of a random partition."""
    tg, jg = _graphs()
    tpid = t_part.partition_graph(tg, n_parts, method="random", seed=5)
    np.testing.assert_array_equal(
        tpid, j_part.partition_graph(jg, n_parts, method="random", seed=5))
    ta, ja = t_art.build_artifacts(tg, tpid), j_art.build_artifacts(jg, tpid)
    for f in dataclasses.fields(ta):
        x, y = getattr(ta, f.name), getattr(ja, f.name)
        if f.name == "ell_geometry":
            # the GAT geometry waits for the GAT slice
            assert x == {k: v for k, v in y.items() if k in ("fwd", "bwd")}
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name
    assert ta.n_ext == ja.n_ext


def test_degree_helpers_equal():
    tg, jg = _graphs()
    for a, b in zip(t_part.degree_tables(tg.src, tg.dst, tg.n_nodes),
                    j_part.degree_tables(jg.src, jg.dst, jg.n_nodes)):
        np.testing.assert_array_equal(a, b)
    ids = np.arange(0, tg.n_nodes, 3)
    deg = tg.in_degrees().astype(np.float32)
    np.testing.assert_array_equal(t_part.degree_norm_row(deg, ids, 96),
                                  j_part.degree_norm_row(deg, ids, 96))


def _art():
    tg, _ = _graphs()
    return t_art.build_artifacts(tg, t_part.partition_graph(tg, 1))


def test_build_layouts_array_equal():
    art = _art()
    for geo in (None, art.ell_geometry):
        tf, tb, ta = t_ell.build_layouts(art.src, art.dst, art.pad_inner,
                                         art.n_ext, geometry=geo)
        jf, jb, ja = j_ell.build_layouts(art.src, art.dst, art.pad_inner,
                                         art.n_ext, geometry=geo)
        assert dataclasses.asdict(tf) == dataclasses.asdict(jf)
        assert dataclasses.asdict(tb) == dataclasses.asdict(jb)
        _assert_arrays_equal(ta, ja)


def test_split_rows_layout_array_equal():
    """Rows above the 128 split cap (the power-law tail) build the same
    split-row chunk tables."""
    g = t_graph.synthetic_graph(n_nodes=400, avg_degree=40, seed=5,
                                power_law=True)
    art = t_art.build_artifacts(g, t_part.partition_graph(g, 1))
    tf, tb, ta = t_ell.build_layouts(art.src, art.dst, art.pad_inner,
                                     art.n_ext)
    jf, jb, ja = j_ell.build_layouts(art.src, art.dst, art.pad_inner,
                                     art.n_ext)
    assert tf.n_split > 0 and tb.n_split > 0
    assert (tf, tb) == (t_ell.EllSpec(**dataclasses.asdict(jf)),
                        t_ell.EllSpec(**dataclasses.asdict(jb)))
    _assert_arrays_equal(ta, ja)


@pytest.mark.parametrize("target", [64, 512])
def test_cluster_order_equal(target):
    art = _art()
    tp = t_blk.cluster_order(art.src[0], art.dst[0], art.pad_inner,
                             art.n_ext, target=target, log=lambda m: None)
    jp = j_blk.cluster_order(art.src[0], art.dst[0], art.pad_inner,
                             art.n_ext, target=target)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a, b)


def test_cluster_order_says_which_order():
    art = _art()
    said = []
    t_blk.cluster_order(art.src[0], art.dst[0], art.pad_inner, art.n_ext,
                        target=64, log=said.append)
    t_blk.cluster_order(art.src[0], art.dst[0], art.pad_inner, art.n_ext,
                        target=10**6, log=said.append)
    assert "native clustering" in said[0] and "identity order" in said[1]


@pytest.mark.parametrize("tile,occ", [(64, 4), (32, 8), (64, 10**9)])
def test_build_block_layouts_array_equal(tile, occ):
    """At an equal cluster order, the hybrid layout (tile stacks, transposed
    stacks, ids, residual ELL) is the JAX one, array for array; occ=huge is
    the no-dense-tile degeneration."""
    art = _art()
    pi, pe = t_blk.cluster_order(art.src[0], art.dst[0], art.pad_inner,
                                 art.n_ext, target=tile, log=lambda m: None)
    kw = dict(occupancy_min=occ, tile_r=tile, tile_c=tile)
    tf, tb, tpair, ta = t_blk.build_block_layouts(
        art.src, art.dst, art.pad_inner, art.n_ext, pi[None], pe[None], **kw)
    jf, jb, jpair, ja = j_blk.build_block_layouts(
        art.src, art.dst, art.pad_inner, art.n_ext, pi[None], pe[None], **kw)
    assert dataclasses.asdict(tf) == dataclasses.asdict(jf)
    assert dataclasses.asdict(tb) == dataclasses.asdict(jb)
    for t, j in zip(tpair, jpair):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    _assert_arrays_equal(ta, ja)
    assert t_blk.dense_edge_count(ta) == j_blk.dense_edge_count(ja)
    if occ < 100:
        assert t_blk.dense_edge_count(ta) > 0
    assert (t_blk.effective_occupancy(0, tile, tile)
            == j_blk.effective_occupancy(0, tile, tile))
