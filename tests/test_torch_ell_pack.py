"""K1's row schedule (`pack_rows`) and its plain version (`ell_apply_plain`),
on the CPU.

The schedule must hold exactly the ELL tables' terms: for the residual
layouts of a P=1 and a P=4 hybrid, both directions, its CSR equals the
residual edges (every edge the dense tiles do not carry) grouped by row, and
each row lists its table rows' terms in table order, a split row's chunks
joined in chunk order. The work order is a permutation of the rows with
the long rows first, each part longest first. A plain CSR sum over the schedule, which is what the
kernel computes, equals `ell_apply_plain` on the tables, and that equals the
JAX package's `_ell_apply` / `make_ell_spmm` and `pallas_ell_apply` (the
Pallas bucket kernel in interpret mode). Inputs come from numpy with a seed;
rtol = atol = 1e-5 (f32 sums of a few dozen terms in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnsgcn_tpu.ops import ell as j_ell
from bnsgcn_tpu_torch.data.artifacts import build_artifacts
from bnsgcn_tpu_torch.data.graph import sbm_graph, synthetic_graph
from bnsgcn_tpu_torch.data.partitioner import partition_graph
from bnsgcn_tpu_torch.ops import block_spmm as t_blk
from bnsgcn_tpu_torch.ops import ell as t_ell
from bnsgcn_tpu_torch.ops.bucket_sum import (LONG_ROW, ell_apply_plain,
                                             work_order)
from tools.pallas_spmm import pallas_ell_apply

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _csr_sum(rows, h, base=None, base_row=None):
    """The kernel's function on the schedule, in plain torch: each row's
    terms summed (in any order), then base[base_row] +."""
    deg = (rows.row_ptr[1:] - rows.row_ptr[:-1]).long()
    seg = torch.repeat_interleave(torch.arange(rows.n_rows), deg)
    out = torch.zeros((rows.n_rows, h.shape[1]))
    out.index_add_(0, seg, h[rows.src.long()])
    return out if base is None else base[base_row.long()] + out


def _table_terms(rows):
    """Each row's terms read straight off the ELL tables, by a loop."""
    spec = rows.spec
    tabs = [t.numpy() for t in rows.idx]
    table = [r for t in tabs for r in t]
    n_tab = len(table)
    cap_off = n_tab - (len(tabs[-1]) if tabs else 0)
    perm = rows.perm.numpy()
    out = []
    for r in range(spec.n_rows):
        p = int(perm[r])
        if p < n_tab:
            trows = [table[p]]
        elif p < n_tab + spec.n_split:
            seg, pos = rows.chunk_seg.numpy(), rows.chunk_pos.numpy()
            trows = [table[cap_off + c] for c in pos[seg == p - n_tab]]
        else:
            trows = []
        out.append([int(s) for t in trows for s in t if s != spec.n_src])
    return out


def _check_schedule(rows, expect_pairs=None):
    """The CSR against the tables (and, given, a multiset of (row, src)
    pairs); the work order against its definition."""
    rp = rows.row_ptr.numpy()
    assert rp[0] == 0 and np.all(np.diff(rp) >= 0)
    assert rp[-1] == rows.src.numel()
    src = rows.src.numpy()
    terms = _table_terms(rows)
    for r in range(rows.n_rows):
        assert src[rp[r]:rp[r + 1]].tolist() == terms[r], r
    deg = np.diff(rp)
    if expect_pairs is not None:
        got = np.repeat(np.arange(rows.n_rows), deg).astype(np.int64) \
            * rows.n_src + src
        np.testing.assert_array_equal(np.sort(got), np.sort(expect_pairs))
    _check_work(rows, deg)


def _check_work(rows, deg):
    w = rows.work.numpy()
    assert rows.work.dtype == torch.int32
    np.testing.assert_array_equal(np.sort(w), np.arange(rows.n_rows))
    nl = rows.n_long
    assert nl == int((deg > rows.long_row).sum())
    assert np.all(deg[w[:nl]] > rows.long_row)
    assert np.all(np.diff(deg[w[:nl]]) <= 0)
    assert np.all(np.diff(deg[w[nl:]]) <= 0)


def _hybrid_parts(n_parts, tile=32, seed=67):
    """Each part's hybrid layout, built from the part alone (as every rank
    builds its own), with the part's edges."""
    g = sbm_graph(n_nodes=300, n_class=5, n_feat=6, p_in=0.15, p_out=0.003,
                  seed=seed)
    art = build_artifacts(g, partition_graph(g, n_parts))
    out = []
    for p in range(n_parts):
        pi, pe = t_blk.cluster_order(art.src[p], art.dst[p], art.pad_inner,
                                     art.n_ext, target=tile,
                                     log=lambda m: None)
        fwd, bwd, pair, arrays = t_blk.build_block_layouts(
            art.src[p:p + 1], art.dst[p:p + 1], art.pad_inner, art.n_ext,
            pi[None], pe[None], occupancy_min=4, tile_r=tile, tile_c=tile)
        a0 = {k: _t(v[0]) for k, v in arrays.items()}
        real = art.dst[p] < art.pad_inner
        out.append((t_blk.BlockSpmm(fwd, bwd, pair, a0), a0,
                    art.src[p][real], art.dst[p][real]))
    return out


def _dense_pairs(a, direction, tile, n_rows, n_src):
    """(row, src) keys of the edges the dense tiles carry, in original ids,
    with multiplicity."""
    tiles = a[f"blk_tiles_{direction}"].numpy()
    rowb, colb = a[f"blk_rowb_{direction}"].numpy(), \
        a[f"blk_colb_{direction}"].numpy()
    pr, pc = (("blk_perm_inner", "blk_perm_ext") if direction == "fwd"
              else ("blk_perm_ext", "blk_perm_inner"))
    inv_r = np.argsort(a[pr].numpy())
    inv_c = np.argsort(a[pc].numpy())
    b, i, j = np.nonzero(tiles)
    keep = rowb[b] < (n_rows + tile - 1) // tile
    b, i, j = b[keep], i[keep], j[keep]
    mult = tiles[b, i, j].astype(np.int64)
    r = inv_r[rowb[b].astype(np.int64) * tile + i]
    c = inv_c[colb[b].astype(np.int64) * tile + j]
    return np.repeat(r * n_src + c, mult)


def _minus(a, b):
    """Multiset difference of two int64 key arrays (b within a)."""
    ua, ca = np.unique(a, return_counts=True)
    ub, cb = np.unique(b, return_counts=True)
    cnt = ca.copy()
    pos = np.searchsorted(ua, ub)
    assert np.all(ua[pos] == ub)
    cnt[pos] -= cb
    assert np.all(cnt >= 0)
    return np.repeat(ua, cnt)


@pytest.mark.parametrize("n_parts", [1, 4])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_schedule_round_trips_the_residual(n_parts, direction):
    """The residual of each part's hybrid layout: the CSR holds the residual
    edges grouped by row, in table order; the work order is a permutation
    of the rows, also at a long-row threshold that makes most rows long."""
    tile, n_terms = 32, 0
    for op, a, s, d in _hybrid_parts(n_parts, tile):
        rows = op.residual.rows[direction]
        n_rows, n_src = rows.n_rows, rows.n_src
        r, c = (d, s) if direction == "fwd" else (s, d)
        pairs = _minus(r.astype(np.int64) * n_src + c,
                       _dense_pairs(a, direction, tile, n_rows, n_src))
        n_terms += len(pairs)
        _check_schedule(rows, pairs)
        deg = np.diff(rows.row_ptr.numpy())
        _check_work(rows.with_long_row(2), deg)
    assert n_terms > 0


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_schedule_joins_split_rows(direction):
    """A power-law graph whose rows above the split cap (degree > 128) are
    split into 128-wide chunks: the CSR joins them back into one row of the
    row's full degree; a hub of more than LONG_ROW terms is a long row."""
    g = synthetic_graph(n_nodes=400, avg_degree=40, n_feat=6, seed=5,
                        power_law=True)
    art = build_artifacts(g, partition_graph(g, 1))
    hub_src = np.arange(LONG_ROW + 80) % art.n_ext
    src = np.concatenate([art.src[0], hub_src]).astype(np.int32)[None]
    dst = np.concatenate([art.dst[0], np.full(len(hub_src), 7)]
                         ).astype(np.int32)[None]
    fs, bs, arrays = t_ell.build_layouts(src, dst, art.pad_inner, art.n_ext)
    op = t_ell.EllSpmm(fs, bs, {k: _t(v[0]) for k, v in arrays.items()})
    spec = fs if direction == "fwd" else bs
    rows = op.rows[direction]
    assert spec.n_split > 0
    real = dst[0] < art.pad_inner
    r, c = ((dst[0][real], src[0][real]) if direction == "fwd"
            else (src[0][real], dst[0][real]))
    _check_schedule(rows, r.astype(np.int64) * rows.n_src + c)
    deg = np.diff(rows.row_ptr.numpy())
    np.testing.assert_array_equal(deg, np.bincount(r, minlength=rows.n_rows))
    assert (deg > 128).any()
    if direction == "fwd":
        assert rows.n_long >= 1 and int(rows.work[0]) == 7


def test_schedule_of_an_empty_layout():
    """No edges at all: every row is empty, the CSR has no terms, the work
    order still lists every row once, and the function is the base alone."""
    n_rows, n_src = 24, 30
    src = np.zeros((1, 8), np.int32)
    dst = np.full((1, 8), n_rows, np.int32)                 # all padding
    fs, bs, arrays = t_ell.build_layouts(src, dst, n_rows, n_src)
    op = t_ell.EllSpmm(fs, bs, {k: _t(v[0]) for k, v in arrays.items()})
    for d in ("fwd", "bwd"):
        rows = op.rows[d]
        assert rows.src.numel() == 0 and rows.n_long == 0
        assert not rows.row_ptr.any()
        _check_work(rows, np.zeros(rows.n_rows, np.int64))
    rng = np.random.default_rng(0)
    h = _t(rng.normal(size=(n_src, 3)).astype(np.float32))
    base = _t(rng.normal(size=(n_rows, 3)).astype(np.float32))
    br = _t(rng.permutation(n_rows).astype(np.int32))
    rows = op.rows["fwd"]
    np.testing.assert_array_equal(ell_apply_plain(rows, h).numpy(), 0.0)
    np.testing.assert_array_equal(ell_apply_plain(rows, h, base, br).numpy(),
                                  base[br.long()].numpy())


def test_work_order_edge_cases():
    """Long rows (past the threshold) come first, longest first, then the
    others longest first, ties in row order; degree-0 rows are listed."""
    deg = np.array([0, 5, 300, 2, 300, 0, 700, 1])
    rp = _t(np.concatenate([[0], np.cumsum(deg)]).astype(np.int32))
    work, n_long = work_order(rp, long_row=250)
    assert n_long == 3 and work.tolist() == [6, 2, 4, 1, 3, 7, 0, 5]
    work, n_long = work_order(rp, long_row=1000)
    assert n_long == 0 and work.tolist() == [6, 2, 4, 1, 3, 7, 0, 5]
    work, n_long = work_order(rp, long_row=300)
    assert n_long == 1 and work.tolist()[0] == 6


def _ell_case(graph):
    if graph == "sbm":
        g = sbm_graph(n_nodes=64, n_class=4, n_feat=6, p_in=0.2, p_out=0.01,
                      seed=11)
    else:   # rows above the split cap exercise the chunk combine
        g = synthetic_graph(n_nodes=400, avg_degree=40, n_feat=6, seed=5,
                            power_law=True)
    art = build_artifacts(g, partition_graph(g, 1))
    fs, bs, arrays = t_ell.build_layouts(art.src, art.dst, art.pad_inner,
                                         art.n_ext, geometry=art.ell_geometry)
    a0 = {k: v[0] for k, v in arrays.items()}
    op = t_ell.EllSpmm(fs, bs, {k: _t(v) for k, v in a0.items()})
    return art, fs, bs, a0, op


@pytest.mark.parametrize("graph", ["sbm", "powerlaw"])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("with_base", [False, True])
def test_ell_apply_plain_matches_jax(graph, direction, with_base):
    """ell_apply_plain == the JAX _ell_apply (== make_ell_spmm's forward and
    backward) + base[base_row], and == the CSR sum over the schedule; on a
    layout without split rows also == pallas_ell_apply in interpret mode."""
    art, fs, bs, a0, op = _ell_case(graph)
    spec = fs if direction == "fwd" else bs
    rows = op.rows[direction]
    rng = np.random.default_rng(7)
    h = rng.normal(size=(spec.n_src, 5)).astype(np.float32)
    base = base_row = None
    if with_base:
        base = rng.normal(size=(spec.n_rows + 5, 5)).astype(np.float32)
        base_row = rng.permutation(spec.n_rows + 5)[:spec.n_rows].astype(
            np.int32)
    idx = [a0[f"{direction}_idx_{k}"] for k in range(len(spec.widths))]
    ref = np.asarray(j_ell._ell_apply(
        spec, [jnp.asarray(i) for i in idx],
        jnp.asarray(a0[f"{direction}_perm"]), jnp.asarray(h),
        chunk_pos=(jnp.asarray(a0[f"{direction}_chunk_pos"])
                   if spec.n_split else None),
        chunk_seg=(jnp.asarray(a0[f"{direction}_chunk_seg"])
                   if spec.n_split else None)))
    if with_base:
        ref = base[base_row] + ref
    tb = None if base is None else _t(base)
    tbr = None if base_row is None else _t(base_row)
    ours = ell_apply_plain(rows, _t(h), tb, tbr).numpy()
    np.testing.assert_allclose(ours, ref, **TOL)
    np.testing.assert_allclose(_csr_sum(rows, _t(h), tb, tbr).numpy(), ref,
                               **TOL)
    if spec.n_split == 0:
        pal = np.asarray(pallas_ell_apply(
            spec, [jnp.asarray(i) for i in idx],
            jnp.asarray(a0[f"{direction}_perm"]), jnp.asarray(h),
            interpret=True))
        if with_base:
            pal = base[base_row] + pal
        np.testing.assert_allclose(ours, pal, **TOL)


def test_pack_rows_is_the_tables_function_on_a_hybrid_residual():
    """On a hybrid's residual (both directions, P=1) the CSR sum over the
    schedule with K2's output as the base equals ell_apply_plain with it:
    the fused base path the CPU run takes."""
    (op, a, _, _), = _hybrid_parts(1)
    rng = np.random.default_rng(5)
    for d, spec in (("fwd", op.fwd), ("bwd", op.bwd)):
        rows = op.residual.rows[d]
        h = _t(rng.normal(size=(rows.n_src, 4)).astype(np.float32))
        src, out = (("blk_perm_ext", "blk_perm_inner") if d == "fwd"
                    else ("blk_perm_inner", "blk_perm_ext"))
        dense = t_blk.dense_tiles(
            spec, a[f"blk_tiles_{d}"], a[f"blk_rowb_{d}"], a[f"blk_colb_{d}"],
            op.arrays[f"blk_off_{d}"], op.arrays[f"blk_ent_{d}"],
            op.arrays[f"blk_entoff_{d}"], a[src], h)
        got = ell_apply_plain(rows, h, dense, a[out])
        np.testing.assert_allclose(got.numpy(),
                                   _csr_sum(rows, h, dense, a[out]).numpy(),
                                   **TOL)
        np.testing.assert_allclose(got.numpy(),
                                   op.apply_dir(d, h, "check").numpy(), **TOL)
