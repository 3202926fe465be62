"""Hybrid dense-tile + ELL sparse aggregation (counterpart of
bnsgcn_tpu/ops/block_spmm.py).

On clustered graphs, with rows in a locality order, much of the edge mass
falls into a few dense adjacency tiles, which a dense matmul aggregates
cheaper per edge than row gathers:

  offline (numpy, copied from the JAX package so layouts are array-equal):
    * cluster_order: the native partitioner groups rows into ~n/target
      locality clusters (halo slots keep their order);
    * the (dst x src) adjacency is cut into [TR x TC] tiles; a tile with
      >= occupancy_min edges becomes a dense int8 tile of edge
      multiplicities, (row_block, col_block) ids sorted by row_block; every
      other edge goes to the bucketed-ELL residual;
    * the backward layout is the exact per-tile transpose.
  on the device, per pass:
    * x_slabs = h in cluster order as [n_cb, TC, H] slabs (plain indexing);
    * kernel K2 (ops/tile_matmul.py) sums tiles @ slabs into each output
      row-block, in cluster order: f32 slabs from the tiles' nonzero
      entries (packed once per layout, `pack_tiles`), bf16 and int8 slabs
      (transposed to K-major) on the tensor cores over the dense tiles;
      under --spmm-dense int8 the slabs are quantized first (one scale per
      call, or per slab where int32 row sums could wrap);
    * kernel K1 (ops/bucket_sum.py) sums the ELL residual's rows and adds
      K2's output, gathered back to row order by the permutation, in the
      same launch (ops/ell.py).

The backward runs the same two kernels on the transposed layouts, through a
torch.autograd.Function that saves only the layout.
"""

from __future__ import annotations

import copy
import sys
import time
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from bnsgcn_tpu_torch.ops.ell import (ELL_SPLIT_CAP, EllSpmm, GeoAccum,
                                     build_layouts, run_parallel)
from bnsgcn_tpu_torch.ops.tile_matmul import (MMA_KINDS, k_major,
                                              pack_tiles, row_offsets,
                                              tile_matmul, work_order)

TR = 512          # default dst rows per dense tile (square: transposes keep
TC = 512          # shape); --block-tile selects another edge


@dataclass(frozen=True)
class BlockSpec:
    """Static geometry of one direction's dense-tile layout."""
    n_rows: int                    # output rows (original id space)
    n_src: int                     # gatherable rows (original id space)
    row_tile: int
    col_tile: int
    n_blocks: int                  # padded dense-tile count
    n_row_blocks: int              # ceil(n_rows / row_tile)
    max_row_dense: int = 0         # max dense edges on any output row:
                                   # bounds an int8 tile path's int32
                                   # accumulator, |row sum| <= 127*127*this


def effective_occupancy(occupancy: int, tile_r: int = TR,
                        tile_c: int = TC) -> int:
    """Resolve the occupancy knob: 0 = auto, the byte break-even of a
    tile_r x tile_c int8 tile vs 512B gather rows (~tile_bytes/512 edges:
    512 at the default 512x512 tile, 128 at 256x256). Explicit values are
    absolute edge counts."""
    return occupancy if occupancy > 0 else max(tile_r * tile_c // 512, 16)


def _select_dense(tile_id, occupancy_min, tile_budget_bytes,
                  tile_bytes=TR * TC, need_inverse=True, n_tiles=None):
    """Which tiles densify: >= occupancy_min edges, highest-count tiles win
    under the device-memory budget (ties trimmed last).

    With `n_tiles` (the dense tile-grid extent) the unique pass runs as one
    O(E + n_tiles) bincount + rank LUT instead of np.unique's O(E log E)
    sort — bitwise-identical output (bincount indices are ascending, the
    same order np.unique emits; ~24x at 20M edges). The sort fallback
    covers grids too large to histogram."""
    if n_tiles is not None and n_tiles <= (1 << 26):
        cf = np.bincount(tile_id, minlength=n_tiles)
        uniq = np.flatnonzero(cf)
        counts = cf[uniq]
        if need_inverse:
            lut = np.zeros(n_tiles, dtype=np.int64)
            lut[uniq] = np.arange(len(uniq))
            inv = lut[tile_id]
        else:
            inv = None
    elif need_inverse:
        uniq, inv, counts = np.unique(tile_id, return_inverse=True,
                                      return_counts=True)
    else:
        uniq, counts = np.unique(tile_id, return_counts=True)
        inv = None
    max_tiles = max(int(tile_budget_bytes // tile_bytes), 1)
    dense_sel = counts >= occupancy_min
    if int(dense_sel.sum()) > max_tiles:
        # keep every tile strictly above the cut, trim only among ties
        thresh = np.sort(counts[dense_sel])[-max_tiles]
        above = counts > thresh
        ties = np.nonzero(dense_sel & (counts == thresh))[0]
        dense_sel = above
        dense_sel[ties[:max_tiles - int(above.sum())]] = True
    return uniq, inv, counts, dense_sel


def estimate_coverage(perm_rows, perm_cols, n_rows, n_src, rows, cols,
                      occupancy_min=512, tile_budget_bytes=2 << 30,
                      tile_r=TR, tile_c=TC) -> float:
    """Fraction of edges that would land on dense tiles under the given
    cluster order: the decision statistic of --spmm auto
    (bnsgcn_tpu/ops/block_spmm.py `estimate_coverage`). One O(E) histogram
    pass over exactly _build_tiles' selection rule; no tile stacks or
    residual tables are built. Edges beyond 127 per (tile, row, col) count
    as dense here though _build_tiles sends the excess to the residual, so
    on multigraphs of high multiplicity it can overstate coverage."""
    if len(rows) == 0:
        return 0.0
    n_cb = (n_src + tile_c - 1) // tile_c
    tile_id = (perm_rows[rows] // tile_r).astype(np.int64) * n_cb \
        + perm_cols[cols] // tile_c
    n_rb = (n_rows + tile_r - 1) // tile_r
    _, _, counts, dense_sel = _select_dense(tile_id, occupancy_min,
                                            tile_budget_bytes,
                                            tile_bytes=tile_r * tile_c,
                                            need_inverse=False,
                                            n_tiles=n_rb * n_cb)
    return float(counts[dense_sel].sum()) / float(len(rows))


def _build_tiles(perm_rows, perm_cols, n_rows, n_src, rows, cols,
                 occupancy_min, tile_budget_bytes=2 << 30,
                 tile_r=TR, tile_c=TC):
    """Dense tiles over cluster-ordered (rows x cols); fully vectorized.

    A tile densifies only if it carries >= occupancy_min edges (an int8
    512x512 tile costs TR*TC = 256KB of device-memory reads per pass plus its slab
    and output shares — byte break-even vs 512B-row gathers lands around
    ~512 edges, the default threshold; scale occupancy with tile area) AND
    the total dense storage stays under tile_budget_bytes (highest-count
    tiles win; ties trimmed last).
    Returns (tiles int8 [B,tile_r,tile_c] sorted by row_blk, row_blk,
    col_blk, residual_edge_mask, extra_rows, extra_cols, rle) — the extras
    are >127 multiplicity overflow in PERMUTED coordinates. Tiles fill by a
    cell-id sort + run-length encode (writes only occupied cells); peak
    transient memory is O(E), not O(tiles). `rle` is the occupied-cell
    encoding (cell ids, clamped int8 counts; None when no tile densifies):
    it lets the caller build the transposed bwd stack and the per-row dense
    maxima by O(occupied) scatter/bincount instead of more passes over the
    multi-GB stack."""
    n_cb = (n_src + tile_c - 1) // tile_c
    pr = perm_rows[rows]
    pc = perm_cols[cols]
    tile_id = (pr // tile_r).astype(np.int64) * n_cb + pc // tile_c
    n_rb = (n_rows + tile_r - 1) // tile_r
    uniq, inv, counts, dense_sel = _select_dense(tile_id, occupancy_min,
                                                 tile_budget_bytes,
                                                 tile_bytes=tile_r * tile_c,
                                                 n_tiles=n_rb * n_cb)
    B = int(dense_sel.sum())
    if B == 0:
        return (np.zeros((0, tile_r, tile_c), np.int8),
                np.zeros(0, np.int32),
                np.zeros(0, np.int32), np.ones(len(rows), dtype=bool),
                np.zeros(0, np.int64), np.zeros(0, np.int64), None)

    rank = np.full(len(uniq), -1, dtype=np.int64)
    rank[np.nonzero(dense_sel)[0]] = np.arange(B)        # uniq sorted => rb-major
    e_rank = rank[inv]
    m = e_rank >= 0
    resid_mask = ~m
    sel_ids = uniq[dense_sel]
    row_blk = (sel_ids // n_cb).astype(np.int32)
    col_blk = (sel_ids % n_cb).astype(np.int32)

    # fill by run-length encoding instead of a dense int accumulator: sort
    # the dense edges by exact cell id (tile-major), count runs, and write
    # only the OCCUPIED cells straight into the int8 stack. Replaces the
    # chunked np.add.at histogram + full-stack >127 scan + int32->int8
    # cast — each a pass over B*tile_r*tile_c elements — with one O(E log E)
    # sort plus O(E) writes.
    area = tile_r * tile_c
    tiles8 = np.zeros((B, tile_r, tile_c), dtype=np.int8)
    cell = (e_rank[m] * area + (pr[m] % tile_r) * tile_c
            + (pc[m] % tile_c))
    cell.sort()
    starts = np.concatenate(
        [[0], np.flatnonzero(np.diff(cell)) + 1]).astype(np.int64)
    uc = cell[starts]                                    # occupied cells
    cnt = np.diff(np.concatenate([starts, [len(cell)]]))
    cnt8 = np.minimum(cnt, 127).astype(np.int8)
    tiles8.reshape(-1)[uc] = cnt8
    over = cnt > 127                                     # int8 overflow:
    if over.any():                                       # excess -> residual
        rep = cnt[over] - 127
        ob = uc[over] // area
        orr = (uc[over] % area) // tile_c
        occ = uc[over] % tile_c
        extra_rows = np.repeat(orr + row_blk[ob].astype(np.int64) * tile_r,
                               rep)
        extra_cols = np.repeat(occ + col_blk[ob].astype(np.int64) * tile_c,
                               rep)
    else:
        extra_rows = extra_cols = np.zeros(0, np.int64)
    rle = (uc, cnt8)
    return tiles8, row_blk, col_blk, resid_mask, extra_rows, extra_cols, rle


def build_block_layouts(src_all, dst_all, n_dst, n_src_ext, perm_inner,
                        perm_ext, occupancy_min=512,
                        tile_budget_bytes=2 << 30,
                        tile_r=TR, tile_c=TC):
    """Hybrid layout for all local parts. perm_inner [P, n_dst] /
    perm_ext [P, n_src_ext]: cluster position per original row (the inner
    prefix of perm_ext must equal perm_inner).

    Returns (fwd BlockSpec, bwd BlockSpec, ell pair (spec, spec, buckets),
    arrays dict stacked on parts)."""
    P = src_all.shape[0]

    def one_part(p):
        real = dst_all[p] < n_dst
        s, d = src_all[p][real], dst_all[p][real]
        tiles, rb, cb, resid, xr, xc, rle = _build_tiles(
            perm_inner[p], perm_ext[p], n_dst, n_src_ext, d, s, occupancy_min,
            tile_budget_bytes, tile_r=tile_r, tile_c=tile_c)
        # excess-multiplicity edges come back in PERMUTED coordinates —
        # map to original ids for the residual ELL. perm_* are true
        # permutations, so the inverse is a single scatter
        orig_inner = np.empty(n_dst, dtype=np.intp)
        orig_inner[perm_inner[p]] = np.arange(n_dst)
        orig_ext = np.empty(n_src_ext, dtype=np.intp)
        orig_ext[perm_ext[p]] = np.arange(n_src_ext)
        return ((tiles, rb, cb, rle),
                np.concatenate([s[resid], orig_ext[xc]]),
                np.concatenate([d[resid], orig_inner[xr]]))

    # parts build concurrently (ell.run_parallel pool; results in part
    # order, so stacked layouts are bit-identical to the serial build)
    results = run_parallel([partial(one_part, p) for p in range(P)])
    per_part = [r[0] for r in results]
    res_src = [r[1] for r in results]
    res_dst = [r[2] for r in results]

    B = max(max(e[0].shape[0] for e in per_part), 1)
    # max dense edges on any single output row, per direction: the bound
    # `dense_mode` checks the int8 route's int32 accumulator against
    mrd_f = mrd_b = 0
    area = tile_r * tile_c
    for p, (tiles, rb, cb, rle) in enumerate(per_part):
        if tiles.shape[0] == 0:
            continue
        # O(occupied cells) bincount over the RLE: the clamped int8 counts
        # the stack stores, without another pass over the multi-GB stack
        uc, c8 = rle
        t = uc // area
        r = (uc % area) // tile_c
        c = uc % tile_c
        m_f = int(np.bincount(rb[t].astype(np.int64) * tile_r + r,
                              weights=c8).max())
        m_b = int(np.bincount(cb[t].astype(np.int64) * tile_c + c,
                              weights=c8).max())
        mrd_f, mrd_b = max(mrd_f, m_f), max(mrd_b, m_b)
    # residual geometry stats
    acc_f, acc_b = GeoAccum(ELL_SPLIT_CAP), GeoAccum(ELL_SPLIT_CAP)
    for p in range(P):
        acc_f.add_part(np.bincount(res_dst[p], minlength=n_dst))
        acc_b.add_part(np.bincount(res_src[p], minlength=n_src_ext))
    res_geometry = {"fwd": acc_f.finish(), "bwd": acc_b.finish()}
    n_rb_f = (n_dst + tile_r - 1) // tile_r
    n_rb_b = (n_src_ext + tile_c - 1) // tile_c

    def build_residual():
        # residual ELL over the leftover edges (shared fwd+bwd edge set)
        e_max = max(max((len(s) for s in res_src), default=0), 8)
        e_max = ((e_max + 7) // 8) * 8
        r_src = np.zeros((P, e_max), dtype=np.int32)
        r_dst = np.full((P, e_max), n_dst, dtype=np.int32)
        for p in range(P):
            k = len(res_src[p])
            r_src[p, :k] = res_src[p]
            r_dst[p, :k] = res_dst[p]
            res_src[p] = res_dst[p] = None
        return build_layouts(r_src, r_dst, n_dst, n_src_ext,
                             geometry=res_geometry)

    def build_stacks():
        nonlocal tiles_f
        if P == 1 and per_part[0][0].shape[0] == B:
            # single local part fills the stack exactly: alias instead of
            # a second 2+ GB copy (the fwd stack IS the part's tile stack)
            tiles_f = per_part[0][0][None]
        else:
            tiles_f = np.zeros((P, B, tile_r, tile_c), dtype=np.int8)
        for p in range(P):
            tiles, rb, cb, rle = per_part[p]
            bp = tiles.shape[0]
            if bp:
                if tiles_f.base is not tiles:
                    tiles_f[p, :bp] = tiles
                rowb_f[p, :bp] = rb
                colb_f[p, :bp] = cb
                # transpose: bwd tile (cb,rb) = fwd tile (rb,cb)^T, cb-sorted
                o = np.argsort(cb, kind="stable")
                # write the transposed stack straight from the occupied-cell
                # RLE: an O(occupied) scatter instead of a strided transpose
                # of the whole stack
                uc, c8 = rle
                t = uc // area
                r = (uc % area) // tile_c
                c = uc % tile_c
                pos_b = np.empty(bp, dtype=np.int64)
                pos_b[o] = np.arange(bp)
                tiles_b[p].reshape(-1)[pos_b[t] * area + c * tile_r + r] = c8
                rowb_b[p, :bp] = cb[o]
                colb_b[p, :bp] = rb[o]
            # release this part's stack as soon as it's copied (the P==1
            # alias survives through tiles_f.base)
            per_part[p] = None

    tiles_f = None
    rowb_f = np.full((P, B), n_rb_f, dtype=np.int32)
    colb_f = np.zeros((P, B), dtype=np.int32)
    tiles_b = np.zeros((P, B, tile_c, tile_r), dtype=np.int8)
    rowb_b = np.full((P, B), n_rb_b, dtype=np.int32)
    colb_b = np.zeros((P, B), dtype=np.int32)
    # residual ELL first, while the per-part stacks are the only live
    # multi-GB objects (its random gathers slow down under the page-table
    # pressure of the assembled fwd+bwd stacks)
    ell_fwd, ell_bwd, ell_arrays = build_residual()
    build_stacks()

    arrays = {
        "blk_tiles_fwd": tiles_f, "blk_rowb_fwd": rowb_f,
        "blk_colb_fwd": colb_f,
        "blk_tiles_bwd": tiles_b, "blk_rowb_bwd": rowb_b,
        "blk_colb_bwd": colb_b,
        "blk_perm_ext": perm_ext.astype(np.int32),
        "blk_perm_inner": perm_inner.astype(np.int32),
    }
    for k, v in ell_arrays.items():
        arrays[f"res_{k}"] = v

    fwd = BlockSpec(n_rows=n_dst, n_src=n_src_ext, row_tile=tile_r,
                    col_tile=tile_c, n_blocks=B, n_row_blocks=n_rb_f,
                    max_row_dense=mrd_f)
    bwd = BlockSpec(n_rows=n_src_ext, n_src=n_dst, row_tile=tile_c,
                    col_tile=tile_r, n_blocks=B, n_row_blocks=n_rb_b,
                    max_row_dense=mrd_b)
    return fwd, bwd, (ell_fwd, ell_bwd), arrays


def _compact_rank_perm(perm_full: np.ndarray, mask: np.ndarray,
                       n_pad: int) -> np.ndarray:
    """Cluster positions for a compact row subset
    (bnsgcn_tpu/ops/block_spmm.py _compact_rank_perm): compact row c, the
    c-th True of `mask`, takes the rank of its full cluster position among
    the subset, so the split layouts keep the full build's locality; the
    padded compact slots take the remaining positions."""
    rows = np.nonzero(mask)[0]
    vals = perm_full[rows]
    order = np.argsort(vals, kind="stable")
    rank = np.empty(len(rows), dtype=np.int64)
    rank[order] = np.arange(len(rows))
    out = np.empty(n_pad, dtype=np.int64)
    out[:len(rows)] = rank
    out[len(rows):] = np.arange(len(rows), n_pad)
    return out


def build_split_block_layouts(src_all, dst_all, n_dst, n_src_ext, perm_inner,
                              perm_ext, occupancy_min=512,
                              tile_budget_bytes=2 << 30,
                              tile_r=TR, tile_c=TC):
    """Interior/frontier row-partitioned hybrid layouts for --overlap split
    (bnsgcn_tpu/ops/block_spmm.py build_split_block_layouts): the row split
    of ops/ell.build_split_layouts as two complete hybrid builds, dense
    tiles and ELL residual each, the compact rows ordered by their rank in
    the full cluster order. The interior build gathers from the owned rows
    (its columns in the inner cluster order), the frontier build from the
    extended rows. Returns ((int_fwd, int_bwd, int_ell_pair), (fro_fwd,
    fro_bwd, fro_ell_pair), arrays, n_int_pad, n_fro_pad); arrays holds
    the two builds' tables under 'int_' / 'fro_' prefixes and 'merge_perm'
    [P, n_dst] int32."""
    from bnsgcn_tpu_torch.ops.spmm import split_row_partition
    P = src_all.shape[0]
    masks, merge_perm, (si, di, n_int_pad), (sf, df, n_fro_pad) = \
        split_row_partition(src_all, dst_all, n_dst)
    pi_int = np.stack([_compact_rank_perm(perm_inner[p], ~masks[p],
                                          n_int_pad) for p in range(P)])
    pi_fro = np.stack([_compact_rank_perm(perm_inner[p], masks[p],
                                          n_fro_pad) for p in range(P)])
    int_build, fro_build = run_parallel([
        partial(build_block_layouts, si, di, n_int_pad, n_dst,
                pi_int, perm_inner, occupancy_min=occupancy_min,
                tile_budget_bytes=tile_budget_bytes,
                tile_r=tile_r, tile_c=tile_c),
        partial(build_block_layouts, sf, df, n_fro_pad, n_src_ext,
                pi_fro, perm_ext, occupancy_min=occupancy_min,
                tile_budget_bytes=tile_budget_bytes,
                tile_r=tile_r, tile_c=tile_c)])
    int_f, int_b, int_pair, int_arr = int_build
    fro_f, fro_b, fro_pair, fro_arr = fro_build
    arrays = {"merge_perm": merge_perm}
    arrays.update({f"int_{k}": v for k, v in int_arr.items()})
    arrays.update({f"fro_{k}": v for k, v in fro_arr.items()})
    return ((int_f, int_b, int_pair), (fro_f, fro_b, fro_pair),
            arrays, n_int_pad, n_fro_pad)


def dense_edge_count(arrays, part: int = 0) -> int:
    """Diagnostic: number of edges carried by the dense tiles of one part
    (0 for a layout without dense tiles); a split layout's two stacks
    ('int_' and 'fro_') summed."""
    total = 0
    for key in ("blk_tiles_fwd", "int_blk_tiles_fwd", "fro_blk_tiles_fwd"):
        tiles = arrays.get(key)
        if tiles is not None:
            total += int(np.asarray(tiles[part]).sum(dtype=np.int64))
    return total


def build_x_slabs(spec: BlockSpec, perm_src, h):
    """h in cluster order, sliced into [n_cb, col_tile, H] slabs: row i of h
    lands at cluster position perm_src[i]; positions past n_src stay zero.
    Plain PyTorch (one scatter), as it was XLA outside the Pallas kernel."""
    n_cb = (spec.n_src + spec.col_tile - 1) // spec.col_tile
    x = h.new_zeros((n_cb * spec.col_tile, h.shape[1]))
    x[perm_src.long()] = h
    return x.view(n_cb, spec.col_tile, h.shape[1])


# the int32 accumulator of the int8 per-call route holds row sums of
# |q| <= 127 times multiplicities <= 127: a row with more dense edges than
# this could wrap (bnsgcn_tpu/ops/block_spmm.py `_I8_ROW_CAP`)
I8_ROW_CAP = (2 ** 31 - 1) // (127 * 127)
DENSE_DTYPES = ("native", "int8")


def dense_mode(spec: BlockSpec, dense_dtype: str,
               row_cap: int = I8_ROW_CAP) -> str:
    """How one direction's dense tiles run: 'native' (slabs in h's dtype),
    'int8' (one per-call scale, int32 sums: `dense_apply_pallas`) where the
    layout's max_row_dense keeps the int32 sums from wrapping, else
    'int8-slab' (per-slab scales rescaled to f32 per tile: `_dense_apply`'s
    int8 route, which the JAX package takes for such layouts)."""
    if dense_dtype == "native":
        return "native"
    if dense_dtype != "int8":
        raise ValueError(f"dense dtype {dense_dtype!r} is not one of "
                         f"{DENSE_DTYPES}")
    return "int8" if spec.max_row_dense <= row_cap else "int8-slab"


def quantize_slabs(x: torch.Tensor, per_slab: bool):
    """(int8 slabs, scale) of slabs x [n_cb, TC, H]: symmetric amax/127 with
    a 1e-30 floor, one scale for all slabs (`dense_apply_pallas`) or one per
    slab [n_cb] (`_dense_apply`); round half to even, clip to +-127. The
    int8 slabs are K-major, [n_cb, H, TC], as the tensor-core K2 reads them
    (one transposing copy of the int8 bytes)."""
    xf = x.float()
    amax = xf.abs().amax(dim=(1, 2)) if per_slab else xf.abs().amax()
    scale = (amax / 127.0).clamp(min=1e-30)
    s = scale[:, None, None] if per_slab else scale
    return k_major(torch.round(xf / s).clamp(-127, 127).to(torch.int8)), \
        scale


def dense_tiles(spec: BlockSpec, tiles, rowb, colb, off, ent, ent_off,
                perm_src, h, mode: str = "native",
                phase: str = "fwd", order=None) -> torch.Tensor:
    """Dense-tile aggregation through K2, [n_row_blocks * row_tile, H] f32
    in cluster order (a row-block no tile visits is zero): what
    bnsgcn_tpu/ops/pallas_block.py `dense_apply_pallas` computes before its
    cast to h's dtype and its permutation gather, which K1 applies here
    (`mode` as `dense_mode` gives it; 'int8' scales K2's int32 sums back
    here, 'int8-slab' inside K2). `off` is row_offsets(rowb), (ent,
    ent_off) pack_tiles(tiles), `order` work_order(off)."""
    x = build_x_slabs(spec, perm_src, h.contiguous())
    scale = None
    if mode != "native":
        x, scale = quantize_slabs(x, per_slab=mode == "int8-slab")
    elif x.dtype in MMA_KINDS:
        x = k_major(x)
    out = tile_matmul(tiles, rowb, colb, off, ent, ent_off, x,
                      spec.n_row_blocks,
                      slab_scale=scale if mode == "int8-slab" else None,
                      phase=phase, order=order)
    if mode == "int8":
        out = out.float() * scale
    return out.view(spec.n_row_blocks * spec.row_tile, h.shape[1])


class BlockSpmm:
    """spmm(h_ext [n_src_ext, H]) -> [n_dst, H]: dense tiles through K2, then
    the ELL residual through K1, which adds K2's output (in cluster order,
    gathered back to row order by the permutation) to its own row sums in
    the same launch, in h's dtype. The backward runs K2 on the transposed
    tiles and the residual with the fwd/bwd roles swapped. `arrays` holds
    one part's layout as device tensors (build_block_layouts' keys, without
    the part axis); `self.arrays` adds what K2 walks, for each direction d:
    the CSR offsets over rowb (`blk_off_d`), the row-blocks' work order
    (`blk_order_d`) and the tiles' packed nonzero entries (`blk_ent_d`,
    `blk_entoff_d`). These and the residual's row schedules are layout
    set-up, timed together as `pack_seconds`.
    gather_dtype quantizes the residual's gathers (ops/ell.py EllSpmm);
    dense_dtype 'int8' the dense tiles' slabs, each direction in the mode
    `dense_mode` picks from its max_row_dense and `row_cap`. Counterpart of
    bnsgcn_tpu/ops/block_spmm.py `make_block_spmm` with use_pallas."""

    def __init__(self, fwd: BlockSpec, bwd: BlockSpec, ell_pair, arrays: dict,
                 gather_dtype: str = "native", dense_dtype: str = "native",
                 row_cap: int = I8_ROW_CAP):
        self.fwd, self.bwd = fwd, bwd
        self.mode = {"fwd": dense_mode(fwd, dense_dtype, row_cap),
                     "bwd": dense_mode(bwd, dense_dtype, row_cap)}
        self.arrays = dict(arrays)
        t0 = time.perf_counter()
        for d, spec in (("fwd", fwd), ("bwd", bwd)):
            self.arrays[f"blk_off_{d}"] = row_offsets(arrays[f"blk_rowb_{d}"],
                                                      spec.n_row_blocks)
            self.arrays[f"blk_order_{d}"] = work_order(
                self.arrays[f"blk_off_{d}"])
            (self.arrays[f"blk_ent_{d}"],
             self.arrays[f"blk_entoff_{d}"]) = pack_tiles(
                arrays[f"blk_tiles_{d}"])
        self.residual = EllSpmm(
            ell_pair[0], ell_pair[1],
            {k[len("res_"):]: v for k, v in arrays.items()
             if k.startswith("res_")}, gather_dtype=gather_dtype)
        self.pack_seconds = time.perf_counter() - t0   # ends in a host read

    def with_dtypes(self, gather_dtype: str, dense_dtype: str,
                    row_cap: int = I8_ROW_CAP) -> "BlockSpmm":
        """The same layout (shared, not packed again) with other gather and
        dense dtypes, the dense modes picked at `row_cap`."""
        op = copy.copy(self)
        op.mode = {"fwd": dense_mode(self.fwd, dense_dtype, row_cap),
                   "bwd": dense_mode(self.bwd, dense_dtype, row_cap)}
        op.residual = self.residual.with_dtypes(gather_dtype)
        return op

    def apply_dir(self, direction: str, h, phase: str, native: bool = False):
        """The direction's aggregation of h in h's dtype; `native` runs the
        dense tiles and the gathers in h's dtype whatever the operator's
        dtypes say (the use_pp precompute's codecs)."""
        a = self.arrays
        if direction == "fwd":
            src, out = a["blk_perm_ext"], a["blk_perm_inner"]
        else:
            src, out = a["blk_perm_inner"], a["blk_perm_ext"]
        dense = dense_tiles(
            self.fwd if direction == "fwd" else self.bwd,
            a[f"blk_tiles_{direction}"], a[f"blk_rowb_{direction}"],
            a[f"blk_colb_{direction}"], a[f"blk_off_{direction}"],
            a[f"blk_ent_{direction}"], a[f"blk_entoff_{direction}"], src, h,
            mode="native" if native else self.mode[direction], phase=phase,
            order=a[f"blk_order_{direction}"])
        return self.residual.apply_dir(direction, h, phase, base=dense,
                                       base_row=out, native=native)

    def __call__(self, h, phase: str = "fwd"):
        return _BlockFn.apply(h, self, phase)


class _BlockFn(torch.autograd.Function):
    # saves only the layout (held by `op`), never the activations

    @staticmethod
    def forward(ctx, h, op: BlockSpmm, phase: str):
        ctx.op = op
        return op.apply_dir("fwd", h, phase)

    @staticmethod
    def backward(ctx, g):
        return ctx.op.apply_dir("bwd", g, "bwd").to(g.dtype), None, None


def cluster_order(src, dst, n_rows, n_ext, target=TC, log=None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Locality permutation of the (inner, extended) row spaces.

    Inner rows: clustered by the native partitioner (LDG streaming + light
    refinement) into ~n_rows/target balanced groups, ordered group-major.
    Halo rows keep their slot order. Returns (perm_inner [n_rows], perm_ext
    [n_ext]): each row's position in cluster order; the inner prefix of
    perm_ext equals perm_inner.

    Says which order it used (to `log`, default stderr): an identity order
    leaves the dense-tile kernel with almost no tiles, so a fallback must
    never pass unnoticed."""
    log = log or (lambda m: print(m, file=sys.stderr))
    n_clusters = max(int(np.ceil(n_rows / max(target, 1))), 1)
    order = None
    src = np.asarray(src)
    dst = np.asarray(dst)
    inner = (src < n_rows) & (dst < n_rows)
    if n_clusters > 1 and inner.any():
        from bnsgcn_tpu_torch.native import native_partition
        try:
            cid = native_partition(src[inner], dst[inner], n_rows, n_clusters,
                                   obj="cut", seed=0, refine_passes=2,
                                   n_seeds=1)
        except RuntimeError as e:
            log(f"[cluster_order] identity order: native partitioner "
                f"unavailable ({e})")
        else:
            order = np.argsort(cid, kind="stable")
            log(f"[cluster_order] native clustering: {n_rows} rows into "
                f"{n_clusters} clusters of ~{target}")
    else:
        log(f"[cluster_order] identity order: {n_clusters} cluster(s) for "
            f"{n_rows} rows")
    if order is None:
        order = np.arange(n_rows)
    perm_inner = np.empty(n_rows, dtype=np.int64)
    perm_inner[order] = np.arange(n_rows)
    perm_ext = np.concatenate([perm_inner,
                               np.arange(n_rows, n_ext, dtype=np.int64)])
    return perm_inner, perm_ext
