"""Bucketed-ELLPACK sparse aggregation (counterpart of bnsgcn_tpu/ops/ell.py).

The same aggregation `out[v] = sum_{e: dst_e == v} h[src_e]` as dense,
scatter-free work:

  * offline (numpy, per part; copied from the JAX package so the layouts are
    array-equal, tests/test_torch_data.py): destination rows grouped by
    in-degree into power-of-two buckets, each stored as a dense [rows, width]
    index table padded with the index n_src; rows of degree > 128 split into
    128-wide chunks;
  * once per layout (`EllSpmm`), plain torch on the device: the row
    schedule kernel K1 reads (ops/bucket_sum.py `pack_rows`), the tables'
    terms as a CSR in final row order plus a work order;
  * on the device, per pass: one launch of K1 (CUDA on the card) computes
    every row's sum, the split rows' chunks joined, in row order; on the CPU
    the plain version runs the tables (bucket sums, the split-row combine,
    the permutation gather); with --spmm-gather int8 or fp8 the gathered
    rows are quantized first, one scale per call;
  * the backward runs the transposed layout (rows = source nodes, grouped by
    out-degree) through a torch.autograd.Function, so d_h is the same
    scatter-free shape.
"""

from __future__ import annotations

import copy
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from functools import partial
from typing import Sequence

import numpy as np
import torch

from bnsgcn_tpu_torch.ops.bucket_sum import ell_apply, pack_rows
from bnsgcn_tpu_torch.utils.quant import f8_quant, i8_quant


def run_parallel(fns):
    """Run thunks in a thread pool (results in order): the layout builds run
    per part and per direction, mostly inside numpy, which releases the
    interpreter lock. Serial for a single thunk."""
    w = max(1, min(8, os.cpu_count() or 1, len(fns)))
    if w <= 1:
        return [f() for f in fns]
    with ThreadPoolExecutor(max_workers=w) as ex:
        futs = [ex.submit(f) for f in fns]
        return [f.result() for f in futs]


ELL_SPLIT_CAP = 128   # rows with degree > cap are split into cap-wide chunks


def grouped_order(keys: np.ndarray, n_keys: int) -> np.ndarray:
    """Stable argsort of small-int `keys` — the layout builders' dominant
    pass (edges sorted by destination row). Fast path packs (key, index)
    into one int64 and runs numpy's SIMD quicksort: the packed keys are
    distinct, so the unstable sort reproduces the kind='stable' order
    exactly (~7x on 20M edges, numpy 2.0). Falls back to stable argsort
    when the packed key would overflow int64."""
    n = len(keys)
    bits = max(int(n - 1).bit_length(), 1)
    if n and (int(n_keys) << bits) < 2**63:
        packed = (keys.astype(np.int64) << bits) \
            | np.arange(n, dtype=np.int64)
        packed.sort()
        return packed & ((1 << bits) - 1)
    return np.argsort(keys, kind="stable")


@dataclass(frozen=True)
class EllSpec:
    """Static bucket geometry (identical across parts)."""
    widths: tuple[int, ...]            # bucket ELL widths, ascending powers of 2
    rows: tuple[int, ...]              # padded row count per bucket
    n_rows: int                        # output rows (n_dst for fwd, n_src_ext for bwd)
    n_src: int                         # gatherable rows (n_src_ext for fwd, n_dst for bwd)
    n_split: int = 0                   # padded count of split (degree > cap) rows
    n_chunks: int = 0                  # padded count of their cap-wide chunks


def _bucketize(deg: np.ndarray, widths: Sequence[int]) -> np.ndarray:
    """bucket index per row; deg 0 -> -1 (skipped)."""
    b = np.full(deg.shape, -1, dtype=np.int32)
    lo = 0
    for k, w in enumerate(widths):
        b[(deg > lo) & (deg <= w)] = k
        lo = w
    return b


def build_ell_numpy(src: np.ndarray, dst: np.ndarray, n_rows: int, n_src: int,
                    widths: Sequence[int] | None = None,
                    row_pad: Sequence[int] | None = None,
                    cap: int | None = None,
                    split_pad: int = 0, chunk_pad: int = 0):
    """Build one part's ELL tables for `out[r] = sum_{e: dst_e == r} h[src_e]`.

    Padded edges must already point at dst == n_rows (they are dropped).
    Returns (widths, rows_per_bucket, idx_arrays, perm, chunk_pos, chunk_seg).

    Split-row scheme (`cap`): rows with degree > cap become ceil(deg/cap)
    cap-wide pseudo-rows appended to the cap bucket (cutting the power-law
    padding waste from ~1.5x to ~1.15x of E); their partial sums are combined
    by a tiny sorted segment-sum over `chunk_pos`/`chunk_seg`. Table layout:
    [bucket rows 0..T-1 ; combine results T..T+split_pad-1 ; zero row].
    `perm[r]` points a normal row at its bucket position, a split row at its
    combine slot, and a degree-0 row at the zero row.
    """
    if cap is not None and (cap < 4 or cap & (cap - 1)):
        raise ValueError(f"split cap must be a power of two >= 4, got {cap}")
    real = dst < n_rows
    src, dst = src[real], dst[real]
    deg = np.bincount(dst, minlength=n_rows)
    split_mask = (deg > cap) if cap else np.zeros(n_rows, dtype=bool)
    deg_b = np.where(split_mask, 0, deg)
    if widths is None:
        # ladder from the FULL degree distribution so it reaches cap whenever
        # any row splits (deg_b alone would stop short of cap)
        widths = _choose_widths(deg, cap=cap)
    if cap and split_mask.any() and widths[-1] != cap:
        raise ValueError(f"width ladder {widths} must end at cap={cap} "
                         f"when split rows exist")
    bucket = _bucketize(deg_b, widths)

    order = grouped_order(dst, n_rows)
    src_sorted = src[order]
    dst_sorted = dst[order]
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])

    # split bookkeeping: pseudo-row base per split row, chunk segments
    split_rows = np.nonzero(split_mask)[0]
    n_split = len(split_rows)
    chunks_per = np.ceil(deg[split_rows] / cap).astype(np.int64) if n_split else         np.zeros(0, np.int64)
    n_pseudo = int(chunks_per.sum())
    assert n_split <= max(split_pad, 0) or split_pad == 0
    pseudo_base = np.zeros(n_rows, dtype=np.int64)
    if n_split:
        pseudo_base[split_rows] = np.concatenate([[0], np.cumsum(chunks_per)[:-1]])

    # fully vectorized fill: for each edge, its (bucket, row-within-bucket,
    # slot-within-row) — no per-row python loop (matters at 100M edges)
    rpos = np.zeros(n_rows, dtype=np.int64)
    within = np.arange(len(dst_sorted), dtype=np.int64) - indptr[dst_sorted]
    e_bucket = bucket[dst_sorted]
    e_split = split_mask[dst_sorted]

    rows_per_bucket = []
    perm = np.zeros(n_rows, dtype=np.int32)
    offset = 0
    cap_k = len(widths) - 1
    # bucket geometry in one cheap row-level pass, shared by both fill paths
    flat_base = np.zeros(len(widths) + 1, dtype=np.int64)
    cap_offset = cap_normal = 0
    for k, w in enumerate(widths):
        rows_k = np.nonzero(bucket == k)[0]
        n_k = len(rows_k)
        extra = n_pseudo if (cap and k == cap_k) else 0
        pad_rows = row_pad[k] if row_pad is not None else n_k + extra
        assert pad_rows >= n_k + extra
        rpos[rows_k] = np.arange(n_k)
        perm[rows_k] = offset + np.arange(n_k, dtype=np.int32)
        if cap and k == cap_k:
            cap_offset, cap_normal = offset, n_k
        rows_per_bucket.append(pad_rows)
        offset += pad_rows
        flat_base[k + 1] = flat_base[k] + pad_rows * w
    total = offset                                 # table rows T

    # one flat table + one collision-free scatter for ALL buckets —
    # each edge owns a distinct (row, slot), so a single fancy-index
    # write replaces the per-bucket O(E x buckets) full-edge masks
    idx_flat = np.full(int(flat_base[-1]), n_src, dtype=np.int32)
    w_arr = np.asarray(widths, dtype=np.int64)
    ns = ~e_split
    eb = e_bucket[ns]
    idx_flat[flat_base[eb] + rpos[dst_sorted[ns]] * w_arr[eb]
             + within[ns]] = src_sorted[ns]
    if n_pseudo:
        es = e_split
        pr = cap_normal + pseudo_base[dst_sorted[es]] + within[es] // cap
        idx_flat[flat_base[cap_k] + pr * w_arr[cap_k]
                 + within[es] % cap] = src_sorted[es]
    idx_arrays = [idx_flat[flat_base[k]:flat_base[k + 1]]
                  .reshape(rows_per_bucket[k], w)
                  for k, w in enumerate(widths)]

    sp = split_pad if split_pad else ((n_split + 7) // 8 * 8 if n_split else 0)
    cp = chunk_pad if chunk_pad else ((n_pseudo + 7) // 8 * 8 if n_pseudo else 0)
    # chunk_pos indexes the CAP BUCKET's rows (plus one appended zero row at
    # rows_per_bucket[-1]) — not the whole table — so the combine gathers from
    # the cap bucket output directly without re-materializing the table
    cap_rows = rows_per_bucket[-1] if rows_per_bucket else 0
    chunk_pos = np.full(cp, cap_rows, dtype=np.int32)   # pad -> appended zero row
    chunk_seg = np.full(cp, sp, dtype=np.int32)         # pad -> dropped segment
    # row_of[table_pos] = the output row this table row computes (split
    # pseudo-rows map to their split source; padding -> n_rows). Consumers
    # that need per-table-row context (GAT attention broadcasts el/z by row)
    # index with this.
    row_of = np.full(total, n_rows, dtype=np.int32)
    normal = (bucket >= 0)
    rws = np.nonzero(normal)[0]
    row_of[perm[rws]] = rws
    if n_split:
        chunk_pos[:n_pseudo] = cap_normal + np.arange(n_pseudo)
        chunk_seg[:n_pseudo] = np.repeat(np.arange(n_split), chunks_per)
        perm[split_rows] = total + np.arange(n_split, dtype=np.int32)
        row_of[cap_offset + cap_normal + np.arange(n_pseudo)] = \
            np.repeat(split_rows, chunks_per)
    perm[(bucket == -1) & ~split_mask] = total + sp     # zero row
    return (tuple(widths), tuple(rows_per_bucket), idx_arrays, perm,
            chunk_pos, chunk_seg, row_of)


def _choose_widths(deg: np.ndarray, cap: int | None = None) -> tuple[int, ...]:
    """Power-of-2 bucket-width ladder from 4 up to min(max degree, cap).

    (An edge-mass-quantile scheme was tried and measured *slower* on a v5e
    despite ~25% fewer padded gathers — wide low-row-count buckets hurt the
    gather/reduce pipeline more than padding does. Keep the ladder; the
    split-row cap handles the power-law tail instead.)
    """
    deg = deg[deg > 0]
    max_deg = int(deg.max()) if deg.size else 1
    if cap:
        max_deg = min(max_deg, cap)
    widths, w = [], 4
    while True:
        widths.append(w)
        if w >= max(max_deg, 1):
            break
        w *= 2
    return tuple(widths)


def _part_edges(src, dst, n_dst, direction):
    """Real edges of one part, oriented for the requested layout direction."""
    real = dst < n_dst
    if direction == "fwd":             # rows = dst, gather = src
        return src[real], dst[real]
    return dst[real], src[real]        # rows = src(ext), gather = dst


def compute_geometry(src_all: np.ndarray, dst_all: np.ndarray, n_dst: int,
                     n_src_ext: int, cap: int = ELL_SPLIT_CAP,
                     directions: tuple = ("fwd", "bwd")) -> dict:
    """Global ELL geometry (widths, padded rows, split/chunk pads) for both
    directions — a pure graph property needing the FULL set of parts.
    JSON-serializable so the offline partitioner can store it in meta.json,
    letting multi-host processes build their ELL tables from local parts
    alone (data/artifacts.py)."""
    P = src_all.shape[0]
    geo = {}
    for direction in directions:
        n_rows = n_dst if direction == "fwd" else n_src_ext
        degs = []
        for p in range(P):
            _, d = _part_edges(src_all[p], dst_all[p], n_dst, direction)
            degs.append(np.bincount(d, minlength=n_rows))
        all_deg = np.concatenate(degs)
        widths = _choose_widths(all_deg, cap=cap)
        eff_cap = cap if (cap and all_deg.max() > cap) else None
        rows_max = [0] * len(widths)
        split_max = chunk_max = 0
        for d in degs:
            split = (d > eff_cap) if eff_cap else np.zeros_like(d, dtype=bool)
            b = _bucketize(np.where(split, 0, d), widths)
            for k in range(len(widths)):
                rows_max[k] = max(rows_max[k], int(np.sum(b == k)))
            if eff_cap:
                split_max = max(split_max, int(split.sum()))
                chunk_max = max(chunk_max, int(np.ceil(d[split] / eff_cap).sum()))
        if eff_cap:
            rows_max[-1] += chunk_max          # pseudo-rows live in the cap bucket
        pad8 = lambda r: ((r + 7) // 8) * 8 if r else 0
        geo[direction] = {
            "widths": [int(w) for w in widths],
            "rows": [pad8(r) for r in rows_max],
            "split": pad8(split_max), "chunks": pad8(chunk_max),
            "cap": eff_cap,
        }
    return geo


def build_layouts(src_all: np.ndarray, dst_all: np.ndarray, n_dst: int,
                  n_src_ext: int, cap: int = ELL_SPLIT_CAP,
                  geometry: dict | None = None
                  ) -> tuple[EllSpec, EllSpec, dict]:
    """Build stacked fwd (rows = dst) and bwd (rows = src_ext) ELL layouts.

    src_all/dst_all: [P_local, E] artifact edge arrays — may be a subset of
    parts when `geometry` (from compute_geometry, possibly via meta.json)
    provides the global pads. Returns (fwd_spec, bwd_spec, arrays) with
    arrays = {'{dir}_idx_k', '{dir}_perm', '{dir}_chunk_pos',
    '{dir}_chunk_seg'} stacked on the leading local-part axis.
    """
    P = src_all.shape[0]
    if geometry is None:
        geometry = compute_geometry(src_all, dst_all, n_dst, n_src_ext, cap)

    def build_all(direction):
        n_rows = n_dst if direction == "fwd" else n_src_ext
        n_src = n_src_ext if direction == "fwd" else n_dst
        g = geometry[direction]
        widths = tuple(g["widths"])
        rows_max = tuple(g["rows"])
        split_max, chunk_max, eff_cap = g["split"], g["chunks"], g["cap"]

        def build_one(p):
            s, d = _part_edges(src_all[p], dst_all[p], n_dst, direction)
            _, _, idx, perm, cp, cs, _ = build_ell_numpy(
                s, d, n_rows, n_src, widths=widths, row_pad=rows_max,
                cap=eff_cap, split_pad=split_max, chunk_pad=chunk_max)
            return idx, perm, cp, cs

        results = run_parallel([partial(build_one, p) for p in range(P)])
        idx_stacked = [[r[0][k] for r in results] for k in range(len(widths))]
        perms = [r[1] for r in results]
        cpos = [r[2] for r in results]
        csegs = [r[3] for r in results]
        spec = EllSpec(widths=widths, rows=rows_max, n_rows=n_rows,
                       n_src=n_src, n_split=split_max, n_chunks=chunk_max)
        return (spec, [np.stack(x) for x in idx_stacked], np.stack(perms),
                np.stack(cpos), np.stack(csegs))

    (fwd_spec, fwd_idx, fwd_perm, fwd_cp, fwd_cs), \
        (bwd_spec, bwd_idx, bwd_perm, bwd_cp, bwd_cs) = run_parallel(
            [partial(build_all, "fwd"), partial(build_all, "bwd")])
    arrays = {"fwd_perm": fwd_perm, "bwd_perm": bwd_perm}
    if fwd_spec.n_split:
        arrays["fwd_chunk_pos"], arrays["fwd_chunk_seg"] = fwd_cp, fwd_cs
    if bwd_spec.n_split:
        arrays["bwd_chunk_pos"], arrays["bwd_chunk_seg"] = bwd_cp, bwd_cs
    for k in range(len(fwd_spec.widths)):
        arrays[f"fwd_idx_{k}"] = fwd_idx[k]
    for k in range(len(bwd_spec.widths)):
        arrays[f"bwd_idx_{k}"] = bwd_idx[k]
    return fwd_spec, bwd_spec, arrays


def build_split_layouts(src_all: np.ndarray, dst_all: np.ndarray, n_dst: int,
                        n_src_ext: int, cap: int = ELL_SPLIT_CAP):
    """Interior/frontier row-partitioned ELL layouts for --overlap split
    (bnsgcn_tpu/ops/ell.py build_split_layouts): the rows of
    ops/spmm.split_row_partition, each side a complete build_layouts pair.
    The interior pair gathers from the owned rows (n_src = n_dst), so its
    backward emits d_h; the frontier pair gathers from the extended rows
    and its backward emits d_h_ext. Every output row's whole edge set lands
    on one side, so concat(int_out, fro_out)[merge_perm] is the fused
    aggregation row for row. Returns ((int_fwd, int_bwd), (fro_fwd,
    fro_bwd), arrays, n_int_pad, n_fro_pad); arrays holds the two builds'
    tables under 'int_' / 'fro_' prefixes and 'merge_perm' [P, n_dst]
    int32."""
    from bnsgcn_tpu_torch.ops.spmm import split_row_partition
    _, merge_perm, (si, di, n_int_pad), (sf, df, n_fro_pad) = \
        split_row_partition(src_all, dst_all, n_dst)
    (int_f, int_b, int_arr), (fro_f, fro_b, fro_arr) = run_parallel([
        partial(build_layouts, si, di, n_int_pad, n_dst, cap=cap),
        partial(build_layouts, sf, df, n_fro_pad, n_src_ext, cap=cap)])
    arrays = {"merge_perm": merge_perm}
    arrays.update({f"int_{k}": v for k, v in int_arr.items()})
    arrays.update({f"fro_{k}": v for k, v in fro_arr.items()})
    return (int_f, int_b), (fro_f, fro_b), arrays, n_int_pad, n_fro_pad


def _pow2_bucket(deg: np.ndarray) -> np.ndarray:
    """Ladder bucket index of each positive degree for widths (4, 8, 16, ...):
    deg in (0,4] -> 0, (4,8] -> 1, (2^j, 2^(j+1)] -> j-1 (matches
    ops/ell._bucketize against ops/ell._choose_widths ladders exactly)."""
    d = np.maximum(deg, 1)
    return np.maximum(np.ceil(np.log2(d)).astype(np.int64), 2) - 2


class GeoAccum:
    """Accumulates per-part degree statistics into the compute_geometry dict
    without holding any stacked arrays: per-part pow2-bucket counts (below the
    cap), split-row counts and chunk sums (above it), and the global max."""

    def __init__(self, cap):
        self.cap = cap
        self.rows_max = np.zeros(64, dtype=np.int64)
        self.split_max = 0
        self.chunk_max = 0
        self.max_deg = 0

    def add_part(self, deg: np.ndarray):
        deg = deg[deg > 0]
        if deg.size == 0:
            return
        self.max_deg = max(self.max_deg, int(deg.max()))
        if self.cap:
            over = deg > self.cap
            n_split = int(over.sum())
            if n_split:
                self.split_max = max(self.split_max, n_split)
                self.chunk_max = max(self.chunk_max, int(
                    np.ceil(deg[over] / self.cap).sum()))
                deg = deg[~over]
        if deg.size:
            b = np.bincount(_pow2_bucket(deg), minlength=64)
            self.rows_max = np.maximum(self.rows_max, b)

    def state(self) -> "np.ndarray":
        """Fixed-size mergeable stats vector (for cross-host agreement):
        [rows_max[64], split_max, chunk_max, max_deg]."""
        return np.concatenate([self.rows_max,
                               [self.split_max, self.chunk_max, self.max_deg]]
                              ).astype(np.int64)

    def merge_state(self, state: "np.ndarray"):
        """Elementwise-max another accumulator's state() into this one."""
        self.rows_max = np.maximum(self.rows_max, state[:64])
        self.split_max = max(self.split_max, int(state[64]))
        self.chunk_max = max(self.chunk_max, int(state[65]))
        self.max_deg = max(self.max_deg, int(state[66]))

    def finish(self) -> dict:
        if self.max_deg == 0:
            return {"widths": [4], "rows": [0], "split": 0, "chunks": 0,
                    "cap": None}
        fake = np.asarray([self.max_deg])
        widths = _choose_widths(fake, cap=self.cap)
        eff_cap = self.cap if (self.cap and self.max_deg > self.cap) else None
        rows = [int(r) for r in self.rows_max[:len(widths)]]
        pad8 = lambda r: ((r + 7) // 8) * 8 if r else 0
        split = chunks = 0
        if eff_cap:
            split, chunks = pad8(self.split_max), pad8(self.chunk_max)
            rows[-1] += self.chunk_max
        return {"widths": [int(w) for w in widths], "rows": [pad8(r) for r in rows],
                "split": split, "chunks": chunks, "cap": eff_cap}


# ----------------------------------------------------------------------------
# on the device
# ----------------------------------------------------------------------------

GATHER_DTYPES = ("native", "int8", "fp8")


def gather_quant(h: torch.Tensor, gather_dtype: str):
    """(rows K1 gathers, their scale or None): h itself for 'native', else
    h quantized to int8 or e4m3 with one per-call scale
    (bnsgcn_tpu/ops/ell.py `_ell_apply`)."""
    if gather_dtype == "native":
        return h, None
    if gather_dtype == "int8":
        return i8_quant(h)
    if gather_dtype == "fp8":
        return f8_quant(h)
    raise ValueError(f"gather dtype {gather_dtype!r} is not one of "
                     f"{GATHER_DTYPES}")


class EllSpmm:
    """spmm(h_ext [n_src, H]) -> [n_dst, H] over one part's layout arrays
    (device tensors keyed as build_layouts names them, without the part
    axis); the backward runs the bwd_* layout. `rows[d]` is direction d's
    K1 layout (ops/bucket_sum.py `EllRows`): the tables and the row schedule
    packed from them here, layout set-up timed as `pack_seconds`.
    gather_dtype 'int8' / 'fp8' quantizes what each pass gathers with one
    scale per call, the backward's cotangent with its own, and rounds the
    scaled sums to h's dtype. Counterpart of bnsgcn_tpu/ops/ell.py
    `make_ell_spmm`."""

    def __init__(self, fwd_spec: EllSpec, bwd_spec: EllSpec, arrays: dict,
                 gather_dtype: str = "native"):
        if gather_dtype not in GATHER_DTYPES:
            raise ValueError(f"gather dtype {gather_dtype!r} is not one of "
                             f"{GATHER_DTYPES}")
        self.gather_dtype = gather_dtype
        t0 = time.perf_counter()
        self.rows = {}
        for d, spec in (("fwd", fwd_spec), ("bwd", bwd_spec)):
            self.rows[d] = pack_rows(
                spec, [arrays[f"{d}_idx_{k}"] for k in range(len(spec.widths))],
                arrays[f"{d}_perm"], arrays.get(f"{d}_chunk_pos"),
                arrays.get(f"{d}_chunk_seg"))
        self.pack_seconds = time.perf_counter() - t0   # ends in a host read

    def with_dtypes(self, gather_dtype: str, dense_dtype: str = "native",
                    row_cap: int = 0) -> "EllSpmm":
        """The same layout (shared, not packed again) gathering in
        `gather_dtype`; dense_dtype and row_cap, BlockSpmm's, mean nothing
        here."""
        if gather_dtype not in GATHER_DTYPES:
            raise ValueError(f"gather dtype {gather_dtype!r} is not one of "
                             f"{GATHER_DTYPES}")
        op = copy.copy(self)
        op.gather_dtype = gather_dtype
        return op

    def apply_dir(self, direction: str, h, phase: str, base=None,
                  base_row=None, native: bool = False):
        """The direction's aggregation of h in h's dtype, plus
        base[base_row] if given, through K1 on a CUDA tensor and its plain
        version on the CPU; `native` gathers h itself whatever
        gather_dtype says (the use_pp precompute's codecs)."""
        hq, scale = gather_quant(h.contiguous(),
                                 "native" if native else self.gather_dtype)
        return ell_apply(self.rows[direction], hq.contiguous(), base,
                         base_row, scale=scale,
                         out_dtype=None if scale is None else h.dtype,
                         phase=phase)

    def __call__(self, h, phase: str = "fwd"):
        return _EllFn.apply(h, self, phase)


class _EllFn(torch.autograd.Function):
    # saves only the layout (held by `op`), never the activations

    @staticmethod
    def forward(ctx, h, op: EllSpmm, phase: str):
        ctx.op = op
        return op.apply_dir("fwd", h, phase)

    @staticmethod
    def backward(ctx, g):
        return ctx.op.apply_dir("bwd", g, "bwd").to(g.dtype), None, None
