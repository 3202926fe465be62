"""Kernel K1: the ELL SpMM of one direction of one part's layout, in one
launch,

    out[r] = base[base_row[r]] + scale * sum_{e in row r} h[src_e]
                                                  (base and scale optional)

Counterpart of the TPU kernel tools/pallas_spmm.py `pallas_bucket_sum`
together with its wrapper `pallas_ell_apply` (= bnsgcn_tpu/ops/ell.py
`_ell_apply`: per-bucket sums, the split-row combine, the permutation, the
dequant scale of quantized rows). In the hybrid SpMM, `base` is the
dense-tile kernel's output in cluster order and `base_row` the permutation
back to row order, which the JAX package gathered and added outside the
kernels.

Rows may be f32 or bf16 (summed in f32, out in the rows' dtype), or the
quantized gathers' int8 (exact int32 sums) and e4m3 (f32 sums) payloads,
whose sums are scaled by the quantizer's scale and rounded to the
activations' dtype (`out_dtype`); int8 rows without a scale give the raw
int32 sums. The base is added after that rounding, in the out dtype, as
the JAX package computes `dense + ell(h)` in h's dtype.

The CUDA kernel (csrc/bucket_sum.cu) reads a row schedule that `pack_rows`
packs once per layout with plain torch on the layout's device: the ELL
tables' terms as a CSR in final row order (`row_ptr`, `src`) and a work
order over the rows (`work`, long rows first, then longest first). The ELL
tables stay beside it: `ell_apply_plain` computes the same function on them
in plain PyTorch (per-bucket `bucket_sum_plain`, `ell_combine`, the scale,
the base gather and add), which the CPU path and the tests use and
chip_smoke.py holds the kernel to.

Index convention of the tables: entries equal to n_src (the layout's pad
index) contribute nothing; the JAX path reads them from a zero row appended
to h. The CSR holds no pads.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass, replace
from typing import Optional

import torch

from bnsgcn_tpu_torch import buildlib

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "bucket_sum.cu")
LIB_NAME = "bnsgcn_bucket_sum"
LONG_ROW = 1024         # a row of more terms gets a CTA of its own
# the kernel's row kinds and out kinds (csrc/bucket_sum.cu's codes)
ROW_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
             torch.float8_e4m3fn: 3}
KIND_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.int8: "int8", torch.float8_e4m3fn: "fp8"}
OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

launches = buildlib.LaunchCount()
_kernel = buildlib.Kernel(
    LIB_NAME, SOURCE, "bnsgcn_ell_rows",
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    + [ctypes.c_void_p], "bnsgcn_ell_rows_error")


def lib() -> ctypes.CDLL:
    return _kernel.load()


def acc_dtype(row_dtype: torch.dtype) -> torch.dtype:
    """The accumulator of a row dtype: int32 for int8 rows, else f32."""
    return torch.int32 if row_dtype == torch.int8 else torch.float32


def out_dtype_for(row_dtype: torch.dtype, out_dtype=None) -> torch.dtype:
    """What ell_apply returns for rows of `row_dtype`: f32 and bf16 rows
    their own dtype; quantized rows `out_dtype`, or without one their raw
    accumulator (int32 for int8, f32 for e4m3). Raises for a pair the
    kernel does not compute."""
    if row_dtype in (torch.float32, torch.bfloat16):
        ok = (row_dtype,)
    elif row_dtype == torch.int8:
        ok = (torch.int32, torch.float32, torch.bfloat16)
    elif row_dtype == torch.float8_e4m3fn:
        ok = (torch.float32, torch.bfloat16)
    else:
        raise ValueError(f"ell_apply: rows of {row_dtype} are not taken "
                         f"(f32, bf16, int8, float8_e4m3fn)")
    out = ok[0] if out_dtype is None else out_dtype
    if out not in ok:
        raise ValueError(f"ell_apply: {row_dtype} rows give {ok}, not {out}")
    return out


# ---------------------------------------------------------------------------
# the plain version, on the ELL tables
# ---------------------------------------------------------------------------

def bucket_sum_plain(h: torch.Tensor, idx: torch.Tensor,
                     chunk_gathers: int = 1_000_000) -> torch.Tensor:
    """One bucket's `hp[idx].sum(1)` in the rows' accumulator (f32; int32
    for int8 rows) over h plus one zero row, row-chunked so the gathered
    [rows, W, H] block stays under ~chunk_gathers * H elements
    (bnsgcn_tpu/ops/ell.py `_bucket_sum`, accum='reduce')."""
    r, w = idx.shape
    acc = acc_dtype(h.dtype)
    hp = torch.cat([h.to(acc), torch.zeros((1, h.shape[1]), dtype=acc,
                                           device=h.device)])
    out = torch.empty((r, h.shape[1]), dtype=acc, device=h.device)
    step = max(1, chunk_gathers // max(w, 1))
    for r0 in range(0, r, step):
        out[r0:r0 + step] = hp[idx[r0:r0 + step].long()].sum(1, dtype=acc)
    return out


def ell_combine(spec, outs, perm, chunk_pos=None, chunk_seg=None):
    """Per-bucket outputs [R_k, H] -> [n_rows, H]: the split-row chunk
    combine (an index_add_ over the cap bucket's chunk rows) and one
    permutation gather (bnsgcn_tpu/ops/ell.py `ell_combine`)."""
    h = outs[0].shape[1]
    zero = outs[0].new_zeros((1, h))
    if spec.n_split:
        cap_z = torch.cat([outs[-1], zero])
        comb = outs[0].new_zeros((spec.n_split + 1, h))
        comb.index_add_(0, chunk_seg.long(), cap_z[chunk_pos.long()])
        full = torch.cat(list(outs) + [comb[:spec.n_split], zero])
    else:
        full = torch.cat(list(outs) + [zero])
    return full[perm.long()]


# ---------------------------------------------------------------------------
# the row schedule, packed once per layout
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EllRows:
    """One direction of one part's ELL layout as both versions of K1 read
    it. The plain version reads the tables (bnsgcn_tpu/ops/ell.py's); the
    kernel reads the schedule: row r's terms are src[row_ptr[r] ..
    row_ptr[r + 1]) in table order (a split row's chunks joined in chunk
    order), and `work` lists every row once, the n_long rows of more than
    `long_row` terms first, then the rest, each part longest first."""
    spec: object                  # ops/ell.py EllSpec
    idx: tuple                    # per-bucket [R_k, W_k] int32 tables
    perm: torch.Tensor            # [n_rows] int32: table position of a row
    chunk_pos: Optional[torch.Tensor]
    chunk_seg: Optional[torch.Tensor]
    row_ptr: torch.Tensor         # [n_rows + 1] int32
    src: torch.Tensor             # [nnz] int32
    work: torch.Tensor            # [n_rows] int32
    n_long: int
    long_row: int

    @property
    def n_rows(self) -> int:
        return self.spec.n_rows

    @property
    def n_src(self) -> int:
        return self.spec.n_src

    def with_long_row(self, long_row: int) -> "EllRows":
        """The same layout with another long-row threshold (the CSR is
        shared): a small one sends many rows down the long-row path."""
        work, n_long = work_order(self.row_ptr, long_row)
        return replace(self, work=work, n_long=n_long, long_row=long_row)


def work_order(row_ptr: torch.Tensor,
               long_row: int = LONG_ROW) -> tuple[torch.Tensor, int]:
    """(work [n_rows] int32, n_long): the rows of more than `long_row` terms
    first, then the others, each part with the most terms first (ties in
    row order)."""
    deg = (row_ptr[1:] - row_ptr[:-1]).long()
    rows = torch.sort(deg, descending=True, stable=True).indices
    is_long = deg[rows] > long_row
    work = torch.cat([rows[is_long], rows[~is_long]]).to(torch.int32)
    return work, int(is_long.sum())         # a host read after the work


def pack_rows(spec, idx, perm, chunk_pos=None, chunk_seg=None) -> EllRows:
    """The row schedule of one direction's ELL tables (build_ell_numpy's:
    per-bucket [R_k, W_k] tables padded with n_src, perm, and for split rows
    chunk_pos/chunk_seg), in plain torch on their device, with long rows
    past LONG_ROW (`EllRows.with_long_row` gives another threshold). Raises
    for 2^31 terms or more."""
    dev = perm.device
    n_rows, n_src = spec.n_rows, spec.n_src
    perm_l = perm.long()
    n_tab = sum(int(t.shape[0]) for t in idx)
    # the output row of each table row (-1: none); perm sends a normal row
    # to its table row, a split row to its combine slot n_tab + s, a
    # degree-0 row to the zero row n_tab + n_split (overwritten, unused)
    tab_row = torch.full((n_tab + spec.n_split + 1,), -1, dtype=torch.int64,
                         device=dev)
    tab_row[perm_l] = torch.arange(n_rows, device=dev)
    tab_row[-1] = -1
    if spec.n_split:
        # the cap bucket's chunk rows belong to their split row
        real = chunk_seg < spec.n_split
        split_row = tab_row[n_tab:n_tab + spec.n_split]
        cap_off = n_tab - int(idx[-1].shape[0])
        tab_row[cap_off + chunk_pos[real].long()] = \
            split_row[chunk_seg[real].long()]
    keys, vals, t0 = [], [], 0
    for t in idx:
        r_k, w_k = t.shape
        rk = tab_row[t0:t0 + r_k, None].expand(r_k, w_k)
        m = (t != n_src) & (rk >= 0)
        keys.append(rk[m])
        vals.append(t[m])
        t0 += r_k
    key = torch.cat(keys) if keys else torch.zeros(0, dtype=torch.int64,
                                                    device=dev)
    val = torch.cat(vals) if vals else torch.zeros(0, dtype=torch.int32,
                                                   device=dev)
    if key.numel() >= 1 << 31:
        raise ValueError(f"pack_rows: {key.numel()} terms do not fit int32 "
                         f"offsets")
    # the tables list a row's terms (and a split row's chunks) in order, so
    # a stable sort by output row keeps each row's term order
    src = val[torch.sort(key, stable=True).indices].to(torch.int32)
    row_ptr = torch.zeros(n_rows + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = torch.cumsum(torch.bincount(key, minlength=n_rows), 0)
    work, n_long = work_order(row_ptr)
    return EllRows(spec=spec, idx=tuple(idx), perm=perm, chunk_pos=chunk_pos,
                   chunk_seg=chunk_seg, row_ptr=row_ptr, src=src, work=work,
                   n_long=n_long, long_row=LONG_ROW)


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def finish(acc: torch.Tensor, scale=None, out_dtype=None, base=None,
           base_row=None) -> torch.Tensor:
    """The kernel's epilogue in plain torch: the row sums `acc` (f32 or
    int32) times `scale`, rounded to `out_dtype`, plus base[base_row] in
    that dtype (the base rounded to it first)."""
    out_dtype = acc.dtype if out_dtype is None else out_dtype
    if out_dtype == acc.dtype and scale is None and base is None:
        return acc
    v = acc.float()
    if scale is not None:
        v = v * scale
    v = v.to(out_dtype)
    if base is not None:
        v = base[base_row.long()].to(out_dtype) + v
    return v


def ell_apply_plain(rows: EllRows, h: torch.Tensor, base=None,
                    base_row=None, scale=None, out_dtype=None
                    ) -> torch.Tensor:
    """Plain PyTorch version on the ELL tables: the bucket sums and the
    split-row combine in the rows' accumulator, the permutation
    (bnsgcn_tpu/ops/ell.py `_ell_apply`), then `finish`'s scale, rounding
    and base."""
    out_dtype = out_dtype_for(h.dtype, out_dtype)
    outs = [bucket_sum_plain(h, t) for t in rows.idx]
    acc = ell_combine(rows.spec, outs, rows.perm, rows.chunk_pos,
                      rows.chunk_seg)
    return finish(acc, scale, out_dtype, base, base_row)


def _check_index(name, v, n, dev):
    if (v.dtype != torch.int32 or v.dim() != 1 or v.numel() != n
            or v.device != dev or not v.is_contiguous()):
        raise ValueError(f"ell_apply: {name} must be contiguous int32 [{n}] "
                         f"on {dev}, got {v.dtype} {tuple(v.shape)} on "
                         f"{v.device}")


def ell_apply(rows: EllRows, h: torch.Tensor, base=None, base_row=None,
              scale=None, out_dtype=None, phase: str = "fwd") -> torch.Tensor:
    """[n_rows, H] = base[base_row] + scale * the layout's row sums of h
    [n_src, H] (base and base_row both or neither; scale a 0-d f32 tensor
    or None), in `out_dtype_for(h.dtype, out_dtype)`. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel on the current
    stream, or raises."""
    if h.device.type == "cpu":
        return ell_apply_plain(rows, h, base, base_row, scale, out_dtype)
    if h.device.type != "cuda":
        raise ValueError(f"ell_apply: unsupported device {h.device}")
    dev = h.device
    out_dtype = out_dtype_for(h.dtype, out_dtype)
    if h.dim() != 2 or not h.is_contiguous() or h.shape[0] != rows.n_src:
        raise ValueError(f"ell_apply: h must be contiguous [{rows.n_src}, "
                         f"H], got {tuple(h.shape)}")
    n_rows, hdim = rows.n_rows, h.shape[1]
    _check_index("row_ptr", rows.row_ptr, n_rows + 1, dev)
    _check_index("src", rows.src, rows.src.numel(), dev)
    _check_index("work", rows.work, n_rows, dev)
    if (base is None) != (base_row is None):
        raise ValueError("ell_apply: base and base_row go together")
    if base is not None:
        if out_dtype == torch.int32:
            raise ValueError("ell_apply: raw int32 sums take no base")
        if (base.dtype != torch.float32 or base.dim() != 2
                or base.shape[1] != hdim or base.device != dev
                or not base.is_contiguous()):
            raise ValueError(f"ell_apply: base must be contiguous float32 "
                             f"[*, {hdim}] on {dev}, got {base.dtype} "
                             f"{tuple(base.shape)} on {base.device}")
        _check_index("base_row", base_row, n_rows, dev)
    if scale is not None:
        if h.dtype not in (torch.int8, torch.float8_e4m3fn):
            raise ValueError("ell_apply: a scale goes with quantized rows")
        if out_dtype == torch.int32:
            raise ValueError("ell_apply: raw int32 sums take no scale")
        if (scale.dtype != torch.float32 or scale.numel() != 1
                or scale.device != dev):
            raise ValueError(f"ell_apply: scale must be one float32 on "
                             f"{dev}, got {scale.dtype} "
                             f"{tuple(scale.shape)} on {scale.device}")
        scale = scale.reshape(()).contiguous()
    out = torch.empty((n_rows, hdim), dtype=out_dtype, device=dev)
    if n_rows == 0 or hdim == 0:
        return out
    _kernel(h.data_ptr(), ROW_KINDS[h.dtype], rows.row_ptr.data_ptr(),
            rows.src.data_ptr(), rows.work.data_ptr(), n_rows, rows.n_long,
            None if scale is None else scale.data_ptr(),
            None if base is None else base.data_ptr(),
            None if base is None else base_row.data_ptr(), out.data_ptr(),
            OUT_KINDS[out_dtype], hdim, buildlib.raw_stream(dev.index))
    launches.add(phase, KIND_NAMES[h.dtype])
    return out
