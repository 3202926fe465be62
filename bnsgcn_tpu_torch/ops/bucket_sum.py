"""Kernel K1: the ELL SpMM of one direction of one part's layout, in one
launch,

    out[r] = base[base_row[r]] + sum_{e in row r} h[src_e]     (base optional)

Counterpart of the TPU kernel tools/pallas_spmm.py `pallas_bucket_sum`
together with its wrapper `pallas_ell_apply` (= bnsgcn_tpu/ops/ell.py
`_ell_apply`: per-bucket sums, the split-row combine, the permutation). In
the hybrid SpMM, `base` is the dense-tile kernel's output in cluster order
and `base_row` the permutation back to row order, which the JAX package
gathered and added outside the kernels.

The CUDA kernel (csrc/bucket_sum.cu) reads a row schedule that `pack_rows`
packs once per layout with plain torch on the layout's device: the ELL
tables' terms as a CSR in final row order (`row_ptr`, `src`) and a work
order over the rows (`work`, long rows first). The ELL tables stay beside
it: `ell_apply_plain` computes the same function on them in plain PyTorch
(per-bucket `bucket_sum_plain`, `ell_combine`, the base gather and add),
which the CPU path and the tests use and chip_smoke.py holds the kernel to.

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
CHUNKS = (32, 64, 256)  # column chunks the kernel is built for
CHUNK = 32              # columns per pass (chip_smoke.py's sweep chose it)
ORDERS = ("original", "cluster", "longest")
ORDER = "longest"       # work order (chip_smoke.py's sweep chose it)
LONG_ROW = 1024         # a row of more terms gets a CTA of its own

launches = buildlib.LaunchCount()
_kernel = buildlib.Kernel(
    LIB_NAME, SOURCE, "bnsgcn_ell_rows_f32",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 2 + [ctypes.c_void_p], "bnsgcn_ell_rows_error")


def lib() -> ctypes.CDLL:
    return _kernel.load()


# ---------------------------------------------------------------------------
# the plain version, on the ELL tables
# ---------------------------------------------------------------------------

def bucket_sum_plain(h: torch.Tensor, idx: torch.Tensor,
                     chunk_gathers: int = 1_000_000) -> torch.Tensor:
    """One bucket's `hp[idx].sum(1)` in f32 over h plus one zero row,
    row-chunked so the gathered [rows, W, H] block stays under
    ~chunk_gathers * H elements (bnsgcn_tpu/ops/ell.py `_bucket_sum`,
    accum='reduce')."""
    r, w = idx.shape
    hp = torch.cat([h.float(), h.new_zeros((1, h.shape[1]), dtype=torch.float32)])
    out = torch.empty((r, h.shape[1]), dtype=torch.float32, device=h.device)
    step = max(1, chunk_gathers // max(w, 1))
    for r0 in range(0, r, step):
        out[r0:r0 + step] = hp[idx[r0:r0 + step].long()].sum(1)
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
    `long_row` terms first (longest first), then the rest in `order`."""
    spec: object                  # ops/ell.py EllSpec
    idx: tuple                    # per-bucket [R_k, W_k] int32 tables
    perm: torch.Tensor            # [n_rows] int32: table position of a row
    chunk_pos: Optional[torch.Tensor]
    chunk_seg: Optional[torch.Tensor]
    row_ptr: torch.Tensor         # [n_rows + 1] int32
    src: torch.Tensor             # [nnz] int32
    work: torch.Tensor            # [n_rows] int32
    n_long: int
    order: str
    long_row: int

    @property
    def n_rows(self) -> int:
        return self.spec.n_rows

    @property
    def n_src(self) -> int:
        return self.spec.n_src

    def with_order(self, order: str, cluster_pos=None,
                   long_row: Optional[int] = None) -> "EllRows":
        """The same layout with another work order (the CSR is shared)."""
        long_row = self.long_row if long_row is None else long_row
        work, n_long = work_order(self.row_ptr, order, cluster_pos, long_row)
        return replace(self, work=work, n_long=n_long, order=order,
                       long_row=long_row)


def work_order(row_ptr: torch.Tensor, order: str, cluster_pos=None,
               long_row: int = LONG_ROW) -> tuple[torch.Tensor, int]:
    """(work [n_rows] int32, n_long): the rows of more than `long_row` terms
    longest first, then the others in `order`: 'original' (row order),
    'cluster' (by cluster_pos, each row's position in a locality order,
    e.g. the hybrid layout's) or 'longest' (most terms first; ties in row
    order)."""
    deg = (row_ptr[1:] - row_ptr[:-1]).long()
    n = deg.numel()
    if order == "original":
        rows = torch.arange(n, device=deg.device)
    elif order == "cluster":
        if cluster_pos is None or cluster_pos.numel() != n:
            raise ValueError(f"work order 'cluster' needs a position for each "
                             f"of the {n} rows")
        rows = torch.sort(cluster_pos.long(), stable=True).indices
    elif order == "longest":
        rows = torch.sort(deg, descending=True, stable=True).indices
    else:
        raise ValueError(f"work order {order!r} is not one of {ORDERS}")
    is_long = deg[rows] > long_row
    longs = rows[is_long]
    longs = longs[torch.sort(deg[longs], descending=True, stable=True).indices]
    work = torch.cat([longs, rows[~is_long]]).to(torch.int32)
    return work, int(is_long.sum())         # a host read after the work


def pack_rows(spec, idx, perm, chunk_pos=None, chunk_seg=None) -> EllRows:
    """The row schedule of one direction's ELL tables (build_ell_numpy's:
    per-bucket [R_k, W_k] tables padded with n_src, perm, and for split rows
    chunk_pos/chunk_seg), in plain torch on their device, in work order
    ORDER with long rows past LONG_ROW (`EllRows.with_order` gives the
    others). Raises for 2^31 terms or more."""
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
    work, n_long = work_order(row_ptr, ORDER)
    return EllRows(spec=spec, idx=tuple(idx), perm=perm, chunk_pos=chunk_pos,
                   chunk_seg=chunk_seg, row_ptr=row_ptr, src=src, work=work,
                   n_long=n_long, order=ORDER, long_row=LONG_ROW)


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def ell_apply_plain(rows: EllRows, h: torch.Tensor, base=None,
                    base_row=None) -> torch.Tensor:
    """Plain PyTorch version on the ELL tables: the bucket sums, the
    split-row combine and the permutation (bnsgcn_tpu/ops/ell.py
    `_ell_apply`), then `base[base_row] +` that."""
    outs = [bucket_sum_plain(h, t) for t in rows.idx]
    out = ell_combine(rows.spec, outs, rows.perm, rows.chunk_pos,
                      rows.chunk_seg)
    if base is not None:
        out = base[base_row.long()] + out
    return out


def _check_index(name, v, n, dev):
    if (v.dtype != torch.int32 or v.dim() != 1 or v.numel() != n
            or v.device != dev or not v.is_contiguous()):
        raise ValueError(f"ell_apply: {name} must be contiguous int32 [{n}] "
                         f"on {dev}, got {v.dtype} {tuple(v.shape)} on "
                         f"{v.device}")


def ell_apply(rows: EllRows, h: torch.Tensor, base=None, base_row=None,
              phase: str = "fwd", chunk: int = CHUNK) -> torch.Tensor:
    """[n_rows, H] f32 = base[base_row] + the layout's row sums of h
    [n_src, H] f32 (base and base_row both or neither). A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel on the current
    stream, `chunk` columns per pass, or raises."""
    if h.device.type == "cpu":
        return ell_apply_plain(rows, h, base, base_row)
    if h.device.type != "cuda":
        raise ValueError(f"ell_apply: unsupported device {h.device}")
    dev = h.device
    if (h.dtype != torch.float32 or h.dim() != 2 or not h.is_contiguous()
            or h.shape[0] != rows.n_src):
        raise ValueError(f"ell_apply: h must be contiguous float32 "
                         f"[{rows.n_src}, H], got {h.dtype} {tuple(h.shape)}")
    n_rows, hdim = rows.n_rows, h.shape[1]
    _check_index("row_ptr", rows.row_ptr, n_rows + 1, dev)
    _check_index("src", rows.src, rows.src.numel(), dev)
    _check_index("work", rows.work, n_rows, dev)
    if (base is None) != (base_row is None):
        raise ValueError("ell_apply: base and base_row go together")
    if base is not None:
        if (base.dtype != torch.float32 or base.dim() != 2
                or base.shape[1] != hdim or base.device != dev
                or not base.is_contiguous()):
            raise ValueError(f"ell_apply: base must be contiguous float32 "
                             f"[*, {hdim}] on {dev}, got {base.dtype} "
                             f"{tuple(base.shape)} on {base.device}")
        _check_index("base_row", base_row, n_rows, dev)
    if chunk not in CHUNKS:
        raise ValueError(f"ell_apply: column chunk {chunk} is not one of "
                         f"{CHUNKS}")
    out = torch.empty((n_rows, hdim), dtype=torch.float32, device=dev)
    if n_rows == 0 or hdim == 0:
        return out
    _kernel(h.data_ptr(), rows.row_ptr.data_ptr(), rows.src.data_ptr(),
            rows.work.data_ptr(), n_rows, rows.n_long,
            None if base is None else base.data_ptr(),
            None if base is None else base_row.data_ptr(), out.data_ptr(),
            hdim, chunk, buildlib.raw_stream(dev.index))
    launches.add(phase)
    return out
