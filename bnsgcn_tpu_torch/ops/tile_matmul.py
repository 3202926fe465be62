"""Kernel K2: the grouped dense-tile matmul of the hybrid SpMM,
`out[rowb[b]] += tiles[b] @ x_slabs[colb[b]]`.

Counterpart of the TPU kernel bnsgcn_tpu/ops/pallas_block.py
`pallas_tile_matmul` / `dense_apply_pallas`, with its slab types: f32 and
bf16 slabs give f32 sums; int8 slabs give exact int32 sums, the raw
accumulators whose one per-call scale the caller owns, or, with a per-slab
scale array, each tile's int32 sum times its slab's scale summed over the
row-block's tiles in f32 (bnsgcn_tpu/ops/block_spmm.py `_dense_apply`'s
int8 formulation).

Two CUDA kernels, one route per slab type, chosen by the slabs' dtype
alone:
  * int8 and bf16 slabs: csrc/tile_mma.cu, a grouped GEMM on the tensor
    cores (wgmma s8 x s8 -> s32, exact; bf16 x bf16 -> f32) over the dense
    tiles, the row-blocks taken in `work_order` (most tiles first). wgmma
    reads int8 operands K-major only, so these slabs are [n_cb, H, TC],
    each slab transposed (`k_major`; ops/block_spmm.py writes them so);
  * f32 slabs ([n_cb, TC, H]): csrc/tile_matmul.cu, which reads the
    tiles' nonzero entries as `pack_tiles` packs them (once per layout)
    and skips every zero on the CUDA cores (the tensor cores would take
    f32 as TF32).
`tile_matmul_plain` is the same function in plain PyTorch on the dense
tiles (chunked products + index_add_ by row-block, as `_dense_apply`
does), which the CPU tests use and chip_smoke.py holds both kernels to.

Contract: tiles [B, TR, TC] int8 sorted by rowb; rowb/colb [B] int32, pad
tiles carry rowb == n_row_blocks; off [n_row_blocks + 1] int32, the CSR
offsets of `row_offsets(rowb)`; (ent, ent_off) = `pack_tiles(tiles)`; all
built once per layout by the caller (the zero-skipping kernel walks off,
ent_off and ent, the tensor-core kernel off and tiles; the plain version
reads tiles and rowb); x_slabs [n_cb, TC, H] f32, or [n_cb, H, TC] int8
or bf16; slab_scale [n_cb] f32 or None (int8 only). Returns
[n_row_blocks, TR, H], f32 (int32 for int8 slabs without slab_scale), in
which a row-block that no tile visits is zero (the Pallas kernel's extra
trash block and the caller's visited-mask are gone).
"""

from __future__ import annotations

import ctypes
import os

import torch

from bnsgcn_tpu_torch import buildlib

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
SOURCE = os.path.join(_CSRC, "tile_matmul.cu")
LIB_NAME = "bnsgcn_tile_matmul"
MMA_SOURCE = os.path.join(_CSRC, "tile_mma.cu")
MMA_LIB_NAME = "bnsgcn_tile_mma"
BUILDS = ((LIB_NAME, SOURCE), (MMA_LIB_NAME, MMA_SOURCE))
# the f32 kernel stages at least two [TC, 32] f32 slab chunks in 232,448
# bytes of shared memory: TC <= 908. The tensor-core kernel (its slab kinds
# and codes: MMA_KINDS) stages pieces of a tile and takes any TC.
MAX_TC = 232448 // (2 * 32 * 4)
MMA_KINDS = {torch.int8: 0, torch.bfloat16: 1}
_COL_BITS = 24          # a packed entry: column << 8 | (int8 multiplicity)

launches = buildlib.LaunchCount()
_kernel = buildlib.Kernel(
    LIB_NAME, SOURCE, "bnsgcn_tile_spmm_f32",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "bnsgcn_tile_spmm_error")
_mma = buildlib.Kernel(
    MMA_LIB_NAME, MMA_SOURCE, "bnsgcn_tile_mma",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 6 + [ctypes.c_void_p], "bnsgcn_tile_mma_error")


def lib() -> ctypes.CDLL:
    """Build and load both kernels' libraries; the tensor-core one is
    returned."""
    _kernel.load()
    return _mma.load()


def slab_dims(x_slabs: torch.Tensor) -> tuple[int, int, int]:
    """(n_cb, TC, H) of a slab stack: [n_cb, TC, H] for f32 slabs, [n_cb, H,
    TC] (K-major) for the tensor cores' int8 and bf16."""
    n_cb, a, b = x_slabs.shape
    return (n_cb, b, a) if x_slabs.dtype in MMA_KINDS else (n_cb, a, b)


def k_major(x_slabs: torch.Tensor) -> torch.Tensor:
    """Slabs [n_cb, TC, H] as the tensor cores read them: [n_cb, H, TC]
    (one transposing copy)."""
    return x_slabs.transpose(1, 2).contiguous()


def kind_name(slab_dtype: torch.dtype, per_slab: bool = False) -> str:
    """The launch count's name of a variant, which names its route: 'f32'
    (the zero-skipping kernel); 'tc-bf16', 'tc-int8' (one per-call scale,
    int32 out) and 'tc-int8-slab' (per-slab scales) on the tensor cores."""
    name = {torch.float32: "f32", torch.bfloat16: "bf16",
            torch.int8: "int8"}[slab_dtype] + ("-slab" if per_slab else "")
    return f"tc-{name}" if slab_dtype in MMA_KINDS else name


def out_dtype_for(slab_dtype: torch.dtype, per_slab: bool = False
                  ) -> torch.dtype:
    """int32 for int8 slabs without per-slab scales, else f32."""
    if slab_dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise ValueError(f"tile_matmul: slabs of {slab_dtype} are not taken "
                         f"(f32, bf16, int8)")
    if per_slab and slab_dtype != torch.int8:
        raise ValueError("tile_matmul: per-slab scales go with int8 slabs")
    return (torch.int32 if slab_dtype == torch.int8 and not per_slab
            else torch.float32)


def work_order(off: torch.Tensor) -> torch.Tensor:
    """[n_row_blocks] int32: the row-blocks in the order the tensor-core
    kernel's CTAs take them, most tiles first (ties in row-block order), so
    the longest row-blocks do not start last. Built once per layout."""
    counts = (off[1:] - off[:-1]).long()
    return torch.argsort(counts, descending=True, stable=True).to(
        torch.int32)


def _chunk_for(row_tile: int, width: int,
               budget_bytes: int = 768 << 20) -> int:
    """Tiles per chunk so the f32 [C, TR, H] partial product stays under
    `budget_bytes` (bnsgcn_tpu/ops/block_spmm.py `_tile_chunk_for`)."""
    return max(64, budget_bytes // max(row_tile * width * 4, 1))


# int8 tiles x int8 slabs: a row of this many columns sums to at most
# 1024 * 127 * 127 < 2^24, so an f32 product of such a column piece is an
# exact integer (any order, any device)
_EXACT_COLS = 1024


def _tile_products(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-tile products [C, TR, H] of int8 tiles t [C, TR, TC] with slabs x:
    f32 for f32 slabs [C, TC, H] and bf16 slabs [C, H, TC] (products of the
    slab dtype's values, summed in f32); exact int32 for int8 slabs [C, H,
    TC], summed as f32 column pieces whose sums are exact integers."""
    if x.dtype == torch.float32:
        return torch.einsum("brc,bch->brh", t.float(), x)
    if x.dtype != torch.int8:
        return torch.einsum("brc,bhc->brh", t.float(), x.float())
    out = None
    for c0 in range(0, t.shape[2], _EXACT_COLS):
        p = torch.einsum("brc,bhc->brh", t[:, :, c0:c0 + _EXACT_COLS].float(),
                         x[:, :, c0:c0 + _EXACT_COLS].float()).to(torch.int32)
        out = p if out is None else out + p
    return out


def tile_matmul_plain(tiles: torch.Tensor, rowb: torch.Tensor,
                      colb: torch.Tensor, x_slabs: torch.Tensor,
                      n_row_blocks: int, slab_scale=None) -> torch.Tensor:
    """Plain PyTorch version: per chunk of tiles, the products of
    `_tile_products` and an index_add_ of them into their row-blocks (pad
    tiles land in a dropped extra block). With per-slab scales, each tile's
    int32 sums times its slab's scale are added to the row-block in tile
    order (one index_add_ per position within the row-block, so no two adds
    meet at an address: the kernel's order, on any device)."""
    b, tr, _ = tiles.shape
    h = slab_dims(x_slabs)[2]
    dt = out_dtype_for(x_slabs.dtype, slab_scale is not None)
    acc = torch.zeros((n_row_blocks + 1, tr, h), dtype=dt,
                      device=x_slabs.device)
    step = _chunk_for(tr, h)
    rb_all = rowb.long()
    first = torch.searchsorted(rb_all, rb_all)      # a row-block's first tile
    for b0 in range(0, b, step):
        rb = rb_all[b0:b0 + step]
        cb = colb[b0:b0 + step].long()
        part = _tile_products(tiles[b0:b0 + step], x_slabs[cb])
        if slab_scale is None:
            acc.index_add_(0, rb, part)
            continue
        part = part.float() * slab_scale[cb][:, None, None]
        pos = torch.arange(b0, b0 + len(rb), device=rb.device) - \
            first[b0:b0 + step]
        for k in torch.unique(pos).tolist():
            sel = pos == k
            acc.index_add_(0, rb[sel], part[sel])
    return acc[:n_row_blocks]


def row_offsets(rowb: torch.Tensor, n_row_blocks: int) -> torch.Tensor:
    """CSR offsets over the sorted rowb: row-block rb owns tiles
    [off[rb], off[rb + 1]); pads (rowb == n_row_blocks) fall past the end."""
    grid = torch.arange(n_row_blocks + 1, device=rowb.device,
                        dtype=rowb.dtype)
    return torch.searchsorted(rowb, grid).to(torch.int32)


def pack_tiles(tiles: torch.Tensor, chunk_bytes: int = 64 << 20
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The nonzero entries of an int8 tile stack [B, TR, TC], as the kernel
    reads them: (ent, ent_off).

    ent [nnz] int32: one word per nonzero entry, `column << 8 | (multiplicity
    & 0xff)` (the column in the tile, the int8 value's low byte), sorted by
    (tile, row, column). ent_off [B, TR + 1] int32: row r of tile b owns
    entries [ent_off[b, r], ent_off[b, r + 1]), and ent_off[b, TR] ==
    ent_off[b + 1, 0]; an all-zero tile (every pad tile) has an empty range.

    Plain torch (nonzero, bincount, cumsum) on the tiles' device, a chunk of
    tiles at a time so the transient (a bool mask and int64 indices) stays
    near `chunk_bytes` of tile. Raises when the stack's geometry cannot be
    packed: TC >= 2^24, or 2^31 entries or more."""
    if tiles.dtype != torch.int8 or tiles.dim() != 3:
        raise ValueError(f"pack_tiles: tiles must be 3-D int8, got "
                         f"{tiles.dtype} {tuple(tiles.shape)}")
    b, tr, tc = tiles.shape
    if tc >= 1 << _COL_BITS:
        raise ValueError(f"pack_tiles: TC={tc} does not fit the packed "
                         f"word's {_COL_BITS} column bits")
    dev = tiles.device
    counts = torch.zeros(b * tr, dtype=torch.int64, device=dev)
    words = []
    step = max(1, chunk_bytes // max(tr * tc, 1))
    for b0 in range(0, b, step):
        chunk = tiles[b0:b0 + step].reshape(-1)
        flat = torch.nonzero(chunk).squeeze(1)          # row-major: sorted
        row = flat // tc                                # row within chunk
        counts[b0 * tr:b0 * tr + chunk.numel() // tc] = torch.bincount(
            row, minlength=chunk.numel() // tc)
        val = chunk[flat].to(torch.int32) & 0xFF
        words.append(((flat - row * tc).to(torch.int32) << 8) | val)
        del chunk, flat, row, val
    ends = torch.cumsum(counts, 0)
    total = int(ends[-1]) if ends.numel() else 0
    if total >= 1 << 31:
        raise ValueError(f"pack_tiles: {total} entries do not fit int32 "
                         f"offsets")
    ent_off = torch.empty((b, tr + 1), dtype=torch.int32, device=dev)
    ent_off[:, :tr] = (ends - counts).view(b, tr)
    ent_off[:, tr] = ends.view(b, tr)[:, -1]
    ent = (torch.cat(words) if words
           else torch.zeros(0, dtype=torch.int32, device=dev))
    return ent, ent_off


def _check_int32(name, v, shape, dev):
    if (v.dtype != torch.int32 or tuple(v.shape) != tuple(shape)
            or v.device != dev or not v.is_contiguous()):
        raise ValueError(f"tile_matmul: {name} must be contiguous int32 "
                         f"{list(shape)} on {dev}, got {v.dtype} "
                         f"{tuple(v.shape)} on {v.device}")


def tile_matmul(tiles: torch.Tensor, rowb: torch.Tensor, colb: torch.Tensor,
                off: torch.Tensor, ent: torch.Tensor, ent_off: torch.Tensor,
                x_slabs: torch.Tensor, n_row_blocks: int, slab_scale=None,
                phase: str = "fwd", order=None) -> torch.Tensor:
    """[n_row_blocks, TR, H] (see the module docstring). A CPU tensor takes
    the plain version on the dense tiles; a CUDA tensor launches a kernel on
    the current stream, or raises: int8 and bf16 slabs the tensor-core
    kernel on the dense tiles, the row-blocks in `order` (`work_order(off)`
    when not given), f32 slabs the zero-skipping kernel on the packed
    entries."""
    if x_slabs.device.type == "cpu":
        return tile_matmul_plain(tiles, rowb, colb, x_slabs, n_row_blocks,
                                 slab_scale)
    if x_slabs.device.type != "cuda":
        raise ValueError(f"tile_matmul: unsupported device {x_slabs.device}")
    dev = x_slabs.device
    out_dtype = out_dtype_for(x_slabs.dtype, slab_scale is not None)
    if x_slabs.dim() != 3 or not x_slabs.is_contiguous():
        raise ValueError(f"tile_matmul: x_slabs must be contiguous 3-D, got "
                         f"{tuple(x_slabs.shape)}")
    if tiles.dim() != 3:
        raise ValueError(f"tile_matmul: tiles must be 3-D, got "
                         f"{tuple(tiles.shape)}")
    b, tr, tc = tiles.shape
    n_cb, tc_x, h = slab_dims(x_slabs)
    for name, v, shape in (("rowb", rowb, (b,)), ("colb", colb, (b,)),
                           ("off", off, (n_row_blocks + 1,))):
        _check_int32(name, v, shape, dev)
    if slab_scale is not None and (
            slab_scale.dtype != torch.float32 or slab_scale.dim() != 1
            or slab_scale.numel() != n_cb or slab_scale.device != dev
            or not slab_scale.is_contiguous()):
        raise ValueError(f"tile_matmul: slab_scale must be contiguous "
                         f"float32 [{n_cb}] on {dev}, got {slab_scale.dtype} "
                         f"{tuple(slab_scale.shape)} on {slab_scale.device}")
    if tc_x != tc:
        raise ValueError(f"tile_matmul: tiles have TC={tc}, slabs {tc_x}")
    tensor_cores = x_slabs.dtype in MMA_KINDS
    if tensor_cores:
        if (tiles.dtype != torch.int8 or tiles.device != dev
                or not tiles.is_contiguous()):
            raise ValueError(f"tile_matmul: tiles must be contiguous int8 "
                             f"on {dev}, got {tiles.dtype} on {tiles.device}")
        if order is None:
            order = work_order(off)
        _check_int32("order", order, (n_row_blocks,), dev)
    else:
        _check_int32("ent", ent, (ent.numel(),), dev)
        _check_int32("ent_off", ent_off, (b, tr + 1), dev)
        if tc > MAX_TC:
            raise ValueError(f"tile_matmul: the f32 kernel takes TC <= "
                             f"{MAX_TC} (its stages in shared memory), got "
                             f"{tc}")
    out = torch.empty((n_row_blocks, tr, h), dtype=out_dtype, device=dev)
    if n_row_blocks == 0 or h == 0:
        return out
    scale_ptr = None if slab_scale is None else slab_scale.data_ptr()
    stream = buildlib.raw_stream(dev.index)
    if tensor_cores:
        _mma(tiles.data_ptr(), colb.data_ptr(), off.data_ptr(),
             order.data_ptr(), x_slabs.data_ptr(), MMA_KINDS[x_slabs.dtype],
             scale_ptr, out.data_ptr(), b, n_cb, n_row_blocks, tr, tc, h,
             stream)
    else:
        _kernel(ent.data_ptr(), ent_off.data_ptr(), colb.data_ptr(),
                off.data_ptr(), x_slabs.data_ptr(), out.data_ptr(),
                n_row_blocks, tr, tc, h, stream)
    launches.add(phase, kind_name(x_slabs.dtype, slab_scale is not None))
    return out
