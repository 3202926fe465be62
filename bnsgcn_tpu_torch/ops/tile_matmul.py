"""Kernel K2: the grouped dense-tile matmul of the hybrid SpMM,
`out[rowb[b]] += tiles[b] @ x_slabs[colb[b]]`.

Counterpart of the TPU kernel bnsgcn_tpu/ops/pallas_block.py
`pallas_tile_matmul` / `dense_apply_pallas`. The CUDA kernel is
csrc/tile_matmul.cu, which reads the tiles' nonzero entries as `pack_tiles`
packs them (once per layout) and skips every zero; `tile_matmul_plain` is
the same function in plain PyTorch on the dense tiles (chunked einsum +
index_add_ by row-block, as bnsgcn_tpu/ops/block_spmm.py `_dense_apply`
does), which the CPU tests use and chip_smoke.py holds the kernel to.

Contract: tiles [B, TR, TC] int8 sorted by rowb; rowb/colb [B] int32, pad
tiles carry rowb == n_row_blocks; off [n_row_blocks + 1] int32, the CSR
offsets of `row_offsets(rowb)`; (ent, ent_off) = `pack_tiles(tiles)`; all
built once per layout by the caller (the kernel walks off, ent_off and ent;
the plain version reads tiles and rowb); x_slabs [n_cb, TC, H] f32. Returns
[n_row_blocks, TR, H] f32 in which a row-block that no tile visits is zero
(the Pallas kernel's extra trash block and the caller's visited-mask are
gone).
"""

from __future__ import annotations

import ctypes
import os

import torch

from bnsgcn_tpu_torch import buildlib

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "tile_matmul.cu")
LIB_NAME = "bnsgcn_tile_matmul"
# the kernel stages two or three [TC, 32] f32 slab chunks in shared memory,
# at most 227 KB a block: at least two fit for TC <= 908
MAX_TC = 232448 // (2 * 32 * 4)
_COL_BITS = 24          # a packed entry: column << 8 | (int8 multiplicity)

launches = buildlib.LaunchCount()
_kernel = buildlib.Kernel(
    LIB_NAME, SOURCE, "bnsgcn_tile_spmm_f32",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "bnsgcn_tile_spmm_error")


def lib() -> ctypes.CDLL:
    return _kernel.load()


def _chunk_for(row_tile: int, width: int,
               budget_bytes: int = 768 << 20) -> int:
    """Tiles per chunk so the f32 [C, TR, H] partial product stays under
    `budget_bytes` (bnsgcn_tpu/ops/block_spmm.py `_tile_chunk_for`)."""
    return max(64, budget_bytes // max(row_tile * width * 4, 1))


def tile_matmul_plain(tiles: torch.Tensor, rowb: torch.Tensor,
                      colb: torch.Tensor, x_slabs: torch.Tensor,
                      n_row_blocks: int) -> torch.Tensor:
    """Plain PyTorch version: per chunk of tiles, one einsum
    [C, TR, TC] x [C, TC, H] in f32 and an index_add_ of the partials into
    their row-blocks (pad tiles land in a dropped extra block)."""
    b, tr, _ = tiles.shape
    h = x_slabs.shape[-1]
    acc = torch.zeros((n_row_blocks + 1, tr, h), dtype=torch.float32,
                      device=x_slabs.device)
    step = _chunk_for(tr, h)
    for b0 in range(0, b, step):
        t = tiles[b0:b0 + step].to(torch.float32)
        part = torch.einsum("brc,bch->brh", t,
                            x_slabs[colb[b0:b0 + step].long()].float())
        acc.index_add_(0, rowb[b0:b0 + step].long(), part)
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


def tile_matmul(tiles: torch.Tensor, rowb: torch.Tensor, colb: torch.Tensor,
                off: torch.Tensor, ent: torch.Tensor, ent_off: torch.Tensor,
                x_slabs: torch.Tensor, n_row_blocks: int,
                phase: str = "fwd") -> torch.Tensor:
    """[n_row_blocks, TR, H] f32 (see the module docstring). A CPU tensor
    takes the plain version on the dense tiles; a CUDA tensor launches the
    kernel on the packed entries, on the current stream, or raises."""
    if x_slabs.device.type == "cpu":
        return tile_matmul_plain(tiles, rowb, colb, x_slabs, n_row_blocks)
    if x_slabs.device.type != "cuda":
        raise ValueError(f"tile_matmul: unsupported device {x_slabs.device}")
    dev = x_slabs.device
    if (x_slabs.dtype != torch.float32 or x_slabs.dim() != 3
            or not x_slabs.is_contiguous()):
        raise ValueError(f"tile_matmul: x_slabs must be contiguous 3-D "
                         f"float32, got {x_slabs.dtype} "
                         f"{tuple(x_slabs.shape)}")
    if tiles.dim() != 3:
        raise ValueError(f"tile_matmul: tiles must be 3-D, got "
                         f"{tuple(tiles.shape)}")
    b, tr, tc = tiles.shape
    n_cb, tc_x, h = x_slabs.shape
    for name, v, shape in (("rowb", rowb, (b,)), ("colb", colb, (b,)),
                           ("off", off, (n_row_blocks + 1,)),
                           ("ent", ent, (ent.numel(),)),
                           ("ent_off", ent_off, (b, tr + 1))):
        if (v.dtype != torch.int32 or tuple(v.shape) != shape
                or v.device != dev or not v.is_contiguous()):
            raise ValueError(f"tile_matmul: {name} must be contiguous int32 "
                             f"{list(shape)} on {dev}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")
    if tc_x != tc:
        raise ValueError(f"tile_matmul: tiles have TC={tc}, slabs {tc_x}")
    if tc > MAX_TC:
        raise ValueError(f"tile_matmul: the kernel takes TC <= {MAX_TC} "
                         f"(two slab stages in shared memory), got {tc}")
    out = torch.empty((n_row_blocks, tr, h), dtype=torch.float32, device=dev)
    if n_row_blocks == 0 or h == 0:
        return out
    _kernel(ent.data_ptr(), ent_off.data_ptr(), colb.data_ptr(),
            off.data_ptr(), x_slabs.data_ptr(), out.data_ptr(), n_row_blocks,
            tr, tc, h, buildlib.raw_stream(dev.index))
    launches.add(phase)
    return out
