"""Kernel K2: the grouped dense-tile matmul of the hybrid SpMM,
`out[rowb[b]] += tiles[b] @ x_slabs[colb[b]]`.

Counterpart of the TPU kernel bnsgcn_tpu/ops/pallas_block.py
`pallas_tile_matmul` / `dense_apply_pallas`. The CUDA kernel is
csrc/tile_matmul.cu; `tile_matmul_plain` is the same function in plain
PyTorch (chunked einsum + index_add_ by row-block, as
bnsgcn_tpu/ops/block_spmm.py `_dense_apply` does), which the CPU tests use and
chip_smoke.py holds the kernel to.

Contract: tiles [B, TR, TC] int8 sorted by rowb; rowb/colb [B] int32, pad
tiles carry rowb == n_row_blocks; off [n_row_blocks + 1] int32, the CSR
offsets of `row_offsets(rowb)`, built once per layout by the caller (the
kernel walks them; the plain version reads rowb); x_slabs [n_cb, TC, H] f32.
Returns
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
BLOCK_ROWS = 64         # the kernel's output rows per CTA: TR % 64 == 0
BLOCK_K = 32            # the kernel's K step: TC % 32 == 0

launches = buildlib.LaunchCount()


def _declare(lib):
    lib.bnsgcn_tile_matmul_f32.restype = ctypes.c_int
    lib.bnsgcn_tile_matmul_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.bnsgcn_tile_matmul_error.restype = ctypes.c_char_p
    lib.bnsgcn_tile_matmul_error.argtypes = [ctypes.c_int]


def lib() -> ctypes.CDLL:
    return buildlib.load(LIB_NAME, "cuda", [SOURCE], _declare)


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


def tile_matmul(tiles: torch.Tensor, rowb: torch.Tensor, colb: torch.Tensor,
                off: torch.Tensor, x_slabs: torch.Tensor, n_row_blocks: int,
                phase: str = "fwd") -> torch.Tensor:
    """[n_row_blocks, TR, H] f32 (see the module docstring). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel on the
    current stream or raises."""
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
    if (tiles.dtype != torch.int8 or tiles.dim() != 3
            or not tiles.is_contiguous() or tiles.device != dev):
        raise ValueError(f"tile_matmul: tiles must be contiguous 3-D int8 on "
                         f"{dev}, got {tiles.dtype} {tuple(tiles.shape)}")
    b, tr, tc = tiles.shape
    n_cb, tc_x, h = x_slabs.shape
    for name, v, n in (("rowb", rowb, b), ("colb", colb, b),
                       ("off", off, n_row_blocks + 1)):
        if (v.dtype != torch.int32 or v.shape != (n,) or v.device != dev
                or not v.is_contiguous()):
            raise ValueError(f"tile_matmul: {name} must be contiguous int32 "
                             f"[{n}] on {dev}, got {v.dtype} "
                             f"{tuple(v.shape)}")
    if tc_x != tc:
        raise ValueError(f"tile_matmul: tiles have TC={tc}, slabs {tc_x}")
    if tr % BLOCK_ROWS or tc % BLOCK_K or tiles.data_ptr() % 8:
        raise ValueError(f"tile_matmul: the kernel takes TR % {BLOCK_ROWS} "
                         f"== 0 and TC % {BLOCK_K} == 0, got {tr}x{tc}")
    out = torch.empty((n_row_blocks, tr, h), dtype=torch.float32, device=dev)
    if n_row_blocks == 0 or h == 0:
        return out
    k = lib()
    rc = k.bnsgcn_tile_matmul_f32(
        tiles.data_ptr(), colb.data_ptr(), off.data_ptr(), x_slabs.data_ptr(),
        out.data_ptr(), n_row_blocks, tr, tc, h,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tile_matmul kernel launch failed: "
                           f"{k.bnsgcn_tile_matmul_error(rc).decode()}")
    launches.add(phase)
    return out
