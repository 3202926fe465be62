"""Kernel K1: the ELL bucket gather-sum `out[r] = sum_w h[idx[r, w]]`.

Counterpart of the TPU kernel tools/pallas_spmm.py `pallas_bucket_sum` and
of bnsgcn_tpu/ops/ell.py `_bucket_sum`. The CUDA kernel is
csrc/bucket_sum.cu; `bucket_sum_plain` is the same function in plain
PyTorch, which the CPU tests use and chip_smoke.py holds the kernel to.

Index convention: `idx` entries equal to h.shape[0] (the layout's pad index
n_src) contribute nothing. The JAX path reads them from a zero row appended
to h; the kernel skips them instead, so no padded copy of h is made.
"""

from __future__ import annotations

import ctypes
import os

import torch

from bnsgcn_tpu_torch import buildlib

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "bucket_sum.cu")
LIB_NAME = "bnsgcn_bucket_sum"

launches = buildlib.LaunchCount()


def _declare(lib):
    lib.bnsgcn_bucket_sum_f32.restype = ctypes.c_int
    lib.bnsgcn_bucket_sum_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.bnsgcn_bucket_sum_error.restype = ctypes.c_char_p
    lib.bnsgcn_bucket_sum_error.argtypes = [ctypes.c_int]


def lib() -> ctypes.CDLL:
    return buildlib.load(LIB_NAME, "cuda", [SOURCE], _declare)


def bucket_sum_plain(h: torch.Tensor, idx: torch.Tensor,
                     chunk_gathers: int = 1_000_000) -> torch.Tensor:
    """Plain PyTorch version: `hp[idx].sum(1)` in f32 over h plus one zero
    row, row-chunked so the gathered [rows, W, H] block stays under
    ~chunk_gathers * H elements (bnsgcn_tpu/ops/ell.py `_bucket_sum`,
    accum='reduce')."""
    r, w = idx.shape
    hp = torch.cat([h.float(), h.new_zeros((1, h.shape[1]), dtype=torch.float32)])
    out = torch.empty((r, h.shape[1]), dtype=torch.float32, device=h.device)
    step = max(1, chunk_gathers // max(w, 1))
    for r0 in range(0, r, step):
        out[r0:r0 + step] = hp[idx[r0:r0 + step].long()].sum(1)
    return out


def bucket_sum(h: torch.Tensor, idx: torch.Tensor,
               phase: str = "fwd") -> torch.Tensor:
    """out [R, H] f32 = sum over each row of idx [R, W] int32 of h [N, H] f32
    rows (index N = skip). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel on the current stream or raises."""
    if h.device.type == "cpu":
        return bucket_sum_plain(h, idx)
    if h.device.type != "cuda":
        raise ValueError(f"bucket_sum: unsupported device {h.device}")
    if h.dtype != torch.float32 or h.dim() != 2 or not h.is_contiguous():
        raise ValueError(f"bucket_sum: h must be contiguous 2-D float32, got "
                         f"{h.dtype} {tuple(h.shape)}")
    if (idx.dtype != torch.int32 or idx.dim() != 2 or not idx.is_contiguous()
            or idx.device != h.device):
        raise ValueError(f"bucket_sum: idx must be contiguous 2-D int32 on "
                         f"{h.device}, got {idx.dtype} {tuple(idx.shape)} on "
                         f"{idx.device}")
    n, hdim = h.shape
    r, w = idx.shape
    out = torch.empty((r, hdim), dtype=torch.float32, device=h.device)
    if r == 0 or hdim == 0:
        return out
    k = lib()
    rc = k.bnsgcn_bucket_sum_f32(
        h.data_ptr(), idx.data_ptr(), out.data_ptr(), n, hdim, r, w,
        torch.cuda.current_stream(h.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bucket_sum kernel launch failed: "
                           f"{k.bnsgcn_bucket_sum_error(rc).decode()}")
    launches.add(phase)
    return out
