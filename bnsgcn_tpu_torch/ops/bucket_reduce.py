"""Kernel K3: the width-axis reduction of a gathered ELL bucket,
`out[r] = sum_w g[r, w]`, accumulated in f32 and cast to g's dtype.

Counterpart of the TPU kernel tools/pallas_spmm.py `pallas_bucket_reduce`
(`_reduce_kernel`), which the JAX package retired from its ELL path
(bnsgcn_tpu/ops/ell.py:488); no path of the port runs it either, since K1
gathers and sums in one kernel. The CUDA kernel is csrc/bucket_reduce.cu;
`bucket_reduce_plain` is the same function in plain PyTorch, which the CPU
tests use and chip_smoke.py holds the kernel to.
"""

from __future__ import annotations

import ctypes
import os

import torch

from bnsgcn_tpu_torch import buildlib

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "bucket_reduce.cu")
LIB_NAME = "bnsgcn_bucket_reduce"
BUILDS = ((LIB_NAME, SOURCE),)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = buildlib.LaunchCount()
_kernel = buildlib.Kernel(
    LIB_NAME, SOURCE, "bnsgcn_bucket_reduce",
    [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 3 + [ctypes.c_int,
                                                     ctypes.c_void_p],
    "bnsgcn_bucket_reduce_error")


def lib() -> ctypes.CDLL:
    return _kernel.load()


def bucket_reduce_plain(g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: an f32 accumulator over w in order, then one
    cast to g's dtype."""
    acc = torch.zeros((g.shape[0], g.shape[2]), dtype=torch.float32,
                      device=g.device)
    for w in range(g.shape[1]):
        acc += g[:, w].float()
    return acc.to(g.dtype)


def bucket_reduce(g: torch.Tensor, phase: str = "check") -> torch.Tensor:
    """[R, W, H] f32 or bf16 -> [R, H] of the same dtype. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel on the current
    stream or raises."""
    if g.device.type == "cpu":
        return bucket_reduce_plain(g)
    if g.device.type != "cuda":
        raise ValueError(f"bucket_reduce: unsupported device {g.device}")
    if g.dtype not in DTYPES or g.dim() != 3 or not g.is_contiguous():
        raise ValueError(f"bucket_reduce: g must be contiguous 3-D float32 "
                         f"or bfloat16, got {g.dtype} {tuple(g.shape)}")
    r, w, h = g.shape
    out = g.new_empty((r, h))
    if r == 0 or h == 0:
        return out
    _kernel(g.data_ptr(), out.data_ptr(), r, w, h, DTYPES[g.dtype],
            buildlib.raw_stream(g.get_device()))
    launches.add(phase)
    return out
