"""Kernel K4: the manual-copy probe, `out = x[0:1]` copied through shared
memory by one TMA bulk copy that completes on an mbarrier.

Counterpart of the TPU probe tools/hw_session.py `dma_kernel` (one
`pltpu.make_async_copy` of x[0] into VMEM at f32 [4, 8, 128]), a check that
the toolchain reaches the chip's manual-copy path; no training path runs
it. The CUDA kernel is csrc/copy_probe.cu; `copy_probe_plain` is the same
function in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import os

import torch

from bnsgcn_tpu_torch import buildlib

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "copy_probe.cu")
LIB_NAME = "bnsgcn_copy_probe"
MAX_BYTES = 16384       # the kernel's shared buffer
PROBE_SHAPE = (4, 8, 128)

launches = buildlib.LaunchCount()


def _declare(lib):
    lib.bnsgcn_copy_probe.restype = ctypes.c_int
    lib.bnsgcn_copy_probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_uint32, ctypes.c_void_p]
    lib.bnsgcn_copy_probe_error.restype = ctypes.c_char_p
    lib.bnsgcn_copy_probe_error.argtypes = [ctypes.c_int]


def lib() -> ctypes.CDLL:
    return buildlib.load(LIB_NAME, "cuda", [SOURCE], _declare)


def copy_probe_plain(x: torch.Tensor) -> torch.Tensor:
    return x[0:1].clone()


def copy_probe(x: torch.Tensor, phase: str = "check") -> torch.Tensor:
    """x[0:1] as a new tensor. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel on the current stream or raises. The kernel
    takes f32 with x[0] a multiple of 16 bytes and at most MAX_BYTES."""
    if x.device.type == "cpu":
        return copy_probe_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"copy_probe: unsupported device {x.device}")
    nbytes = x[0].numel() * x.element_size() if x.dim() else 0
    if (x.dtype != torch.float32 or x.dim() < 1 or not x.is_contiguous()
            or nbytes == 0 or nbytes % 16 or nbytes > MAX_BYTES
            or x.data_ptr() % 16):
        raise ValueError(f"copy_probe: x must be contiguous float32, 16-byte "
                         f"aligned, with x[0] a multiple of 16 bytes up to "
                         f"{MAX_BYTES}, got {x.dtype} {tuple(x.shape)}")
    out = torch.empty((1,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    k = lib()
    rc = k.bnsgcn_copy_probe(x.data_ptr(), out.data_ptr(), nbytes,
                             torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"copy_probe kernel launch failed: "
                           f"{k.bnsgcn_copy_probe_error(rc).decode()}")
    launches.add(phase)
    return out
