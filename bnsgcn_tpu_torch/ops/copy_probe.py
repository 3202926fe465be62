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
BUILDS = ((LIB_NAME, SOURCE),)
PROBE_SHAPE = (4, 8, 128)

launches = buildlib.LaunchCount()
_kernel = buildlib.Kernel(
    LIB_NAME, SOURCE, "bnsgcn_copy_probe",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p],
    "bnsgcn_copy_probe_error")


def lib() -> ctypes.CDLL:
    return _kernel.load()


def copy_probe_plain(x: torch.Tensor) -> torch.Tensor:
    return x[0:1].clone()


def copy_probe(x: torch.Tensor, phase: str = "check") -> torch.Tensor:
    """x[0:1] as a new tensor. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel on the current stream or raises. The kernel
    takes contiguous f32 with x[0] a multiple of 16 bytes, at most 16 KiB
    (its shared buffer), 16-byte aligned; the C entry point checks size and
    alignment and refuses the rest (ValueError)."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return copy_probe_plain(x)
        raise ValueError(f"copy_probe: unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() or not x.dim():
        raise ValueError(f"copy_probe: x must be contiguous float32 with a "
                         f"leading axis, got {x.dtype} {tuple(x.shape)}")
    out = x.new_empty((1,) + x.shape[1:])
    _kernel(x.data_ptr(), out.data_ptr(), x.nbytes // max(len(x), 1),
            buildlib.raw_stream(x.get_device()))
    launches.add(phase)
    return out
