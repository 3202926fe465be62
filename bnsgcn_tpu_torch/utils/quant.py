"""Narrow-wire quantization codecs, e4m3 and int8 (counterpart of
bnsgcn_tpu/utils/quant.py).

One symmetric rule (amax -> scale -> cast) serves the quantized halo wire
(parallel/halo.py, one scale per (sender, peer) block) and the quantized
SpMM gathers (ops/ell.py, one scale per call). Gradients get their own
scales at their own call sites. Payloads and scales are array-equal to the
JAX package's on the same f32 inputs: torch.round rounds half to even as
jnp.round does, and the cast to float8_e4m3fn rounds to nearest even as
ml_dtypes does.
"""

from __future__ import annotations

import torch

F8 = torch.float8_e4m3fn
F8_MAX = 448.0
I8_MAX = 127.0
_AMAX_FLOOR = 1e-30


def _sym_scale(x: torch.Tensor, qmax: float, axes, keepdims: bool):
    """(x as f32, scale) for symmetric quantization into [-qmax, qmax]:
    one 0-d scale for the whole tensor (axes=None), else one per slice over
    `axes`."""
    xf = x.float()
    amax = (xf.abs().amax() if axes is None
            else xf.abs().amax(dim=axes, keepdim=keepdims))
    return xf, amax.clamp(min=_AMAX_FLOOR) / qmax


def f8_quant(x: torch.Tensor, axes=None, keepdims: bool = True):
    """(payload e4m3, scale f32)."""
    xf, scale = _sym_scale(x, F8_MAX, axes, keepdims)
    return (xf / scale).to(F8), scale


def f8_dequant(payload: torch.Tensor, scale, dtype) -> torch.Tensor:
    """payload * scale in f32, cast to `dtype` (int8 payloads too)."""
    return (payload.float() * scale).to(dtype)


def i8_quant(x: torch.Tensor, axes=None, keepdims: bool = True):
    """(payload int8, scale f32): round half to even, clip to +-127."""
    xf, scale = _sym_scale(x, I8_MAX, axes, keepdims)
    return (torch.round(xf / scale).clamp(-I8_MAX, I8_MAX).to(torch.int8),
            scale)
