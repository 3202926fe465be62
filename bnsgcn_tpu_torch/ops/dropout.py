"""Kernel D1: dropout with the JAX package's own mask, drawn in the kernel.

`dropout(x, key, rate)` is the JAX package's `_dropout`
(bnsgcn_tpu/models/gnn.py:230-235): jnp.where(jax.random.bernoulli(key,
1 - rate, x.shape), x / (1 - rate), 0) in x's dtype (f32 or bf16), with
`key` a threefry key's two words (utils/prng.py). The mask is a pure
function of (key, element index), so the backward is the same draw over
the incoming gradient (the derivative of where(mask, x / keep, 0)) and a
rematerialized forward (--remat) draws the same mask; none is stored.

On a CUDA tensor the wrapper launches csrc/dropout.cu (D1), counted in
`launches` under 'fwd' or 'bwd'; on a CPU tensor it runs `dropout_plain`,
the same function through utils/prng.py's torch integer ops (the tests hold
it bitwise to jax). The JAX package has no Pallas kernel here: XLA fuses
the draw into one elementwise pass, which D1 is.
"""

from __future__ import annotations

import ctypes
import os

import torch

from bnsgcn_tpu_torch import buildlib
from bnsgcn_tpu_torch.utils import prng

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "dropout.cu")
LIB_NAME = "bnsgcn_dropout"
BUILDS = ((LIB_NAME, SOURCE),)
# the plain version draws this many elements' words at a time
PLAIN_CHUNK = 1 << 22
_DTYPES = {torch.float32: (0, "f32"), torch.bfloat16: (1, "bf16")}

launches = buildlib.LaunchCount()
_kernel = buildlib.Kernel(
    LIB_NAME, SOURCE, "bnsgcn_dropout",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
     ctypes.c_uint32, ctypes.c_float, ctypes.c_float, ctypes.c_int,
     ctypes.c_void_p],
    "bnsgcn_dropout_error")


def lib() -> ctypes.CDLL:
    return _kernel.load()


def key_words(key) -> tuple[int, int]:
    """A threefry key (an int64 tensor [2], or two ints) as two ints."""
    if isinstance(key, torch.Tensor):
        k0, k1 = (int(w) for w in key.tolist())
    else:
        k0, k1 = (int(w) for w in key)
    return k0 & prng.MASK, k1 & prng.MASK


def _divisor(keep: float, dtype: torch.dtype) -> torch.Tensor:
    # jax divides by the weakly typed scalar in x's dtype
    return torch.tensor(keep, dtype=dtype)


def dropout_plain(x: torch.Tensor, k0: int, k1: int,
                  keep: float) -> torch.Tensor:
    """where(uniform(key, x.shape) < f32(keep), x / keep, 0) in x's dtype,
    drawn PLAIN_CHUNK elements at a time (utils/prng.py)."""
    flat = x.contiguous().reshape(-1)
    out = torch.empty_like(flat)
    key = torch.tensor([k0, k1], dtype=torch.int64, device=x.device)
    keep32 = torch.tensor(keep, dtype=torch.float32, device=x.device)
    div = _divisor(keep, x.dtype).to(x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    for s in range(0, flat.numel(), PLAIN_CHUNK):
        c = min(PLAIN_CHUNK, flat.numel() - s)
        u = prng._floats(prng.random_bits(key, flat.numel(), s, c))
        out[s:s + c] = torch.where(u < keep32, flat[s:s + c] / div, zero)
    return out.view_as(x)


def dropout_apply(x: torch.Tensor, k0: int, k1: int, keep: float,
                  phase: str = "fwd") -> torch.Tensor:
    """One pass of the draw over x. A CPU tensor takes the plain version; a
    CUDA tensor launches D1 on the current stream or raises (f32 or bf16,
    contiguous)."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return dropout_plain(x, k0, k1, keep)
        raise ValueError(f"dropout: unsupported device {x.device}")
    if x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"dropout: x must be contiguous float32 or "
                         f"bfloat16, got {x.dtype} {tuple(x.shape)}")
    code, kind = _DTYPES[x.dtype]
    out = torch.empty_like(x)
    _kernel(x.data_ptr(), out.data_ptr(), x.numel(), k0, k1, keep,
            float(_divisor(keep, x.dtype)), code,
            buildlib.raw_stream(x.get_device()))
    launches.add(phase, kind)
    return out


class _DropoutFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k0: int, k1: int, keep: float):
        ctx.k0, ctx.k1, ctx.keep = k0, k1, keep
        return dropout_apply(x.contiguous(), k0, k1, keep, "fwd")

    @staticmethod
    def backward(ctx, g):
        return (dropout_apply(g.contiguous(), ctx.k0, ctx.k1, ctx.keep,
                              "bwd"), None, None, None)


def dropout(x: torch.Tensor, key, rate: float) -> torch.Tensor:
    """The JAX package's `_dropout(x, rate, key, training=True)`: x itself
    at rate <= 0 or without a key."""
    if rate <= 0.0 or key is None:
        return x
    k0, k1 = key_words(key)
    return _DropoutFn.apply(x, k0, k1, 1.0 - rate)
