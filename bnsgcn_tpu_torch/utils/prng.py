"""The parts of `jax.random`'s default generator (threefry2x32) that the
port draws: the boundary-node sampling draw, the model's initialization
(split, uniform, normal) and the dropout masks (bernoulli), in torch
integer ops.

A key is an int64 tensor `[..., 2]` holding the two uint32 words of a JAX
threefry key; every function broadcasts over the leading axes, so one call
derives or draws for many keys at once, on the key's device. Words are held
in int64 and masked to 32 bits after each add: torch's uint32 lacks the
shifts and adds this needs.

The layout is that of `jax_threefry_partitionable = True` (the installed
jax's default):

  * key(s)          = (s >> 32, s & 0xFFFFFFFF)
  * fold_in(k, d)   = threefry2x32(k, (0, d))
  * split(k, n)     = threefry2x32(k, (hi, lo)) over the 64-bit counters
                      0..n-1 split into words, the two output words the
                      new key's (not xored)
  * random words    = bits1 ^ bits2 of threefry2x32(k, (hi, lo)) over the
                      64-bit counters 0..n-1 split into words; an N-d shape
                      counts its elements row-major
  * uniform f32     = ((bits >> 9) | 0x3F800000) viewed as f32, minus 1;
                      with minval/maxval (f32) u * (max - min) + min as
                      one fused multiply-add (XLA's), then max(min, .)
  * bfloat16        = the low byte of each word, >> 1 | 0x3F80, minus 1,
                      scaled in bf16
  * bernoulli(p)    = uniform < f32(p)
  * normal          = f32(sqrt 2) * erfinv(uniform on [nextafter(-1, 0), 1)),
                      erfinv as XLA computes it in f32 (Giles' polynomials
                      in w = -log1p(-x^2), Horner steps fused)

tests/test_torch_prng.py pins each of these bitwise against the installed
jax, except `normal`: torch's log1p is not XLA's, and the two agree
within NORMAL_ULP units in the last place (torch.erfinv itself differs
from XLA's approximation by up to ~90 ulp in the tails).
"""

from __future__ import annotations

from typing import Union

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA                   # threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Word = Union[int, torch.Tensor]
Shape = Union[int, tuple]

# `normal` against jax.random.normal, in f32 units in the last place
# (tests/test_torch_prng.py holds it over 2M draws; 99% are bitwise)
NORMAL_ULP = 3

# XLA's f32 erfinv (M. Giles, "Approximating the erfinv function"): Horner
# coefficients, highest power first, for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613, 0.00943887047,
               1.00167406, 2.83297682)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0: Word, k1: Word, x0: Word,
                 x1: Word) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds of the key (k0, k1) over the counter
    words (x0, x1); all four broadcast. At least one must be a tensor."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """`jax.random.key(seed)`'s words as an int64 tensor [2]."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64,
                        device=device)


def fold_in(k: torch.Tensor, data: Word) -> torch.Tensor:
    """`jax.random.fold_in(k, data)`: keys [..., 2] with data (a uint32
    value, or an int64 tensor of them broadcasting against the keys'
    leading axes) -> keys of the broadcast shape [..., 2]."""
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(y0, y1), -1)


def split(k: torch.Tensor, n: int = 2) -> torch.Tensor:
    """`jax.random.split(k, n)`: keys [..., 2] -> [..., n, 2]."""
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., 0, None], k[..., 1, None], i >> 32, i & MASK)
    return torch.stack([y0, y1], -1)


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(
        int(d) for d in shape)


def random_bits(k: torch.Tensor, shape: Shape, start: int = 0,
                count: "int | None" = None) -> torch.Tensor:
    """The 32-bit words `jax.random.bits(k, shape)` draws, as int64: keys
    [..., 2] -> [..., *shape]. With `count`, only the flat (row-major)
    elements [start, start + count) of that draw, as [..., count]."""
    shape = _shape(shape)
    n = math.prod(shape)
    flat = count is not None
    count = n - start if count is None else count
    i = torch.arange(start, start + count, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., 0, None], k[..., 1, None], i >> 32, i & MASK)
    bits = y0 ^ y1
    return bits if flat else bits.reshape(k.shape[:-1] + shape)


def _floats(bits: torch.Tensor) -> torch.Tensor:
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def _scalar(x: float, dtype, device) -> torch.Tensor:
    """A 0-d tensor of x rounded to dtype, filled on the device (no copy
    from the host, so a draw inside a --strict-exec step syncs nothing)."""
    return torch.full((), x, dtype=dtype, device=device)


def uniform(k: torch.Tensor, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """`jax.random.uniform(k, shape, dtype, minval, maxval)` on [minval,
    maxval): keys [..., 2] -> [..., *shape] (an int shape n gives [..., n]).
    The words are threefry of the counters 0..n-1 (64-bit, split into hi
    and lo words), each the xor of the two output words. bfloat16 takes
    each word's low byte as jax does (7 mantissa bits, so 8 random bits),
    and scales in bf16, each operation rounded."""
    if dtype == torch.bfloat16:
        bits = (random_bits(k, shape) & 0xFF) >> 1 | 0x3F80
        f = bits.to(torch.int16).view(torch.bfloat16) - 1.0
        lo = _scalar(minval, dtype, k.device)
        hi = _scalar(maxval, dtype, k.device)
        return torch.maximum(lo, f * (hi - lo) + lo)
    if dtype != torch.float32:
        raise ValueError(f"uniform: float32 or bfloat16, got {dtype}")
    f = _floats(random_bits(k, shape))
    lo = _scalar(minval, torch.float32, k.device)
    hi = _scalar(maxval, torch.float32, k.device)
    # XLA fuses u * (max - min) + min into one multiply-add, rounded once:
    # in f64 the product of two f32 is exact, and so is the sum whenever
    # min and max - min are of one scale (every draw of the port's), so
    # the one rounding to f32 is the fused one
    fma = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, fma)


def bernoulli(k: torch.Tensor, p: float, shape: Shape) -> torch.Tensor:
    """`jax.random.bernoulli(k, p, shape)`: uniform(k, shape) < f32(p)."""
    return uniform(k, shape) < _scalar(p, torch.float32, k.device)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 erfinv: w = -log1p(-x^2); p a degree-8 polynomial in
    w - 2.5 (w < 5) or sqrt(w) - 3, each Horner step one fused
    multiply-add (exact in f64, rounded once); p * x; +-1 -> +-inf."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    lt5 = torch.tensor(_ERFINV_LT5, dtype=torch.float32, device=x.device)
    ge5 = torch.tensor(_ERFINV_GE5, dtype=torch.float32, device=x.device)
    p = torch.where(lt, lt5[0], ge5[0])
    for i in range(1, len(_ERFINV_LT5)):
        c = torch.where(lt, lt5[i], ge5[i])
        p = (c.double() + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


def normal(k: torch.Tensor, shape: Shape,
           dtype=torch.float32) -> torch.Tensor:
    """`jax.random.normal(k, shape, dtype)`: sqrt(2) * erfinv(u), u uniform
    on [nextafter(-1, 0), 1) in dtype. float32 within NORMAL_ULP of jax's;
    bfloat16 (erfinv in f32, rounded, times bf16 sqrt 2) bitwise."""
    lo = -1.0 + 2.0 ** -8 if dtype == torch.bfloat16 else float(
        np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(k, shape, lo, 1.0, dtype)
    return (torch.tensor(np.sqrt(2), dtype=dtype)
            * erfinv(u.float()).to(dtype))
