"""The parts of `jax.random`'s default generator (threefry2x32) that the
boundary-node sampling draw uses, in torch integer ops.

A key is an int64 tensor `[..., 2]` holding the two uint32 words of a JAX
threefry key; every function broadcasts over the leading axes, so one call
derives or draws for many keys at once, on the key's device. Words are held
in int64 and masked to 32 bits after each add: torch's uint32 lacks the
shifts and adds this needs.

The layout is that of `jax_threefry_partitionable = True` (the installed
jax's default):

  * key(s)          = (s >> 32, s & 0xFFFFFFFF)
  * fold_in(k, d)   = threefry2x32(k, (0, d))
  * n random words  = bits1 ^ bits2 of threefry2x32(k, (hi, lo)) over the
                      64-bit counters 0..n-1 split into words
  * uniform f32     = ((bits >> 9) | 0x3F800000) viewed as f32, minus 1

tests/test_torch_prng.py pins each of these bitwise against the installed
jax.
"""

from __future__ import annotations

from typing import Union

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA                   # threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Word = Union[int, torch.Tensor]


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


def uniform(k: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.uniform(k, (n,))` in float32 on [0, 1): keys [..., 2] ->
    [..., n]. The n words are threefry of the counters 0..n-1 (64-bit,
    split into hi and lo words), each the xor of the two output words."""
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., 0, None], k[..., 1, None], i >> 32, i & MASK)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
