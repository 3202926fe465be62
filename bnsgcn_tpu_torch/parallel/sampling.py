"""Boundary-node sampling with a shared key (counterpart of
bnsgcn_tpu/parallel/sampling.py).

Sender p and receiver j of a pair draw the same uniform without-replacement
subset of p's boundary list toward j from one key, `pair_key(base, epoch,
p, j)`, so no indices cross the wire: the draw is the JAX package's,
bitwise (utils/prng.py is its threefry stream). At sampling rate 1.0 the
'sample' is the identity. `chunk_sample` (--halo-refresh) and the replica
fold come with their slices.
"""

from __future__ import annotations

import numpy as np
import torch

from bnsgcn_tpu_torch.utils import prng


def _fold_guard(x, name: str):
    """A fold_in operand must be one uint32 word: a Python int outside
    [0, 2**32) would wrap onto (and share the stream of) another value.
    Tensors are the caller's to keep in range. Returns x unchanged."""
    if isinstance(x, (int, np.integer)) and not 0 <= int(x) < 2 ** 32:
        raise ValueError(
            f"pair_key {name}={x} outside the uint32 fold_in range [0, 2**32):"
            f" fold_in would silently wrap and alias another {name}'s "
            f"sampling stream")
    return x


def pair_key(base_key: torch.Tensor, epoch, p, j) -> torch.Tensor:
    """The key sender p and receiver j share for one epoch: base folded
    with epoch, then p, then j. p and j may be int64 tensors, which gives
    one key per element: [..., 2]."""
    k = prng.fold_in(base_key, _fold_guard(epoch, "epoch"))
    k = prng.fold_in(k, _fold_guard(p, "p"))
    return prng.fold_in(k, _fold_guard(j, "j"))


def pair_sample(keys: torch.Tensor, n_valid: torch.Tensor,
                s_valid: torch.Tensor, pad_b: int,
                pad_s: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A uniform random s_valid-subset of the positions [0, n_valid) for
    each key: keys [R, 2], n_valid and s_valid [R] -> (positions [R, pad_s]
    int64, valid [R, pad_s] bool), the first s_valid of each row valid.

    The JAX package scores pad_b uniforms (2.0 past n_valid) and takes
    `lax.top_k(-scores, pad_s)`, which breaks ties by the lower index. A
    stable ascending sort does the same; torch.topk does not. The scores
    are 23-bit, so a list of ~30k boundary nodes holds some ties."""
    scores = prng.uniform(keys, pad_b)
    pos = torch.arange(pad_b, device=keys.device)
    scores = torch.where(pos < n_valid[:, None], scores, 2.0)
    idx = torch.sort(scores, dim=1, stable=True).indices[:, :pad_s]
    return idx, pos[None, :pad_s] < s_valid[:, None]


def identity_sample(n_valid: torch.Tensor,
                    pad_s: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-rate 'sample': positions 0..pad_s with the first n_valid
    marked valid, for each row of n_valid [R] -> ([R, pad_s], [R, pad_s])."""
    pos = torch.arange(pad_s, device=n_valid.device)
    return (pos.expand(n_valid.shape[0], pad_s),
            pos[None] < n_valid[:, None])
