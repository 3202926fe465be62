"""Boundary-node sampling (counterpart of bnsgcn_tpu/parallel/sampling.py).

Only the full-rate 'sample' of this slice: at sampling rate 1.0 every
boundary node crosses the wire. The shared-key BNS draw (`pair_key`,
`pair_sample`) comes with the rate < 1 slice.
"""

from __future__ import annotations

import numpy as np


def identity_sample(n_valid, pad_s: int) -> tuple[np.ndarray, np.ndarray]:
    """Full-rate 'sample': positions 0..pad_s with the first n_valid marked
    valid. `n_valid` may be a vector of per-peer counts ([P] -> [P, pad_s]
    masks), as the JAX package vmaps it."""
    pos = np.arange(pad_s, dtype=np.int64)
    return pos, pos < np.asarray(n_valid)[..., None]
