"""Partitioning at P=1 plus the degree helpers (counterpart of
bnsgcn_tpu/data/partitioner.py). Multi-part partitioning waits for the slice
that ports the halo exchange."""

from __future__ import annotations

import numpy as np

from bnsgcn_tpu_torch.data.graph import Graph


def partition_graph(g: Graph, n_parts: int, method: str = "metis",
                    obj: str = "vol", seed: int = 0) -> np.ndarray:
    if n_parts == 1:
        return np.zeros(g.n_nodes, dtype=np.int32)
    raise NotImplementedError(
        f"n_parts={n_parts}: multi-part partitioning is not ported yet")


def degree_tables(src: np.ndarray, dst: np.ndarray,
                  n_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Degree recompute from COO edges: (in_deg, out_deg), [N] int64."""
    in_deg = np.bincount(np.asarray(dst), minlength=n_nodes).astype(np.int64)
    out_deg = np.bincount(np.asarray(src), minlength=n_nodes).astype(np.int64)
    return in_deg, out_deg


def degree_norm_row(deg_g: np.ndarray, ids: np.ndarray, pad: int) -> np.ndarray:
    """One part's padded degree row: global degrees at `ids` (the part's
    sorted inner node ids), padding rows pinned to 1 so the normalization
    divide is a no-op on them. f32."""
    row = np.ones(pad, dtype=np.float32)
    row[:len(ids)] = deg_g[ids]
    return row
