"""COO sum-aggregation for the eval forward (counterpart of
bnsgcn_tpu/ops/spmm.py `agg_sum`, an XLA segment_sum there: no TPU kernel).
Plain PyTorch index_add_."""

from __future__ import annotations

import torch


def agg_sum(h_src: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
            n_dst: int, budget_elems: int = 1 << 28) -> torch.Tensor:
    """out[v] = sum over edges (u -> v) of h_src[u], [n_dst, H]. Edges with
    dst >= n_dst are dropped. Edges go in chunks so the gathered [chunk, H]
    block stays under `budget_elems` elements (1 GiB of f32 by default): the
    use_pp eval layer aggregates raw features, ~34 GB gathered at once on a
    Reddit-scale graph."""
    out = h_src.new_zeros((n_dst + 1, h_src.shape[1]))
    step = max(1, budget_elems // max(h_src.shape[1], 1))
    dst = dst.clamp(max=n_dst)
    for e0 in range(0, src.shape[0], step):
        out.index_add_(0, dst[e0:e0 + step], h_src[src[e0:e0 + step]])
    return out[:n_dst]
