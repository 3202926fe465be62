"""COO aggregation for the eval forward (counterpart of
bnsgcn_tpu/ops/spmm.py `agg_sum` and `segment_softmax`, XLA segment ops
there: no TPU kernel). Plain PyTorch index_add_ and scatter_reduce_."""

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


def segment_softmax(scores: torch.Tensor, dst: torch.Tensor, n_dst: int,
                    mask=None, chunk: int = 1 << 24) -> torch.Tensor:
    """The masked edge softmax grouped by destination (bnsgcn_tpu/ops/
    spmm.py `segment_softmax`, DGL's edge_softmax in the reference's
    GATConv): scores [E, heads], dst [E] (dst == n_dst: a padded edge, its
    own segment), mask [E] bool or None; masked edges get weight 0. The
    segment max and the denominators are accumulated over edge chunks of
    `chunk` edges."""
    n_out = n_dst + 1
    s = scores if mask is None else torch.where(mask[:, None], scores,
                                                -1e30)
    heads = scores.shape[1]
    smax = s.new_full((n_out, heads), float("-inf"))
    for e0 in range(0, s.shape[0], chunk):
        d = dst[e0:e0 + chunk, None].expand(-1, heads)
        smax.scatter_reduce_(0, d, s[e0:e0 + chunk], "amax")
    smax = torch.where(torch.isfinite(smax), smax, 0.0)
    denom = s.new_zeros((n_out, heads))
    ex = torch.empty_like(s)
    for e0 in range(0, s.shape[0], chunk):
        x = torch.exp(s[e0:e0 + chunk] - smax[dst[e0:e0 + chunk]])
        if mask is not None:
            x = torch.where(mask[e0:e0 + chunk, None], x, 0.0)
        ex[e0:e0 + chunk] = x
        denom.index_add_(0, dst[e0:e0 + chunk], x)
    denom = denom.clamp(min=1e-16)
    for e0 in range(0, s.shape[0], chunk):
        ex[e0:e0 + chunk] /= denom[dst[e0:e0 + chunk]]
    return ex
