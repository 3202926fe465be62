"""COO aggregation, --spmm segment, and the --overlap split row partition
(counterpart of bnsgcn_tpu/ops/spmm.py: XLA segment ops there, no TPU
kernel). Plain PyTorch index_add_ and scatter_reduce_; on a card index_add_
adds with atomics, so its sums may differ in the last bits from run to
run. `FixedOrderSum` is the serving forward's sum: each row's terms added
in the order of its own in-edges, the same bits on every call and whatever
other rows the edge list holds.

The split: a destination row is FRONTIER when at least one of its in-edges
comes from a halo slot (src >= n_dst in the extended index space) and
INTERIOR otherwise; an interior row's aggregation does not depend on the
exchange, so it can run while the exchange is in flight. BNS only zeroes
halo values, never removes edges, so the split is the same every epoch.
`split_row_partition` gives the compact interior and frontier row spaces
the ELL and hybrid split layouts build on (ops/ell.py, ops/block_spmm.py),
`split_coo` the segment path's two edge lists; `SplitSpmm` recombines an
(interior, frontier) operator pair into the fused aggregation.
"""

from __future__ import annotations

import numpy as np
import torch


def agg_sum(h_src: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
            n_dst: int, edge_chunk: int = 0,
            budget_elems: int = 1 << 28) -> torch.Tensor:
    """out[v] = sum over edges (u -> v) of h_src[u], [n_dst, H]. Edges with
    dst >= n_dst are dropped. Edges go in chunks of `edge_chunk`
    (--edge-chunk; bnsgcn_tpu/ops/spmm.py gather_scatter_sum), or, without
    it, of as many as keep the gathered [chunk, H] block under
    `budget_elems` elements (1 GiB of f32 by default): the use_pp eval
    layer aggregates raw features, ~34 GB gathered at once on a
    Reddit-scale graph. Differentiable (torch's own index_add_ and
    gather)."""
    out = h_src.new_zeros((n_dst + 1, h_src.shape[1]))
    step = (edge_chunk if edge_chunk > 0 else
            max(1, budget_elems // max(h_src.shape[1], 1)))
    dst = dst.clamp(max=n_dst)
    for e0 in range(0, src.shape[0], step):
        out.index_add_(0, dst[e0:e0 + step], h_src[src[e0:e0 + step]])
    return out[:n_dst]


class FixedOrderSum:
    """The COO sum of a fixed edge list in a fixed order per row: out[v] =
    the terms of v's in-edges added one after another in the order the
    list holds them (the order index_add_ adds them on the CPU), one
    sequential sum per output element (torch.segment_reduce over the edges
    stably sorted by destination). A row's bits so depend on its own
    in-edges alone: not on which other rows the list holds, nor on a card's
    atomics. Edges with dst >= n_dst are dropped. Sorted once, on the
    edges' device; a call gathers whole rows in chunks of at most
    `budget_elems` gathered elements (one longer row alone)."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, n_dst: int,
                 budget_elems: int = 1 << 28):
        dst = dst.long()
        order = torch.sort(dst, stable=True).indices
        counts = torch.bincount(dst.clamp(max=n_dst), minlength=n_dst + 1)
        ptr = np.concatenate([[0], np.cumsum(counts.cpu().numpy())])
        n_real = int(ptr[n_dst])
        self.order = order[:n_real]
        self.src = src.long()[self.order]
        self.lengths = counts[:n_dst]
        self.ptr = ptr[:n_dst + 1]
        self.n_dst, self.budget = n_dst, budget_elems
        self._chunks: dict[int, list] = {}

    def _rows(self, width: int) -> list:
        """[(r0, r1)]: row chunks of at most budget / width edges each."""
        hit = self._chunks.get(width)
        if hit is None:
            step = max(1, self.budget // max(width, 1))
            hit, r0 = [], 0
            while r0 < self.n_dst:
                r1 = int(np.searchsorted(self.ptr, self.ptr[r0] + step,
                                         "right")) - 1
                r1 = min(max(r1, r0 + 1), self.n_dst)
                hit.append((r0, r1))
                r0 = r1
            self._chunks[width] = hit
        return hit

    def _sum(self, width: int, take) -> torch.Tensor:
        """Row chunks of segment sums of take(e0, e1) [e1 - e0, width]."""
        outs = []
        for r0, r1 in self._rows(width):
            e0, e1 = int(self.ptr[r0]), int(self.ptr[r1])
            outs.append(torch.segment_reduce(
                take(e0, e1), "sum", lengths=self.lengths[r0:r1], axis=0,
                unsafe=True))
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    def gather_sum(self, h_src: torch.Tensor) -> torch.Tensor:
        """out[v] = sum over v's in-edges (u -> v) of h_src[u], [n_dst, H]."""
        return self._sum(h_src.shape[1], lambda e0, e1: h_src[self.src[e0:e1]])

    def map_sum(self, width: int, fn) -> torch.Tensor:
        """out[v] = sum over v's in-edges e of fn(e) [width], where fn maps
        a LongTensor of edge ids (positions in the edge list) to their
        rows; [n_dst, width]."""
        return self._sum(width, lambda e0, e1: fn(self.order[e0:e1]))

    def edge_sum(self, vals: torch.Tensor) -> torch.Tensor:
        """out[v] = sum over v's in-edges e of vals[e] (vals [E, d] in the
        edge list's order), [n_dst, d]."""
        return self.map_sum(vals.shape[1], lambda ids: vals[ids])


def frontier_mask(src: np.ndarray, dst: np.ndarray, n_dst: int) -> np.ndarray:
    """[n_dst] bool: rows with >= 1 in-edge from a halo slot, from the full
    static edge list (bnsgcn_tpu/ops/spmm.py frontier_mask)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    m = np.zeros(n_dst, dtype=bool)
    halo = (dst < n_dst) & (src >= n_dst)
    m[dst[halo]] = True
    return m


def _pad8(n: int) -> int:
    return max(8, ((n + 7) // 8) * 8)


def _classify_edges(s: np.ndarray, d: np.ndarray, fm: np.ndarray,
                    n_dst: int):
    """(interior edge mask, frontier edge mask) of one part's padded COO
    edges under the frontier row mask `fm` (padding edges in neither)."""
    fmx = np.append(fm, False)
    real = d < n_dst
    is_f = real & fmx[d]
    return real & ~fmx[d], is_f


def _pack_edge_sets(sets, trash: int):
    """Stack per-part (src, dst) edge lists to [P, E_pad] int32, padded
    with dst == `trash`, src == 0."""
    P = len(sets)
    e_max = _pad8(max((len(s) for s, _ in sets), default=0))
    sa = np.zeros((P, e_max), dtype=np.int32)
    da = np.full((P, e_max), trash, dtype=np.int32)
    for p, (s, d) in enumerate(sets):
        sa[p, :len(s)] = s
        da[p, :len(d)] = d
    return sa, da


def split_row_partition(src_all: np.ndarray, dst_all: np.ndarray, n_dst: int):
    """The interior/frontier row split every split layout family builds on
    (bnsgcn_tpu/ops/spmm.py split_row_partition): per part, the
    destination rows renumbered into two compact row spaces (ids ascending
    with the original id; degree-0 and padded rows are interior), each
    floored at 8 rows. Returns (frontier masks, merge_perm [P, n_dst] int32
    with out[r] = concat(int_out, fro_out)[merge_perm[r]], (src_int,
    dst_int, n_int_pad), (src_fro, dst_fro, n_fro_pad)), the edge arrays
    [P, E_pad] int32 in the compact row spaces, padded with dst == n_X_pad,
    src == 0."""
    P = src_all.shape[0]
    masks = [frontier_mask(src_all[p], dst_all[p], n_dst) for p in range(P)]
    n_int_pad = _pad8(max(int((~m).sum()) for m in masks))
    n_fro_pad = _pad8(max(int(m.sum()) for m in masks))
    merge_perm = np.zeros((P, n_dst), dtype=np.int32)
    e_int, e_fro = [], []
    for p in range(P):
        fm = masks[p]
        int_id = (np.cumsum(~fm) - 1).astype(np.int64)
        fro_id = (np.cumsum(fm) - 1).astype(np.int64)
        merge_perm[p] = np.where(fm, n_int_pad + fro_id, int_id)
        s = np.asarray(src_all[p])
        d = np.asarray(dst_all[p])
        is_i, is_f = _classify_edges(s, d, fm, n_dst)
        e_int.append((s[is_i], int_id[d[is_i]]))
        e_fro.append((s[is_f], fro_id[d[is_f]]))
    si, di = _pack_edge_sets(e_int, n_int_pad)
    sf, df = _pack_edge_sets(e_fro, n_fro_pad)
    return (masks, merge_perm, (si, di, n_int_pad), (sf, df, n_fro_pad))


def split_coo(src_all: np.ndarray, dst_all: np.ndarray, n_dst: int
              ) -> dict[str, np.ndarray]:
    """The segment path's split (bnsgcn_tpu/ops/spmm.py split_coo): each
    part's edges into the interior set and the frontier set (ALL edges of
    the frontier rows, local sources included), each padded to a common
    length with dst == n_dst, src == 0, dst ids in the original row space.
    Returns {'seg_int_src', 'seg_int_dst', 'seg_fro_src', 'seg_fro_dst'}
    [P, E_pad]; the two aggregations cover disjoint rows, so their sum is
    the fused one."""
    P = src_all.shape[0]
    ints, fros = [], []
    for p in range(P):
        s = np.asarray(src_all[p])
        d = np.asarray(dst_all[p])
        is_i, is_f = _classify_edges(s, d, frontier_mask(s, d, n_dst), n_dst)
        ints.append((s[is_i], d[is_i]))
        fros.append((s[is_f], d[is_f]))
    out = {}
    for name, sets in (("int", ints), ("fro", fros)):
        sa, da = _pack_edge_sets(sets, n_dst)
        out[f"seg_{name}_src"] = sa
        out[f"seg_{name}_dst"] = da
    return out


class CooSpmm:
    """--spmm segment: spmm(h_ext [n_src, H]) -> [n_dst, H] as `agg_sum`
    over one part's COO edges (device tensors), in chunks of `edge_chunk`
    edges; autograd runs torch's own backward of the gather and the
    index_add. No kernel: the JAX package computes it outside any Pallas
    kernel."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, n_dst: int,
                 edge_chunk: int = 0):
        self.src, self.dst = src.long(), dst.long()
        self.n_dst, self.edge_chunk = n_dst, edge_chunk

    def with_dtypes(self, gather_dtype: str = "native",
                    dense_dtype: str = "native", row_cap: int = 0):
        return self

    def apply_dir(self, direction: str, h, phase: str, native: bool = False):
        if direction != "fwd":
            raise ValueError("the segment SpMM runs its backward by autograd")
        return agg_sum(h, self.src, self.dst, self.n_dst, self.edge_chunk)

    def __call__(self, h, phase: str = "fwd"):
        return agg_sum(h, self.src, self.dst, self.n_dst, self.edge_chunk)


class SplitSpmm:
    """An (interior, frontier) operator pair of a split layout, the fused
    aggregation when composed (bnsgcn_tpu/trainer.py `_compose_split`):
    interior rows gather from the owned prefix h_ext[:pad_inner], frontier
    rows from the whole extended block, and `merge_perm` [n_dst] puts the
    two outputs back in row order. Serves the precompute and the eval
    forward of a --overlap split run; training runs the two halves around
    the exchange (trainer.py). `interior` and `frontier` are EllSpmm or
    BlockSpmm operators over compact row spaces, or CooSpmm operators over
    `split_coo`'s edge lists, whose outputs share the original row space:
    `merge_perm` None adds them (each row is zero on one side)."""

    def __init__(self, interior, frontier, merge_perm, pad_inner: int):
        self.interior, self.frontier = interior, frontier
        self.merge_perm = None if merge_perm is None else merge_perm.long()
        self.pad_inner = pad_inner

    def with_dtypes(self, gather_dtype: str, dense_dtype: str = "native",
                    row_cap: int = 0) -> "SplitSpmm":
        kw = {} if row_cap == 0 else {"row_cap": row_cap}
        return SplitSpmm(self.interior.with_dtypes(gather_dtype, dense_dtype,
                                                   **kw),
                         self.frontier.with_dtypes(gather_dtype, dense_dtype,
                                                   **kw),
                         self.merge_perm, self.pad_inner)

    def merge(self, o_int: torch.Tensor, o_fro: torch.Tensor) -> torch.Tensor:
        if self.merge_perm is None:
            return o_int + o_fro
        return torch.cat([o_int, o_fro])[self.merge_perm]

    def apply_dir(self, direction: str, h_ext, phase: str,
                  native: bool = False):
        if direction != "fwd":
            raise ValueError("a split operator runs forward only; its "
                             "halves carry their own backward")
        return self.merge(
            self.interior.apply_dir("fwd", h_ext[:self.pad_inner], phase,
                                    native=native),
            self.frontier.apply_dir("fwd", h_ext, phase, native=native))

    def __call__(self, h_ext, phase: str = "fwd"):
        return self.merge(self.interior(h_ext[:self.pad_inner], phase),
                          self.frontier(h_ext, phase))


def segment_softmax(scores: torch.Tensor, dst: torch.Tensor, n_dst: int,
                    mask=None, chunk: int = 1 << 24,
                    fixed: "FixedOrderSum | None" = None) -> torch.Tensor:
    """The masked edge softmax grouped by destination (bnsgcn_tpu/ops/
    spmm.py `segment_softmax`, DGL's edge_softmax in the reference's
    GATConv): scores [E, heads], dst [E] (dst == n_dst: a padded edge, its
    own segment), mask [E] bool or None; masked edges get weight 0. The
    segment max and the denominators are accumulated over edge chunks of
    `chunk` edges; with `fixed` (the same edges' FixedOrderSum) the
    denominators are its fixed-order sums (a padded edge's is 1: its
    weight reaches no real row)."""
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
        if fixed is None:
            denom.index_add_(0, dst[e0:e0 + chunk], x)
    if fixed is not None:
        denom = torch.cat([fixed.edge_sum(ex), s.new_ones((1, heads))])
    denom = denom.clamp(min=1e-16)
    for e0 in range(0, s.shape[0], chunk):
        ex[e0:e0 + chunk] /= denom[dst[e0:e0 + chunk]]
    return ex
