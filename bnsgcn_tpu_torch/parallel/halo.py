"""The halo (boundary-activation) exchange (counterpart of
bnsgcn_tpu/parallel/halo.py): three strategies, four wire codecs, the
staleness-bounded refresh geometry and the seam --overlap split cuts the
exchange at.

Slot layout (data/artifacts.py): extended row `pad_inner + q*pad_b + k` on
part j holds the k-th entry of q's boundary list toward j. One exchange:

  * send: rows h[sel] of my boundary lists toward each peer (all of them
    at rate 1.0, this epoch's BNS sample below it), times the weight
    (1/ratio on a sent entry, 0 on padding), as per-peer blocks [P, S_pad,
    d]; a sample's valid rows are each block's first send_size[me, j];
  * the blocks cross through the strategy's collective, in the wire's
    payload (`wire_quant`: h's dtype, bf16, or int8 / e4m3 with one f32
    scale per (sender, peer) block, the scales in a tiled all-to-all of
    their own), and come back as [P, S_pad, d], block q from rank q:
      - 'padded': one tiled all-to-all of the whole buffer, every pair
        padded to S_pad;
      - 'shift': P-1 rounds, round k carrying the block (p -> p+k) at that
        diagonal's pad `shift_pads[k-1]`, a round of pad 0 skipped; the
        rounds are one batch of send/receive pairs;
      - 'ragged': one split-size all-to-all carrying each pair's exact
        `pair_send[p][j]` rows;
  * receive: index_add_ the P blocks into a zero [n_halo + 1, d] buffer at
    `slots` (padding lands in the trash row n_halo, which is dropped).

The backward is the transpose: gather the halo gradient at `slots`, the
same strategy with the pair sizes transposed (the tiled all-to-all is its
own transpose; a shift round k goes back as round P-k; the ragged sizes
S[p][j] become S[j][p]), a quantized wire quantizing the cotangent with its
own scales, then index_add_ into the inner gradient at `sel` with `weight`,
one peer's block at a time so that the card adds in a fixed order. Every
strategy moves the same rows, so its forward equals padded's bitwise.

`halo_apply` runs one exchange synchronously. `HaloFlight` cuts it at the
JAX package's halo_start/halo_finish seam for --overlap split: start()
launches the collective asynchronously, finish() waits for it and
scatters; its backward launches the transposed collective where the
frontier's cotangent is ready and waits for it only where the inner
gradient is summed, so the interior aggregation's backward runs between.

--halo-refresh K exchanges only the boundary positions {k : k % K == epoch
% K} each epoch (`make_refresh_spec`, `make_halo_plan_refresh`,
`refresh_row_mask`): the same slot layout, sends sized to the largest chunk
without the x8 rounding.

The pack and the scatter are plain torch indexing, as the JAX package
leaves them to XLA; a kernel for them (X1 in ROADMAP) is later work.
Sampled slots stay zero, so the sum over the full static halo edge list is
the reference's sum over the epoch's sampled subgraph, and the 1/ratio
weight makes it unbiased.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from bnsgcn_tpu_torch.parallel.mesh import Comm, Pending
from bnsgcn_tpu_torch.parallel.sampling import (chunk_identity_sample,
                                                chunk_sample, identity_sample,
                                                pair_key, pair_sample)
from bnsgcn_tpu_torch.utils.quant import F8, f8_dequant, f8_quant, i8_quant

WIRES = ("native", "bf16", "int8", "fp8")
STRATEGIES = ("padded", "shift", "ragged")

# --halo-exchange auto (bnsgcn_tpu/parallel/halo.py): ragged must save 5% of
# padded's cross-rank rows to leave the dense collective; shift pays P-1
# serialized hops for ragged's bytes, so it needs 25% and no ragged
RAGGED_MIN_SAVING = 0.05
SHIFT_MIN_SAVING = 0.25


@dataclass(frozen=True)
class HaloSpec:
    """Static exchange geometry (python ints)."""
    n_parts: int
    pad_inner: int
    pad_boundary: int                  # B_pad: per-pair boundary padding
    pad_send: int                      # S_pad: per-pair send padding (<= B_pad)
    exact: bool = True                 # rate == 1.0: identity ordering, no draw
    strategy: str = "padded"           # 'padded' | 'shift' | 'ragged'
    wire: str = "native"
    shift_pads: tuple = ()             # [P-1] round k's send width (shift)
    pair_send: tuple = ()              # [P][P] rows p sends j (ragged)

    @property
    def n_halo(self) -> int:
        return self.n_parts * self.pad_boundary


def _round8(m: int) -> int:
    return ((m + 7) // 8) * 8


def _diagonal_pads(pair_send: np.ndarray, cap: int, round8: bool) -> tuple:
    """Round k's width for k = 1..P-1: the largest send on the diagonal
    (p -> p+k), rounded up to a multiple of 8 when `round8`, at most `cap`;
    0 when no pair of the diagonal sends."""
    P = pair_send.shape[0]
    pads = []
    for k in range(1, P):
        m = int(max(pair_send[p, (p + k) % P] for p in range(P)))
        pads.append(0 if m == 0 else min(_round8(m) if round8 else m, cap))
    return tuple(pads)


def _check_choice(strategy: str, wire: str) -> None:
    if strategy not in STRATEGIES:
        raise ValueError(f"unresolved halo strategy {strategy!r} (resolve "
                         f"'auto' with select_halo_strategy first)")
    if wire not in WIRES:
        raise ValueError(f"halo wire {wire!r} is not one of {WIRES}")


def make_halo_spec(n_b: np.ndarray, pad_inner: int, pad_boundary: int,
                   rate: float, strategy: str = "padded",
                   wire: str = "native") -> tuple[HaloSpec, dict]:
    """The exchange geometry from the boundary sizes and the sampling rate
    (bnsgcn_tpu/parallel/halo.py make_halo_spec; reference train.py:107-131):
    each pair sends send_size = int(rate * n_b) rows, scaled by
    1/ratio = n_b / send_size, fixed for the whole run; rate 0 sends none
    (1/ratio 0, an 8-row pad of zeros). The sizes and ratios are computed
    in float64 numpy, as the JAX package does: a float32 product floors
    some sizes differently. Every strategy's geometry is derived (S_pad,
    the shift rounds' pads, the exact pair sizes). Returns (spec, tables):
    tables = {n_b, send_size} int32 and {inv_ratio} float32, numpy
    [P, P]."""
    _check_choice(strategy, wire)
    n_b = np.asarray(n_b, dtype=np.int64)
    exact = rate >= 1.0
    send_size = n_b if exact else (rate * n_b).astype(np.int64)
    ratio = np.where(n_b > 0, send_size / np.maximum(n_b, 1), 0.0)
    inv_ratio = np.where(ratio > 0, 1.0 / np.maximum(ratio, 1e-30), 0.0)
    # S_pad: one uniform per-pair send width, a multiple of 8, at most B_pad
    pad_send = max(1, int(send_size.max())) if send_size.size else 1
    pad_send = min(_round8(pad_send), pad_boundary)
    spec = HaloSpec(n_parts=n_b.shape[0], pad_inner=pad_inner,
                    pad_boundary=pad_boundary, pad_send=pad_send, exact=exact,
                    strategy=strategy, wire=wire,
                    shift_pads=_diagonal_pads(send_size, pad_send, True),
                    pair_send=tuple(map(tuple, send_size.tolist())))
    return spec, {"n_b": n_b.astype(np.int32),
                  "send_size": send_size.astype(np.int32),
                  "inv_ratio": inv_ratio.astype(np.float32)}


def full_rate_spec(n_b: np.ndarray, pad_inner: int,
                   pad_boundary: int) -> tuple[HaloSpec, dict]:
    """The rate-1.0 (spec, tables) of the use_pp precompute's exchange
    (reference train.py:170-189), whatever the training rate."""
    return make_halo_spec(n_b, pad_inner, pad_boundary, 1.0)


def _ragged_exact_rows(pair_send, n_parts: int) -> int:
    """The busiest sender's off-diagonal rows: what the ragged collective
    puts on the wire."""
    S = np.asarray(pair_send, dtype=np.int64).reshape(n_parts, n_parts).copy()
    np.fill_diagonal(S, 0)
    return int(S.sum(axis=1).max()) if S.size else 0


def wire_bytes(spec: HaloSpec, width: int, native_bytes: int = 4) -> int:
    """Per-rank payload bytes of ONE exchange at the given feature width, at
    the wire's bytes per element (`native_bytes`, the compute dtype's, for
    'native'), the [P] f32 scales left out (bnsgcn_tpu/parallel/halo.py
    wire_bytes): 'padded' the full P-block buffer (the self block rides
    along), 'shift' its rounds' pads, 'ragged' the busiest sender's exact
    off-diagonal rows. The backward exchange costs the same."""
    b = {"native": native_bytes, "bf16": 2, "fp8": 1, "int8": 1}[spec.wire]
    if spec.strategy == "shift":
        return sum(spec.shift_pads) * width * b
    if spec.strategy == "ragged":
        return _ragged_exact_rows(spec.pair_send, spec.n_parts) * width * b
    return spec.n_parts * spec.pad_send * width * b


def ragged_auto_eligible() -> bool:
    """Whether --halo-exchange auto may pick 'ragged'. The JAX package asks
    whether the TPU backend lowers its ragged collective natively; here
    torch's all_to_all_single takes per-rank split sizes natively on nccl
    and on gloo alike, so the answer is always yes."""
    return True


def select_halo_strategy(n_b: np.ndarray, pad_inner: int, pad_boundary: int,
                         rate: float, wire: str = "native",
                         allow_ragged: bool = True) -> tuple[str, str]:
    """--halo-exchange auto (bnsgcn_tpu/parallel/halo.py
    select_halo_strategy): padded, shift or ragged from their rows on the
    wire (the width and the dtype cancel) and the hop count; padded counts
    its P-1 cross-rank blocks. Returns (strategy, reason); deterministic in
    the global n_b table, so every rank and node picks alike."""
    spec = make_halo_spec(n_b, pad_inner, pad_boundary, rate, wire=wire)[0]
    P = spec.n_parts
    padded_rows = (P - 1) * spec.pad_send
    shift_rows = sum(spec.shift_pads)
    ragged_rows = _ragged_exact_rows(spec.pair_send, P)
    if P <= 1 or padded_rows == 0:
        return "padded", "single partition / empty halo"
    if allow_ragged and ragged_rows < (1.0 - RAGGED_MIN_SAVING) * padded_rows:
        return "ragged", (
            f"exact {ragged_rows} rows vs padded {padded_rows} "
            f"({ragged_rows / padded_rows:.0%}), one collective")
    if shift_rows < (1.0 - SHIFT_MIN_SAVING) * padded_rows:
        return "shift", (
            f"per-diagonal {shift_rows} rows vs padded {padded_rows} "
            f"({shift_rows / padded_rows:.0%}), worth P-1 serialized hops"
            + ("" if allow_ragged else "; ragged collective unavailable"))
    if allow_ragged:
        return "padded", (
            f"balanced boundaries (ragged {ragged_rows}/{padded_rows} rows "
            f"saves <{RAGGED_MIN_SAVING:.0%}); one dense collective")
    return "padded", (
        f"ragged collective unavailable and shift {shift_rows}/{padded_rows} "
        f"rows saves <{SHIFT_MIN_SAVING:.0%} (not worth P-1 serialized hops)")


def retune_strategy(n_b: np.ndarray, pad_inner: int, pad_boundary: int,
                    rate: float, current: str, wire: str = "native",
                    allow_ragged: Optional[bool] = None) -> Optional[tuple]:
    """The --tune controller's strategy re-pick (bnsgcn_tpu/parallel/halo.py
    retune_strategy): select_halo_strategy's launch-time byte estimate,
    asked whether a strategy beats the one the run executes. Returns
    (strategy, why) when it prefers another, else None; tune.decide acts on
    it only while the measured comm share is high."""
    if allow_ragged is None:
        allow_ragged = ragged_auto_eligible()
    best, why = select_halo_strategy(n_b, pad_inner, pad_boundary, rate,
                                     wire=wire, allow_ragged=allow_ragged)
    if best == current:
        return None
    return best, why


def make_refresh_spec(n_b: np.ndarray, pad_inner: int, pad_boundary: int,
                      rate: float, refresh: int, strategy: str = "padded",
                      wire: str = "native") -> tuple[HaloSpec, dict]:
    """The --halo-refresh K partial exchange's geometry
    (bnsgcn_tpu/parallel/halo.py make_refresh_spec): chunk c of a boundary
    list holds its positions k % K == c, n_bc of them; the chunk sends
    floor(rate * n_bc) rows, at least 1 where the full exchange sends at
    all, scaled by n_bc / s_c. The slot layout (pad_boundary) is the full
    exchange's; pad_send, the shift pads and pair_send are the largest
    chunk's, without the x8 rounding (it would erase the ~K x saving).
    Tables are [K, P, P] numpy. At K=1 the tables equal make_halo_spec's."""
    _check_choice(strategy, wire)
    K = int(refresh)
    if K < 1:
        raise ValueError(f"halo refresh period must be >= 1, got {K}")
    n_b = np.asarray(n_b, dtype=np.int64)
    P = n_b.shape[0]
    exact = rate >= 1.0
    c_idx = np.arange(K, dtype=np.int64).reshape(K, 1, 1)
    n_bc = (np.maximum(n_b[None] - c_idx, 0) + K - 1) // K
    if exact:
        s_c = n_bc
    else:
        full_send = (rate * n_b).astype(np.int64)
        s_c = np.where((n_bc > 0) & (full_send[None] > 0),
                       np.maximum((rate * n_bc).astype(np.int64), 1), 0)
    ratio_c = np.where(n_bc > 0, s_c / np.maximum(n_bc, 1), 0.0)
    inv_ratio_c = np.where(ratio_c > 0, 1.0 / np.maximum(ratio_c, 1e-30), 0.0)
    pair_send = s_c.max(axis=0)
    pad_b_chunk = (pad_boundary + K - 1) // K
    pad_send = max(1, int(pair_send.max())) if pair_send.size else 1
    pad_send = min(pad_send, max(pad_b_chunk, 1))
    spec = HaloSpec(n_parts=P, pad_inner=pad_inner, pad_boundary=pad_boundary,
                    pad_send=pad_send, exact=exact, strategy=strategy,
                    wire=wire,
                    shift_pads=_diagonal_pads(pair_send, pad_send, False),
                    pair_send=tuple(map(tuple, pair_send.tolist())))
    return spec, {"n_b": n_bc.astype(np.int32),
                  "send_size": s_c.astype(np.int32),
                  "inv_ratio": inv_ratio_c.astype(np.float32)}


@dataclass
class HaloPlan:
    """One rank's send selection and receive scatter plan for one epoch
    (every layer's exchange shares it, as the reference samples once per
    epoch, train.py:388-390)."""
    sel: torch.Tensor                  # [P, S] my boundary rows to send to each peer
    weight: torch.Tensor               # [P, S] f32: 1/ratio on sent entries, 0 on pads
    slots: torch.Tensor                # [P, S] halo slots of received rows (trash = n_halo)
    presence: torch.Tensor             # [pad_inner + n_halo] bool: the inner
                                       # rows and the received halo slots
                                       # (GAT's softmax mask)


def tables_to(tables: dict, device) -> dict:
    """make_halo_spec's numpy tables as tensors on `device`, moved once so
    that a plan per epoch copies nothing from the host."""
    return {k: torch.as_tensor(v, device=device) for k, v in tables.items()}


def make_halo_plan(spec: HaloSpec, tables: dict, bnd: torch.Tensor, me: int,
                   epoch: int = 0,
                   base_key: Optional[torch.Tensor] = None,
                   replica: Optional[int] = None) -> HaloPlan:
    """Rank `me`'s plan for `epoch` from its boundary lists `bnd` [P, B_pad]
    (its row of artifacts.bnd), on bnd's device (bnsgcn_tpu/parallel/
    halo.py make_halo_plan). At rate 1.0 it is the identity: the first n_b
    entries of each list in order, epoch and key unused. Below, the BNS
    draw: toward peer j I send the sample of pair_key(base, epoch, me, j);
    from peer q I receive the sample of pair_key(base, epoch, q, me), which
    q draws alike, so no indices cross the wire. `replica` (an R > 1 run)
    is folded into the keys first (pair_key). `tables` may be numpy or
    tensors on bnd's device (tables_to); static shapes, no host sync."""
    P, Bp, Sp = spec.n_parts, spec.pad_boundary, spec.pad_send
    dev = bnd.device
    t = tables_to(tables, dev)
    n_b = t["n_b"].long()
    peers = torch.arange(P, device=dev)
    if spec.exact:
        pos, valid = identity_sample(n_b[me], Sp)
        rpos, rvalid = identity_sample(n_b[:, me], Sp)
    else:
        pos, valid, rpos, rvalid = _pair_draws(
            pair_sample, base_key, epoch, me, P, n_b, t["send_size"].long(),
            Bp, Sp, replica=replica)
    sel = bnd.long().gather(1, pos)
    weight = torch.where(valid, t["inv_ratio"][me][:, None], 0.0)
    slots = torch.where(rvalid, peers[:, None] * Bp + rpos, spec.n_halo)
    return HaloPlan(sel=sel, weight=weight, slots=slots,
                    presence=plan_presence(spec, slots))


def _pair_draws(sample, base_key, epoch, me: int, P: int, n_b, send,
                pad_b: int, pad_s: int, *extra, replica=None):
    """The draws of rank `me`'s sends (rows 0..P-1: toward j) and receives
    (rows P..2P-1: from q), from the keys pair_key(base, epoch, sender,
    receiver, replica), through `sample` (pair_sample, or chunk_sample with
    its chunk and stride in `extra`)."""
    if base_key is None:
        raise ValueError("a plan at sampling rate < 1 needs the base key")
    dev = n_b.device
    peers = torch.arange(P, device=dev)
    mine = torch.full_like(peers, me)
    keys = pair_key(base_key.to(dev), epoch, torch.cat([mine, peers]),
                    torch.cat([peers, mine]), replica)
    if extra:
        pos, valid = sample(keys, torch.cat([n_b[me], n_b[:, me]]),
                            torch.cat([send[me], send[:, me]]), *extra,
                            pad_b, pad_s)
    else:
        pos, valid = sample(keys, torch.cat([n_b[me], n_b[:, me]]),
                            torch.cat([send[me], send[:, me]]), pad_b, pad_s)
    return pos[:P], valid[:P], pos[P:], valid[P:]


def make_halo_plan_refresh(spec: HaloSpec, tables: dict, bnd: torch.Tensor,
                           me: int, epoch: int,
                           base_key: Optional[torch.Tensor],
                           refresh: int,
                           replica: Optional[int] = None) -> HaloPlan:
    """Rank `me`'s partial plan for `epoch` under --halo-refresh K
    (bnsgcn_tpu/parallel/halo.py make_halo_plan_refresh): chunk c = epoch %
    K of every boundary list, drawn through the same pair keys as the full
    plan (chunk_sample, or chunk_identity_sample at rate 1.0). `spec` and
    `tables` are make_refresh_spec's; slots and presence live in the full
    slot layout, presence covering the refreshed chunk only. Padding
    positions past B_pad are clamped: their weight is 0 and their slot the
    trash row. `replica` folds as in make_halo_plan."""
    K = int(refresh)
    P, Bp, Sp = spec.n_parts, spec.pad_boundary, spec.pad_send
    c = int(epoch) % K
    dev = bnd.device
    t = tables_to(tables, dev)
    n_b_c = t["n_b"][c].long()
    s_c = t["send_size"][c].long()
    peers = torch.arange(P, device=dev)
    if spec.exact:
        pos, valid = chunk_identity_sample(n_b_c[me], c, K, Sp)
        rpos, rvalid = chunk_identity_sample(n_b_c[:, me], c, K, Sp)
    else:
        pos, valid, rpos, rvalid = _pair_draws(
            chunk_sample, base_key, epoch, me, P, n_b_c, s_c,
            (Bp + K - 1) // K, Sp, c, K, replica=replica)
    pos, rpos = pos.clamp(max=Bp - 1), rpos.clamp(max=Bp - 1)
    sel = bnd.long().gather(1, pos)
    weight = torch.where(valid, t["inv_ratio"][c][me][:, None], 0.0)
    slots = torch.where(rvalid, peers[:, None] * Bp + rpos, spec.n_halo)
    return HaloPlan(sel=sel, weight=weight, slots=slots,
                    presence=plan_presence(spec, slots))


def refresh_row_mask(spec: HaloSpec, refresh: int, epoch: int,
                     device=None) -> torch.Tensor:
    """[n_halo] bool: the halo slots of this epoch's refresh chunk, slot
    q*pad_boundary + k when k % K == epoch % K (bnsgcn_tpu/parallel/halo.py
    refresh_row_mask)."""
    k = torch.arange(spec.n_halo, device=device) % spec.pad_boundary
    return (k % int(refresh)) == int(epoch) % int(refresh)


def plan_presence(spec: HaloSpec, slots: torch.Tensor) -> torch.Tensor:
    """[pad_inner + n_halo] bool: every inner row, and the halo slots that
    `slots` fills (bnsgcn_tpu/parallel/halo.py HaloPlan.presence); P=1
    passes an empty `slots` and gets no halo slot."""
    halo = torch.zeros(spec.n_halo + 1, dtype=torch.bool, device=slots.device)
    # a fill, not an indexed store of True: no scalar copied from the host
    halo.index_fill_(0, slots.reshape(-1), True)
    return torch.cat([torch.ones(spec.pad_inner, dtype=torch.bool,
                                 device=slots.device), halo[:-1]])


# ----------------------------------------------------------------------------
# the collectives: per-peer blocks [P, S, d] in, per-sender blocks out
# ----------------------------------------------------------------------------

def wire_quant(x: torch.Tensor, wire: str):
    """x [P, S, d] -> (payload, scales [P, 1, 1] or None): the wire codec,
    one scale per (sender, peer) block over the last two axes
    (bnsgcn_tpu/parallel/halo.py `_quant`)."""
    if wire == "bf16":
        return x.to(torch.bfloat16), None
    if wire == "int8":
        return i8_quant(x, axes=(-2, -1))
    return f8_quant(x, axes=(-2, -1))


@lru_cache(maxsize=64)
def _ragged_rows(sizes: tuple, me: int, S: int, transpose: bool,
                 device: str):
    """(rows I send per peer, rows I receive per peer, the flat [P*S] row
    index of each sent row, the same of each received row) for the pair
    sizes S[p][j] (transposed for the backward)."""
    sz = np.asarray(sizes, dtype=np.int64)
    if transpose:
        sz = sz.T
    send_n, recv_n = sz[me], sz[:, me]

    def flat(ns):
        return torch.as_tensor(np.concatenate(
            [q * S + np.arange(n) for q, n in enumerate(ns)]),
            dtype=torch.long, device=device)

    return send_n.tolist(), recv_n.tolist(), flat(send_n), flat(recv_n)


def warm_ragged(spec: HaloSpec, me: int, device) -> None:
    """Build the ragged strategy's row indices of both directions now (on
    `device`, cached), so that no step copies them from the host."""
    if spec.strategy == "ragged":
        for transpose in (False, True):
            _ragged_rows(spec.pair_send, me, spec.pad_send, transpose,
                         str(torch.device(device)))


def exchange_blocks(spec: HaloSpec, blocks: torch.Tensor, comm: Comm,
                    transpose: bool = False) -> Pending:
    """Launch the strategy's collective on blocks [P, S, d] (block j for
    rank j); the Pending's result is [P, S, d], block q from rank q. Rows a
    strategy does not carry come back zero (shift past the round's pad,
    ragged past the pair's size): they are the zero-weight padding of
    every plan. `transpose` runs the backward's geometry."""
    P, S, d = blocks.shape
    me = comm.rank
    if spec.strategy == "padded":
        p = comm.all_to_all(blocks.reshape(P * S, d))
        return _then(p, lambda out: out.view(P, S, d))
    if spec.strategy == "ragged":
        send_n, recv_n, rows_out, rows_in = _ragged_rows(
            spec.pair_send, me, S, transpose, str(blocks.device))
        p = comm.all_to_all_v(blocks.reshape(P * S, d)[rows_out], send_n,
                              recv_n)

        def unpack(out):
            full = blocks.new_zeros((P * S, d))
            full[rows_in] = out
            return full.view(P, S, d)
        return _then(p, unpack)
    # shift: round k sends block (me + k) and receives block (me - k); the
    # backward's round k carries the forward's round P - k
    out = blocks.new_zeros((P, S, d))
    sends, recvs = [], []
    for k in range(1, P):
        pad = spec.shift_pads[(P - k if transpose else k) - 1]
        if pad == 0:
            continue                       # no pair of this diagonal sends
        to, frm = (me + k) % P, (me - k) % P
        sends.append((to, blocks[to, :pad]))
        recvs.append((frm, out[frm, :pad]))
    return _then(comm.send_recv(sends, recvs), lambda _: out)


def _then(p: Pending, fn) -> Pending:
    """p with fn applied to its result when waited, before its span ends."""
    prev = p.after
    p.after = fn if prev is None else (lambda r: fn(prev(r)))
    return p


def wire_exchange(spec: HaloSpec, send: torch.Tensor, comm: Comm,
                  transpose: bool = False) -> Pending:
    """send [P, S, d] through the wire's codec and the strategy's
    collective, launched asynchronously: the Pending's result is [P, S, d]
    in send's dtype, block q from rank q. A quantized wire ships the
    payload (an e4m3 one as its bytes) and the [P] scales, in a tiled
    all-to-all of their own awaited inside the payload's span, and
    dequantizes with the sender's scales (bnsgcn_tpu/parallel/halo.py
    `_a2a_wire_impl`, `_ppermute_wire_impl`, `_ragged_wire_impl`)."""
    P, S, d = send.shape
    if spec.wire == "native":
        return exchange_blocks(spec, send, comm, transpose)
    payload, scale = wire_quant(send, spec.wire)
    f8 = payload.dtype == F8
    p = exchange_blocks(spec, payload.view(torch.uint8) if f8 else payload,
                        comm, transpose)
    ps = (None if scale is None else
          comm.all_to_all(scale.reshape(P, 1), kind=None))

    def decode(recv):
        if f8:
            recv = recv.view(F8)
        if ps is None:
            return recv.to(send.dtype)
        return f8_dequant(recv, ps.wait().reshape(P, 1, 1), send.dtype)
    return _then(p, decode)


def halo_start(spec: HaloSpec, plan: HaloPlan, h: torch.Tensor,
               comm: Comm) -> Pending:
    """Pack my boundary rows and launch the exchange: the Pending's result
    is the received blocks [P, S_pad, d] in h's dtype, block q from rank q
    (bnsgcn_tpu/parallel/halo.py halo_start)."""
    send = (h[plan.sel] * plan.weight[..., None]).to(h.dtype)   # [P, S, d]
    return wire_exchange(spec, send, comm)


def halo_finish(spec: HaloSpec, plan: HaloPlan,
                recv: torch.Tensor) -> torch.Tensor:
    """Scatter halo_start's received blocks into the per-peer halo slot
    blocks: [n_halo, d] in recv's dtype."""
    d = recv.shape[-1]
    buf = recv.new_zeros((spec.n_halo + 1, d))
    buf.index_add_(0, plan.slots.reshape(-1), recv.reshape(-1, d))
    return buf[:-1]


def halo_back_start(spec: HaloSpec, plan: HaloPlan, g_halo: torch.Tensor,
                    comm: Comm) -> Pending:
    """The backward's exchange, launched: the cotangents of the halo block
    g_halo [n_halo, d] at my receive slots go back to their senders."""
    d = g_halo.shape[-1]
    g_ext = torch.cat([g_halo, g_halo.new_zeros((1, d))])
    return wire_exchange(spec, g_ext[plan.slots], comm, transpose=True)


def halo_back_finish(spec: HaloSpec, plan: HaloPlan, back: torch.Tensor,
                     grad: torch.Tensor) -> torch.Tensor:
    """Add the returned cotangents back [P, S, d], times the weight, into
    the inner gradient `grad` at `sel`, in place: one peer's block at a
    time, since within a block the weighted rows are distinct nodes (a
    sample without replacement; padding adds exact zeros), so on the card
    no two adds meet at an address and the sum takes the same bits every
    run, in the order the CPU takes it."""
    part = (back * plan.weight[..., None]).to(grad.dtype)
    for q in range(spec.n_parts):
        grad.index_add_(0, plan.sel[q], part[q])
    return grad


class _HaloFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, spec: HaloSpec, plan: HaloPlan, comm: Comm):
        ctx.spec, ctx.plan, ctx.comm = spec, plan, comm
        recv = halo_start(spec, plan, h, comm).wait()
        return torch.cat([h, halo_finish(spec, plan, recv)], 0)

    @staticmethod
    def backward(ctx, g):
        spec, plan = ctx.spec, ctx.plan
        back = halo_back_start(spec, plan, g[spec.pad_inner:],
                               ctx.comm).wait()
        grad = halo_back_finish(spec, plan, back, g[:spec.pad_inner].clone())
        return grad, None, None, None


def halo_apply(spec: HaloSpec, plan: HaloPlan, h: torch.Tensor,
               comm: Comm) -> torch.Tensor:
    """One layer's halo exchange: h [pad_inner, d] ->
    h_ext [pad_inner + n_halo, d]; differentiable, its backward the
    transposed exchange."""
    return _HaloFn.apply(h, spec, plan, comm)


class HaloFlight:
    """One layer's exchange cut at its seam (--overlap split): start(h)
    launches it, finish() waits and returns the halo block [n_halo, d].
    Differentiable: the backward launches the transposed exchange where the
    halo block's cotangent arrives (finish's backward) and waits for it
    where h's gradient is formed (start's backward). The autograd engine
    runs ready nodes newest first, so the interior aggregation's backward,
    recorded between the two, runs while the collective is in flight."""

    def __init__(self, spec: HaloSpec, plan: HaloPlan, comm: Comm):
        self.spec, self.plan, self.comm = spec, plan, comm
        self.fwd = self.bwd = self.token = None

    def start(self, h: torch.Tensor) -> None:
        self.token = _StartFn.apply(h, self)

    def finish(self) -> torch.Tensor:
        return _FinishFn.apply(self.token, self)


class _StartFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, flight: HaloFlight):
        flight.fwd = halo_start(flight.spec, flight.plan, h, flight.comm)
        ctx.flight, ctx.shape = flight, h.shape
        return h.new_empty(0)              # the token finish() consumes

    @staticmethod
    def backward(ctx, _):
        f = ctx.flight
        back = f.bwd.wait()
        grad = halo_back_finish(f.spec, f.plan, back,
                                back.new_zeros(ctx.shape))
        return grad, None


class _FinishFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, token, flight: HaloFlight):
        ctx.flight = flight
        return halo_finish(flight.spec, flight.plan, flight.fwd.wait())

    @staticmethod
    def backward(ctx, g):
        f = ctx.flight
        f.bwd = halo_back_start(f.spec, f.plan, g, f.comm)
        return g.new_zeros(0), None


def precompute_exchange(spec_full: HaloSpec, tables_full: dict,
                        bnd: torch.Tensor, feat: torch.Tensor, me: int,
                        comm: Comm) -> torch.Tensor:
    """The use_pp precompute's one full-rate exchange of the raw input
    features (reference train.py:170-189), whatever the training rate:
    feat [pad_inner, F] -> [pad_inner + n_halo, F]."""
    plan = make_halo_plan(spec_full, tables_full, bnd, me)
    return halo_apply(spec_full, plan, feat, comm)
