"""The halo (boundary-activation) exchange (counterpart of
bnsgcn_tpu/parallel/halo.py), strategy 'padded' with wire 'native'.

Slot layout (data/artifacts.py): extended row `pad_inner + q*pad_b + k` on
part j holds the k-th entry of q's boundary list toward j. One exchange:

  * send: rows h[sel] of my boundary lists toward each peer (all of them
    at rate 1.0, this epoch's BNS sample below it), times the weight
    (1/ratio on a sent entry, 0 on padding), as [P, S_pad, d];
  * one tiled all-to-all over P*S_pad contiguous rows (block j to rank j);
  * receive: index_add_ the P blocks into a zero [n_halo + 1, d] buffer at
    `slots` (padding lands in the trash row n_halo, which is dropped).

The backward is the transpose: gather the halo gradient at `slots`, the same
all-to-all (the tiled all-to-all is its own transpose: block j goes back to
rank j), index_add_ into the inner gradient at `sel` with `weight`. The pack
and the scatter are plain torch indexing, as the JAX package leaves them to
XLA; a kernel for them (X1 in ROADMAP) is later work. Sampled slots stay
zero, so the sum over the full static halo edge list is the reference's sum
over the epoch's sampled subgraph, and the 1/ratio weight makes it unbiased.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from bnsgcn_tpu_torch.parallel.mesh import Comm
from bnsgcn_tpu_torch.parallel.sampling import (identity_sample, pair_key,
                                                pair_sample)


@dataclass(frozen=True)
class HaloSpec:
    """Static exchange geometry (python ints)."""
    n_parts: int
    pad_inner: int
    pad_boundary: int                  # B_pad: per-pair boundary padding
    pad_send: int                      # S_pad: per-pair send padding (<= B_pad)
    exact: bool = True                 # rate == 1.0: identity ordering, no draw
    strategy: str = "padded"
    wire: str = "native"

    @property
    def n_halo(self) -> int:
        return self.n_parts * self.pad_boundary


def make_halo_spec(n_b: np.ndarray, pad_inner: int, pad_boundary: int,
                   rate: float, strategy: str = "padded",
                   wire: str = "native") -> tuple[HaloSpec, dict]:
    """The exchange geometry from the boundary sizes and the sampling rate
    (bnsgcn_tpu/parallel/halo.py make_halo_spec; reference train.py:107-131):
    each pair sends send_size = int(rate * n_b) rows, scaled by
    1/ratio = n_b / send_size, fixed for the whole run. The sizes and ratios
    are computed in float64 numpy, as the JAX package does: a float32
    product floors some sizes differently. Returns (spec, tables): tables =
    {n_b, send_size} int32 and {inv_ratio} float32, numpy [P, P]."""
    if strategy != "padded" or wire != "native":
        raise ValueError(f"halo exchange {strategy}/{wire} is not ported yet")
    n_b = np.asarray(n_b, dtype=np.int64)
    exact = rate >= 1.0
    send_size = n_b if exact else (rate * n_b).astype(np.int64)
    ratio = np.where(n_b > 0, send_size / np.maximum(n_b, 1), 0.0)
    inv_ratio = np.where(ratio > 0, 1.0 / np.maximum(ratio, 1e-30), 0.0)
    # S_pad: one uniform per-pair send width, a multiple of 8, at most B_pad
    pad_send = max(1, int(send_size.max())) if send_size.size else 1
    pad_send = min(((pad_send + 7) // 8) * 8, pad_boundary)
    spec = HaloSpec(n_parts=n_b.shape[0], pad_inner=pad_inner,
                    pad_boundary=pad_boundary, pad_send=pad_send, exact=exact,
                    strategy=strategy, wire=wire)
    return spec, {"n_b": n_b.astype(np.int32),
                  "send_size": send_size.astype(np.int32),
                  "inv_ratio": inv_ratio.astype(np.float32)}


def full_rate_spec(n_b: np.ndarray, pad_inner: int,
                   pad_boundary: int) -> tuple[HaloSpec, dict]:
    """The rate-1.0 (spec, tables) of the use_pp precompute's exchange
    (reference train.py:170-189), whatever the training rate."""
    return make_halo_spec(n_b, pad_inner, pad_boundary, 1.0)


def wire_bytes(spec: HaloSpec, width: int, native_bytes: int = 4) -> int:
    """Per-rank payload bytes of ONE exchange at the given feature width:
    the full P-block all-to-all buffer (the self block rides along). The
    backward exchange costs the same."""
    return spec.n_parts * spec.pad_send * width * native_bytes


@dataclass
class HaloPlan:
    """One rank's send selection and receive scatter plan for one epoch
    (every layer's exchange shares it, as the reference samples once per
    epoch, train.py:388-390)."""
    sel: torch.Tensor                  # [P, S] my boundary rows to send to each peer
    weight: torch.Tensor               # [P, S] f32: 1/ratio on sent entries, 0 on pads
    slots: torch.Tensor                # [P, S] halo slots of received rows (trash = n_halo)


def tables_to(tables: dict, device) -> dict:
    """make_halo_spec's numpy tables as tensors on `device`, moved once so
    that a plan per epoch copies nothing from the host."""
    return {k: torch.as_tensor(v, device=device) for k, v in tables.items()}


def make_halo_plan(spec: HaloSpec, tables: dict, bnd: torch.Tensor, me: int,
                   epoch: int = 0,
                   base_key: Optional[torch.Tensor] = None) -> HaloPlan:
    """Rank `me`'s plan for `epoch` from its boundary lists `bnd` [P, B_pad]
    (its row of artifacts.bnd), on bnd's device (bnsgcn_tpu/parallel/
    halo.py make_halo_plan). At rate 1.0 it is the identity: the first n_b
    entries of each list in order, epoch and key unused. Below, the BNS
    draw: toward peer j I send the sample of pair_key(base, epoch, me, j);
    from peer q I receive the sample of pair_key(base, epoch, q, me), which
    q draws alike, so no indices cross the wire. `tables` may be numpy or
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
        if base_key is None:
            raise ValueError("a plan at sampling rate < 1 needs the base key")
        send = t["send_size"].long()
        mine = torch.full_like(peers, me)
        # rows 0..P-1: I send to j; rows P..2P-1: q sends to me
        keys = pair_key(base_key.to(dev), epoch, torch.cat([mine, peers]),
                        torch.cat([peers, mine]))
        pos, valid = pair_sample(keys, torch.cat([n_b[me], n_b[:, me]]),
                                 torch.cat([send[me], send[:, me]]), Bp, Sp)
        pos, rpos = pos[:P], pos[P:]
        valid, rvalid = valid[:P], valid[P:]
    sel = bnd.long().gather(1, pos)
    weight = torch.where(valid, t["inv_ratio"][me][:, None], 0.0)
    slots = torch.where(rvalid, peers[:, None] * Bp + rpos, spec.n_halo)
    return HaloPlan(sel=sel, weight=weight, slots=slots)


def halo_start(spec: HaloSpec, plan: HaloPlan, h: torch.Tensor,
               comm: Comm) -> torch.Tensor:
    """Pack my boundary rows and run the all-to-all: the received payload
    [P*S_pad, d], block q from rank q."""
    P, Sp, d = spec.n_parts, spec.pad_send, h.shape[-1]
    send = (h[plan.sel] * plan.weight[..., None]).to(h.dtype)   # [P, S, d]
    return comm.all_to_all(send.reshape(P * Sp, d))


def halo_finish(spec: HaloSpec, plan: HaloPlan, recv: torch.Tensor,
                like: torch.Tensor) -> torch.Tensor:
    """Scatter halo_start's payload into the per-peer halo slot blocks:
    [n_halo, d]."""
    buf = like.new_zeros((spec.n_halo + 1, like.shape[-1]))
    buf.index_add_(0, plan.slots.reshape(-1), recv.to(like.dtype))
    return buf[:-1]


class _HaloFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, spec: HaloSpec, plan: HaloPlan, comm: Comm):
        ctx.spec, ctx.plan, ctx.comm = spec, plan, comm
        recv = halo_start(spec, plan, h, comm)
        return torch.cat([h, halo_finish(spec, plan, recv, h)], 0)

    @staticmethod
    def backward(ctx, g):
        spec, plan = ctx.spec, ctx.plan
        P, Sp, d = spec.n_parts, spec.pad_send, g.shape[-1]
        g_halo = torch.cat([g[spec.pad_inner:], g.new_zeros((1, d))])
        back = ctx.comm.all_to_all(g_halo[plan.slots.reshape(-1)])  # [P*S, d]
        grad = g[:spec.pad_inner].clone()
        grad.index_add_(0, plan.sel.reshape(-1),
                        (back * plan.weight.reshape(P * Sp, 1)).to(g.dtype))
        return grad, None, None, None


def halo_apply(spec: HaloSpec, plan: HaloPlan, h: torch.Tensor,
               comm: Comm) -> torch.Tensor:
    """One layer's halo exchange: h [pad_inner, d] ->
    h_ext [pad_inner + n_halo, d]; differentiable, its backward the
    transposed exchange."""
    return _HaloFn.apply(h, spec, plan, comm)


def precompute_exchange(spec_full: HaloSpec, tables_full: dict,
                        bnd: torch.Tensor, feat: torch.Tensor, me: int,
                        comm: Comm) -> torch.Tensor:
    """The use_pp precompute's one full-rate exchange of the raw input
    features (reference train.py:170-189), whatever the training rate:
    feat [pad_inner, F] -> [pad_inner + n_halo, F]."""
    plan = make_halo_plan(spec_full, tables_full, bnd, me)
    return halo_apply(spec_full, plan, feat, comm)
