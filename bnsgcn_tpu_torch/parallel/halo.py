"""The halo (boundary-activation) exchange (counterpart of
bnsgcn_tpu/parallel/halo.py), strategy 'padded' with wire 'native'.

Slot layout (data/artifacts.py): extended row `pad_inner + q*pad_b + k` on
part j holds the k-th entry of q's boundary list toward j. One exchange:

  * send: rows h[sel] of my boundary lists toward each peer, times the
    per-pair weight (1 for a real entry, 0 for padding), as [P, S_pad, d];
  * one tiled all-to-all over P*S_pad contiguous rows (block j to rank j);
  * receive: index_add_ the P blocks into a zero [n_halo + 1, d] buffer at
    `slots` (padding lands in the trash row n_halo, which is dropped).

The backward is the transpose: gather the halo gradient at `slots`, the same
all-to-all (the tiled all-to-all is its own transpose: block j goes back to
rank j), index_add_ into the inner gradient at `sel` with `weight`. The pack
and the scatter are plain torch indexing, as the JAX package leaves them to
XLA; a kernel for them (X1 in ROADMAP) is later work.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bnsgcn_tpu_torch.parallel.mesh import Comm
from bnsgcn_tpu_torch.parallel.sampling import identity_sample


@dataclass(frozen=True)
class HaloSpec:
    """Static exchange geometry (python ints)."""
    n_parts: int
    pad_inner: int
    pad_boundary: int                  # B_pad: per-pair boundary padding
    pad_send: int                      # S_pad: per-pair send padding (<= B_pad)
    exact: bool = True                 # rate == 1.0: identity ordering
    strategy: str = "padded"
    wire: str = "native"

    @property
    def n_halo(self) -> int:
        return self.n_parts * self.pad_boundary


def make_halo_spec(n_b: np.ndarray, pad_inner: int, pad_boundary: int,
                   rate: float, strategy: str = "padded",
                   wire: str = "native") -> tuple[HaloSpec, dict]:
    """The exchange geometry from the boundary sizes (bnsgcn_tpu/parallel/
    halo.py make_halo_spec) at sampling rate 1.0, where every boundary row
    is sent with weight 1: the send sizes are n_b. Returns (spec, tables):
    tables = {n_b} as numpy [P, P]. Rate < 1 (BNS) comes with the sampling
    slice, with its send sizes and 1/ratio weights."""
    if strategy != "padded" or wire != "native":
        raise ValueError(f"halo exchange {strategy}/{wire} is not ported yet")
    if rate < 1.0:
        raise NotImplementedError("halo exchange at sampling rate < 1 (BNS) "
                                  "is not ported yet")
    n_b = np.asarray(n_b, dtype=np.int64)
    # S_pad: one uniform per-pair send width, a multiple of 8, at most B_pad
    pad_send = max(1, int(n_b.max())) if n_b.size else 1
    pad_send = min(((pad_send + 7) // 8) * 8, pad_boundary)
    spec = HaloSpec(n_parts=n_b.shape[0], pad_inner=pad_inner,
                    pad_boundary=pad_boundary, pad_send=pad_send, exact=True,
                    strategy=strategy, wire=wire)
    return spec, {"n_b": n_b.astype(np.int32)}


def wire_bytes(spec: HaloSpec, width: int, native_bytes: int = 4) -> int:
    """Per-rank payload bytes of ONE exchange at the given feature width:
    the full P-block all-to-all buffer (the self block rides along). The
    backward exchange costs the same."""
    return spec.n_parts * spec.pad_send * width * native_bytes


@dataclass
class HaloPlan:
    """One rank's send selection and receive scatter plan."""
    sel: torch.Tensor                  # [P, S] my boundary rows to send to each peer
    weight: torch.Tensor               # [P, S] f32: 1 on real entries, 0 on pads
    slots: torch.Tensor                # [P, S] halo slots of received rows (trash = n_halo)


def make_halo_plan(spec: HaloSpec, tables: dict, bnd: torch.Tensor,
                   me: int) -> HaloPlan:
    """Rank `me`'s plan from its boundary lists `bnd` [P, B_pad] (its row of
    artifacts.bnd), on bnd's device. Rate 1.0 (the only spec there is): the
    first n_b entries of each list, in order; the BNS draw of rate < 1 comes
    with the sampling slice."""
    P, Bp, Sp = spec.n_parts, spec.pad_boundary, spec.pad_send
    pos, valid = identity_sample(tables["n_b"][me], Sp)       # [S], [P, S]
    rpos, rvalid = identity_sample(tables["n_b"][:, me], Sp)
    sel = bnd.long()[:, torch.from_numpy(pos).to(bnd.device)]
    weight = valid.astype(np.float32)
    slots = np.where(rvalid, np.arange(P)[:, None] * Bp + rpos[None, :],
                     spec.n_halo)
    return HaloPlan(
        sel=sel.contiguous(),
        weight=torch.from_numpy(weight.astype(np.float32)).to(bnd.device),
        slots=torch.from_numpy(slots.astype(np.int64)).to(bnd.device))


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
