"""Gradient reduction (counterpart of bnsgcn_tpu/parallel/reducer.py).

Each rank's loss is its local cross-entropy sum over the GLOBAL n_train, so
the SUM of the ranks' gradients is the full-graph mean-loss gradient. In the
JAX package the AD transpose of the replicated parameters emits that sum as
one psum; here `reduce_gradients` runs it after loss.backward() as one
all_reduce(SUM) over one flat buffer of every parameter's gradient, with the
loss riding in the same buffer, so the printed loss is the all-reduced sum
at no extra collective.

`moments_sum` is SyncBatchNorm's collective (the JAX package's psum of
[sum_x, sum_x2]): one all-reduce per layer forward, added in rank order,
and the same sum of the cotangents backward (psum's transpose).
"""

from __future__ import annotations

import hashlib

import torch

from bnsgcn_tpu_torch.parallel.mesh import Comm


def reduce_gradients(params, comm: Comm, loss: torch.Tensor) -> torch.Tensor:
    """SUM every parameter's .grad over the ranks in place, in the
    parameters' dtype; returns the all-reduced loss (a 0-d f32 tensor),
    which rides in the same buffer when the gradients are f32 and in one
    f32 all-reduce of its own otherwise (the JAX package sums its f32 loss
    apart from the bf16 gradients)."""
    params = [p for p in params]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    dt = grads[0].dtype
    ride = dt == torch.float32
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + ([loss.detach().reshape(1).to(dt)] if ride else []))
    comm.all_reduce_(flat)
    off = 0
    for p, g in zip(params, grads):
        n = g.numel()
        if p.grad is None:
            p.grad = g
        p.grad.copy_(flat[off:off + n].view_as(g))
        off += n
    if ride:
        return flat[-1]
    total = loss.detach().float().reshape(1).clone()
    return comm.all_reduce_(total)[0]


@torch.no_grad()
def broadcast_parameters(params, comm: Comm, src: int = 0) -> None:
    """Every rank starts from rank `src`'s parameters."""
    params = [p for p in params]
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    comm.broadcast_(flat, src)
    off = 0
    for p in params:
        p.copy_(flat[off:off + p.numel()].view_as(p))
        off += p.numel()


@torch.no_grad()
def assert_replicated(params, comm: Comm) -> str:
    """Check that every rank holds bitwise the same parameters as rank 0
    (did every rank apply the same update?). Returns this rank's digest."""
    h = hashlib.sha256()
    for p in params:
        h.update(p.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    digest = h.hexdigest()
    digests = comm.all_gather_object(digest)
    bad = [r for r, d in enumerate(digests) if d != digests[0]]
    if bad:
        raise AssertionError(f"the parameters of ranks {bad} differ from "
                             f"rank 0's after the run")
    return digest


class _MomentsSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm: Comm):
        ctx.comm = comm
        return comm.all_sum_ordered(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_sum_ordered(g.contiguous()), None


def moments_sum(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """x (the stacked [sum_x, sum_x2] of a layer) summed over the ranks in
    rank order, the gradient likewise: bitwise the same on every rank."""
    return _MomentsSum.apply(x, comm)
