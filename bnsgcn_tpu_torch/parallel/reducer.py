"""Gradient reduction (counterpart of bnsgcn_tpu/parallel/reducer.py).

Each rank's loss is its local cross-entropy sum over the GLOBAL n_train, so
the SUM of the ranks' gradients is the full-graph mean-loss gradient. In the
JAX package the AD transpose of the replicated parameters emits that sum as
one psum; here `reduce_gradients` runs it after loss.backward() as one
all_reduce(SUM) over one flat buffer of every parameter's gradient, with the
loss riding in the same buffer, so the printed loss is the all-reduced sum
at no extra collective.

On an R x P x T run (parallel/replicas.py) the same one all-reduce runs
over the world. Each rank's loss is over n_train x R, so the sum is the
mean over the replicas of each replica's gradient (the JAX package rides
1/R on its 1/n_train scale, bnsgcn_tpu/trainer.py:435-438). A leaf that a
feat shard holds whole (a bias, a norm, an unsharded layer) carries the
whole gradient on each of its group's T ranks (parallel/feat.py), so only
shard 0 contributes it, and the loss; a sharded leaf enters at its full
shape, zero outside this rank's shard, so the sum gives every rank the
gradient of its shard summed over the R x P ranks that hold it. One
collective per step, as at T = 1, moving the full parameter count.

`moments_sum` is SyncBatchNorm's collective (the JAX package's psum of
[sum_x, sum_x2]): one all-reduce per layer forward, added in rank order,
and the same sum of the cotangents backward (psum's transpose); on an
R x P x T run over the world.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import torch

from bnsgcn_tpu_torch.parallel.mesh import Comm


def reduce_gradients(params, comm: Comm, loss: torch.Tensor,
                     shard_dims: Optional[list] = None, T: int = 1,
                     f: int = 0) -> torch.Tensor:
    """SUM every parameter's .grad over the ranks in place, in the
    parameters' dtype; returns the all-reduced loss (a 0-d f32 tensor),
    which rides in the same buffer when the gradients are f32 and in one
    f32 all-reduce of its own otherwise (the JAX package sums its f32 loss
    apart from the bf16 gradients). Under a feat axis of T > 1 this rank
    is shard f and `shard_dims` gives each parameter's sharded dimension
    or None: the module docstring's layout."""
    params = [p for p in params]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    dims = shard_dims if T > 1 else [None] * len(params)
    dt = grads[0].dtype
    ride = dt == torch.float32

    def full_shape(g, d):
        return g.shape[:d] + (g.shape[d] * T,) + g.shape[d + 1:]

    def entry(g, d):
        if d is None:
            return g if f == 0 else torch.zeros_like(g)
        out = g.new_zeros(full_shape(g, d))
        out.narrow(d, f * g.shape[d], g.shape[d]).copy_(g)
        return out

    own = loss.detach().reshape(1) * (1.0 if f == 0 else 0.0)
    flat = torch.cat([entry(g, d).reshape(-1) for g, d in zip(grads, dims)]
                     + ([own.to(dt)] if ride else []))
    comm.all_reduce_(flat)
    off = 0
    for p, g, d in zip(params, grads, dims):
        n = g.numel() * (1 if d is None else T)
        got = flat[off:off + n]
        if d is not None:
            got = got.view(full_shape(g, d)).narrow(d, f * g.shape[d],
                                                    g.shape[d])
        if p.grad is None:
            p.grad = g
        p.grad.copy_(got.reshape(g.shape))
        off += n
    if ride:
        return flat[-1]
    total = own.float().clone()
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


def _digest(params) -> str:
    h = hashlib.sha256()
    for p in params:
        h.update(p.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


@torch.no_grad()
def assert_replicated(params, comm: Comm,
                      shard_dims: Optional[list] = None, f: int = 0) -> str:
    """Check that every rank holds bitwise the same parameters as rank 0
    (did every rank apply the same update?). Under a feat axis
    (`shard_dims` as reduce_gradients takes it, this rank shard f) the
    leaves held whole are checked over the world and each shard among the
    ranks that hold it. Returns this rank's digest."""
    params = [p for p in params]
    dims = shard_dims or [None] * len(params)
    whole = _digest(p for p, d in zip(params, dims) if d is None)
    shard = _digest(p for p, d in zip(params, dims) if d is not None)
    got = comm.all_gather_object((f, whole, shard))
    bad = [r for r, (q, w, s) in enumerate(got)
           if w != got[0][1] or s != next(x[2] for x in got if x[0] == q)]
    if bad:
        raise AssertionError(f"the parameters of ranks {bad} differ from "
                             f"rank 0's after the run")
    return whole + shard


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
