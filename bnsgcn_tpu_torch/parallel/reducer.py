"""Gradient reduction (counterpart of bnsgcn_tpu/parallel/reducer.py).

Each rank's loss is its local cross-entropy sum over the GLOBAL n_train, so
the SUM of the ranks' gradients is the full-graph mean-loss gradient. In the
JAX package the AD transpose of the replicated parameters emits that sum as
one psum; here `reduce_gradients` runs it after loss.backward() as one
all_reduce(SUM) over one flat buffer of every parameter's gradient, with the
loss riding in the same buffer, so the printed loss is the all-reduced sum
at no extra collective.
"""

from __future__ import annotations

import hashlib

import torch

from bnsgcn_tpu_torch.parallel.mesh import Comm


def reduce_gradients(params, comm: Comm, loss: torch.Tensor) -> torch.Tensor:
    """SUM every parameter's .grad over the ranks in place; returns the
    all-reduced loss (a 0-d tensor)."""
    params = [p for p in params]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss.detach().reshape(1).to(grads[0].dtype)])
    comm.all_reduce_(flat)
    off = 0
    for p, g in zip(params, grads):
        n = g.numel()
        if p.grad is None:
            p.grad = g
        p.grad.copy_(flat[off:off + n].view_as(g))
        off += n
    return flat[-1]


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
        h.update(p.detach().contiguous().cpu().numpy().tobytes())
    digest = h.hexdigest()
    digests = comm.all_gather_object(digest)
    bad = [r for r, d in enumerate(digests) if d != digests[0]]
    if bad:
        raise AssertionError(f"the parameters of ranks {bad} differ from "
                             f"rank 0's after the run")
    return digest
