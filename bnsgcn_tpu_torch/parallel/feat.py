"""The feat axis: hidden widths sharded over T ranks (counterpart of
bnsgcn_tpu/parallel/feat.py).

Rank (r, p, f) of an R x P x T run holds part p's graph and shard f of
every weight that shards; the T ranks of one (replica, part) form a 'feat'
group (parallel/replicas.py). A shardable GCN / GraphSAGE / dense layer
slices its full-width input (already dropped out, so D1's masks are the
feat=1 masks) to this shard's H/T columns, runs the halo exchange and the
SpMM on the slice (kernels K1 and K2 at H/T), multiplies by its weight's
row shard and sums the partial products over the group once
(models/gnn.py `_feat_layer`). A GAT graph layer shards heads: its
exchange stays full width, each shard attends over its heads/T heads, and
the head mean is one sum over the group. Biases and norms stay whole on
every rank and are added after the sum.

torch needs the conjugate pair that jax derives from psum and its
transpose (`FeatAxis.enter` and `FeatAxis.sum`): the sum is an all-reduce
forward and the identity backward; the entry to a sharded layer is the
identity forward and an all-reduce of the column-partial gradients
backward. Every rank of a feat group then holds the same activations and
the same upstream gradients, so a leaf it holds whole (a bias, a norm, an
unsharded layer) carries the whole gradient on every one of the T ranks,
and parallel/reducer.py counts it once.

The partition table gives each parameter's sharded dimension (JAX path
'layer_0/w' -> 0, as `gnn_partition_rules` shards it, or None), and its
torch twin the dimension in the port's layout (nn.Linear's weight is the
JAX w transposed). `shard_state` cuts a full state (parameters or Adam's
moments, keyed as the model's state_dict) to a rank's shard, `gather_state`
puts the shards of a group back together with one all-gather: checkpoints
and the host evaluation see full arrays, so they do not depend on T.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


# ----------------------------------------------------------------------------
# which layers shard (bnsgcn_tpu/parallel/feat.py:56-103)
# ----------------------------------------------------------------------------

def layer_fin(spec, i: int) -> int:
    """Layer i's contraction (input) width, what the feat axis slices:
    GraphSAGE's precomputed layer 0 consumes [feat, mean_nbr], twice the
    input width."""
    fin = spec.layer_sizes[i]
    if (spec.model == "graphsage" and spec.use_pp and i == 0
            and i < spec.n_graph_layers):
        fin *= 2
    return fin


def shardable_layers(spec, T: int) -> tuple[bool, ...]:
    """Which layers shard over a feat axis of size T: a GCN / GraphSAGE /
    dense layer when its input width divides by T, a GAT graph layer when
    its heads do. The others keep full width, their weights whole."""
    if T <= 1:
        return (False,) * spec.n_layers
    return tuple((spec.heads % T == 0)
                 if spec.model == "gat" and i < spec.n_graph_layers
                 else layer_fin(spec, i) % T == 0
                 for i in range(spec.n_layers))


def feat_shardable(spec, i: int, T: int) -> bool:
    return shardable_layers(spec, T)[i]


def shard_width(width: int, T: int, shardable: bool = True) -> int:
    """One shard's width: width/T where the layer shards, else width."""
    return width // T if (shardable and T > 1 and width % T == 0) else width


def unshardable_note(spec, T: int) -> Optional[str]:
    """The JAX package's stderr line for layers that keep full width
    (bnsgcn_tpu/trainer.py:447-461), or None when every layer shards."""
    skipped = [i for i, ok in enumerate(shardable_layers(spec, T)) if not ok]
    if T <= 1 or not skipped:
        return None
    return (f"feat={T}: layer(s) {skipped} keep full width (input width/heads "
            f"not divisible by {T}); their params stay replicated")


# ----------------------------------------------------------------------------
# the partition table (bnsgcn_tpu/parallel/feat.py gnn_partition_rules)
# ----------------------------------------------------------------------------

def param_paths(spec) -> list[str]:
    """Every parameter of `spec`'s model as its JAX path, in the JAX
    package's init_params tree ('layer_0/w', 'layer_1/linear1/b',
    'norm_0/scale', ...)."""
    out = []
    for i in range(spec.n_layers):
        if spec.model == "gat" and i < spec.n_graph_layers:
            out += [f"layer_{i}/{k}" for k in ("w", "attn_l", "attn_r",
                                                "bias")]
        elif (spec.model == "graphsage" and i < spec.n_graph_layers
              and not (spec.use_pp and i == 0)):
            out += [f"layer_{i}/linear{j}/{k}" for j in (1, 2)
                    for k in ("w", "b")]
        else:
            out += [f"layer_{i}/w", f"layer_{i}/b"]
        if i < spec.n_layers - 1 and spec.norm in ("layer", "batch"):
            out += [f"norm_{i}/scale", f"norm_{i}/bias"]
    return out


def partition_table(spec, T: int) -> dict:
    """{JAX path: the dimension sharded over 'feat', or None}: weights
    along their input rows ([fin, fout] -> 0) for GCN / GraphSAGE / dense
    layers, GAT's along the head columns ([fin, H F'] -> 1), its attention
    vectors and bias with their heads (-> 0); biases and norms None."""
    ok = shardable_layers(spec, T)
    table = {}
    for path in param_paths(spec):
        head, *_, leaf = path.split("/")
        i = int(head[6:]) if head.startswith("layer_") else -1
        dim = None
        if i >= 0 and ok[i]:
            if spec.model == "gat" and i < spec.n_graph_layers:
                dim = {"w": 1, "attn_l": 0, "attn_r": 0, "bias": 0}[leaf]
            elif leaf == "w":
                dim = 0
        table[path] = dim
    return table


def torch_dims(spec, T: int) -> dict:
    """The partition table in the port's names and layout: {state_dict
    key: sharded dimension} for the sharded parameters only (nn.Linear
    holds the JAX w transposed, so its rows are the torch weight's
    columns; GAT's leaves keep the JAX layout)."""
    out = {}
    for path, dim in partition_table(spec, T).items():
        if dim is None:
            continue
        *mods, leaf = path.split("/")
        if spec.model == "gat" and int(mods[0][6:]) < spec.n_graph_layers:
            out[".".join(mods + [leaf])] = dim
        else:                                   # a Linear's w, transposed
            out[".".join(mods) + ".weight"] = 1 - dim
    return out


def shard_tensor(x: torch.Tensor, dim: int, T: int, f: int) -> torch.Tensor:
    """Shard f of T of x along `dim` (a copy)."""
    k = x.shape[dim] // T
    return x.narrow(dim, f * k, k).clone()


def shard_state(state: dict, dims: dict, T: int, f: int) -> dict:
    """A full state (state_dict-shaped) cut to shard f: the keys in `dims`
    narrowed, the others as they are."""
    return {k: (shard_tensor(v, dims[k], T, f) if k in dims else v)
            for k, v in state.items()}


def gather_state(state: dict, dims: dict, comm) -> dict:
    """The full state from every rank of a feat group's shard (`comm`, its
    rank = f): the keys in `dims` put back together along their dimension
    in shard order, by one all-gather of their values in one flat buffer
    (in the first one's dtype; the parameters and Adam's moments share
    theirs); the others as they are. Every rank of the group calls it."""
    keys = [k for k in state if k in dims]
    if not keys:
        return dict(state)
    dt = state[keys[0]].dtype
    flat = torch.cat([state[k].detach().reshape(-1).to(dt) for k in keys])
    rows = comm.all_gather(flat)                       # [T, n]
    out, off = dict(state), 0
    for k in keys:
        v = state[k]
        n = v.numel()
        out[k] = torch.cat([rows[q, off:off + n].view_as(v)
                            for q in range(comm.world)],
                           dims[k]).to(v.dtype)
        off += n
    return out


# ----------------------------------------------------------------------------
# the layer bodies' collectives
# ----------------------------------------------------------------------------

class _Enter(torch.autograd.Function):
    """The identity forward; the all-reduce over the feat group of the
    column-partial gradients backward (the transpose of jax's psum where
    the shards' inputs meet)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce_(g.contiguous(), "feat"), None


class _Sum(torch.autograd.Function):
    """The all-reduce over the feat group forward; the identity backward
    (every rank holds the whole cotangent of the sum)."""

    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce_(x.contiguous().clone(), "feat")

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclass
class FeatAxis:
    """One rank's view of the feat axis (GraphEnv.feat): its group's Comm
    (rank = f, world = T) and which layers shard."""
    comm: object
    shardable: tuple

    @property
    def T(self) -> int:
        return self.comm.world

    @property
    def f(self) -> int:
        return self.comm.rank

    def enter(self, h: torch.Tensor) -> torch.Tensor:
        """h as a sharded layer's input: its gradient is summed over the
        group in the backward."""
        return _Enter.apply(h, self.comm) if h.requires_grad else h

    def slice(self, h: torch.Tensor) -> torch.Tensor:
        """This shard's columns h[:, f k:(f + 1) k], k = width / T
        (bnsgcn_tpu/models/gnn.py `_feat_slice`)."""
        k = h.shape[-1] // self.T
        return self.enter(h)[..., self.f * k:(self.f + 1) * k]

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The partial products summed over the group (`_feat_psum`)."""
        return _Sum.apply(x, self.comm)
