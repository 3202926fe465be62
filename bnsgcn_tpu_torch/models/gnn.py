"""GCN / GraphSAGE / GAT as nn.Modules (counterpart of
bnsgcn_tpu/models/gnn.py).

Layer for layer the JAX package's math (itself the reference BNS-GCN's
module/layer.py and module/model.py):

  * GCN: h/out_norm -> sum over in-edges -> /in_norm -> linear;
  * GraphSAGE: linear1(h_self) + linear2(sum(h_nbr)/in_deg) with the global
    in-degree; with use_pp, layer 0 is one Linear(2*in, out) over the
    precomputed [feat, mean_nbr] in training and cat(feat, mean) @ W in eval;
  * GAT (DGL's GATConv, the reference's module/model.py:102,111-132): a
    shared projection z = h W, additive attention leaky(el[u] + er[v]) with
    slope 0.2, the edge softmax over v's in-edges with the unsampled halo
    slots masked out (GraphEnv.presence), feat dropout on the exchanged
    rows and, in training, on a separately projected copy of the dst rows,
    edge-deterministic attention dropout, a bias, the mean over heads.
    use_pp is always on: training's layer 0 attends over the precompute's
    full-rate raw halo features (GraphEnv.gat_feat0);
  * stack: dropout -> exchange -> layer -> LayerNorm or SyncBatchNorm ->
    ReLU, with an optional dense tail of n_linear layers. SyncBatchNorm
    (the reference's module/sync_bn.py, the JAX package's
    `_sync_batch_norm`) takes its moments over the real rows of every rank
    (one all-reduce per layer, GraphEnv.bn_sum) over the global n_train;
    its running mean and variance are f32 buffers of the norm module;
  * the feat axis (GraphEnv.feat, parallel/feat.py): a layer that shards
    slices its full-width input, already dropped out, to its H/T columns,
    exchanges and aggregates the slice, multiplies by its weight shard and
    sums over the feat group (`_feat_layer`); a sharded GAT layer attends
    over its heads/T heads and sums the head sums over the group.

The random draws are the JAX package's own (utils/prng.py, ops/dropout.py):
`init_params` draws the JAX parameter tree of `init_params(key(seed))`
element for element, and a training forward splits the step's key
(GraphEnv.rng) into one key per layer, a GAT layer's into its three
(feat dropout of the extended rows, of the dst rows, the attention
dropout's hash seeds). Dropout runs kernel D1 on a card. With
GraphEnv.remat each layer of a training forward runs under
torch.utils.checkpoint (the JAX package's jax.checkpoint per layer): its
activations are recomputed in the backward, its collectives rerun, its
dropout masks redrawn from the same keys, and its new BN statistics leave
as outputs of the forward.

Parameters live in nn.Linear / nn.LayerNorm modules and GATLayer's
parameters (w, attn_l, attn_r, bias in the JAX package's layout), named as
the JAX parameter tree is keyed (layer_i, layer_i.linear1, norm_i), so
trainer.params_from_jax maps one onto the other. Aggregation is injected
through GraphEnv.aggregate (the ELL, hybrid or segment SpMM in training,
COO index_add_ in eval), or with the exchange through
GraphEnv.agg_exchange (--overlap split), and GAT's through GraphEnv.attention (the ELL
attention, ops/ell_attention.py) or, without it, the COO segment softmax
over GraphEnv.src/dst.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from bnsgcn_tpu_torch.config import Config
from bnsgcn_tpu_torch.ops.dropout import dropout as _d1_dropout
from bnsgcn_tpu_torch.ops.spmm import segment_softmax
from bnsgcn_tpu_torch.parallel.feat import (FeatAxis, shard_tensor,
                                            shardable_layers, torch_dims)
from bnsgcn_tpu_torch.utils import prng


@dataclass(frozen=True)
class ModelSpec:
    model: str                         # 'gcn' | 'graphsage' | 'gat'
    layer_sizes: tuple[int, ...]       # (n_feat, hidden, ..., n_class)
    n_linear: int = 0
    norm: Optional[str] = "layer"
    dropout: float = 0.5
    use_pp: bool = False
    heads: int = 1
    train_size: int = 0                # global n_train

    @property
    def n_layers(self) -> int:
        return len(self.layer_sizes) - 1

    @property
    def n_graph_layers(self) -> int:
        return self.n_layers - self.n_linear


def spec_from_config(cfg: Config) -> ModelSpec:
    # GAT is always use_pp, as in the reference trainer (train.py:222)
    return ModelSpec(model=cfg.model, layer_sizes=tuple(cfg.layer_sizes()),
                     n_linear=cfg.n_linear, norm=cfg.norm,
                     dropout=cfg.dropout,
                     use_pp=True if cfg.model == "gat" else cfg.use_pp,
                     heads=cfg.heads, train_size=cfg.n_train)


@dataclass
class GraphEnv:
    """What a forward pass needs to know about the (local) graph.

    exchange(layer, h [n_dst, d]) -> h_ext [n_src_ext, d]: the halo exchange
    (at P=1 in training: h plus the zero halo slots; in eval: identity).
    aggregate(h_ext) -> [n_dst, d]: sum over in-edges."""
    n_dst: int
    in_norm: torch.Tensor              # [n_dst] GCN: sqrt(in_deg); SAGE: in_deg
    out_norm: Optional[torch.Tensor]   # [n_src_ext] GCN: sqrt(out_deg)
    exchange: Callable[[int, torch.Tensor], torch.Tensor]
    aggregate: Optional[Callable[[torch.Tensor], torch.Tensor]]
    training: bool = True
    # the step's dropout key (utils/prng.py words, an int64 tensor [2] on
    # the host): fold_in(fold_in(key(seed + 1), epoch), rank)
    rng: Optional[torch.Tensor] = None
    # GAT: the extended rows present this epoch (inner rows and the sampled
    # halo slots), [n_src_ext] bool, None = all; the precompute's raw
    # features with their full-rate halo rows (training's layer 0); the ELL
    # attention (ops/ell_attention.GatAttention), else the segment softmax
    # over the COO edges src -> dst
    presence: Optional[torch.Tensor] = None
    gat_feat0: Optional[torch.Tensor] = None
    attention: Optional[Callable] = None
    src: Optional[torch.Tensor] = None
    dst: Optional[torch.Tensor] = None
    # agg_exchange(layer, h [n_dst, d], scale_out_norm) -> [n_dst, d]: the
    # exchange and the sum-aggregation in one (--overlap split's interior /
    # frontier layer body); None runs exchange, then aggregate
    agg_exchange: Optional[Callable] = None
    # SyncBatchNorm: the real rows [n_dst] bool, and the sum of the stacked
    # moments [2, d] over the ranks (None at P=1)
    inner_mask: Optional[torch.Tensor] = None
    bn_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    remat: bool = False                # per-layer checkpoint in training
    # the feat axis (parallel/feat.py): its group and which layers shard;
    # None runs every layer whole. bn_copies: how many ranks' moments each
    # real row's enter bn_sum (R x T: every replica holds the whole graph,
    # every feat shard the whole activations)
    feat: Optional[FeatAxis] = None
    bn_copies: int = 1


class SageLayer(nn.Module):
    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.linear1 = nn.Linear(fin, fout)
        self.linear2 = nn.Linear(fin, fout)


class GATLayer(nn.Module):
    """The JAX package's GAT parameters, in its layout: w [fin, H fout],
    attn_l and attn_r [H, fout], bias [H fout]."""

    def __init__(self, fin: int, fout: int, heads: int):
        super().__init__()
        self.heads, self.fin, self.fout = heads, fin, fout
        self.w = nn.Parameter(torch.empty(fin, heads * fout))
        self.attn_l = nn.Parameter(torch.empty(heads, fout))
        self.attn_r = nn.Parameter(torch.empty(heads, fout))
        self.bias = nn.Parameter(torch.zeros(heads * fout))


class BatchNorm(nn.Module):
    """SyncBatchNorm's parameters (weight = the JAX 'scale', bias) and its
    running statistics, buffers `mean` and `var` that stay float32
    whatever dtype the module is cast to (the JAX package's f32
    `bn_state`)."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("mean", torch.zeros(n))
        self.register_buffer("var", torch.ones(n))

    def _apply(self, fn, *args, **kw):
        mean, var = self.mean, self.var
        super()._apply(fn, *args, **kw)
        # a device move, never a cast
        self.mean = mean.to(self.weight.device)
        self.var = var.to(self.weight.device)
        return self


class GNN(nn.Module):
    """Modules layer_{i} (nn.Linear, SageLayer or GATLayer) and norm_{i}
    (LayerNorm or BatchNorm), initialized from the JAX key of `seed` as
    the JAX package's init_params(key(seed)) draws them, in `dtype`'s
    draw."""

    def __init__(self, spec: ModelSpec, seed: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if spec.model not in ("gcn", "graphsage", "gat"):
            raise ValueError(f"model {spec.model!r} is not ported yet")
        if spec.norm not in ("layer", "batch", None):
            raise ValueError(f"norm {spec.norm!r} is not ported yet")
        self.spec = spec
        for i in range(spec.n_layers):
            fin, fout = spec.layer_sizes[i], spec.layer_sizes[i + 1]
            if i < spec.n_graph_layers and spec.model == "gat":
                layer = GATLayer(fin, fout, spec.heads)
            elif (i >= spec.n_graph_layers or spec.model == "gcn"):
                layer = nn.Linear(fin, fout)
            elif spec.use_pp and i == 0:
                # the precompute doubles layer 0's input width
                layer = nn.Linear(2 * fin, fout)
            else:
                layer = SageLayer(fin, fout)
            self.add_module(f"layer_{i}", layer)
            if i < spec.n_layers - 1 and spec.norm == "layer":
                self.add_module(f"norm_{i}", nn.LayerNorm(fout, eps=1e-5))
            elif i < spec.n_layers - 1 and spec.norm == "batch":
                self.add_module(f"norm_{i}", BatchNorm(fout))
        init_params(self, prng.key(seed), dtype)


def _linear_init(lin: nn.Linear, key, dtype):
    """The JAX package's `_linear_init`: kw, kb = split(key); W [fin, fout]
    and b uniform on +-1/sqrt(fin), W transposed into nn.Linear."""
    kw, kb = prng.split(key)
    bound = 1.0 / lin.in_features ** 0.5
    w = prng.uniform(kw, (lin.in_features, lin.out_features), -bound, bound,
                     dtype)
    lin.weight.copy_(w.T)
    lin.bias.copy_(prng.uniform(kb, lin.out_features, -bound, bound, dtype))


def _xavier_normal(p: torch.Tensor, key, fan_in: int, fan_out: int,
                   gain: float, dtype):
    std = gain * (2.0 / (fan_in + fan_out)) ** 0.5
    p.copy_(torch.tensor(std, dtype=dtype) * prng.normal(key, p.shape, dtype))


def init_params(model: GNN, key: torch.Tensor,
                dtype: torch.dtype = torch.float32):
    """The JAX package's init_params(key, spec, dtype)
    (bnsgcn_tpu/models/gnn.py:183-223), draw for draw: one key per layer
    (split(key, n_layers)); a Linear uniform on +-1/sqrt(fan_in) (weight,
    then bias, from split(layer key)); GraphSAGE's linear1 and linear2 from
    split(layer key); a GAT layer's w, attn_l and attn_r Xavier-normal with
    gain sqrt(2) from split(layer key, 3), its bias 0. The values are drawn
    in `dtype` (a bf16 run draws bf16, as jax does) and stored in the
    parameters' dtype. A norm starts at (1, 0), SyncBatchNorm's running
    statistics at (0, 1)."""
    spec = model.spec
    keys = prng.split(key, spec.n_layers)
    with torch.no_grad():
        for i in range(spec.n_layers):
            layer = getattr(model, f"layer_{i}")
            if isinstance(layer, nn.Linear):
                _linear_init(layer, keys[i], dtype)
            elif isinstance(layer, SageLayer):
                k1, k2 = prng.split(keys[i])
                _linear_init(layer.linear1, k1, dtype)
                _linear_init(layer.linear2, k2, dtype)
            else:
                kf, kl, kr = prng.split(keys[i], 3)
                g2 = 2.0 ** 0.5
                _xavier_normal(layer.w, kf, layer.fin,
                               layer.heads * layer.fout, g2, dtype)
                _xavier_normal(layer.attn_l, kl, layer.fout, 1, g2, dtype)
                _xavier_normal(layer.attn_r, kr, layer.fout, 1, g2, dtype)
                layer.bias.zero_()


def shard_model(model: GNN, T: int, f: int) -> GNN:
    """`model`, holding full parameters, cut in place to feat shard f of T
    (parallel/feat.py): every parameter of the partition table narrowed to
    its shard, a sharded GAT layer's `heads` set to its heads/T. The
    others stay whole."""
    for name, dim in torch_dims(model.spec, T).items():
        owner, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(owner)
        setattr(mod, leaf, nn.Parameter(shard_tensor(
            getattr(mod, leaf).detach(), dim, T, f)))
    for i, ok in enumerate(shardable_layers(model.spec, T)):
        layer = getattr(model, f"layer_{i}")
        if ok and isinstance(layer, GATLayer):
            layer.heads //= T
    return model


# ----------------------------------------------------------------------------
# building blocks
# ----------------------------------------------------------------------------

def _dropout(h, rate, rng, training):
    """The JAX package's `_dropout`: jax's bernoulli mask of `rng`, in the
    activations' dtype (ops/dropout.py, D1 on a card)."""
    if not training or rate <= 0.0 or rng is None:
        return h
    return _d1_dropout(h, rng, rate)


def _dropout_heads(a, rate, rng, training, n_total: int, off: int):
    """The JAX package's `_dropout_heads`: dropout on the last (head) axis
    with the mask drawn at the full head width `n_total` and sliced at
    `off`, so a feat shard's heads keep the feat=1 run's masks; at off 0
    and the full width it is `_dropout`. The draw runs on a zero-padded
    full-width copy, whose dropout at columns off.. is the slice's."""
    if not training or rate <= 0.0 or rng is None:
        return a
    if n_total == a.shape[-1]:
        return _dropout(a, rate, rng, training)
    full = a.new_zeros(a.shape[:-1] + (n_total,))
    full[..., off:off + a.shape[-1]] = a
    return _d1_dropout(full, rng, rate)[..., off:off + a.shape[-1]]


def _layer_norm(p: nn.LayerNorm, h, eps=1e-5):
    # statistics in f32, output in h.dtype
    hf = h.float()
    mu = hf.mean(-1, keepdim=True)
    var = ((hf - mu) ** 2).mean(-1, keepdim=True)
    out = (hf - mu) / torch.sqrt(var + eps) * p.weight + p.bias
    return out.to(h.dtype)


def _sync_batch_norm(p: BatchNorm, h, env: GraphEnv, whole_size: int,
                     momentum: float = 0.1, eps: float = 1e-5):
    """The JAX package's `_sync_batch_norm` (module/sync_bn.py:10-28):
    (output, new (mean, var) or None). Training: the moments of the real
    rows (env.inner_mask), summed over the ranks in one all-reduce of the
    stacked [sum_x, sum_x2] (env.bn_sum; every rank of an R x P x T run),
    over whole_size = the global n_train times env.bn_copies (R x T); the
    reference's variance estimate clamped at 0; new running
    statistics (momentum 0.1) in f32, returned, never written here (a
    rematerialized layer reruns this). Eval: the running statistics. Sums
    in f32 rounded to h's dtype once, and the arithmetic in h's dtype, as
    jnp computes them."""
    dt = h.dtype
    if env.training:
        if whole_size <= 0:
            raise ValueError("SyncBatchNorm requires train_size (global "
                             "n_train) > 0")
        hm = (h if env.inner_mask is None else
              torch.where(env.inner_mask[:, None], h,
                          torch.zeros((), dtype=dt, device=h.device)))
        sums = torch.stack([hm.float().sum(0), (hm * hm).float().sum(0)])
        sums = sums.to(dt)
        if env.bn_sum is not None:
            sums = env.bn_sum(sums)
        sum_x, sum_x2 = sums[0], sums[1]
        whole_size = whole_size * env.bn_copies
        mean = sum_x / whole_size
        var = torch.clamp((sum_x2 - mean * sum_x) / whole_size, min=0.0)
        # filled on the device: no copy from the host inside a step
        m = torch.full((), momentum, dtype=dt, device=h.device)
        keep = torch.full((), 1.0 - momentum, dtype=torch.float32,
                          device=h.device)
        new = (keep * p.mean + m * mean.detach(),
               keep * p.var + m * var.detach())
    else:
        mean, var, new = p.mean, p.var, None
    eps_t = torch.full((), eps, dtype=var.dtype, device=h.device)
    x_hat = (h - mean) / torch.sqrt(var + eps_t)
    return x_hat * p.weight + p.bias, new


def _linear(p: nn.Linear, h):
    """h @ W + b in the promoted dtype of h and the parameters, as jnp
    promotes `h @ w + b`: bf16 in a bf16 step, f32 when a bf16 model
    evaluates on f32 features (bnsgcn_tpu/evaluate.py)."""
    dt = torch.promote_types(h.dtype, p.weight.dtype)
    return F.linear(h.to(dt), p.weight.to(dt), p.bias.to(dt))


def _matmul(h, w):
    """h @ w in the promoted dtype (jnp's `h @ w`)."""
    dt = torch.promote_types(h.dtype, w.dtype)
    return h.to(dt) @ w.to(dt)


def env_agg_exchange(env: GraphEnv, i: int, h, scale_out_norm: bool = False):
    """One layer's exchange + sum-aggregation: h [n_dst, d] -> [n_dst, d].
    `scale_out_norm` divides the extended rows by env.out_norm before the
    sum (GCN's symmetric norm); env.agg_exchange, when set, does both."""
    if env.agg_exchange is not None:
        return env.agg_exchange(i, h, scale_out_norm)
    h_ext = env.exchange(i, h)
    if scale_out_norm:
        h_ext = (h_ext / env.out_norm[:, None]).to(h_ext.dtype)
    return env.aggregate(h_ext)


def _linear_part(p: nn.Linear, h):
    """h @ W of a sharded Linear, without its bias (added once, after the
    sum over the feat group)."""
    dt = torch.promote_types(h.dtype, p.weight.dtype)
    return F.linear(h.to(dt), p.weight.to(dt))


def _feat_layer(p, i, h, env: GraphEnv, spec: ModelSpec):
    """One feat-sharded GCN / GraphSAGE / dense layer (the JAX package's
    `_feat_layer`): h arrives full width, already dropped out; this shard's
    H/T columns go through the exchange and the SpMM (the wire carries the
    slice), its weight's row shard multiplies them, and the partial
    products are summed over the feat group once, the biases added after.
    The eval use_pp layer 0 aggregates the full width (its concat consumes
    the whole mean) and shards only the product."""
    fe = env.feat
    is_graph = i < spec.n_graph_layers
    if not is_graph or (env.training and spec.use_pp and i == 0):
        out = fe.sum(_linear_part(p, fe.slice(h)))
        return out + p.bias.to(out.dtype)
    if spec.model == "gcn":
        s = env_agg_exchange(env, i, fe.slice(h), scale_out_norm=True)
        out = fe.sum(_linear_part(p, (s / env.in_norm[:, None]).to(h.dtype)))
        return out + p.bias.to(out.dtype)
    if (not env.training) and spec.use_pp and i == 0:
        ah = env_agg_exchange(env, i, h) / env.in_norm[:, None]
        out = fe.sum(_linear_part(p, fe.slice(torch.cat([h[:env.n_dst], ah],
                                                        1))))
        return out + p.bias.to(out.dtype)
    hs = fe.slice(h)
    ah = (env_agg_exchange(env, i, hs) / env.in_norm[:, None]).to(h.dtype)
    out = fe.sum(_linear_part(p.linear1, hs[:env.n_dst])
                 + _linear_part(p.linear2, ah))
    return out + p.linear1.bias.to(out.dtype) + p.linear2.bias.to(out.dtype)


def _gcn_layer(p, i, h, env: GraphEnv):
    s = env_agg_exchange(env, i, h, scale_out_norm=True)
    return _linear(p, (s / env.in_norm[:, None]).to(h.dtype))


def _sage_layer(p: SageLayer, i, h, env: GraphEnv):
    ah = (env_agg_exchange(env, i, h) / env.in_norm[:, None]).to(h.dtype)
    return _linear(p.linear1, h[:env.n_dst]) + _linear(p.linear2, ah)


def _gat_layer(p: GATLayer, h_dst, h_ext, presence, env: GraphEnv, rng,
               dropout: float, training: bool, negative_slope: float = 0.2,
               total_heads: Optional[int] = None, head_off: int = 0):
    """The GATConv equivalent over the extended (inner + halo) rows
    (the JAX package's `_gat_layer`): [n_dst, H, fout]. In training, feat
    dropout on h_ext and, separately, on h_dst for the dst projection; then
    the attention dropout's two seed words from the same stream. In eval
    the dst projection is z's prefix (h_dst is h_ext's prefix, no dropout).
    A feat shard holds heads/T heads (p.heads) from global head
    `head_off` of `total_heads`: the attention dropout draws the feat=1
    masks of those heads (the ELL hash by head id, the segment path's
    `_dropout_heads`). The three draws use r1, r2, r3 = split(rng, 3), the
    attention hash the two words of r3."""
    heads, fout = p.heads, p.fout
    total_heads = heads if total_heads is None else total_heads
    r1 = r2 = r3 = None
    if training and rng is not None:
        r1, r2, r3 = prng.split(rng, 3)
    h_ext = _dropout(h_ext, dropout, r1, training)             # feat_drop
    z = _matmul(h_ext, p.w).reshape(h_ext.shape[0], heads, fout)
    el = (z * p.attn_l.to(z.dtype)[None]).sum(-1)              # [n_ext, H]
    if r2 is not None:
        h_d = _dropout(h_dst, dropout, r2, training)
        zd = _matmul(h_d, p.w).reshape(h_dst.shape[0], heads, fout)
    else:
        zd = z[:h_dst.shape[0]]
    er = (zd * p.attn_r.to(z.dtype)[None]).sum(-1)             # [n_dst, H]
    seeds = (r3.to(z.device) if r3 is not None and dropout > 0.0
             else None)
    bias = p.bias.to(z.dtype)
    if env.attention is not None:
        out = env.attention(z, el, er, presence, seeds, dropout, training,
                            negative_slope, head_off)
        return out + bias.reshape(1, heads, fout)
    src, dst = env.src, env.dst
    er_pad = torch.cat([er, er.new_zeros((1, heads))])
    e = el[src] + er_pad[dst.clamp(max=env.n_dst)]
    e = torch.where(e > 0, e, e * negative_slope)
    alpha = segment_softmax(e, dst, env.n_dst,
                            None if presence is None else presence[src])
    alpha = _dropout_heads(alpha, dropout, r3, training,         # attn_drop
                           total_heads, head_off)
    out = z.new_zeros((env.n_dst + 1, heads * fout))
    step = max(1, (1 << 28) // max(heads * fout, 1))
    for e0 in range(0, src.shape[0], step):
        msg = z[src[e0:e0 + step]] * alpha[e0:e0 + step, :, None]
        out.index_add_(0, dst[e0:e0 + step], msg.reshape(-1, heads * fout))
    return (out[:env.n_dst] + bias).reshape(env.n_dst, heads, fout)


# ----------------------------------------------------------------------------
# full forward
# ----------------------------------------------------------------------------

def apply_model(model: GNN, feat, env: GraphEnv, return_hidden: bool = False,
                return_state: bool = False):
    """Forward pass: logits [n_dst, n_class]; with return_hidden, also the
    final layer's input (the embedding-table seam) as (logits, hidden);
    with return_state, also SyncBatchNorm's new running statistics
    {'norm_i': (mean, var)} of a training forward (empty otherwise) last.
    A training forward splits env.rng into one key per layer; under
    env.remat each layer runs under torch.utils.checkpoint."""
    spec = model.spec
    h = feat
    hidden = None
    state = {}
    rngs = [None] * spec.n_layers
    if env.training and env.rng is not None:
        rngs = list(prng.split(env.rng, spec.n_layers))
    for i in range(spec.n_layers):
        if i == spec.n_layers - 1:
            hidden = h
        body = partial(_layer_forward, model, i, env=env, rng=rngs[i])
        if env.remat and env.training:
            out = checkpoint(body, h, use_reentrant=False)
        else:
            out = body(h)
        h = out[0]
        if len(out) > 1:
            state[f"norm_{i}"] = out[1:]
    ret = (h,) + ((hidden,) if return_hidden else ()) + (
        (state,) if return_state else ())
    return ret if len(ret) > 1 else h


def _layer_forward(model: GNN, i: int, h, env: GraphEnv, rng=None):
    """One layer: (h,) or, after a training SyncBatchNorm, (h, new mean,
    new var)."""
    spec = model.spec
    p = getattr(model, f"layer_{i}")
    # a layer of the feat axis (parallel/feat.py); the others run whole
    fshard = env.feat is not None and env.feat.shardable[i]
    if spec.model == "gat" and i < spec.n_graph_layers:
        if fshard:
            # this shard's heads; the exchange stays full width, and the
            # input's gradient sums the shards' heads' parts
            h = env.feat.enter(h)
        if env.training and i == 0:
            # the precompute's raw features, halo rows at the full rate;
            # this epoch's presence masks the unsampled slots
            h_ext = env.gat_feat0
            h_d = h[:env.n_dst]
        else:
            h_ext, h_d = env.exchange(i, h), h
        off = env.feat.f * p.heads if fshard else 0
        h = _gat_layer(p, h_d, h_ext, env.presence, env, rng, spec.dropout,
                       env.training, total_heads=spec.heads, head_off=off)
        # the mean over heads; sharded: the sum of every shard's head sums
        h = env.feat.sum(h.sum(1)) / spec.heads if fshard else h.mean(1)
        return _layer_tail(model, i, h, env)
    # dropout fires on the full width, sharded or not: the feat=1 masks
    h = _dropout(h, spec.dropout, rng, env.training)
    if fshard:
        h = _feat_layer(p, i, h, env, spec)
    elif i >= spec.n_graph_layers:
        h = _linear(p, h)
    elif env.training and spec.use_pp and i == 0:
        h = _linear(p, h)                      # precomputed layer 0
    elif spec.model == "gcn":
        h = _gcn_layer(p, i, h, env)
    elif (not env.training) and spec.use_pp and i == 0:
        # eval use_pp layer 0: cat(feat, mean) @ W
        ah = env_agg_exchange(env, i, h) / env.in_norm[:, None]
        h = _linear(p, torch.cat([h[:env.n_dst], ah], 1))
    else:
        h = _sage_layer(p, i, h, env)
    return _layer_tail(model, i, h, env)


def _layer_tail(model: GNN, i: int, h, env: GraphEnv):
    """LayerNorm or SyncBatchNorm, and ReLU, after every layer but the
    last."""
    spec = model.spec
    if i >= spec.n_layers - 1:
        return (h,)
    new = None
    if spec.norm == "layer":
        h = _layer_norm(getattr(model, f"norm_{i}"), h)
    elif spec.norm == "batch":
        h, new = _sync_batch_norm(getattr(model, f"norm_{i}"), h, env,
                                  spec.train_size)
    h = torch.relu(h)
    return (h,) if new is None else (h,) + new
