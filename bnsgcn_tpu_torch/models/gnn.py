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
  * stack: dropout -> exchange -> layer -> LayerNorm -> ReLU, with an
    optional dense tail of n_linear layers.

Parameters live in nn.Linear / nn.LayerNorm modules and GATLayer's
parameters (w, attn_l, attn_r, bias in the JAX package's layout), named as
the JAX parameter tree is keyed (layer_i, layer_i.linear1, norm_i), so
trainer.params_from_jax maps one onto the other. Aggregation is injected
through GraphEnv.aggregate (the ELL or hybrid SpMM in training, COO
index_add_ in eval) and GAT's through GraphEnv.attention (the ELL
attention, ops/ell_attention.py) or, without it, the COO segment softmax
over GraphEnv.src/dst. SyncBatchNorm waits for a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from bnsgcn_tpu_torch.config import Config
from bnsgcn_tpu_torch.ops.spmm import segment_softmax


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
    generator: Optional[torch.Generator] = None   # dropout stream
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


class GNN(nn.Module):
    """Modules layer_{i} (nn.Linear, SageLayer or GATLayer) and norm_{i}
    (LayerNorm)."""

    def __init__(self, spec: ModelSpec,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if spec.model not in ("gcn", "graphsage", "gat"):
            raise ValueError(f"model {spec.model!r} is not ported yet")
        if spec.norm not in ("layer", None):
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
        init_params(self, generator)


def _xavier_normal(p: torch.Tensor, fan_in: int, fan_out: int, gain: float,
                   generator):
    std = gain * (2.0 / (fan_in + fan_out)) ** 0.5
    p.copy_(std * torch.randn(p.shape, generator=generator))


def init_params(model: GNN, generator: Optional[torch.Generator] = None):
    """uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every Linear's weight
    and bias; a GAT layer's w, attn_l and attn_r Xavier-normal with gain
    sqrt(2) and its bias 0; in layer order (the laws of the JAX package's
    `_linear_init` and `_xavier_normal`; its threefry draws are not
    reproduced). LayerNorm starts at (1, 0)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                bound = 1.0 / mod.in_features ** 0.5
                nn.init.uniform_(mod.weight, -bound, bound, generator=generator)
                nn.init.uniform_(mod.bias, -bound, bound, generator=generator)
            elif isinstance(mod, GATLayer):
                g2 = 2.0 ** 0.5
                _xavier_normal(mod.w, mod.fin, mod.heads * mod.fout, g2,
                               generator)
                for a in (mod.attn_l, mod.attn_r):
                    _xavier_normal(a, mod.fout, 1, g2, generator)
                mod.bias.zero_()


# ----------------------------------------------------------------------------
# building blocks
# ----------------------------------------------------------------------------

def _dropout(h, rate, generator, training):
    # in the activations' dtype, as the JAX package's `_dropout`
    if not training or rate <= 0.0:
        return h
    keep = 1.0 - rate
    mask = torch.empty_like(h).bernoulli_(keep, generator=generator).bool()
    return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype,
                                                   device=h.device))


def _layer_norm(p: nn.LayerNorm, h, eps=1e-5):
    # statistics in f32, output in h.dtype
    hf = h.float()
    mu = hf.mean(-1, keepdim=True)
    var = ((hf - mu) ** 2).mean(-1, keepdim=True)
    out = (hf - mu) / torch.sqrt(var + eps) * p.weight + p.bias
    return out.to(h.dtype)


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
    """One layer's exchange + sum-aggregation: h [n_dst, d] -> [n_dst, d]."""
    h_ext = env.exchange(i, h)
    if scale_out_norm:
        h_ext = (h_ext / env.out_norm[:, None]).to(h_ext.dtype)
    return env.aggregate(h_ext)


def _gcn_layer(p, i, h, env: GraphEnv):
    s = env_agg_exchange(env, i, h, scale_out_norm=True)
    return _linear(p, (s / env.in_norm[:, None]).to(h.dtype))


def _sage_layer(p: SageLayer, i, h, env: GraphEnv):
    ah = (env_agg_exchange(env, i, h) / env.in_norm[:, None]).to(h.dtype)
    return _linear(p.linear1, h[:env.n_dst]) + _linear(p.linear2, ah)


def _gat_layer(p: GATLayer, h_dst, h_ext, presence, env: GraphEnv,
               dropout: float, training: bool, negative_slope: float = 0.2):
    """The GATConv equivalent over the extended (inner + halo) rows
    (the JAX package's `_gat_layer`, without the feat axis): [n_dst, H,
    fout]. In training, feat dropout on h_ext and, separately, on h_dst for
    the dst projection; then the attention dropout's two seed words from
    the same stream. In eval the dst projection is z's prefix (h_dst is
    h_ext's prefix, no dropout). The segment path's attention dropout is
    `_dropout` (the JAX package's `_dropout_heads` at the full head
    width)."""
    heads, fout = p.heads, p.fout
    gen = env.generator
    h_ext = _dropout(h_ext, dropout, gen, training)            # feat_drop
    z = _matmul(h_ext, p.w).reshape(h_ext.shape[0], heads, fout)
    el = (z * p.attn_l.to(z.dtype)[None]).sum(-1)              # [n_ext, H]
    if training:
        h_d = _dropout(h_dst, dropout, gen, training)
        zd = _matmul(h_d, p.w).reshape(h_dst.shape[0], heads, fout)
    else:
        zd = z[:h_dst.shape[0]]
    er = (zd * p.attn_r.to(z.dtype)[None]).sum(-1)             # [n_dst, H]
    seeds = (torch.randint(0, 2 ** 32, (2,), generator=gen,
                           dtype=torch.int64, device=z.device)
             if training and dropout > 0.0 else None)
    bias = p.bias.to(z.dtype)
    if env.attention is not None:
        out = env.attention(z, el, er, presence, seeds, dropout, training,
                            negative_slope)
        return out + bias.reshape(1, heads, fout)
    src, dst = env.src, env.dst
    er_pad = torch.cat([er, er.new_zeros((1, heads))])
    e = el[src] + er_pad[dst.clamp(max=env.n_dst)]
    e = torch.where(e > 0, e, e * negative_slope)
    alpha = segment_softmax(e, dst, env.n_dst,
                            None if presence is None else presence[src])
    alpha = _dropout(alpha, dropout, gen, training)             # attn_drop
    out = z.new_zeros((env.n_dst + 1, heads * fout))
    step = max(1, (1 << 28) // max(heads * fout, 1))
    for e0 in range(0, src.shape[0], step):
        msg = z[src[e0:e0 + step]] * alpha[e0:e0 + step, :, None]
        out.index_add_(0, dst[e0:e0 + step], msg.reshape(-1, heads * fout))
    return (out[:env.n_dst] + bias).reshape(env.n_dst, heads, fout)


# ----------------------------------------------------------------------------
# full forward
# ----------------------------------------------------------------------------

def apply_model(model: GNN, feat, env: GraphEnv, return_hidden: bool = False):
    """Forward pass: logits [n_dst, n_class]; with return_hidden, also the
    final layer's input (the embedding-table seam) as (logits, hidden)."""
    h = feat
    hidden = None
    for i in range(model.spec.n_layers):
        if i == model.spec.n_layers - 1:
            hidden = h
        h = _layer_forward(model, i, h, env)
    if return_hidden:
        return h, hidden
    return h


def _layer_forward(model: GNN, i: int, h, env: GraphEnv):
    spec = model.spec
    p = getattr(model, f"layer_{i}")
    if spec.model == "gat" and i < spec.n_graph_layers:
        if env.training and i == 0:
            # the precompute's raw features, halo rows at the full rate;
            # this epoch's presence masks the unsampled slots
            h_ext = env.gat_feat0
            h_d = h[:env.n_dst]
        else:
            h_ext, h_d = env.exchange(i, h), h
        h = _gat_layer(p, h_d, h_ext, env.presence, env, spec.dropout,
                       env.training).mean(1)                    # head mean
        return _layer_tail(model, i, h)
    h = _dropout(h, spec.dropout, env.generator, env.training)
    if i >= spec.n_graph_layers:
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
    return _layer_tail(model, i, h)


def _layer_tail(model: GNN, i: int, h):
    """LayerNorm and ReLU after every layer but the last."""
    spec = model.spec
    if i < spec.n_layers - 1:
        if spec.norm == "layer":
            h = _layer_norm(getattr(model, f"norm_{i}"), h)
        h = torch.relu(h)
    return h
