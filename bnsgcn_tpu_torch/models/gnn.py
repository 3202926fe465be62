"""GCN / GraphSAGE as nn.Modules (counterpart of bnsgcn_tpu/models/gnn.py).

Layer for layer the JAX package's math (itself the reference BNS-GCN's
module/layer.py and module/model.py):

  * GCN: h/out_norm -> sum over in-edges -> /in_norm -> linear;
  * GraphSAGE: linear1(h_self) + linear2(sum(h_nbr)/in_deg) with the global
    in-degree; with use_pp, layer 0 is one Linear(2*in, out) over the
    precomputed [feat, mean_nbr] in training and cat(feat, mean) @ W in eval;
  * stack: dropout -> exchange -> layer -> LayerNorm -> ReLU, with an
    optional dense tail of n_linear layers.

Parameters live in nn.Linear / nn.LayerNorm modules named as the JAX
parameter tree is keyed (layer_i, layer_i.linear1, norm_i), so
trainer.params_from_jax maps one onto the other. Aggregation is injected
through GraphEnv.aggregate: the ELL or hybrid SpMM in training, COO
index_add_ in eval. GAT and SyncBatchNorm wait for later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from bnsgcn_tpu_torch.config import Config


@dataclass(frozen=True)
class ModelSpec:
    model: str                         # 'gcn' | 'graphsage'
    layer_sizes: tuple[int, ...]       # (n_feat, hidden, ..., n_class)
    n_linear: int = 0
    norm: Optional[str] = "layer"
    dropout: float = 0.5
    use_pp: bool = False
    train_size: int = 0                # global n_train

    @property
    def n_layers(self) -> int:
        return len(self.layer_sizes) - 1

    @property
    def n_graph_layers(self) -> int:
        return self.n_layers - self.n_linear


def spec_from_config(cfg: Config) -> ModelSpec:
    return ModelSpec(model=cfg.model, layer_sizes=tuple(cfg.layer_sizes()),
                     n_linear=cfg.n_linear, norm=cfg.norm,
                     dropout=cfg.dropout, use_pp=cfg.use_pp,
                     train_size=cfg.n_train)


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
    aggregate: Callable[[torch.Tensor], torch.Tensor]
    training: bool = True
    generator: Optional[torch.Generator] = None   # dropout stream


class SageLayer(nn.Module):
    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.linear1 = nn.Linear(fin, fout)
        self.linear2 = nn.Linear(fin, fout)


class GNN(nn.Module):
    """Modules layer_{i} (nn.Linear or SageLayer) and norm_{i} (LayerNorm)."""

    def __init__(self, spec: ModelSpec,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if spec.model not in ("gcn", "graphsage"):
            raise ValueError(f"model {spec.model!r} is not ported yet")
        if spec.norm not in ("layer", None):
            raise ValueError(f"norm {spec.norm!r} is not ported yet")
        self.spec = spec
        for i in range(spec.n_layers):
            fin, fout = spec.layer_sizes[i], spec.layer_sizes[i + 1]
            if (i >= spec.n_graph_layers or spec.model == "gcn"):
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


def init_params(model: GNN, generator: Optional[torch.Generator] = None):
    """uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every Linear's weight
    and bias, in layer order (the law of the JAX package's `_linear_init`;
    its threefry draws are not reproduced). LayerNorm starts at (1, 0)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                bound = 1.0 / mod.in_features ** 0.5
                nn.init.uniform_(mod.weight, -bound, bound, generator=generator)
                nn.init.uniform_(mod.bias, -bound, bound, generator=generator)


# ----------------------------------------------------------------------------
# building blocks
# ----------------------------------------------------------------------------

def _dropout(h, rate, generator, training):
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
    return F.linear(h, p.weight, p.bias)


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
    if i < spec.n_layers - 1:
        if spec.norm == "layer":
            h = _layer_norm(getattr(model, f"norm_{i}"), h)
        h = torch.relu(h)
    return h
