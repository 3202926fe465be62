"""One rank's train step (counterpart of bnsgcn_tpu/trainer.py).

One train step: dropout -> layers (halo exchange, then aggregation through
the ELL or hybrid SpMM, i.e. kernels K1 and K2 on the card) -> sum
cross-entropy over this part's train rows / global n_train -> backward (the
SpMMs' backward runs the same kernels on the transposed layouts, the
exchange's backward the transposed all-to-all) -> one all-reduce of the
gradients over the ranks -> Adam with L2 added to the gradient before the
moments. At P=1 (no Comm) the exchange is the identity plus the zero-filled
halo slots of the artifact layout and there is nothing to reduce.

At sampling rate < 1 each step first draws the epoch's boundary sample
(parallel/halo.py make_halo_plan, from the base key prng.key(cfg.seed) and
the epoch, as the JAX step does inside its jit), so the draw's time counts
in the step; every layer's exchange, forward and backward, uses it. The
use_pp precompute exchanges at the full rate whatever the training rate.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from bnsgcn_tpu_torch.config import Config
from bnsgcn_tpu_torch.data.artifacts import PartitionArtifacts
from bnsgcn_tpu_torch.models.gnn import GNN, GraphEnv, ModelSpec, apply_model
from bnsgcn_tpu_torch.ops.block_spmm import (BlockSpmm, build_block_layouts,
                                             cluster_order, dense_edge_count,
                                             effective_occupancy)
from bnsgcn_tpu_torch.ops.ell import EllSpmm, build_layouts
from bnsgcn_tpu_torch.parallel.halo import (HaloSpec, full_rate_spec,
                                            halo_apply, make_halo_plan,
                                            make_halo_spec,
                                            precompute_exchange, tables_to)
from bnsgcn_tpu_torch.parallel.mesh import Comm
from bnsgcn_tpu_torch.parallel.reducer import reduce_gradients
from bnsgcn_tpu_torch.utils import prng


def ce_sum(logits, labels, mask):
    """Cross-entropy summed over the masked rows (reference train.py:358)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(1, labels[:, None].long())[:, 0]
    return -torch.where(mask, ll, torch.zeros((), device=ll.device)).sum()


def build_block_arrays(art: PartitionArtifacts, model: str,
                       dtype=np.float32) -> dict[str, np.ndarray]:
    """Stacked [P, ...] numpy arrays a train step reads (the JAX package's
    build_block_arrays, array for array)."""
    if model == "gcn":
        in_norm = np.sqrt(art.in_deg).astype(dtype)
        out_norm = np.sqrt(art.out_deg_ext).astype(dtype)
    else:
        in_norm = art.in_deg.astype(dtype)
        out_norm = np.ones_like(art.out_deg_ext, dtype=dtype)
    return {
        "feat": art.feat.astype(dtype),
        "label": art.label,
        "train_mask": art.train_mask,
        "inner_mask": art.inner_mask,
        "src": art.src, "dst": art.dst, "bnd": art.bnd,
        "in_norm": in_norm, "out_norm": out_norm,
    }


def to_device(arrays: dict, device, row: int = 0) -> dict:
    """One row of stacked [P, ...] numpy arrays as device tensors."""
    return {k: torch.from_numpy(np.ascontiguousarray(v[row])).to(device)
            for k, v in arrays.items()}


def local_row(art: PartitionArtifacts, rank: int) -> int:
    """The row of part `rank` in art's stacked axis: `art` holds every part,
    or only the rank's own (load_artifacts(path, parts=[rank]))."""
    held = art.feat.shape[0]
    if held == art.n_parts:
        return rank
    if held == 1:
        return 0
    raise ValueError(f"artifacts hold {held} of {art.n_parts} parts; expected "
                     f"all or one")


def make_tx(cfg: Config, params) -> torch.optim.Adam:
    """torch.optim.Adam(lr, weight_decay): L2 added to the gradient before
    the moments, the semantics the JAX package's optax chain reproduces."""
    return torch.optim.Adam(params, lr=cfg.lr, weight_decay=cfg.weight_decay)


def params_from_jax(params_np: dict, spec: ModelSpec) -> "OrderedDict":
    """The JAX parameter tree (numpy leaves) -> the port's state_dict:
    {'w' [fin, fout], 'b'} -> nn.Linear weight [fout, fin] (transposed) and
    bias; {'scale', 'bias'} of norm_i -> LayerNorm weight and bias."""
    sd = OrderedDict()

    def t(x):
        return torch.tensor(np.asarray(x, np.float32))

    for i in range(spec.n_layers):
        p = params_np[f"layer_{i}"]
        for prefix, lin in ([(f"layer_{i}", p)] if "w" in p else
                            [(f"layer_{i}.linear1", p["linear1"]),
                             (f"layer_{i}.linear2", p["linear2"])]):
            sd[f"{prefix}.weight"] = t(lin["w"]).T.contiguous()
            sd[f"{prefix}.bias"] = t(lin["b"])
        if f"norm_{i}" in params_np:
            sd[f"norm_{i}.weight"] = t(params_np[f"norm_{i}"]["scale"])
            sd[f"norm_{i}.bias"] = t(params_np[f"norm_{i}"]["bias"])
    return sd


@dataclass
class StepFns:
    spmm: Union[EllSpmm, BlockSpmm]    # the training aggregation operator
    layout: dict                       # its numpy layout arrays [1, ...]
    train_step: Callable               # (model, opt, blk, epoch, gen) -> loss
    forward: Callable                  # (model, blk, epoch, gen) -> logits
    precompute: Callable               # (blk) -> layer-0 input features
    dense_edges: int = 0               # edges on dense tiles (hybrid)
    halo: Optional[HaloSpec] = None    # the training exchange (P > 1)
    halo_full: Optional[HaloSpec] = None   # the precompute's, at rate 1.0


def build_spmm(cfg: Config, art: PartitionArtifacts, device, log=print,
               row: int = 0):
    """(operator, numpy layout) for cfg.spmm over the part in row `row` of
    `art`. Each part builds its own layout: the ELL pads come from the
    artifacts' global geometry, the hybrid tiles and residual from the part
    alone."""
    src, dst = art.src[row:row + 1], art.dst[row:row + 1]
    if cfg.spmm == "hybrid":
        tile = cfg.block_tile
        pi, pe = cluster_order(src[0], dst[0], art.pad_inner, art.n_ext,
                               target=tile, log=log)
        fwd, bwd, ell_pair, arrays = build_block_layouts(
            src, dst, art.pad_inner, art.n_ext, pi[None], pe[None],
            occupancy_min=effective_occupancy(cfg.block_occupancy, tile, tile),
            tile_budget_bytes=cfg.block_tile_budget_mb << 20,
            tile_r=tile, tile_c=tile)
        return BlockSpmm(fwd, bwd, ell_pair, to_device(arrays, device)), arrays
    if cfg.spmm == "ell":
        fwd, bwd, arrays = build_layouts(src, dst, art.pad_inner, art.n_ext,
                                         geometry=art.ell_geometry)
        return EllSpmm(fwd, bwd, to_device(arrays, device)), arrays
    raise ValueError(f"--spmm {cfg.spmm} is not ported yet")


def build_step_fns(cfg: Config, spec: ModelSpec, art: PartitionArtifacts,
                   device, log=print, rank: int = 0,
                   comm: Optional[Comm] = None) -> StepFns:
    """Rank `rank`'s step functions. Without `comm` the run is P=1."""
    if (art.n_parts > 1) != (comm is not None):
        raise ValueError(f"P={art.n_parts} needs a Comm exactly when P > 1")
    row = local_row(art, rank)
    spmm, layout = build_spmm(cfg, art, device, log, row)
    n_train = max(art.n_train, 1)
    n_halo = art.n_ext - art.pad_inner
    hspec = hfull = None
    if comm is not None:
        bnd = torch.from_numpy(np.ascontiguousarray(art.bnd[row])).to(device)
        hspec, tables = make_halo_spec(art.n_b, art.pad_inner,
                                       art.pad_boundary, cfg.sampling_rate)
        hfull, tables_full = full_rate_spec(art.n_b, art.pad_inner,
                                            art.pad_boundary)
        tables = tables_to(tables, device)
        sample_key = prng.key(cfg.seed, device)
        # rate 1.0: the identity plan, the same every epoch
        fixed_plan = (make_halo_plan(hspec, tables, bnd, rank)
                      if hspec.exact else None)

    def exchange_for(epoch: int):
        if comm is None:
            # P=1: no peer sends anything; the halo slots stay zero
            return lambda i, h: torch.cat([h, h.new_zeros((n_halo,
                                                           h.shape[1]))])
        plan = (fixed_plan if fixed_plan is not None else
                make_halo_plan(hspec, tables, bnd, rank, epoch, sample_key))
        return lambda i, h: halo_apply(hspec, plan, h, comm)

    def forward(model: GNN, blk, epoch: int, generator=None):
        """Training-mode forward at `epoch` (which keys the boundary
        sample): logits [pad_inner, n_class]."""
        env = GraphEnv(n_dst=art.pad_inner, in_norm=blk["in_norm"],
                       out_norm=blk["out_norm"], exchange=exchange_for(epoch),
                       aggregate=spmm, training=True, generator=generator)
        return apply_model(model, blk["feat"], env)

    def train_step(model: GNN, opt, blk, epoch: int, generator=None):
        """One step at `epoch`; returns the loss summed over the ranks."""
        opt.zero_grad(set_to_none=True)
        logits = forward(model, blk, epoch, generator)
        loss = ce_sum(logits, blk["label"], blk["train_mask"]) / n_train
        loss.backward()
        if comm is not None:
            loss = reduce_gradients(model.parameters(), comm, loss)
        opt.step()
        return loss.detach()

    @torch.no_grad()
    def precompute(blk):
        """use_pp layer-0 input, once before training (JAX trainer
        local_precompute): GCN (sum feat/out_norm)/in_norm; GraphSAGE
        cat(feat, sum(feat)/in_deg). The exchange (full-rate at any
        training rate, the JAX package's precompute exchange) and the
        aggregation (the same SpMM) run at the raw feature width."""
        feat_ext = (exchange_for(0)(0, blk["feat"]) if comm is None else
                    precompute_exchange(hfull, tables_full, bnd, blk["feat"],
                                        rank, comm))
        if spec.model == "gcn":
            return spmm.apply_dir("fwd", feat_ext / blk["out_norm"][:, None],
                                  "pre") / blk["in_norm"][:, None]
        ah = spmm.apply_dir("fwd", feat_ext, "pre") / blk["in_norm"][:, None]
        return torch.cat([blk["feat"], ah], 1)

    dense = dense_edge_count(layout) if cfg.spmm == "hybrid" else 0
    return StepFns(spmm=spmm, layout=layout, train_step=train_step,
                   forward=forward, precompute=precompute, dense_edges=dense,
                   halo=hspec, halo_full=hfull)
