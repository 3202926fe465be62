"""One rank's train step (counterpart of bnsgcn_tpu/trainer.py).

One train step: dropout -> layers (halo exchange, then aggregation through
the ELL or hybrid SpMM, i.e. kernels K1 and K2 on the card) -> sum
cross-entropy (multilabel artifacts: sum binary cross-entropy) over this
part's train rows / global n_train -> backward (the
SpMMs' backward runs the same kernels on the transposed layouts, the
exchange's backward the transposed all-to-all) -> one all-reduce of the
gradients over the ranks -> Adam with L2 added to the gradient before the
moments. At P=1 (no Comm) the exchange is the identity plus the zero-filled
halo slots of the artifact layout and there is nothing to reduce.

At sampling rate < 1 each step first draws the epoch's boundary sample
(parallel/halo.py make_halo_plan, from the base key prng.key(cfg.seed) and
the epoch, as the JAX step does inside its jit), so the draw's time counts
in the step; every layer's exchange, forward and backward, uses it. The
use_pp precompute exchanges at the full rate whatever the training rate,
and so does the eval forward of --eval-device mesh (`eval_forward`: eval
mode on the raw features, through the training SpMM and its codecs).

GAT aggregates through the ELL attention (ops/ell_attention.py) over its
own layouts, built per rank from meta.json's 'gat_fwd' and 'bwd' geometry,
at --spmm ell, hybrid or auto alike (auto stays on ELL for GAT, as the JAX
package resolves it); it runs no SpMM. Its precompute is the full-rate
exchange of the raw features alone (`feat0_ext`, training's layer-0 input),
and each epoch's plan gives the presence mask that takes the unsampled halo
slots out of the softmax.

The exchange's variants, resolved here as the JAX package's build_step_fns
resolves them (its log lines too):
  * --halo-exchange padded | shift | ragged | auto (parallel/halo.py);
  * --spmm segment: COO index_add_ in chunks of --edge-chunk edges
    (ops/spmm.CooSpmm; no kernel, as in the JAX package);
  * --overlap split: each GCN/GraphSAGE layer launches its exchange, sums
    the interior rows (K1/K2 on their own layouts), waits, sums the
    frontier rows and merges (`split_body`); the precompute and the eval
    compose the two halves (ops/spmm.SplitSpmm). It falls back to off for
    GAT, grad-only and more than one node, as the JAX package does;
  * --halo-refresh K > 1: `train_step_full` runs the historical exchange
    and records each layer's received halo block and the halo presence
    (the cache, held by the run loop on the device); `train_step_cached`
    exchanges chunk epoch % K through the refresh geometry and merges it
    into the cache, the stale rows detached. K == 1 builds neither;
  * --halo-mode grad-only: no activation exchange, a zero halo block that
    presence masks out whole; the gradient all-reduce stays.

On an R x P x T run (--replicas R, --feat T; parallel/replicas.py) a rank
is (replica r, part p, feat shard f) and gets its Axes: the exchange runs
over its 'parts' group as above; the plans and the dropout key fold r
first (never f, so a part's shards draw alike); the loss is over n_train x
R, so the one gradient all-reduce, over the world, gives the mean over the
replicas (shard 0 alone brings the leaves a shard holds whole,
parallel/reducer.py); SyncBatchNorm's moments are summed over the world
over n_train x R x T; the model holds shard f of each weight that shards,
and its layers slice, exchange, aggregate and sum over the 'feat' group
(models/gnn.py, parallel/feat.py). R = T = 1 builds no group and runs the
path above unchanged.
"""

from __future__ import annotations

import copy
import hashlib
import os
import sys
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function
import torch.nn.functional as F

from bnsgcn_tpu_torch.config import Config, ConfigError
from bnsgcn_tpu_torch.data.artifacts import PartitionArtifacts, feat_values
from bnsgcn_tpu_torch.models.gnn import GNN, GraphEnv, ModelSpec, apply_model
from bnsgcn_tpu_torch.ops.block_spmm import (BlockSpmm, build_block_layouts,
                                             build_split_block_layouts,
                                             cluster_order, dense_edge_count,
                                             I8_ROW_CAP, effective_occupancy,
                                             estimate_coverage)
from bnsgcn_tpu_torch.ops.ell import (EllSpmm, build_layouts,
                                     build_split_layouts)
from bnsgcn_tpu_torch.ops.ell_attention import (GatAttention,
                                                build_gat_attention,
                                                part_gat_layouts)
from bnsgcn_tpu_torch.ops.spmm import CooSpmm, SplitSpmm, split_coo
from bnsgcn_tpu_torch.parallel.halo import (HaloFlight, HaloSpec,
                                            full_rate_spec, halo_apply,
                                            make_halo_plan,
                                            make_halo_plan_refresh,
                                            make_halo_spec, make_refresh_spec,
                                            precompute_exchange,
                                            ragged_auto_eligible,
                                            warm_ragged,
                                            refresh_row_mask,
                                            select_halo_strategy, tables_to)
from bnsgcn_tpu_torch.parallel.feat import (FeatAxis, gather_state,
                                            shard_state, shardable_layers,
                                            torch_dims)
from bnsgcn_tpu_torch.parallel.mesh import Comm
from bnsgcn_tpu_torch.parallel.reducer import moments_sum, reduce_gradients
from bnsgcn_tpu_torch.parallel.replicas import Axes
from bnsgcn_tpu_torch.utils import prng
from bnsgcn_tpu_torch.utils.diskcache import (atomic_dump, sweep_stale_tmp,
                                              try_load)
from bnsgcn_tpu_torch.utils.msgpack_codec import Bfloat16Array

# --spmm auto picks the dense-tile hybrid when at least this fraction of the
# edges would densify onto tiles, else the ELL gathers
# (bnsgcn_tpu/trainer.py AUTO_HYBRID_MIN_COVERAGE)
AUTO_HYBRID_MIN_COVERAGE = 0.5


def compute_dtype(cfg: Config) -> torch.dtype:
    """The parameters', Adam moments' and activations' dtype (--dtype)."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def ce_sum(logits, labels, mask):
    """Cross-entropy summed over the masked rows (reference train.py:358).
    Rows outside the mask may carry the label -1 (papers100M's unlabeled
    nodes, data/disk_readers.py): the gather reads them at a clamped index
    and the mask drops the value, as the JAX ce_sum's jnp.where does, so
    neither the loss nor the gradient sees them."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(1, labels[:, None].long().clamp(min=0))[:, 0]
    return -torch.where(mask, ll, torch.zeros((), device=ll.device)).sum()


def bce_sum(logits, labels, mask):
    """Binary cross-entropy with logits, in f32, summed over the masked rows
    and every class: Yelp's multi-hot labels (reference train.py:359-361,
    bnsgcn_tpu/trainer.py bce_sum)."""
    per = F.binary_cross_entropy_with_logits(
        logits.float(), labels.float(), reduction="none")
    return torch.where(mask[:, None], per,
                       torch.zeros((), device=per.device)).sum()


def build_block_arrays(art: PartitionArtifacts, model: str,
                       dtype=np.float32) -> dict[str, np.ndarray]:
    """Stacked [P, ...] numpy arrays a train step reads (the JAX package's
    build_block_arrays, array for array; bf16 feature storage upcast
    exactly)."""
    if model == "gcn":
        in_norm = np.sqrt(art.in_deg).astype(dtype)
        out_norm = np.sqrt(art.out_deg_ext).astype(dtype)
    else:
        in_norm = art.in_deg.astype(dtype)
        out_norm = np.ones_like(art.out_deg_ext, dtype=dtype)
    return {
        "feat": feat_values(art).astype(dtype),
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


def params_from_jax(params_np: dict, spec: ModelSpec,
                    bn_state: Optional[dict] = None) -> "OrderedDict":
    """The JAX parameter tree (numpy leaves) -> the port's state_dict:
    {'w' [fin, fout], 'b'} -> nn.Linear weight [fout, fin] (transposed) and
    bias; a GAT layer's {'w', 'attn_l', 'attn_r', 'bias'} -> GATLayer's
    parameters of the same names and layout; {'scale', 'bias'} of norm_i ->
    LayerNorm's or BatchNorm's weight and bias. Under --norm batch,
    `bn_state` (the JAX state tree {'norm_i': {'mean', 'var'}}) gives
    BatchNorm's f32 buffers; without one (or an empty one) they are the
    initial (0, 1). bf16 leaves (a checkpoint's Bfloat16Array) give bf16
    tensors, any other leaf f32."""
    sd = OrderedDict()

    def t(x):
        if isinstance(x, Bfloat16Array):
            return torch.from_numpy(x.bits.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.tensor(np.asarray(x, np.float32))

    for i in range(spec.n_layers):
        p = params_np[f"layer_{i}"]
        if "attn_l" in p:                      # GAT: the JAX layout as is
            for k in ("w", "attn_l", "attn_r", "bias"):
                sd[f"layer_{i}.{k}"] = t(p[k])
            lins = []
        else:
            lins = ([(f"layer_{i}", p)] if "w" in p else
                    [(f"layer_{i}.linear1", p["linear1"]),
                     (f"layer_{i}.linear2", p["linear2"])])
        for prefix, lin in lins:
            sd[f"{prefix}.weight"] = t(lin["w"]).T.contiguous()
            sd[f"{prefix}.bias"] = t(lin["b"])
        if f"norm_{i}" in params_np:
            sd[f"norm_{i}.weight"] = t(params_np[f"norm_{i}"]["scale"])
            sd[f"norm_{i}.bias"] = t(params_np[f"norm_{i}"]["bias"])
            if spec.norm == "batch":
                st = (bn_state or {}).get(f"norm_{i}")
                n = sd[f"norm_{i}.bias"].numel()
                sd[f"norm_{i}.mean"] = (torch.zeros(n) if st is None
                                        else t(st["mean"]).float())
                sd[f"norm_{i}.var"] = (torch.ones(n) if st is None
                                       else t(st["var"]).float())
    return sd


def bn_state_to_jax(state, spec: ModelSpec) -> dict:
    """SyncBatchNorm's running statistics of a state_dict-shaped mapping
    -> the JAX state tree {'norm_i': {'mean', 'var'}} with f32 numpy leaves
    (the checkpoints' `bn_state`); {} without --norm batch, as the JAX
    package's state is."""
    if spec.norm != "batch":
        return {}
    return {f"norm_{i}": {k: np.ascontiguousarray(
        state[f"norm_{i}.{k}"].detach().cpu().float().numpy())
        for k in ("mean", "var")} for i in range(spec.n_layers - 1)}


def with_bn_state(state: dict, model: GNN) -> dict:
    """`state` (a parameter snapshot) with SyncBatchNorm's running
    statistics replaced by the model's current ones: the JAX package scores
    its best parameters with the run's final state and writes that state
    into the final checkpoint (bnsgcn_tpu/run.py:1850-1874)."""
    if model.spec.norm != "batch":
        return state
    out = dict(state)
    for k, v in model.state_dict().items():
        if k.endswith((".mean", ".var")):
            out[k] = v.detach().clone()
    return out


def params_to_jax(state, spec: ModelSpec) -> dict:
    """The inverse of params_from_jax: a state_dict-shaped mapping (the
    model's parameters, or Adam's moments keyed by parameter name) -> the
    JAX parameter tree with numpy float32 leaves (Bfloat16Array leaves for
    bf16 tensors), the layout of the JAX package's `init_params` and of its
    checkpoints."""
    def a(t, transpose=False):
        t = t.detach().cpu()
        t = (t.T if transpose else t).contiguous()
        if t.dtype == torch.bfloat16:
            return Bfloat16Array(t.view(torch.int16).numpy().view(np.uint16))
        return np.ascontiguousarray(t.float().numpy())

    def lin(name):
        return {"w": a(state[f"{name}.weight"], True),
                "b": a(state[f"{name}.bias"])}

    tree = {}
    for i in range(spec.n_layers):
        tree[f"layer_{i}"] = (
            {k: a(state[f"layer_{i}.{k}"])
             for k in ("w", "attn_l", "attn_r", "bias")}
            if f"layer_{i}.attn_l" in state else
            lin(f"layer_{i}") if f"layer_{i}.weight" in state else
            {"linear1": lin(f"layer_{i}.linear1"),
             "linear2": lin(f"layer_{i}.linear2")})
        if f"norm_{i}.weight" in state:
            tree[f"norm_{i}"] = {"scale": a(state[f"norm_{i}.weight"]),
                                 "bias": a(state[f"norm_{i}.bias"])}
    return tree


def opt_state_to_jax(opt: torch.optim.Adam, model: GNN,
                     full: Optional[Callable] = None) -> dict:
    """torch Adam's state -> the JAX package's optax chain state
    (bnsgcn_tpu/trainer.py make_tx: add_decayed_weights or identity, then
    scale_by_adam and scale_by_learning_rate), as its checkpoints hold it:
    {'0': {}, '1': {'0': {'count', 'mu', 'nu'}, '1': {}}}; count is Adam's
    step (int32), mu and nu its exp_avg and exp_avg_sq. `full` (a feat
    shard's: StepFns.full_state) turns a shard's moments into the full
    ones first; every rank of the feat group calls it then."""
    st = {n: opt.state[p] for n, p in model.named_parameters()}
    full = full or (lambda x: x)

    def moments(key):
        return params_to_jax(full({n: s[key] for n, s in st.items()}),
                             model.spec)

    count = int(next(iter(st.values()))["step"])
    return {"0": {}, "1": {"0": {"count": np.asarray(count, np.int32),
                                 "mu": moments("exp_avg"),
                                 "nu": moments("exp_avg_sq")}, "1": {}}}


def opt_state_from_jax(tree: dict, opt: torch.optim.Adam, model: GNN,
                       cut: Optional[Callable] = None):
    """Load an optax chain state (opt_state_to_jax's layout, as the JAX
    package's checkpoints hold it) into torch Adam; `cut` (a feat shard's:
    StepFns.shard_state) cuts the full moments to the model's shard."""
    adam = tree["1"]["0"]
    cut = cut or (lambda x: x)
    mu = cut(params_from_jax(adam["mu"], model.spec))
    nu = cut(params_from_jax(adam["nu"], model.spec))
    step = torch.tensor(float(int(adam["count"])))
    sd = opt.state_dict()
    sd["state"] = {i: {"step": step.clone(), "exp_avg": mu[n],
                       "exp_avg_sq": nu[n]}
                   for i, (n, _) in enumerate(model.named_parameters())}
    opt.load_state_dict(sd)


def resize_domain(rnonce: int) -> int:
    """The fold operand of the elastic resize nonce (bnsgcn_tpu/run.py:920):
    the (1 << 30) domain, disjoint from the small retry nonces."""
    return (1 << 30) | (int(rnonce) & 0x3FFFFFFF)


def dropout_key(seed: int, epoch: int, part: int,
                replica: Optional[int] = None, nonce: int = 0,
                rnonce: int = 0) -> torch.Tensor:
    """Epoch `epoch`'s dropout key on part `part`, as the JAX step folds it
    (bnsgcn_tpu/trainer.py local_loss, :817 _replica_fold; the resize and
    retry folds of bnsgcn_tpu/run.py:904 `_fold_keys`): fold_in(fold_in(k,
    epoch), part) with k = key(seed + 1), folded with the elastic resize
    nonce's domain when `rnonce` is not 0 (after a shrink), then with the
    retry nonce when it is not 0 (after a divergence rollback), then with
    the replica under a replica axis (replica None: none); an int64 tensor
    [2] on the host. The feat index is never folded. The model splits it
    per layer and draws jax's masks from it, so a resumed run replays every
    epoch's masks and a run equals the JAX package's draw for draw."""
    k = prng.key(seed + 1)
    if rnonce:
        k = prng.fold_in(k, resize_domain(rnonce))
    if nonce:
        k = prng.fold_in(k, nonce)
    if replica is not None:
        k = prng.fold_in(k, replica)
    return prng.fold_in(prng.fold_in(k, epoch), part)


def param_global_norm(model) -> float:
    """The global L2 norm of the model's parameters (f32 sums; this rank's
    shards under a feat axis), the divergence guard's probe every
    `log_every` epochs (bnsgcn_tpu/trainer.py:1195): non-finite when any
    parameter went NaN/Inf, even while the masked loss reads finite."""
    with torch.no_grad():
        sq = [p.detach().float().square().sum() for p in model.parameters()]
        return float(torch.stack(sq).sum().sqrt()) if sq else 0.0


def restore_payload(payload: dict, model, opt: torch.optim.Adam,
                    cut: Optional[Callable] = None) -> None:
    """A checkpoint payload (the JAX package's trees) into the model's
    parameters and SyncBatchNorm statistics and into Adam, in place; `cut`
    (a feat shard's: StepFns.shard_state) cuts the full arrays to the
    model's shard."""
    cut = cut or (lambda x: x)
    model.load_state_dict(cut(params_from_jax(
        payload["params"], model.spec, payload.get("bn_state"))))
    opt_state_from_jax(payload["opt_state"], opt, model, cut)


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return copy.deepcopy(x)


def host_state(model, opt: torch.optim.Adam) -> tuple[dict, dict]:
    """Host copies of the model's state_dict and Adam's (empty before the
    first step): what load_host_state puts back, bitwise."""
    return _to_host(model.state_dict()), _to_host(opt.state_dict())


def load_host_state(snap: tuple[dict, dict], model,
                    opt: torch.optim.Adam) -> None:
    """host_state's copies back into the model and Adam. Adam gets a copy:
    on the CPU its state would keep the snapshot's tensors and step them."""
    model.load_state_dict(snap[0])
    opt.load_state_dict(_to_host(snap[1]))


@dataclass
class StepFns:
    spmm: Optional[Union[EllSpmm, BlockSpmm, SplitSpmm, CooSpmm]]
                                       # the training aggregation operator
                                       # (None for GAT)
    layout: dict                       # its numpy layout arrays [1, ...]
    train_step: Callable               # (model, opt, blk, epoch, key) -> loss
    forward: Callable                  # (model, blk, epoch, key) -> logits
    precompute: Callable               # (blk) -> layer-0 input features
    eval_forward: Callable             # (model, blk) -> eval logits
    dense_edges: int = 0               # edges on dense tiles (hybrid)
    halo: Optional[HaloSpec] = None    # the training exchange (P > 1)
    halo_full: Optional[HaloSpec] = None   # the precompute's, at rate 1.0
    spmm_kind: str = "ell"             # 'ell' | 'hybrid' | 'segment'
                                       # (--spmm resolved)
    gat: Optional[GatAttention] = None     # GAT's attention (spmm is None)
    layout_times: dict = field(default_factory=dict)   # LayoutCache.times
    overlap: str = "off"               # --overlap resolved ('off' where the
                                       # JAX package falls back)
    halo_strategy: str = "padded"      # --halo-exchange resolved
    halo_refresh: int = 1              # --halo-refresh resolved (1 under
                                       # grad-only)
    halo_refresh_spec: Optional[HaloSpec] = None   # the cached step's
    # --halo-refresh K > 1 only: the full-refresh step, which records every
    # layer's received halo block, (model, opt, blk, epoch, key) -> (loss,
    # cache), and the cached step, (model, opt, blk, epoch, key, cache) ->
    # (loss, cache)
    train_step_full: Optional[Callable] = None
    train_step_cached: Optional[Callable] = None
    # the replica and feat axes (None: R = T = 1); feat_dims: the sharded
    # parameters' dimensions (parallel/feat.torch_dims; {} at T = 1)
    axes: Optional[Axes] = None
    feat_dims: dict = field(default_factory=dict)
    # (nonce, rnonce=0) -> None: the retry nonce, after the elastic resize
    # nonce's domain, folded into the boundary sample's base key from now
    # on (a divergence rollback, a resize, a resume); 0 and 0 are the
    # unfolded key (no-op at P = 1, which samples nothing)
    set_nonce: Callable = lambda nonce, rnonce=0: None
    cache: Optional["LayoutCache"] = None   # the layouts it was built from

    def full_state(self, state: dict) -> dict:
        """A state_dict-shaped mapping of this rank's shards made full (one
        all-gather over the feat group, which every rank of it calls); as
        it is at T = 1."""
        if not self.feat_dims:
            return state
        return gather_state(state, self.feat_dims, self.axes.feat)

    def shard_state(self, state: dict) -> dict:
        """A full state_dict-shaped mapping cut to this rank's shard; as it
        is at T = 1."""
        if not self.feat_dims:
            return state
        return shard_state(state, self.feat_dims, self.axes.T, self.axes.f)


# ----------------------------------------------------------------------------
# --cache-dir (bnsgcn_tpu/run.py:371-425)
# ----------------------------------------------------------------------------

def reorder_active(cfg: Config) -> bool:
    """Whether the artifacts a build sees are --reorder permuted (cfg with
    the resolved mode, data/reorder.py maybe_reorder): their rows already
    stand in tile-packed cluster order, so the hybrid takes identity
    orders, and every layout key gains ':ro' (bnsgcn_tpu/trainer.py
    reorder_active)."""
    return (cfg.reorder or "off") != "off"


def ell_layout_key(cfg: Config) -> str:
    """The ELL layouts' cache key (bnsgcn_tpu/trainer.py ell_layout_key):
    'ell', or 'ell:ovl' for the --overlap split interior/frontier pair (cfg
    with the resolved overlap), ':ro' under an applied --reorder."""
    key = "ell:ovl" if cfg.overlap == "split" else "ell"
    return key + (":ro" if reorder_active(cfg) else "")


def hybrid_layout_key(cfg: Config) -> str:
    """The hybrid layout's cache key under cfg's tiling knobs, with the
    effective occupancy, and ':ovl' for the split pair
    (bnsgcn_tpu/trainer.py hybrid_layout_key)."""
    tile = cfg.block_tile
    key = (f"hybrid:{effective_occupancy(cfg.block_occupancy, tile, tile)}:"
           f"{cfg.block_tile_budget_mb}")
    key += f":t{tile}" if tile != 512 else ""
    key += ":ovl" if cfg.overlap == "split" else ""
    return key + (":ro" if reorder_active(cfg) else "")


def gat_layout_key(cfg: Config) -> str:
    """The GAT attention layouts' cache key (bnsgcn_tpu/trainer.py)."""
    return "gat:ro" if reorder_active(cfg) else "gat"


def identity_perms(art: PartitionArtifacts) -> tuple:
    """The orders of an applied --reorder's rows: identity on the inner
    and the extended row spaces."""
    return (np.arange(art.pad_inner, dtype=np.int64),
            np.arange(art.n_ext, dtype=np.int64))


def artifact_digest(art: PartitionArtifacts, row: int = 0) -> str:
    """Content address of one part (bnsgcn_tpu/run.py artifact_digest over
    a rank's own part): sha1 over (n_b, src, dst)."""
    dg = hashlib.sha1()
    for a in (art.n_b, art.src[row], art.dst[row]):
        dg.update(np.ascontiguousarray(a))
    return dg.hexdigest()[:12]


class LayoutCache:
    """One part's host-side layouts (the ELL tables, the hybrid's tiles and
    residual, the GAT layouts: what the card packing starts from), kept in
    `cache_dir` as versioned pickles named by the graph, the part's
    artifact_digest and the layout key of the knobs that shape them. A
    missing, stale or torn file is a miss and a failed write is logged: a
    bad cache costs a rebuild, never the run. Without a directory it only
    times the builds. `times` maps each key to ('built' | 'loaded',
    seconds)."""

    def __init__(self, cache_dir: str, graph_name: str,
                 art: PartitionArtifacts, row: int, log=print):
        self.dir, self.log = cache_dir or None, log
        self.times: dict = {}
        self._held: dict = {}
        if self.dir:
            os.makedirs(self.dir, exist_ok=True)
            sweep_stale_tmp(self.dir, log)
            self.prefix = f"layouts_{graph_name}_{artifact_digest(art, row)}"

    def path(self, key: str) -> str:
        return os.path.join(self.dir,
                            f"{self.prefix}_{key.replace(':', '-')}.pkl")

    def load(self, key: str):
        """The layouts under `key` held or on disk, else None."""
        if key not in self._held and self.dir:
            t0 = time.perf_counter()
            obj = try_load(self.path(key), self.log)
            if obj is not None:
                self._held[key] = obj
                self.times[key] = ("loaded", time.perf_counter() - t0)
        return self._held.get(key)

    def get(self, key: str, build: Callable):
        """The layouts under `key`: held, on disk, or built now by
        build() and written."""
        obj = self.load(key)
        if obj is not None:
            return obj
        t0 = time.perf_counter()
        obj = self._held[key] = build()
        self.times[key] = ("built", time.perf_counter() - t0)
        if self.dir:
            try:
                atomic_dump(obj, self.path(key))
                self.log(f"  layout cache: wrote {self.path(key)}")
            except OSError as e:
                self.log(f"  layout cache: write failed at {self.path(key)} "
                         f"({e}); continuing without it")
        return obj


def resolve_spmm(cfg: Config, art: PartitionArtifacts, row: int = 0,
                 comm: Optional[Comm] = None, log=print, perms=None):
    """(spmm kind, cluster perms or None): cfg.spmm, with 'auto' resolved as
    the JAX package's build_step_fns resolves it: the part's cluster order
    (`perms` when the caller already holds it; identity under an applied
    --reorder, bnsgcn_tpu/trainer.py:485-488), then the fraction of edges
    that would densify onto tiles (estimate_coverage), summed over the
    ranks; hybrid at AUTO_HYBRID_MIN_COVERAGE or more (reusing the perms),
    else ELL. Rank 0 prints the same `spmm=auto: ...` line."""
    if cfg.spmm != "auto":
        return cfg.spmm, None
    tile = cfg.block_tile
    src, dst = art.src[row], art.dst[row]
    if reorder_active(cfg):
        perms = identity_perms(art)
    pi, pe = perms if perms is not None else cluster_order(
        src, dst, art.pad_inner, art.n_ext, target=tile, log=log)
    real = dst < art.pad_inner
    d, s = dst[real], src[real]
    cov = estimate_coverage(
        pi, pe, art.pad_inner, art.n_ext, d, s,
        occupancy_min=effective_occupancy(cfg.block_occupancy, tile, tile),
        tile_budget_bytes=cfg.block_tile_budget_mb << 20, tile_r=tile,
        tile_c=tile)
    both = torch.tensor([cov * len(d), float(len(d))], dtype=torch.float64)
    if comm is not None:
        both = comm.all_reduce_(both.to(comm.device)).cpu()
    frac = float(both[0]) / max(float(both[1]), 1.0)
    kind = "hybrid" if frac >= AUTO_HYBRID_MIN_COVERAGE else "ell"
    log(f"spmm=auto: {frac:.1%} of edges densify onto dense tiles -> {kind}")
    return kind, ((pi, pe) if kind == "hybrid" else None)


def resolve_halo_mode(cfg: Config, log=print) -> tuple[int, bool]:
    """(refresh period K, grad-only) as the JAX package's build_step_fns
    resolves them: grad-only never exchanges activations, so it ignores
    --halo-refresh, with the JAX package's line."""
    k = int(cfg.halo_refresh or 1)
    if k < 1:
        raise ConfigError(f"--halo-refresh must be >= 1, got {k}")
    if cfg.halo_mode not in ("exchange", "grad-only"):
        raise ConfigError(f"--halo-mode must be 'exchange' or 'grad-only', "
                          f"got {cfg.halo_mode!r}")
    grad_only = cfg.halo_mode == "grad-only"
    if grad_only and k > 1:
        log("halo-mode=grad-only never exchanges activations; "
            "--halo-refresh has no effect")
        k = 1
    return k, grad_only


def resolve_overlap(cfg: Config, model: str,
                    grad_only: bool) -> tuple[str, Optional[str]]:
    """(overlap, why it fell back or None): --overlap split falls back to
    off where the JAX package's build_step_fns does, for grad-only (no
    exchange to overlap), GAT (its softmax consumes the whole halo block)
    and more than one node."""
    if cfg.overlap != "split":
        return cfg.overlap, None
    if grad_only:
        return "off", ("halo-mode=grad-only skips the activation exchange "
                       "entirely — there is no collective to overlap")
    if model not in ("gcn", "graphsage"):
        return "off", (f"model={model!r} aggregates through the masked "
                       f"edge softmax, which consumes the whole halo block")
    if cfg.n_nodes > 1:
        return "off", ("multi-host partial loads cannot derive the global "
                       "interior/frontier row split from local parts yet")
    return "split", None


def resolve_strategy(cfg: Config, n_b, pad_inner: int, pad_boundary: int,
                     rate: float) -> tuple[str, Optional[str]]:
    """(halo strategy, the auto pick's reason or None): --halo-exchange,
    with 'auto' resolved by select_halo_strategy over the global n_b table,
    as every rank and node resolves it alike."""
    if cfg.halo_exchange != "auto":
        return cfg.halo_exchange, None
    return select_halo_strategy(n_b, pad_inner, pad_boundary, rate,
                                wire=cfg.halo_wire,
                                allow_ragged=ragged_auto_eligible())


def _held_perms(held: dict):
    """The full cluster order (perm_inner, perm_ext) a hybrid layout holds:
    its own, or, for a split layout, the interior build's column order
    (the inner one) and the frontier build's (the extended one)."""
    if "blk_perm_inner" in held:
        return held["blk_perm_inner"][0], held["blk_perm_ext"][0]
    return held["int_blk_perm_ext"][0], held["fro_blk_perm_ext"][0]


def build_spmm(cfg: Config, art: PartitionArtifacts, device, log=print,
               row: int = 0, comm: Optional[Comm] = None,
               reuse: Optional["StepFns"] = None,
               row_cap: int = I8_ROW_CAP,
               cache: Optional[LayoutCache] = None):
    """(operator, numpy layout, resolved spmm kind) for cfg.spmm over the
    part in row `row` of `art`, with cfg's gather and dense dtypes (the
    int8 dense modes picked at `row_cap`), under cfg.overlap (resolved: the
    caller's cfg carries 'split' only where the split runs). Each part
    builds its own layout (through `cache`, --cache-dir): the ELL pads come
    from the artifacts' global geometry, the hybrid tiles and residual from
    the part alone, a split pair's row spaces from the part alone. `reuse`,
    the step functions of an earlier build of the same part and tiling,
    lends its layout when the resolved kind and overlap are its own (only
    the dtypes change); its hybrid's cluster order, or a cached hybrid's,
    goes to the auto pick (cluster_order is deterministic, so it is the
    order the pick would compute). --spmm segment runs `CooSpmm` over the
    part's COO edges (split: `split_coo`'s two edge lists)."""
    cache = cache or LayoutCache("", "", art, row, log)
    split = cfg.overlap == "split"
    held = None
    if reuse is not None and reuse.spmm_kind == "hybrid":
        held = reuse.layout
    elif cfg.spmm == "auto":
        cached = cache.load(hybrid_layout_key(cfg))
        held = (None if cached is None else
                cached[2] if split else cached[3])
    if held is not None:
        held = _held_perms(held)
    kind, perms = resolve_spmm(cfg, art, row, comm, log, held)
    if (reuse is not None and reuse.spmm_kind == kind
            and reuse.overlap == cfg.overlap):
        return (reuse.spmm.with_dtypes(cfg.spmm_gather, cfg.spmm_dense,
                                       row_cap), reuse.layout, kind)
    src, dst = art.src[row:row + 1], art.dst[row:row + 1]
    ni, n_ext = art.pad_inner, art.n_ext
    if kind == "segment":
        if cfg.spmm_gather != "native":
            log(f"spmm_gather={cfg.spmm_gather} has no effect for "
                f"spmm='segment' / model={cfg.model!r} (only the ell/hybrid "
                f"GCN/GraphSAGE aggregation paths quantize gathers)")

        def coo(s, d):
            return CooSpmm(torch.from_numpy(np.ascontiguousarray(s)).to(
                device), torch.from_numpy(np.ascontiguousarray(d)).to(device),
                ni, cfg.edge_chunk)

        if not split:
            return coo(src[0], dst[0]), {}, kind
        arrays = split_coo(src, dst, ni)
        return (SplitSpmm(coo(arrays["seg_int_src"][0],
                              arrays["seg_int_dst"][0]),
                          coo(arrays["seg_fro_src"][0],
                              arrays["seg_fro_dst"][0]), None, ni),
                arrays, kind)
    if kind == "hybrid":
        tile = cfg.block_tile
        knobs = dict(occupancy_min=effective_occupancy(cfg.block_occupancy,
                                                       tile, tile),
                     tile_budget_bytes=cfg.block_tile_budget_mb << 20,
                     tile_r=tile, tile_c=tile)

        def cluster():
            pi, pe = (identity_perms(art) if reorder_active(cfg) else
                      perms if perms is not None else cluster_order(
                          src[0], dst[0], ni, n_ext, target=tile, log=log))
            return pi[None], pe[None]

        def block_op(fwd, bwd, pair, arrays):
            return BlockSpmm(fwd, bwd, pair, to_device(arrays, device),
                             gather_dtype=cfg.spmm_gather,
                             dense_dtype=cfg.spmm_dense, row_cap=row_cap)

        if split:
            (i_f, i_b, i_pair), (f_f, f_b, f_pair), arrays, _, _ = cache.get(
                hybrid_layout_key(cfg), lambda: build_split_block_layouts(
                    src, dst, ni, n_ext, *cluster(), **knobs))
            return (SplitSpmm(block_op(i_f, i_b, i_pair, _sub(arrays, "int_")),
                              block_op(f_f, f_b, f_pair, _sub(arrays, "fro_")),
                              _merge_perm(arrays, device), ni), arrays, kind)
        fwd, bwd, ell_pair, arrays = cache.get(hybrid_layout_key(cfg), lambda: (
            build_block_layouts(src, dst, ni, n_ext, *cluster(), **knobs)))
        return block_op(fwd, bwd, ell_pair, arrays), arrays, kind
    if kind == "ell":
        if split:
            (i_f, i_b), (f_f, f_b), arrays, _, _ = cache.get(
                ell_layout_key(cfg), lambda: build_split_layouts(
                    src, dst, ni, n_ext))
            ell_op = partial(EllSpmm, gather_dtype=cfg.spmm_gather)
            return (SplitSpmm(
                ell_op(i_f, i_b, to_device(_sub(arrays, "int_"), device)),
                ell_op(f_f, f_b, to_device(_sub(arrays, "fro_"), device)),
                _merge_perm(arrays, device), ni), arrays, kind)
        fwd, bwd, arrays = cache.get(ell_layout_key(cfg), lambda: (
            build_layouts(src, dst, ni, n_ext, geometry=art.ell_geometry)))
        return (EllSpmm(fwd, bwd, to_device(arrays, device),
                        gather_dtype=cfg.spmm_gather), arrays, kind)
    raise ValueError(f"--spmm {cfg.spmm} is not ported yet")


def _sub(arrays: dict, prefix: str) -> dict:
    """The arrays under `prefix`, without it: one side of a split layout."""
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def _merge_perm(arrays: dict, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        arrays["merge_perm"][0])).to(device)


def build_step_fns(cfg: Config, spec: ModelSpec, art: PartitionArtifacts,
                   device, log=print, rank: int = 0,
                   comm: Optional[Comm] = None,
                   reuse: Optional[StepFns] = None,
                   row_cap: int = I8_ROW_CAP,
                   axes: Optional[Axes] = None,
                   cache: Optional[LayoutCache] = None) -> StepFns:
    """Part `rank`'s step functions. Without `comm` (its 'parts' group) the
    run is P=1. `axes`: the replica and feat axes of an R x P x T run
    (None at R = T = 1). `reuse` and `row_cap` go to build_spmm; the
    layouts go through `cache`, by default a LayoutCache of cfg.cache_dir
    (a --tune rebuild passes the run's, StepFns.cache, so no layout is
    built twice). Resolves, as the JAX
    package's build_step_fns does and logging its lines: --halo-exchange
    auto, --halo-mode and --halo-refresh, --overlap split's fallbacks."""
    if (art.n_parts > 1) != (comm is not None):
        raise ValueError(f"P={art.n_parts} needs a Comm exactly when P > 1")
    row = local_row(art, rank)
    cache = cache or LayoutCache(cfg.cache_dir,
                                 cfg.graph_name or cfg.derive_graph_name(),
                                 art, row, log)
    strategy, why = resolve_strategy(cfg, art.n_b, art.pad_inner,
                                     art.pad_boundary, cfg.sampling_rate)
    if why is not None:
        log(f"halo-exchange=auto: {why} -> {strategy}")
    refresh_k, grad_only = resolve_halo_mode(cfg, log)
    overlap, reason = resolve_overlap(cfg, spec.model, grad_only)
    if reason is not None:
        log(f"overlap=split unavailable ({reason}); falling back to "
            f"--overlap off")
    cfg = cfg.replace(overlap=overlap)
    gat = None
    if spec.model == "gat":
        # no SpMM: --spmm auto stays on ELL (bnsgcn_tpu/trainer.py:707)
        spmm, layout = None, {}
        kind = cfg.spmm if cfg.spmm in ("ell", "hybrid") else "ell"
        gat = build_gat_attention(art, row, device, lambda: cache.get(
            gat_layout_key(cfg), lambda: part_gat_layouts(art, row)))
        if cfg.spmm_gather != "native":
            log(f"spmm_gather={cfg.spmm_gather} has no effect for "
                f"spmm={kind!r} / model='gat' (only the ell/hybrid GCN/"
                f"GraphSAGE aggregation paths quantize gathers)")
    else:
        spmm, layout, kind = build_spmm(cfg, art, device, log, row, comm,
                                        reuse, row_cap, cache)
    # the replica and feat axes: the replica fold of the keys, the reduce
    # and SyncBatchNorm over the world, the feat group's layers
    R = axes.R if axes is not None else 1
    replica = axes.replica if axes is not None else None
    red_comm = axes.world if axes is not None else comm
    feat, feat_dims = None, {}
    if axes is not None and axes.T > 1:
        feat = FeatAxis(axes.feat, shardable_layers(spec, axes.T))
        feat_dims = torch_dims(spec, axes.T)
    n_train = max(art.n_train, 1) * R
    keys = {}           # the boundary sample's key (P > 1), set_nonce's
    loss_sum = bce_sum if art.multilabel else ce_sum
    ni = art.pad_inner
    n_halo = art.n_ext - ni
    hspec = hfull = hspec_r = None
    if comm is not None:
        bnd = torch.from_numpy(np.ascontiguousarray(art.bnd[row])).to(device)
        hspec, tables = make_halo_spec(art.n_b, ni, art.pad_boundary,
                                       cfg.sampling_rate, strategy=strategy,
                                       wire=cfg.halo_wire)
        hfull, tables_full = full_rate_spec(art.n_b, ni, art.pad_boundary)
        tables = tables_to(tables, device)
        tables_full = tables_to(tables_full, device)
        if refresh_k > 1:
            hspec_r, tables_r = make_refresh_spec(
                art.n_b, ni, art.pad_boundary, cfg.sampling_rate, refresh_k,
                strategy=strategy, wire=cfg.halo_wire)
            tables_r = tables_to(tables_r, device)
            warm_ragged(hspec_r, comm.rank, device)
        warm_ragged(hspec, comm.rank, device)
        base_key = prng.key(cfg.seed, device)
        keys["sample"] = base_key
        # rate 1.0: the identity plan, the same every epoch
        fixed_plan = (make_halo_plan(hspec, tables, bnd, rank)
                      if hspec.exact else None)

    def local_exchange(i, h):
        # P=1: no peer sends anything; the halo slots stay zero
        return torch.cat([h, h.new_zeros((n_halo, h.shape[1]))])

    def local_presence():
        return torch.arange(art.n_ext, device=device) < ni

    def split_body(blk, spec_h=None, plan=None, combine=None):
        """--overlap split's layer body (bnsgcn_tpu/trainer.py
        `_split_agg_for`): launch the exchange, aggregate the interior
        rows, finish the exchange (merged into the cache by `combine` in a
        refresh step), aggregate the frontier rows, merge. The interior
        rows' aggregation does not read the halo block, so on a card it
        runs while the collective is in flight (on nccl's stream, or in
        gloo's thread), and its backward runs while the transposed
        collective is (HaloFlight). At P=1 the halo block is zero."""
        out_norm = blk["out_norm"]

        def scale(x, norm):
            # GCN's norm, piecewise: elementwise the fused path's division
            return (x / norm[:, None]).to(x.dtype)

        def agg(i, h, scale_out_norm):
            flight = None
            if comm is not None:
                flight = HaloFlight(spec_h, plan, comm)
                flight.start(h)
            h_in = scale(h, out_norm[:ni]) if scale_out_norm else h
            # the phases' spans, for a trace window's overlap check
            # (utils/traceparse.py overlap_from_events)
            with record_function("interior_agg"):
                o_int = spmm.interior(h_in)
            buf = (flight.finish() if flight is not None else
                   h.new_zeros((n_halo, h.shape[1])))
            if combine is not None:
                buf = combine(i, buf)
            h_halo = scale(buf, out_norm[ni:]) if scale_out_norm else buf
            with record_function("frontier_agg"):
                o_fro = spmm.frontier(torch.cat([h_in, h_halo]))
            return spmm.merge(o_int, o_fro)
        return agg

    def step_env(blk, epoch: int, mode: str = "step", cache=None):
        """(exchange, presence, agg_exchange, cache out) of `epoch`'s step:
        'step' the historical exchange; under --halo-refresh K > 1 'full'
        the historical exchange recording each layer's halo block and the
        halo presence, 'cached' chunk epoch % K through the refresh
        geometry merged into `cache`, the stale rows detached (no gradient
        flows through them, so the backward's collective runs on the
        refresh geometry too); grad-only no exchange, a zero halo block
        that presence masks out whole."""
        split = overlap == "split"
        if comm is None:
            agg = split_body(blk) if split else None
            out = {} if mode != "step" else None
            return local_exchange, local_presence(), agg, out
        if grad_only:
            presence = torch.cat([torch.ones(ni, dtype=torch.bool,
                                             device=device),
                                  torch.zeros(n_halo, dtype=torch.bool,
                                              device=device)])
            return local_exchange, presence, None, None
        if mode == "cached":
            spec_h = hspec_r
            plan = make_halo_plan_refresh(hspec_r, tables_r, bnd, rank,
                                          epoch, keys["sample"], refresh_k,
                                          replica)
            mask = refresh_row_mask(hspec_r, refresh_k, epoch, device)
            presence_h = torch.where(mask, plan.presence[ni:],
                                     cache["presence"])
        else:
            spec_h = hspec
            plan = (fixed_plan if fixed_plan is not None else
                    make_halo_plan(hspec, tables, bnd, rank, epoch,
                                   keys["sample"], replica))
            mask, presence_h = None, plan.presence[ni:]
        presence = torch.cat([plan.presence[:ni], presence_h])
        if mode == "step":
            return ((lambda i, h: halo_apply(hspec, plan, h, comm)),
                    presence, split_body(blk, hspec, plan) if split else None,
                    None)
        out = {"presence": presence_h}

        def combine(i, fresh):
            if mask is not None:
                fresh = torch.where(mask[:, None], fresh,
                                    cache[f"layer_{i}"].to(fresh.dtype))
            out[f"layer_{i}"] = fresh.detach()
            return fresh

        def exchange(i, h):
            h_ext = halo_apply(spec_h, plan, h, comm)
            if mask is None:
                out[f"layer_{i}"] = h_ext[ni:].detach()
                return h_ext
            return torch.cat([h_ext[:ni], combine(i, h_ext[ni:])])

        return (exchange, presence,
                split_body(blk, spec_h, plan, combine) if split else None,
                out)

    bn_sum = None
    if red_comm is not None and spec.norm == "batch":
        bn_sum = partial(moments_sum, comm=red_comm)
    # the refresh steps record each layer's halo block from inside the
    # forward, which a rematerialized layer would rerun: --remat is ignored
    # for them, with the JAX package's note (bnsgcn_tpu/trainer.py:900-905)
    remat = cfg.remat and refresh_k == 1
    if cfg.remat and refresh_k > 1 and rank == 0:
        print("halo-refresh>1: the refresh steps return per-layer halo "
              "buffers as step outputs, which cannot escape a "
              "jax.checkpoint region — --remat is ignored for them "
              "(numerics unchanged; memory savings lost)", file=sys.stderr)

    def run_forward(model: GNN, blk, epoch: int, key=None,
                    mode: str = "step", cache=None):
        exchange, presence, agg, out = step_env(blk, epoch, mode, cache)
        env = GraphEnv(n_dst=ni, in_norm=blk["in_norm"],
                       out_norm=blk["out_norm"], exchange=exchange,
                       aggregate=spmm, training=True, rng=key,
                       presence=presence, gat_feat0=blk.get("feat0_ext"),
                       attention=gat, agg_exchange=agg,
                       inner_mask=blk.get("inner_mask"), bn_sum=bn_sum,
                       remat=remat, feat=feat,
                       bn_copies=R * (axes.T if axes is not None else 1))
        logits, state = apply_model(model, blk["feat"], env,
                                    return_state=True)
        return logits, out, state

    def forward(model: GNN, blk, epoch: int, key=None):
        """Training-mode forward at `epoch` (which keys the boundary
        sample) with the dropout key `key`: logits [pad_inner, n_class]."""
        return run_forward(model, blk, epoch, key)[0]

    def step(model: GNN, opt, blk, epoch: int, key=None,
             mode: str = "step", cache=None):
        opt.zero_grad(set_to_none=True)
        logits, out, state = run_forward(model, blk, epoch, key, mode, cache)
        loss = loss_sum(logits, blk["label"], blk["train_mask"]) / n_train
        loss.backward()
        if red_comm is not None:
            loss = reduce_gradients(
                model.parameters(), red_comm, loss,
                [feat_dims.get(n) for n, _ in model.named_parameters()],
                feat.T if feat is not None else 1,
                feat.f if feat is not None else 0)
        opt.step()
        # SyncBatchNorm's new running statistics, outputs of the forward
        # (the JAX step returns them as its new state): the model carries
        # them to the next step and to the evals
        with torch.no_grad():
            for name, (mean, var) in state.items():
                norm = getattr(model, name)
                norm.mean.copy_(mean)
                norm.var.copy_(var)
        return loss.detach(), out

    def train_step(model: GNN, opt, blk, epoch: int, key=None):
        """One step at `epoch` with the dropout key `key` (dropout_key);
        returns the loss summed over the ranks."""
        return step(model, opt, blk, epoch, key)[0]

    refresh_steps = {}
    if refresh_k > 1:
        refresh_steps = dict(
            train_step_full=lambda model, opt, blk, epoch, key=None:
            step(model, opt, blk, epoch, key, "full"),
            train_step_cached=lambda model, opt, blk, epoch, key, cache:
            step(model, opt, blk, epoch, key, "cached", cache))

    @torch.no_grad()
    def precompute(blk):
        """use_pp layer-0 input, once before training (JAX trainer
        local_precompute): GCN (sum feat/out_norm)/in_norm; GraphSAGE
        cat(feat, sum(feat)/in_deg), in f32 (the norms are f32; the caller
        casts a bf16 run's result). The exchange (full-rate at any training
        rate, native wire: the JAX package's precompute exchange) and the
        aggregation (the same SpMM with native codecs, as the JAX package's
        precompute operator; a split pair composed) run at the raw feature
        width in its dtype. GAT: the exchanged features themselves,
        feat0_ext."""
        feat_ext = (local_exchange(0, blk["feat"]) if comm is None else
                    precompute_exchange(hfull, tables_full, bnd, blk["feat"],
                                        rank, comm))
        if spec.model == "gat":
            return feat_ext
        if spec.model == "gcn":
            return spmm.apply_dir("fwd", feat_ext / blk["out_norm"][:, None],
                                  "pre", native=True) / blk["in_norm"][:, None]
        ah = spmm.apply_dir("fwd", feat_ext, "pre",
                            native=True) / blk["in_norm"][:, None]
        return torch.cat([blk["feat"], ah], 1)

    @torch.no_grad()
    def eval_forward(model: GNN, blk):
        """The full-rate eval forward of this part (the JAX trainer's
        local_embed/eval_forward): eval mode (no dropout; with use_pp, layer
        0 exchanges and aggregates the raw features), every halo row
        present (the precompute's full-rate plan, native wire, padded),
        the norms of the artifacts' graph, and the training SpMM with the
        training codecs (`_aggregate_for`; a split pair composed), its K1
        and K2 launches counted under 'eval'. blk['feat'] holds the raw f32
        features. Logits [pad_inner, n_class]; at P > 1 every rank calls it
        together. GAT attends with the full-rate plan's presence."""
        if comm is None:
            exchange, presence = local_exchange, local_presence()
        else:
            plan = make_halo_plan(hfull, tables_full, bnd, rank)
            exchange = lambda i, h: halo_apply(hfull, plan, h, comm)
            presence = plan.presence
        env = GraphEnv(n_dst=ni, in_norm=blk["in_norm"],
                       out_norm=blk["out_norm"], exchange=exchange,
                       aggregate=(None if spmm is None else
                                  lambda h: spmm.apply_dir("fwd", h, "eval")),
                       training=False, presence=presence, attention=gat,
                       feat=feat)
        return apply_model(model, blk["feat"], env)

    def set_nonce(nonce: int, rnonce: int = 0) -> None:
        # bnsgcn_tpu/run.py:904 `_fold_keys`: the resize nonce's domain,
        # then the retry nonce, fold the base key, before the epoch,
        # replica and pair folds of the draw
        if "sample" in keys:
            k = base_key
            if rnonce:
                k = prng.fold_in(k, resize_domain(rnonce))
            if nonce:
                k = prng.fold_in(k, nonce)
            keys["sample"] = k

    dense = (dense_edge_count(layout)
             if spmm is not None and kind == "hybrid" else 0)
    return StepFns(spmm=spmm, layout=layout, train_step=train_step,
                   forward=forward, precompute=precompute,
                   eval_forward=eval_forward, dense_edges=dense,
                   halo=hspec, halo_full=hfull, spmm_kind=kind, gat=gat,
                   layout_times=cache.times, overlap=overlap,
                   halo_strategy=strategy, halo_refresh=refresh_k,
                   halo_refresh_spec=hspec_r, axes=axes,
                   feat_dims=feat_dims, set_nonce=set_nonce, cache=cache,
                   **refresh_steps)
