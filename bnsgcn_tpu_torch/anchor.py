"""The calibrated accuracy anchor: an accuracy gate that can fail
(counterpart of tools/anchor_harness.py `train_eval`, with the graph and
the gates of tests/test_accuracy_anchor.py).

`reddit_like_graph(feat_snr=0.12, label_noise=0.03)` at 8,192 nodes is hard
enough that exact training plateaus below saturation (the JAX package
calibrated 0.9658), so a sampler or a kernel stack that costs accuracy
shows. `train_eval` trains GraphSAGE 3x32 without normalization and without
use_pp (under LayerNorm or an exact layer-0 precompute a broken BNS rescale
is learnable-around; here every layer rides the sampled exchange) through
the port's own entry point, run.run_training, over P ranks at a BNS rate,
on random partitions, and returns the full-rate eval-mode validation
accuracy of the final parameters. The gates: exact (P=1, rate 1.0, f32,
ELL) in EXACT_BAND; BNS or the quantized stack within QUANT_TOL of exact.
The weights and the draws are the JAX package's own (its init and
dropout draws and its BNS stream, through the port's threefry), so the
accuracies are the port's own arithmetic on the JAX package's draws, held
to its bands.

Two mutations reproduce ways the BNS math can silently break (the JAX
harness's): `biased_sampler`, a first-k "sample" of each boundary list (a
deterministic subset: the estimator's expectation is no longer the full
aggregate), and `break_rescale`, the 1/ratio sender rescale forced to 1
(every remote contribution shrinks by about the rate). Neither is a flag of
the CLI: `train_eval` has each spawned rank apply them to itself (`mutate`,
its rank hook), since a patch made in the parent would not reach the ranks.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import functools

import torch

from bnsgcn_tpu_torch.config import Config
from bnsgcn_tpu_torch.data.artifacts import build_artifacts, save_artifacts
from bnsgcn_tpu_torch.data.graph import Graph, reddit_like_graph
from bnsgcn_tpu_torch.data.partitioner import partition_graph

# tests/test_accuracy_anchor.py:43-46 (calibrated by the JAX package's
# tools/calibrate_anchor.py)
ANCHOR_GRAPH = dict(n_nodes=8192, avg_degree=96, n_class=16, n_feat=32,
                    seed=11, feat_snr=0.12, label_noise=0.03)
EPOCHS = 200
EXACT_BAND = (0.93, 0.985)      # exact training lands inside, unsaturated
QUANT_TOL = 0.005               # |BNS or quantized - exact| at most this
PARTITION_SEED = 2              # the harness's random partition


def anchor_graph() -> Graph:
    return reddit_like_graph(**ANCHOR_GRAPH)


def biased_pair_sample(keys, n_valid, s_valid, pad_b: int, pad_s: int):
    """The biased-sampler mutation in place of parallel/sampling.py
    `pair_sample` (tools/anchor_harness.py `_biased_pair_sample`): always
    the first s_valid positions of each list, whatever the key."""
    pos = torch.arange(pad_s, device=keys.device)
    return pos.expand(keys.shape[0], pad_s), pos[None] < s_valid[:, None]


def unit_rescale(tables: dict) -> dict:
    """The broken-rescale mutation: make_halo_spec's tables (numpy or
    tensors) with inv_ratio forced to 1 wherever it is positive, so sampled
    remote rows arrive unscaled."""
    inv = torch.as_tensor(tables["inv_ratio"])
    return dict(tables, inv_ratio=torch.where(inv > 0, 1.0, 0.0).to(
        torch.float32))


def mutate(biased_sampler: bool, break_rescale: bool, pr=None) -> None:
    """Apply the mutations in this process: the port's halo module draws
    with biased_pair_sample, and the trainer's per-epoch plans take
    unit_rescale's tables. `pr` (unused) makes a partial of it a rank hook
    of run.run_training, which each rank runs after building its step
    functions and before its first epoch."""
    from bnsgcn_tpu_torch import trainer
    from bnsgcn_tpu_torch.parallel import halo
    if biased_sampler:
        halo.pair_sample = biased_pair_sample
    if break_rescale:
        plan = trainer.make_halo_plan
        trainer.make_halo_plan = (lambda spec, tables, *a, **k: plan(
            spec, unit_rescale(tables), *a, **k))


def train_eval(g: Graph, P: int, rate: float, epochs: int = 120,
               n_hidden: int = 32, n_layers: int = 3, seed: int = 5,
               lr: float = 0.01, norm: Optional[str] = None,
               use_pp: bool = False, spmm: str = "ell",
               use_pallas: bool = False, spmm_gather: str = "native",
               spmm_dense: str = "native", halo_wire: str = "native",
               dtype: str = "float32", device: str = "cuda",
               work: Optional[str] = None, log=lambda m: None,
               biased_sampler: bool = False,
               break_rescale: bool = False) -> float:
    """Train GraphSAGE on g over P ranks (gloo; at P > 1 they share the one
    card, or run on the CPU) at BNS `rate` for `epochs` epochs, dropout 0.1,
    with the given SpMM, gather, dense, wire and compute dtypes, and the
    mutations asked for (P > 1); return the full-rate eval-mode validation
    accuracy of the final parameters. Artifacts, checkpoints and results go
    under `work` (a temporary directory by default)."""
    own = work is None
    work = tempfile.mkdtemp(prefix="anchor_") if own else work
    cfg = Config(dataset="anchor", model="graphsage", n_layers=n_layers,
                 n_hidden=n_hidden, norm=norm, dropout=0.1, use_pp=use_pp,
                 lr=lr, sampling_rate=rate, n_epochs=epochs,
                 log_every=epochs, eval=True, seed=seed, n_partitions=P,
                 partition_method="random", dtype=dtype, spmm=spmm,
                 use_pallas=use_pallas, spmm_gather=spmm_gather,
                 spmm_dense=spmm_dense, halo_wire=halo_wire, device=device,
                 dist_backend="gloo",
                 part_path=os.path.join(work, "parts"),
                 graph_name=f"anchor-{P}",
                 ckpt_path=os.path.join(work, f"ckpt-{P}-{rate}-{dtype}"),
                 results_path=os.path.join(work, "results"))
    from bnsgcn_tpu_torch.run import artifacts_dir, run_training
    if P > 1 and not os.path.exists(os.path.join(artifacts_dir(cfg),
                                                 "meta.json")):
        save_artifacts(build_artifacts(g, partition_graph(
            g, P, method="random", seed=PARTITION_SEED)), artifacts_dir(cfg))
    try:
        hook = (functools.partial(mutate, biased_sampler, break_rescale)
                if biased_sampler or break_rescale else None)
        return float(run_training(cfg, g=g, log=log, rank_hook=hook).val_acc)
    finally:
        if own:
            import shutil
            shutil.rmtree(work, ignore_errors=True)
