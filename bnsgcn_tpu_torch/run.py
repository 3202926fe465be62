"""Single-process training loop (counterpart of the single-host path of
bnsgcn_tpu/run.py `run_training`).

Builds the graph, the P=1 artifacts and the SpMM layout, runs the use_pp
precompute, trains `n_epochs` epochs printing the JAX package's epoch line,
evaluates every `log_every` epochs on the full graph, and ends with the
best-validation parameters' accuracy line. Checkpoints, resume and the
resilience/coordination layers wait for later slices.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from bnsgcn_tpu_torch.config import Config, ConfigError
from bnsgcn_tpu_torch.data.artifacts import build_artifacts
from bnsgcn_tpu_torch.data.datasets import load_data
from bnsgcn_tpu_torch.data.graph import Graph
from bnsgcn_tpu_torch.data.partitioner import partition_graph
from bnsgcn_tpu_torch.evaluate import evaluate_trans
from bnsgcn_tpu_torch.models.gnn import GNN, ModelSpec, spec_from_config
from bnsgcn_tpu_torch.trainer import (StepFns, build_block_arrays,
                                      build_step_fns, make_tx, to_device)

# epochs excluded from the Time(s) mean: eager PyTorch compiles nothing, so
# only the first epoch (allocator growth, library handles) is warm-up
WARMUP_EPOCHS = 1

TRAIN_KEYS = ("feat", "label", "train_mask", "in_norm", "out_norm")


@dataclass
class RunResult:
    losses: list = field(default_factory=list)
    epoch_times: list = field(default_factory=list)
    epoch_time: float = 0.0            # mean over post-warm-up epochs, s
    best_val_acc: float = 0.0
    val_acc: float = 0.0               # of the final evaluation
    test_acc: float = 0.0
    dense_edges: int = 0
    n_edges: int = 0


def resolve_device(name: str) -> torch.device:
    """The device the caller asked for. 'cuda' without a GPU is an error:
    the port never drops to the CPU unless asked to."""
    if name == "cpu":
        return torch.device("cpu")
    if name == "cuda":
        if not torch.cuda.is_available():
            raise ConfigError("no CUDA device: the port runs on the GPU; pass "
                              "--device cpu to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    raise ConfigError(f"unknown device {name!r}")


def set_float32_math():
    """f32 products in full f32, as the JAX package's --dtype float32
    computes: no TF32 in matmuls or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass
class Prepared:
    """Everything a run builds before its first epoch."""
    cfg: Config                        # with n_feat/n_class/n_train filled
    spec: ModelSpec
    g: Graph
    fns: StepFns
    blk: dict                          # part 0's training arrays on device
    device: torch.device
    n_edges: int


def prepare_run(cfg: Config, g: Optional[Graph] = None,
                log=print) -> Prepared:
    """Graph -> P=1 artifacts -> SpMM layout (on the device) -> block
    arrays. The use_pp precompute is the first step of run_training."""
    device = resolve_device(cfg.device)
    set_float32_math()
    if g is None:
        g, _, _ = load_data(cfg)
    art = build_artifacts(g, partition_graph(g, cfg.n_partitions))
    cfg = cfg.replace(n_feat=art.n_feat, n_class=art.n_class,
                      n_train=art.n_train)
    spec = spec_from_config(cfg)
    t0 = time.perf_counter()
    fns = build_step_fns(cfg, spec, art, device, log=log)
    n_edges = int((art.dst[0] < art.pad_inner).sum())
    log(f"Graph: {g.n_nodes} nodes, {n_edges} edges, F={art.n_feat}, "
        f"{art.n_class} classes | spmm={cfg.spmm} layout "
        f"{time.perf_counter() - t0:.1f}s"
        + (f" | dense tiles carry {fns.dense_edges} edges "
           f"({fns.dense_edges / max(n_edges, 1):.1%})"
           if cfg.spmm == "hybrid" else ""))
    blk = to_device({k: v for k, v in build_block_arrays(
        art, spec.model).items() if k in TRAIN_KEYS}, device)
    return Prepared(cfg, spec, g, fns, blk, device, n_edges)


def init_training(pr: Prepared, model_init: Optional[dict] = None):
    """(block arrays with the use_pp precompute applied, model, optimizer,
    dropout generator) for a prepared run. The model is initialized on the
    host from cfg.seed, so the draw does not depend on the device;
    `model_init` (a state_dict) replaces it."""
    blk = dict(pr.blk)
    if pr.spec.use_pp:
        blk["feat"] = pr.fns.precompute(blk)
    model = GNN(pr.spec, torch.Generator().manual_seed(pr.cfg.seed))
    if model_init is not None:
        model.load_state_dict(model_init)
    model = model.to(pr.device)
    opt = make_tx(pr.cfg, model.parameters())
    gen = torch.Generator(device=pr.device).manual_seed(pr.cfg.seed + 1)
    return blk, model, opt, gen


def run_training(cfg: Config, g: Optional[Graph] = None, log=print,
                 model_init: Optional[dict] = None,
                 prepared: Optional[Prepared] = None) -> RunResult:
    """Train cfg on one device. `model_init` (a state_dict) replaces the
    seeded initialization (the parity tests carry JAX parameters over);
    `prepared` reuses an earlier prepare_run of the same cfg."""
    pr = prepared if prepared is not None else prepare_run(cfg, g, log)
    cfg, g, fns, device = pr.cfg, pr.g, pr.fns, pr.device
    res = RunResult(dense_edges=fns.dense_edges, n_edges=pr.n_edges)
    blk, model, opt, drop_gen = init_training(pr, model_init)

    best_state = None
    for epoch in range(cfg.n_epochs):
        t_ep = time.perf_counter()
        loss = fns.train_step(model, opt, blk, drop_gen)
        loss_f = float(loss)                    # waits for the device
        dt = time.perf_counter() - t_ep
        res.losses.append(loss_f)
        res.epoch_times.append(dt)
        if not np.isfinite(loss_f):
            raise FloatingPointError(f"epoch {epoch}: loss is {loss_f}")
        if (epoch + 1) % cfg.log_every == 0:
            timed = res.epoch_times[WARMUP_EPOCHS:]
            mt = float(np.mean(timed)) if timed else 0.0
            log("Process 000 | Epoch {:05d} | Time(s) {:.4f} | Comm(s) "
                "{:.4f} [P=1] | Reduce(s) {:.4f} | Loss {:.4f}".format(
                    epoch, mt, 0.0, 0.0, loss_f))
            if cfg.eval:
                val, _ = evaluate_trans("Epoch %05d" % epoch, model, g,
                                        device, log=log)
                if best_state is None or val > res.best_val_acc:
                    res.best_val_acc = val
                    best_state = copy.deepcopy(model.state_dict())
    timed = res.epoch_times[WARMUP_EPOCHS:]
    res.epoch_time = float(np.mean(timed)) if timed else 0.0
    if cfg.eval:
        if best_state is not None:
            model.load_state_dict(best_state)
            log("Max Validation Accuracy {:.2%}".format(res.best_val_acc))
        res.val_acc, res.test_acc = evaluate_trans("Test Result", model, g,
                                                   device, log=log)
    return res
