"""The training loop (counterpart of bnsgcn_tpu/run.py `run_training`).

P=1 runs in this process: graph -> P=1 artifacts in memory -> SpMM layout ->
use_pp precompute -> `n_epochs` epochs printing the JAX package's epoch line
-> a full-graph eval every `log_every` epochs -> the best-validation
parameters' accuracy line.

P > 1 runs one process per part (parallel/mesh.py): this process builds the
graph and writes the partition artifacts once (host numpy only), then
spawns P ranks. Rank r loads only part r, builds its own layout and runs the
same loop, exchanging halos and all-reducing gradients with the others; rank
0 prints the epoch lines, evaluates on the full graph (the others wait at a
barrier with a timeout of its own) and checks at the end that every rank
holds rank 0's parameters. Each rank hands back its losses, epoch and
collective times, kernel launch counts and peak device memory. At sampling
rate < 1 every rank keys each epoch's boundary sample from cfg.seed and the
epoch (trainer.py), so the ranks agree on it without exchanging indices,
and a run with the same seed replays the same samples.
Checkpoints, resume and the resilience/coordination layers wait for later
slices.
"""

from __future__ import annotations

import copy
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from bnsgcn_tpu_torch import buildlib
from bnsgcn_tpu_torch.config import Config, ConfigError
from bnsgcn_tpu_torch.data.artifacts import (PartitionArtifacts,
                                             build_artifacts, load_artifacts,
                                             save_artifacts)
from bnsgcn_tpu_torch.data.datasets import load_data
from bnsgcn_tpu_torch.data.graph import Graph
from bnsgcn_tpu_torch.data.partitioner import partition_graph
from bnsgcn_tpu_torch.evaluate import evaluate_trans
from bnsgcn_tpu_torch.models.gnn import GNN, ModelSpec, spec_from_config
from bnsgcn_tpu_torch.ops import bucket_sum, tile_matmul
from bnsgcn_tpu_torch.parallel.halo import (full_rate_spec, make_halo_spec,
                                            wire_bytes)
from bnsgcn_tpu_torch.parallel.mesh import (Comm, RankContext,
                                            check_mesh_budget, launch,
                                            rank_device)
from bnsgcn_tpu_torch.parallel.reducer import (assert_replicated,
                                               broadcast_parameters)
from bnsgcn_tpu_torch.trainer import (StepFns, build_block_arrays,
                                      build_step_fns, local_row, make_tx,
                                      to_device)

# epochs excluded from the Time(s) mean: eager PyTorch compiles nothing, so
# only the first epoch (allocator growth, library handles) is warm-up
WARMUP_EPOCHS = 1

TRAIN_KEYS = ("feat", "label", "train_mask", "in_norm", "out_norm")


@dataclass
class RunResult:
    losses: list = field(default_factory=list)
    epoch_times: list = field(default_factory=list)
    epoch_time: float = 0.0            # mean over post-warm-up epochs, s
    comm_times: list = field(default_factory=list)     # exchange s / epoch
    reduce_times: list = field(default_factory=list)   # all-reduce s / epoch
    best_val_acc: float = 0.0
    val_acc: float = 0.0               # of the final evaluation
    test_acc: float = 0.0
    dense_edges: int = 0
    n_edges: int = 0
    ranks: list = field(default_factory=list)   # P > 1: each rank's report


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
    """Everything a run (or one rank of it) builds before its first epoch."""
    cfg: Config                        # with n_feat/n_class/n_train filled
    spec: ModelSpec
    g: Optional[Graph]                 # the full graph, where eval runs
    fns: StepFns
    blk: dict                          # this part's training arrays on device
    device: torch.device
    n_edges: int                       # this part's edges
    rank: int = 0
    comm: Optional[Comm] = None        # None at P=1


def prepare_part(cfg: Config, art: PartitionArtifacts, g: Optional[Graph],
             device, log, rank: int = 0,
             comm: Optional[Comm] = None) -> Prepared:
    """Artifacts -> this part's SpMM layout (on the device) -> block arrays.
    The use_pp precompute is the first step of the loop."""
    set_float32_math()
    cfg = cfg.replace(n_feat=art.n_feat, n_class=art.n_class,
                      n_train=art.n_train)
    spec = spec_from_config(cfg)
    t0 = time.perf_counter()
    fns = build_step_fns(cfg, spec, art, device, log=log, rank=rank,
                         comm=comm)
    row = local_row(art, rank)
    n_edges = int((art.dst[row] < art.pad_inner).sum())
    log(("Graph: " if comm is None else f"Part {rank} of {art.n_parts}: ")
        + f"{int(art.n_inner[rank])} nodes, {n_edges} edges, "
        f"F={art.n_feat}, {art.n_class} classes | spmm={cfg.spmm} layout "
        f"{time.perf_counter() - t0:.1f}s"
        + (f" | dense tiles carry {fns.dense_edges} edges "
           f"({fns.dense_edges / max(n_edges, 1):.1%})"
           if cfg.spmm == "hybrid" else ""))
    blk = to_device({k: v for k, v in build_block_arrays(
        art, spec.model).items() if k in TRAIN_KEYS}, device, row)
    return Prepared(cfg, spec, g, fns, blk, device, n_edges, rank, comm)


def prepare_run(cfg: Config, g: Optional[Graph] = None,
                log=print) -> Prepared:
    """P=1: graph -> artifacts in memory -> layout -> block arrays."""
    device = resolve_device(cfg.device)
    if g is None:
        g, _, _ = load_data(cfg)
    art = build_artifacts(g, partition_graph(g, 1))
    return prepare_part(cfg, art, g, device, log)


def init_training(pr: Prepared, model_init: Optional[dict] = None):
    """(block arrays with the use_pp precompute applied, model, optimizer,
    dropout generator) for a prepared run. The model is initialized on the
    host from cfg.seed, so the draw does not depend on the device;
    `model_init` (a state_dict) replaces it. Under P > 1 every rank then
    takes rank 0's parameters, and each rank's dropout stream has its own
    seed."""
    blk = dict(pr.blk)
    if pr.spec.use_pp:
        blk["feat"] = pr.fns.precompute(blk)
    model = GNN(pr.spec, torch.Generator().manual_seed(pr.cfg.seed))
    if model_init is not None:
        model.load_state_dict(model_init)
    model = model.to(pr.device)
    if pr.comm is not None:
        broadcast_parameters(model.parameters(), pr.comm)
    opt = make_tx(pr.cfg, model.parameters())
    gen = torch.Generator(device=pr.device).manual_seed(
        pr.cfg.seed + 1 + pr.rank)
    return blk, model, opt, gen


def train_loop(pr: Prepared, model_init: Optional[dict] = None,
               log=print) -> tuple[RunResult, GNN]:
    """The epoch loop of one process (P=1) or one rank. Rank 0 logs and, with
    cfg.eval, evaluates on the full graph, last the best-validation
    parameters on a copy; the epoch time is taken after the step's gradient
    all-reduce and ends in float(loss). Returns the trained model, which
    every rank holds alike."""
    cfg, g, fns, device, comm = pr.cfg, pr.g, pr.fns, pr.device, pr.comm
    lead = pr.rank == 0
    res = RunResult(dense_edges=fns.dense_edges, n_edges=pr.n_edges)
    blk, model, opt, drop_gen = init_training(pr, model_init)

    def mean(xs):
        xs = xs[WARMUP_EPOCHS:]
        return float(np.mean(xs)) if xs else 0.0

    clock = "P=1" if comm is None else (
        "events" if device.type == "cuda" else "host")
    best_state = None
    for epoch in range(cfg.n_epochs):
        if comm is not None:
            comm.reset_seconds()
        t_ep = time.perf_counter()
        loss = fns.train_step(model, opt, blk, epoch, drop_gen)
        loss_f = float(loss)                    # waits for the device
        dt = time.perf_counter() - t_ep
        secs = comm.seconds() if comm else {"exchange": 0.0, "reduce": 0.0}
        res.losses.append(loss_f)
        res.epoch_times.append(dt)
        res.comm_times.append(secs["exchange"])
        res.reduce_times.append(secs["reduce"])
        if not np.isfinite(loss_f):
            raise FloatingPointError(f"epoch {epoch}: loss is {loss_f}")
        if (epoch + 1) % cfg.log_every != 0:
            continue
        if lead:
            log("Process 000 | Epoch {:05d} | Time(s) {:.4f} | Comm(s) "
                "{:.4f} [{}] | Reduce(s) {:.4f} | Loss {:.4f}".format(
                    epoch, mean(res.epoch_times), mean(res.comm_times),
                    clock, mean(res.reduce_times), loss_f))
        if cfg.eval and lead:
            val, _ = evaluate_trans("Epoch %05d" % epoch, model, g, device,
                                    log=log)
            if best_state is None or val > res.best_val_acc:
                res.best_val_acc = val
                best_state = copy.deepcopy(model.state_dict())
        if cfg.eval and comm is not None:
            comm.barrier()                      # the peers wait for rank 0
    res.epoch_time = mean(res.epoch_times)
    if cfg.eval and lead:
        best = model
        if best_state is not None:
            best = copy.deepcopy(model)
            best.load_state_dict(best_state)
            log("Max Validation Accuracy {:.2%}".format(res.best_val_acc))
        res.val_acc, res.test_acc = evaluate_trans("Test Result", best, g,
                                                   device, log=log)
    return res, model


def run_training(cfg: Config, g: Optional[Graph] = None, log=print,
                 model_init: Optional[dict] = None,
                 prepared: Optional[Prepared] = None,
                 rank_hook: Optional[Callable[[Prepared], dict]] = None
                 ) -> RunResult:
    """Train cfg: in this process at P=1, on P spawned ranks otherwise.
    `model_init` (a state_dict) replaces the seeded initialization (the
    parity tests carry JAX parameters over); `prepared` reuses an earlier
    prepare_run of the same P=1 cfg; `rank_hook` (P > 1, a module-level
    function) runs in every rank on its prepared part before the epoch loop
    and the launch counters' reset, its result in the rank's report under
    'hook'."""
    if cfg.n_partitions > 1:
        return run_parts(cfg, g, log, model_init, rank_hook)
    pr = prepared if prepared is not None else prepare_run(cfg, g, log)
    return train_loop(pr, model_init, log)[0]


# ----------------------------------------------------------------------------
# P > 1
# ----------------------------------------------------------------------------

def artifacts_dir(cfg: Config) -> str:
    return os.path.join(cfg.part_path, cfg.derive_graph_name())


def prepare_partition(cfg: Config,
                      g: Optional[Graph] = None) -> PartitionArtifacts:
    """Offline partitioning (bnsgcn_tpu/run.py prepare_partition, without
    its streaming branch): skipped when the artifact directory exists, as
    the reference's config-JSON check does; else partition and write."""
    path = artifacts_dir(cfg)
    if os.path.exists(os.path.join(path, "meta.json")):
        return load_artifacts(path)
    if g is None:
        g, _, _ = load_data(cfg)
    pid = partition_graph(g, cfg.n_partitions, method=cfg.partition_method,
                          obj=cfg.partition_obj, seed=cfg.seed)
    art = build_artifacts(g, pid)
    save_artifacts(art, path)
    return art


def _prebuild(cfg: Config) -> None:
    """Build every native library the ranks load before spawning them, so
    P ranks never compile the same library at once."""
    from bnsgcn_tpu_torch import native
    specs = [(native.LIB_NAME, "cxx", [native.SOURCE])]
    if cfg.device == "cuda":
        specs += [(m.LIB_NAME, "cuda", [m.SOURCE])
                  for m in (bucket_sum, tile_matmul)]
    buildlib.build_many(specs)


def _rank_main(ctx: RankContext, cfg: Config, path: str,
               model_init: Optional[dict], g: Optional[Graph],
               rank_hook: Optional[Callable[[Prepared], dict]]) -> dict:
    """One rank of a P > 1 run: load part r, train, check replication,
    report."""
    lead = ctx.rank == 0
    log = ctx.log if lead else (lambda m: None)
    art = load_artifacts(path, parts=[ctx.rank])
    pr = prepare_part(cfg, art, g, ctx.device, log, ctx.rank, ctx.comm)
    hook = rank_hook(pr) if rank_hook is not None else None
    ctx.comm.barrier()          # the ranks build their layouts at own speeds
    bucket_sum.launches.reset()
    tile_matmul.launches.reset()
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    res, model = train_loop(pr, model_init, log)
    if cfg.eval:
        ctx.comm.barrier()                  # rank 0's final evaluation
    assert_replicated(model.parameters(), ctx.comm)
    return {
        "rank": ctx.rank, "device": str(ctx.device),
        "losses": res.losses, "epoch_times": res.epoch_times,
        "epoch_time": res.epoch_time, "comm_times": res.comm_times,
        "reduce_times": res.reduce_times,
        "launches": {"K1": dict(bucket_sum.launches.by_phase),
                     "K2": dict(tile_matmul.launches.by_phase)},
        "max_memory_bytes": (torch.cuda.max_memory_allocated(ctx.device)
                             if ctx.device.type == "cuda" else None),
        "dense_edges": res.dense_edges, "n_edges": res.n_edges,
        "best_val_acc": res.best_val_acc, "val_acc": res.val_acc,
        "test_acc": res.test_acc, "hook": hook,
    }


def run_parts(cfg: Config, g: Optional[Graph] = None, log=print,
              model_init: Optional[dict] = None,
              rank_hook: Optional[Callable[[Prepared], dict]] = None
              ) -> RunResult:
    """P > 1: build the artifacts here, then train on P spawned ranks."""
    check_mesh_budget(cfg.n_partitions, cfg.dist_backend, cfg.device)
    resolve_device(cfg.device)
    P = cfg.n_partitions
    if g is None:
        g, _, _ = load_data(cfg)
    t0 = time.perf_counter()
    art = prepare_partition(cfg, g)
    path = artifacts_dir(cfg)
    _prebuild(cfg)
    hspec, _ = make_halo_spec(art.n_b, art.pad_inner, art.pad_boundary,
                              cfg.sampling_rate)
    hfull, _ = full_rate_spec(art.n_b, art.pad_inner, art.pad_boundary)
    devs = [str(rank_device(cfg.device, cfg.dist_backend, r))
            for r in range(P)]
    staged = cfg.dist_backend == "gloo" and cfg.device == "cuda"
    log(f"Mesh: {P} ranks | {cfg.dist_backend}"
        + (" (collectives staged through host memory)" if staged else "")
        + f" | devices {','.join(devs)} | pad_inner={art.pad_inner} "
        f"pad_boundary={art.pad_boundary} pad_send={hspec.pad_send} "
        f"edges/part={art.pad_edges} | halo {hspec.strategy}/{hspec.wire} "
        f"at sampling rate {cfg.sampling_rate:g}: "
        f"{wire_bytes(hspec, cfg.n_hidden) / 1e6:.2f} MB/exchange/rank at "
        f"hidden width {cfg.n_hidden} "
        f"({wire_bytes(hfull, art.n_feat) / 1e6:.2f} MB at feature width "
        f"{art.n_feat}, the precompute's full-rate exchange) | artifacts "
        f"{path} {time.perf_counter() - t0:.1f}s")
    reports = launch(_rank_main, P,
                     [(cfg, path, model_init,
                       g if (r == 0 and cfg.eval) else None, rank_hook)
                      for r in range(P)],
                     cfg.dist_backend, cfg.device, log=log)
    lead = reports[0]
    return RunResult(
        losses=lead["losses"], epoch_times=lead["epoch_times"],
        epoch_time=lead["epoch_time"], comm_times=lead["comm_times"],
        reduce_times=lead["reduce_times"],
        best_val_acc=lead["best_val_acc"], val_acc=lead["val_acc"],
        test_acc=lead["test_acc"],
        dense_edges=sum(r["dense_edges"] for r in reports),
        n_edges=sum(r["n_edges"] for r in reports), ranks=reports)
