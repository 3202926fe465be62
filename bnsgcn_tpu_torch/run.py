"""The training loop (counterpart of bnsgcn_tpu/run.py `run_training`).

P=1 runs in this process: graph -> P=1 artifacts in memory -> SpMM layout ->
use_pp precompute -> `n_epochs` epochs printing the JAX package's epoch line
-> a full-graph eval every `log_every` epochs -> the best-validation
parameters' accuracy line.

P > 1 runs one process per part (parallel/mesh.py): this process builds the
graph and writes the partition artifacts once (host numpy only; the
streaming builder, one part resident, above STREAMING_MIN_EDGES edges or
under --streaming-artifacts always), reads back only their meta.json and
shared.npz, then spawns P ranks; with --n-nodes > 1 one such launcher runs
per node and node 0's writes the artifacts and hands its seed and resume
choice to the others (run_parts). Rank r loads only part r, builds its own
layout (or loads it from --cache-dir) and runs the
same loop, exchanging halos and all-reducing gradients with the others; rank
0 prints the epoch lines, evaluates (the others wait at a barrier with a
timeout of its own) and checks at the end that every rank holds rank 0's
parameters. Each rank hands back its losses, epoch and collective times,
kernel launch counts and peak device memory. At sampling rate < 1 every
rank keys each epoch's boundary sample from cfg.seed and the epoch
(trainer.py), so the ranks agree on it without exchanging indices, and a
run with the same seed replays the same samples.

--inductive trains on the train subgraph (its artifacts, its n_train), and
rank 0 alone holds the train+val subgraph and the full graph it evaluates
on. Every `log_every` epochs rank 0 writes a periodic checkpoint in the JAX
package's format (checkpoint.py), then, as the JAX package does
(bnsgcn_tpu/run.py:1693-1745): with --eval-device host (the default) it
drains the previous evaluation, which ran in a one-worker thread on its own
CUDA stream while the ranks trained, keeps its parameters if it beat the
best accuracy, and submits this epoch's on a copy of the parameters; with
--eval-device mesh every rank joins the full-rate eval forward over the
eval graph's partition (evaluate.evaluate_mesh), through K1 and K2. The
eval line also goes to the results file. After the loop: the last drain,
the best-validation parameters' final checkpoint and their `Test Result |
Accuracy` line on the test mask of the full graph, only when an
evaluation ran. --resume continues from the newest valid periodic
checkpoint with its parameters, optimizer, SyncBatchNorm state, seed and
best accuracy; each epoch's dropout is jax's draw from the key of (seed,
epoch, rank), so the resumed epochs replay the uninterrupted run's.

Fault tolerance (resilience.py; --resilience on, the default) runs in
every rank: a non-finite loss rolls every rank back to the newest valid
checkpoint (rank 0's read, broadcast) with the retry nonce folded into the
sampling and dropout keys (exit 76 once --resil-retries are spent); a
SIGTERM/SIGINT (the launcher forwards its own to its ranks) is agreed at a
step boundary, rank 0 writes a resumable checkpoint and the run exits 75;
a hung step exits 77; --inject fires faults at step boundaries.

With more than one coordinated launch (Control: --n-nodes > 1, or the JAX
CLI's harness mode --coord-world W --coord-rank r, whose launches share no
process group and each train every part) the launcher opens the rank
coordinator (parallel/coord.py) and makes the JAX package's set-up
exchanges (bnsgcn_tpu/run.py:183-301, 633-780): the partition barrier,
the seed, an agreed --resume acked by every launch (exit 78 when one
cannot load its copy); its rank 0 then carries the exchanges on, and
every step's verdict is agree_step's, relayed to the launch's ranks: an
agreed preemption, rollback, abort or, under --elastic on, a resize of
the world when a launch's heartbeats stop or a lost one rejoins (the
parts re-hosted as bookkeeping, the resize nonce folded into the keys).
With an event log (--obs-log) or --obs-dir each launch's rank 0 emits the
JAX package's telemetry events (obs.py).

--replicas R --feat T (parallel/replicas.py) spawn R x P x T ranks; rank
(r, p, f) loads part p, its exchange runs over its replica row's 'parts'
group, and every rank takes part in the world's gradient reduce, barriers
and broadcasts. Rank 0 is (0, 0, 0): its lines, checkpoints and evals are
replica 0's. Checkpoints and the host evaluation hold full arrays, the feat
shards gathered over rank 0's feat group at each log point, so a file
resumes into any R and T; --eval-device mesh scores on the shards, each
(replica, feat shard) row of parts alike, rank 0 reporting.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from bnsgcn_tpu_torch import buildlib
from bnsgcn_tpu_torch import checkpoint as ckpt
from bnsgcn_tpu_torch import obs as obs_mod
from bnsgcn_tpu_torch import tune as tune_mod
from bnsgcn_tpu_torch.config import Config, ConfigError, node_ranks
from bnsgcn_tpu_torch.data.artifacts import (PartitionArtifacts,
                                             build_artifacts,
                                             build_artifacts_streaming,
                                             load_artifacts, read_meta,
                                             save_artifacts)
from bnsgcn_tpu_torch.data.datasets import load_data
from bnsgcn_tpu_torch.data.graph import Graph, inductive_split
from bnsgcn_tpu_torch.data.partitioner import partition_graph
from bnsgcn_tpu_torch.data.reorder import maybe_reorder
from bnsgcn_tpu_torch.evaluate import (EvalGraph, evaluate_induc,
                                       evaluate_mesh, evaluate_trans)
from bnsgcn_tpu_torch.models.gnn import (GNN, ModelSpec, shard_model,
                                        spec_from_config)
from bnsgcn_tpu_torch.ops import bucket_sum, dropout, tile_matmul
from bnsgcn_tpu_torch.parallel.feat import shard_width, unshardable_note
from bnsgcn_tpu_torch.parallel.coord import (Coordinator, CoordAbort,
                                             CoordTimeout, make_coordinator)
from bnsgcn_tpu_torch.parallel.halo import (full_rate_spec, make_halo_spec,
                                            make_refresh_spec,
                                            retune_strategy, wire_bytes)
from bnsgcn_tpu_torch.parallel.mesh import (Comm, NodeStore, RankContext,
                                            RankExit, check_mesh_budget,
                                            launch, rank_device)
from bnsgcn_tpu_torch.parallel.reducer import (assert_replicated,
                                               broadcast_parameters)
from bnsgcn_tpu_torch.parallel.replicas import (Axes, dedup_replica0,
                                                make_axes, mesh_desc,
                                                slot_desc)
from bnsgcn_tpu_torch.resilience import (CoordLink, PreemptedError,
                                         ResilienceManager, StepHung,
                                         check_inject, collective_timed_out)
from bnsgcn_tpu_torch.strict import StrictExec
from bnsgcn_tpu_torch.trainer import (StepFns, build_block_arrays,
                                      bn_state_to_jax, build_step_fns,
                                      compute_dtype, dropout_key,
                                      local_row, make_tx, opt_state_to_jax,
                                      param_global_norm, params_from_jax,
                                      params_to_jax, resolve_halo_mode,
                                      resolve_overlap, resolve_strategy,
                                      restore_payload, to_device,
                                      with_bn_state)
from bnsgcn_tpu_torch.utils import traceparse

# epochs excluded from the Time(s), Comm(s) and Reduce(s) means, as the JAX
# package's EpochTimer(warmup=5) and the reference (train.py:415) exclude
# them: the epoch numbers 0-4, whether or not this run executed them
WARMUP_EPOCHS = 5

TRAIN_KEYS = ("feat", "label", "train_mask", "inner_mask", "in_norm",
              "out_norm")

# --streaming-artifacts auto builds through the streaming builder above this
# many edges (bnsgcn_tpu/run.py prepare_partition)
STREAMING_MIN_EDGES = 30_000_000


def warm_mean(xs: list, start_epoch: int = 0) -> float:
    """The mean of per-epoch values past the warm-up, xs[i] being epoch
    start_epoch + i, None for an epoch the timer does not record (traced,
    or a retune's): what EpochTimer(warmup=5).means() gives for the same
    values; 0.0 when no epoch is past the warm-up."""
    xs = [x for x in xs[max(WARMUP_EPOCHS - start_epoch, 0):]
          if x is not None]
    return float(np.mean(xs)) if xs else 0.0


@dataclass
class RunResult:
    losses: list = field(default_factory=list)   # epochs start_epoch.. on
    epoch_times: list = field(default_factory=list)
    epoch_time: float = 0.0            # warm_mean of epoch_times, s
    start_epoch: int = 0               # > 0 when resumed
    comm_times: list = field(default_factory=list)     # exchange s / epoch
    reduce_times: list = field(default_factory=list)   # all-reduce s / epoch
    feat_times: list = field(default_factory=list)     # feat axis s / epoch
    eval_seconds: list = field(default_factory=list)  # rank 0's evals, the
                                       # final one last (host clock; each
                                       # ends in a copy to the host)
    # the overlap, on rank 0's host clock (time.perf_counter): each
    # periodic eval's (epoch, start, end), the thread's for a host eval;
    # each drain's (epoch, seconds waited), the one after the loop labelled
    # n_epochs; each epoch's start; the loop's wall time from the first
    # epoch's start through the last drain
    eval_spans: list = field(default_factory=list)
    drain_waits: list = field(default_factory=list)
    epoch_starts: list = field(default_factory=list)
    loop_seconds: float = 0.0
    best_val_acc: float = 0.0
    val_acc: float = 0.0               # the best validation accuracy
    test_acc: float = 0.0              # the best parameters' on the test
                                       # mask of the full graph
    dense_edges: int = 0
    n_edges: int = 0
    ranks: list = field(default_factory=list)   # P > 1: each rank's report
                                       # (R x P x T, in global rank order)
    rollbacks: list = field(default_factory=list)   # resilience.py's
                                       # rollback records, oldest first
    agree_times: list = field(default_factory=list)  # P > 1, resilience
                                       # on: each step's agreement
                                       # all-reduce, s (host clock)
    coord_times: list = field(default_factory=list)  # a coordinator: each
                                       # step's agree_step, the relay to the
                                       # launch included, s (host clock)
    relay_times: list = field(default_factory=list)  # P > 1, a coordinator:
                                       # each step's relay of the decision
                                       # to the launch's ranks, s
    clean: list = field(default_factory=list)   # per epoch: counted in the
                                       # means (not traced, not a retune's)
    comm_traced: Optional[float] = None    # the trace window's in-step
    reduce_traced: Optional[float] = None  # exchange / reduce s per step
                                       # (rank 0 of the launch)
    tune_decisions: list = field(default_factory=list)   # --tune: every
                                       # applied decision, in order
    retune_seconds: list = field(default_factory=list)   # (epoch, s) of
                                       # each retune's rebuild
    strict: Optional[dict] = None      # --strict-exec: the audit summary


def require_device(name: str) -> None:
    """'cuda' without a GPU is an error: the port never drops to the CPU
    unless asked to."""
    if name not in ("cpu", "cuda"):
        raise ConfigError(f"unknown device {name!r}")
    if name == "cuda" and not torch.cuda.is_available():
        raise ConfigError("no CUDA device: the port runs on the GPU; pass "
                          "--device cpu to run on the CPU")


def resolve_device(name: str) -> torch.device:
    """The device the caller asked for (require_device's rules)."""
    require_device(name)
    if name == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


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
    val_g: Optional[Graph]             # where eval runs (rank 0 only): the
    test_g: Optional[Graph]            # full graph twice, or under
                                       # --inductive the train+val subgraph
                                       # and the full graph
    fns: StepFns
    blk: dict                          # this part's training arrays on device
    device: torch.device
    n_edges: int                       # this part's edges
    rank: int = 0                      # the part index
    comm: Optional[Comm] = None        # the 'parts' group; None at P=1
    art: Optional[PartitionArtifacts] = None   # what the layout came from
    axes: Optional[Axes] = None        # the replica and feat axes (R x P x
                                       # T > P ranks), else None
    reorder_info: dict = field(default_factory=dict)   # the --reorder
                                       # pass's statistics (its obs event)

    @property
    def world(self) -> Optional[Comm]:
        """The Comm of every rank: the barriers, the checkpoint broadcast
        and the timers."""
        return self.axes.world if self.axes is not None else self.comm


def prepare_part(cfg: Config, art: PartitionArtifacts,
                 eval_graphs: Optional[tuple], device, log, rank: int = 0,
                 comm: Optional[Comm] = None,
                 reuse: Optional[StepFns] = None,
                 axes: Optional[Axes] = None, **spmm_kw) -> Prepared:
    """Artifacts -> this part's SpMM layout (on the device) -> block arrays.
    `eval_graphs` is (val graph, test graph) where eval runs, else None. The
    use_pp precompute is the first step of the loop. `reuse` and `spmm_kw`
    (row_cap) go to trainer.build_step_fns: another dtype configuration of
    an earlier prepared run reuses its layout. `rank` is the part, `comm`
    its 'parts' group, `axes` the replica and feat axes."""
    set_float32_math()
    cfg = cfg.replace(n_feat=art.n_feat, n_class=art.n_class,
                      n_train=art.n_train)
    spec = spec_from_config(cfg)
    t0 = time.perf_counter()
    fns = build_step_fns(cfg, spec, art, device, log=log, rank=rank,
                         comm=comm, reuse=reuse, axes=axes, **spmm_kw)
    row = local_row(art, rank)
    n_edges = int((art.dst[row] < art.pad_inner).sum())
    # the host-side layouts' build or --cache-dir load, within the layout
    cached = ", ".join(f"{k} {how} {secs:.3f}s"
                       for k, (how, secs) in fns.layout_times.items())
    kernels = (f"model=gat heads={cfg.heads} spmm={fns.spmm_kind} (the ELL "
               f"attention, layouts {fns.gat.build_seconds:.1f}s)"
               if fns.gat is not None else
               f"spmm={fns.spmm_kind} gather={cfg.spmm_gather} "
               f"dense={cfg.spmm_dense}")
    log(("Graph: " if comm is None and axes is None else
         f"Part {rank} of {art.n_parts}: ")
        + f"{int(art.n_inner[rank])} nodes, {n_edges} edges, "
        f"F={art.n_feat}, {art.n_class} classes | {cfg.dtype} {kernels} "
        f"layout {time.perf_counter() - t0:.1f}s"
        + (f" ({cached})" if cached else "")
        + (f" | dense tiles carry {fns.dense_edges} edges "
           f"({fns.dense_edges / max(n_edges, 1):.1%})"
           if fns.spmm is not None and fns.spmm_kind == "hybrid" else ""))
    blk = to_device({k: v for k, v in build_block_arrays(
        art, spec.model).items() if k in TRAIN_KEYS}, device, row)
    val_g, test_g = eval_graphs if eval_graphs is not None else (None, None)
    return Prepared(cfg, spec, val_g, test_g, fns, blk, device, n_edges,
                    rank, comm, art, axes)


def split_graphs(cfg: Config, g: Graph) -> tuple[Graph, Graph, Graph]:
    """(train graph, val graph, test graph): inductive_split under
    --inductive, else g three times."""
    return inductive_split(g) if cfg.inductive else (g, g, g)


def prepare_run(cfg: Config, g: Optional[Graph] = None,
                log=print) -> Prepared:
    """P=1: graph -> artifacts of the train graph in memory (from the
    artifact directory under --skip-partition) -> layout -> block arrays."""
    device = resolve_device(cfg.device)
    if g is None:
        g, _, _ = load_data(cfg)
    train_g, val_g, test_g = split_graphs(cfg, g)
    art, resolved, info = maybe_reorder(cfg, p1_artifacts(cfg, train_g), log)
    pr = prepare_part(cfg.replace(reorder=resolved), art, (val_g, test_g),
                      device, log)
    pr.reorder_info = info
    return pr


def p1_artifacts(cfg: Config, g: Graph) -> PartitionArtifacts:
    """P=1: the artifacts of `g`, built in memory; through prepare_partition
    (its directory, built or loaded) under --skip-partition or when the
    streaming builder is selected, whose within-part edge order is not the
    in-memory builder's (the JAX package builds every run's there)."""
    if cfg.skip_partition or streams(cfg, g):
        return prepare_partition(cfg, g)
    return build_artifacts(g, partition_graph(g, 1))


def init_training(pr: Prepared, model_init: Optional[dict] = None):
    """(block arrays with the use_pp precompute applied, model, optimizer)
    for a prepared run. The model is initialized on the host from cfg.seed
    as the JAX package's init_params(key(seed), spec, dtype) draws it (in
    bf16 under --dtype bfloat16, as jax draws), so the draw does not depend
    on the device; `model_init` (a state_dict) replaces it. Under --dtype bfloat16 the parameters (and so Adam's
    moments) are bf16, and the features are cast to bf16 on the device
    before the precompute, whose result is cast to bf16 too
    (bnsgcn_tpu/run.py:429-438); GAT's goes to blk['feat0_ext']. Under a
    feat axis the model then holds this rank's shard (models/gnn.py
    shard_model). Under P > 1 every rank then takes part 0's parameters
    (its replica row's, of its shard)."""
    dtype = compute_dtype(pr.cfg)
    blk = dict(pr.blk)
    blk["feat"] = blk["feat"].to(dtype)
    if pr.spec.use_pp:
        # GAT keeps its raw features and attends over the exchanged ones
        # at layer 0 (bnsgcn_tpu/run.py:439-440)
        blk["feat0_ext" if pr.spec.model == "gat" else "feat"] = (
            pr.fns.precompute(blk).to(dtype))
    model = GNN(pr.spec, pr.cfg.seed, dtype)
    if model_init is not None:
        model.load_state_dict(model_init)
    if pr.fns.feat_dims:
        shard_model(model, pr.axes.T, pr.axes.f)
    model = model.to(device=pr.device, dtype=dtype)
    if pr.comm is not None:
        broadcast_parameters(model.parameters(), pr.comm)
    opt = make_tx(pr.cfg, model.parameters())
    return blk, model, opt


def resume_point(cfg: Config, log=print) -> tuple[Config, Optional[str]]:
    """--resume: (cfg with the checkpoint's seed, the newest valid periodic
    checkpoint), walking past corrupt files; (cfg, None) without --resume
    or without a checkpoint. main.py draws a new seed per launch, and a
    resumed run must continue the saved sampling and dropout streams."""
    if not cfg.resume:
        return cfg, None
    found = ckpt.latest_valid_checkpoint(cfg, log=log)
    if found is None:
        return cfg, None
    path, payload = found
    return cfg.replace(seed=int(payload.get("seed", cfg.seed))), path


# ----------------------------------------------------------------------------
# the control plane: the rank coordinator and the telemetry bus
# ----------------------------------------------------------------------------

@dataclass
class Control:
    """A launch's control plane (bnsgcn_tpu/run.py:183-231): its
    coordination rank of `world` launches and, in the launcher, the rank
    coordinator (`coord`; None without one: --coord off, a single launch or
    --resilience off). The launcher makes the exchanges before its ranks
    start (`open_control`, `harness_sync`, the resume ack); `for_ranks()`
    is what it hands them: their rank 0 carries the schedule on
    (`Coordinator.adopt`) and relays every decision to the others
    (resilience.CoordLink). At P=1 the launcher is that rank."""
    rank: int = 0
    world: int = 1
    coord: Optional[Coordinator] = None
    handoff: Optional[dict] = None
    joiner: bool = False        # --elastic on: a relaunch after a shrink
    agreed: bool = False        # the resume's checkpoint was agreed on
    best_recovered: Optional[bool] = None   # agreed: every launch holds
                                # the resumed best_acc's final checkpoint
    tune_start: Optional[tuple] = None      # --tune: the (changes, reason)
                                # folded into cfg at launch (tune_launch)

    @property
    def on(self) -> bool:
        return self.coord is not None or self.handoff is not None

    def for_ranks(self) -> "Control":
        return dataclasses.replace(
            self, coord=None,
            handoff=self.coord.handoff() if self.coord is not None else None)

    def close(self) -> None:
        if self.coord is not None:
            self.coord.close()


def open_control(cfg: Config, log=print, port: Optional[int] = None
                 ) -> Control:
    """The launcher's coordinator (under --resilience on, unless --coord off
    or a single launch) and --elastic's preconditions; a replacement
    launch of coordination rank > 0 finds the lost-rank beacon here and
    becomes a joiner. `port` overrides --coord-port (multi-node runs)."""
    coord, rank, world = None, 0, 1
    if cfg.resilience == "on" and cfg.coord != "off":
        coord, rank, world = make_coordinator(cfg, log, port)
    ctl = (Control(rank, world, coord) if coord is not None else Control())
    if cfg.elastic == "on":
        if coord is None:
            raise ConfigError(
                "--elastic on needs the rank coordinator: run with "
                "--resilience on and --coord tcp|file (got --coord "
                f"{cfg.coord}, --resilience {cfg.resilience})")
        if cfg.n_nodes > 1:
            coord.close()
            raise ConfigError(
                "--elastic on is harness-mode only (--coord-world/"
                "--coord-rank): the ranks of a multi-node run share one "
                "process group, which cannot be resized in place")
        coord.enable_elastic(cfg.elastic_min_world)
        if rank != 0:
            ctl.joiner = coord.detect_rejoin()
            if ctl.joiner:
                log(f"[elastic] rank {rank}: rejoining a resized world "
                    f"(lost-rank beacon found)")
    return ctl


def tune_launch(cfg: Config, ctl: Control, log=print) -> Config:
    """--tune at launch (bnsgcn_tpu/run.py:323-362): the mode checks (auto
    is refused across launches: more than one node, or a coordinator),
    then the schedule's epoch-0 entries or auto's coarse start folded into
    cfg before the first build; the fold goes to ctl.tune_start, which
    rank 0 records as the controller's epoch-0 decision."""
    tune_mod.validate_mode(cfg, multi_host=cfg.n_nodes > 1,
                           coordinated=ctl.on)
    if cfg.tune == "off":
        return cfg
    changes, why = tune_mod.startup_changes(cfg)
    if changes:
        cfg = cfg.replace(**changes)
        ctl.tune_start = (changes, why)
        log(f"[tune] {why}: " + ", ".join(
            f"{k}={v}" for k, v in sorted(changes.items())))
    return cfg


def harness_mode(cfg: Config, ctl: Control) -> bool:
    """Independent launches coupled only through the coordinator
    (--coord-world > 1): each trains every part and holds its own state."""
    return ctl.coord is not None and cfg.n_nodes == 1


def parts_ready(cfg: Config, ctl: Control, build: Callable) -> None:
    """The harness's partition barrier (bnsgcn_tpu/run.py:287-301): without
    --skip-partition coordination rank 0 builds the artifacts and its peers
    wait for them (two builders would tear the shared directory);
    build(skip) builds, or with skip only checks they are there."""
    if not harness_mode(cfg, ctl) or cfg.skip_partition:
        build(cfg.skip_partition)
    elif ctl.rank == 0:
        build(False)
        ctl.coord.broadcast("parts-ready", {"ok": 1})
    elif ctl.joiner:
        build(True)             # built long ago; the key is retired
    else:
        ctl.coord.broadcast("parts-ready")
        build(True)


def harness_sync(cfg: Config, ctl: Control, log=print
                 ) -> tuple[Config, Optional[str]]:
    """The harness's set-up exchanges (bnsgcn_tpu/run.py:633-780), in the
    JAX package's order: rank 0's seed (a joiner reads it from the elastic
    boot record), then under --resume the agreed checkpoint: rank 0 walks
    the chain and broadcasts its choice, every launch loads its own copy
    and acks (a torn copy anywhere aborts every launch: CoordAbort, exit
    78), then agrees whether every launch holds the best parameters'
    final checkpoint. Returns (cfg with the seed, the launch's own copy of
    the chosen checkpoint or None); without a harness, resume_point's."""
    if not harness_mode(cfg, ctl):
        return resume_point(cfg, log)
    coord = ctl.coord
    if ctl.joiner:
        return cfg.replace(seed=int(coord.boot_info()["seed"])), None
    seed = int(coord.broadcast(
        "seed", {"seed": cfg.seed} if ctl.rank == 0 else None)["seed"])
    cfg = cfg.replace(seed=seed)
    if cfg.elastic == "on" and ctl.rank == 0:
        coord.publish_boot({"seed": seed})
    if not cfg.resume:
        return cfg, None
    choice = None
    if ctl.rank == 0:
        found = ckpt.latest_valid_checkpoint(cfg, log=log)
        choice = {"have": 0}
        if found:
            path0, payload0 = found
            rx = ckpt.resilience_extra(payload0)
            choice = {"have": 1, "file": os.path.basename(path0),
                      "epoch": int(payload0["epoch"]) + 1,
                      "seed": int(payload0.get("seed", seed)),
                      "nonce": rx["retry_nonce"],
                      "rnonce": rx["resize_nonce"],
                      "best_acc": float(payload0["best_acc"])}
    choice = coord.broadcast("resume-choice", choice)
    if not choice["have"]:
        return cfg, None
    cpath = os.path.join(cfg.ckpt_path, choice["file"])
    _ack_resume(ctl, cpath, ctl.rank != 0)
    ctl.agreed = True
    cfg = cfg.replace(seed=int(choice["seed"]))
    best = float(choice["best_acc"])
    if best > 0:
        ctl.best_recovered, _ = coord.gather_ok(
            "resume-best",
            ckpt.final_best_payload(cfg, best, log) is not None)
    return cfg, cpath


def node_resume_ack(ctl: Control, resume_from: Optional[str]) -> None:
    """A multi-node resume with a coordinator: node 0 chose the checkpoint
    (its state reaches every rank from rank 0's read); every other launch
    that holds a local copy of it must be able to load it, or every launch
    aborts (78) before training on a directory that lies."""
    if ctl.coord is not None and resume_from is not None:
        _ack_resume(ctl, resume_from,
                    ctl.rank != 0 and os.path.exists(resume_from))


def _ack_resume(ctl: Control, path: str, check: bool) -> None:
    """Every launch acks the chosen checkpoint (its own copy loads, when
    `check`: rank 0 already read it); one that cannot makes every launch
    raise CoordAbort (exit 78)."""
    err = ckpt.load_or_error(path)[1] if check else None
    all_ok, fails = ctl.coord.gather_ok("resume", err is None, err or "")
    if not all_ok:
        raise CoordAbort(
            "resume aborted by agreement: rank(s) cannot load the chosen "
            f"checkpoint {os.path.basename(path)!r}: "
            + "; ".join(f"rank {r}: {d}" for r, d in sorted(fails.items())))


def node_coord_port(cfg: Config) -> int:
    """Node 0's coordinator port: --coord-port, or a free one (0) when it
    is the launchers' store's (--port) or the ranks' rendezvous's (--port
    + 1); the other nodes read the bound one from the store."""
    return 0 if cfg.coord_port in (cfg.port, cfg.port + 1) else cfg.coord_port


def results_file(cfg: Config) -> str:
    """{results_path}/{dataset}_n{P}_p{rate:.2f}.txt
    (bnsgcn_tpu/run.py:963)."""
    return os.path.join(cfg.results_path, "%s_n%d_p%.2f.txt" % (
        cfg.dataset, cfg.n_partitions, cfg.sampling_rate))


def eval_cfg(cfg: Config, suffix: str) -> Config:
    """The config of an eval graph's partition artifacts: the training
    graph name plus '-val' or '-test' (bnsgcn_tpu/run.py _eval_resources)."""
    return cfg.replace(graph_name=(cfg.graph_name or cfg.derive_graph_name())
                       + suffix)


def mesh_eval_part(pr: Prepared, suffix: str, log=print):
    """(step functions, block arrays on the device, artifacts) that
    --eval-device mesh scores with on this rank (bnsgcn_tpu/run.py
    _eval_resources). Transductive: the training layout and blocks, whose
    'feat' is still the raw f32 features (init_training casts and
    precomputes a copy). Inductive: the eval graph's own partition, '-val'
    (the train+val subgraph) or '-test' (the full graph), with its own
    layout; at P > 1 each rank loads its part of the artifacts the parent
    wrote (node 0's launcher), at P=1 p1_artifacts gives them."""
    cfg = pr.cfg
    if not cfg.inductive:
        return pr.fns, pr.blk, pr.art
    cfg_e = eval_cfg(cfg, suffix)
    if pr.world is not None:
        art = load_artifacts(artifacts_dir(cfg_e), parts=[pr.rank])
    else:
        art = p1_artifacts(cfg_e, pr.val_g if suffix == "-val" else pr.test_g)
    # the training's resolved --reorder: its own order for the eval graph's
    # part (bnsgcn_tpu/run.py:615-618); the statistics are order-invariant
    art, _, _ = maybe_reorder(cfg_e, art, log, pr.comm, pr.rank)
    pe = prepare_part(cfg_e, art, None, pr.device,
                      lambda m: log(f"[eval{suffix}] {m}"), pr.rank, pr.comm,
                      axes=pr.axes)
    return pe.fns, pe.blk, pe.art


def lead_read(pr: Prepared, read: Callable):
    """read() on rank 0 handed to every rank (P > 1; at P=1 just read()):
    a rank on another node may not see rank 0's checkpoint directory, so
    rank 0 reads the checkpoint and broadcasts its payload, as the JAX
    package broadcasts the restored state (bnsgcn_tpu/run.py:744). A
    failed read fails every rank."""
    world = pr.world
    if world is None:
        return read()
    got = None
    if world.rank == 0:
        try:
            got = ("ok", read())
        except Exception as e:
            world.broadcast_object(("err", f"{type(e).__name__}: {e}"))
            raise
    kind, value = world.broadcast_object(got)
    if kind == "err":
        raise RuntimeError(f"rank 0 could not read the checkpoint: {value}")
    return value


def snapshot(model: GNN) -> dict:
    """A copy of the parameters on the current stream: Adam updates the
    model's in place."""
    return copy_state(model.state_dict())


def copy_state(state: dict) -> dict:
    return {k: v.detach().clone() for k, v in state.items()}


def full_model(pr: Prepared, model: GNN) -> GNN:
    """A module that holds full parameters, for a full state: a copy of
    `model`, or under a feat axis a whole model of its spec and dtype."""
    if not pr.fns.feat_dims:
        return copy.deepcopy(model)
    dt = next(model.parameters()).dtype
    return GNN(pr.spec, pr.cfg.seed, dt).to(device=pr.device, dtype=dt)


def _eval_job(e: int, thunk):
    """The eval thread's wrapper (bnsgcn_tpu/run.py `_eval_job`): a raise
    inside the thread must not kill training a log_every later when
    .result() re-raises, so the failure is labelled with the epoch it
    belongs to and handed to the drain. Returns (epoch, thunk's result or
    None, the exception or None, (start, end) on the host clock)."""
    t0 = time.perf_counter()
    try:
        return e, thunk(), None, (t0, time.perf_counter())
    except Exception as ex:     # noqa: BLE001 - every eval failure is soft
        return e, None, ex, (t0, time.perf_counter())


def _drain_eval(fut, res: RunResult, log):
    """(parameters, accuracy) of a finished eval future, or None when it
    failed (logged, as bnsgcn_tpu/run.py `_drain_eval` logs it); its span
    and seconds go to `res`."""
    e, out, err, span = fut.result()
    res.eval_spans.append((e,) + span)
    res.eval_seconds.append(span[1] - span[0])
    if err is not None:
        log(f"[resilience] host eval for epoch {e} failed "
            f"({type(err).__name__}: {err}); continuing training")
        return None
    return out


class HostEval:
    """Rank 0's --eval-device host evaluations, overlapped with training as
    the JAX package runs them (bnsgcn_tpu/run.py:969, :1719-1745): one
    worker thread scores a copy of the parameters taken at the log point
    while the loop trains on. On a card the thread runs on a CUDA stream of
    its own (a thread's current stream is per thread; on the training
    stream the eval would serialize with the steps): the copy is made on
    the training stream, the eval stream waits on an event recorded after
    it, and the copy's tensors are recorded on the eval stream, so the
    caching allocator cannot hand their memory out while the eval reads
    them. The eval loads the copy into a module of its own, scores the
    val graph copied to the device once, here (EvalGraph), and hands its
    logits to the host through pinned memory, so that the thread's waits
    hold up none of the training thread's copies."""

    def __init__(self, pr: Prepared, model: GNN, log, result_file,
                 obs=None):
        self.pr, self.log, self.result_file = pr, log, result_file
        self.obs = obs
        self.pool = ThreadPoolExecutor(max_workers=1)
        self.stream = (torch.cuda.Stream(pr.device)
                       if pr.device.type == "cuda" else None)
        self.model = full_model(pr, model)
        self.val = EvalGraph(pr.val_g, pr.spec.model, pr.device)
        self.pending = None

    def submit(self, epoch: int, state: dict) -> None:
        """Score a copy of `state` (the full parameters: the model's
        state_dict, or under a feat axis the gathered shards)."""
        snap = copy_state(state)
        ready = None
        if self.stream is not None:
            ready = torch.cuda.Event()
            ready.record()
        # the epoch is bound here, with the parameters: the thread may run
        # after the loop has moved on (bnsgcn_tpu/run.py:1727-1730)
        self.pending = self.pool.submit(
            _eval_job, epoch,
            lambda e=epoch, s=snap, r=ready: (s, self._score(e, s, r)))

    def _score(self, epoch: int, snap: dict, ready) -> float:
        pr, name = self.pr, "Epoch %05d" % epoch
        ctx = (torch.cuda.stream(self.stream) if self.stream is not None
               else nullcontext())
        with ctx:
            if ready is not None:
                self.stream.wait_event(ready)
                for t in snap.values():
                    t.record_stream(self.stream)
            self.model.load_state_dict(snap)
            if pr.cfg.inductive:
                return evaluate_induc(name, self.model, self.val, pr.device,
                                      "val", log=self.log,
                                      result_file=self.result_file)
            return evaluate_trans(name, self.model, self.val, pr.device,
                                  log=self.log,
                                  result_file=self.result_file)[0]

    def drain(self, res: RunResult, label: int):
        """Wait for the pending eval: its (parameters, accuracy), or None
        (none pending, or it failed); the wait goes to res.drain_waits."""
        if self.pending is None:
            return None
        t0 = time.perf_counter()
        done = _drain_eval(self.pending, res, self.log)
        res.drain_waits.append((label, time.perf_counter() - t0))
        self.pending = None
        if done is not None and self.obs is not None:
            self.obs.emit("eval", epoch=res.eval_spans[-1][0],
                          val_acc=round(float(done[1]), 6))
        return done

    def close(self, wait: bool = True) -> None:
        if wait:
            self.pool.shutdown(wait=True)
            if self.stream is not None:
                self.stream.synchronize()
        else:
            self.pool.shutdown(wait=False, cancel_futures=True)


def train_loop(pr: Prepared, model_init: Optional[dict] = None,
               log=print, resume_from: Optional[str] = None,
               ctx: Optional[RankContext] = None,
               ctl: Optional[Control] = None,
               launch_comm: Optional[Comm] = None
               ) -> tuple[RunResult, GNN]:
    """The epoch loop of one process (P=1) or one rank, from epoch 0 or,
    with `resume_from` (a periodic checkpoint), from the epoch after it
    with its nonces. Every `log_every` epochs, in the JAX package's
    order (bnsgcn_tpu/run.py:1693-1745): the launch's rank 0 logs, rank 0
    writes a periodic checkpoint, pruned to cfg.keep_ckpt; with cfg.eval,
    under --eval-device host rank 0 drains the previous evaluation and
    submits this epoch's to its thread (HostEval), under --eval-device mesh
    every rank joins the evaluation on the ranks. An evaluation becomes the
    best only if its accuracy is above the best so far, from 0.0. After the
    loop: the last drain, and only if an evaluation ran, rank 0's final
    checkpoint of the best parameters and their `Test Result` accuracy on
    the full graph's test mask (on a copy; on the ranks under mesh). The
    epoch time is taken after the step's gradient all-reduce and ends in
    float(loss). Returns the trained model, which every rank holds
    alike. Rank 0 is global rank 0 of coordination rank 0's launch: a
    harness launch of another coordination rank writes no file.

    Under --resilience on (resilience.py; the JAX package's hooks,
    bnsgcn_tpu/run.py:1247-1262, 1353-1507, 1755-1777) the loop is a
    `while` that a rollback moves back: at each step boundary the
    watchdog's beat and the injected faults, then `ctx.beat` (the
    launcher's view of this rank entering the step); after the step the
    loss check, at log points the parameter-norm probe, and at P > 1 one
    MAX all-reduce of [preemption, divergence] over the launch
    (`launch_comm`, by default the world), so every rank acts on the same
    verdict at the same boundary. Without a coordinator: divergence rolls
    back (model, Adam, SyncBatchNorm, the restart epoch, the keys' nonce;
    the losses from the restart on are dropped, the halo cache too);
    preemption, after the epoch's periodic work, has rank 0 write the
    epoch's checkpoint (unless the log point just did) and every rank raise
    PreemptedError. With one (`ctl`), the launch's verdict goes through
    agree_step and every rank acts on the agreed decision at once: an
    agreed preemption checkpoints and raises, a rollback or an elastic
    resize restores the agreed source (acked through the coordinator), an
    abort raises; a joiner first rejoins through the grant handshake. A
    collective that times out on a peer raises StepHung. The watchdog's
    clock is held through the log points' work (checkpoint, drain,
    barrier, eval). With the telemetry bus (a log path or --obs-dir) the
    launch's rank 0 emits the JAX package's events."""
    cfg, spec, fns, device, comm = pr.cfg, pr.spec, pr.fns, pr.device, pr.comm
    world, axes = pr.world, pr.axes
    ctl = ctl if ctl is not None else Control()
    launch = launch_comm if launch_comm is not None else world
    launch_lead = launch is None or launch.rank == 0
    # rank 0: the files, the host evals and the final eval's line
    lead = (world is None or world.rank == 0) and ctl.rank == 0
    # under a feat axis rank 0's feat group gathers the full parameters and
    # moments for its checkpoints and host evals (a collective of the group)
    gathers = lead or (ctl.rank == 0 and bool(fns.feat_dims)
                       and axes.r == 0 and axes.p == 0)
    replica = axes.replica if axes is not None else None
    mesh_eval = cfg.eval and cfg.eval_device == "mesh"
    res = RunResult(dense_edges=fns.dense_edges, n_edges=pr.n_edges)
    blk, model, opt = init_training(pr, model_init)
    seed, best_acc, best_state, nonce, rnonce = cfg.seed, 0.0, None, 0, 0
    tune_state = None       # the checkpoint's --tune history (extra["tune"])
    if resume_from is not None:
        payload = lead_read(pr, lambda: ckpt.read_blob(resume_from))
        tune_state = (payload.get("extra") or {}).get("tune")
        restore_payload(payload, model, opt, fns.shard_state)
        res.start_epoch = int(payload["epoch"]) + 1
        seed, best_acc = int(payload["seed"]), float(payload["best_acc"])
        extra = ckpt.resilience_extra(payload)
        nonce, rnonce = extra["retry_nonce"], extra["resize_nonce"]
        log(("Resumed (agreed via coordinator) from "
             f"{os.path.basename(resume_from)}" if ctl.agreed else
             f"Resumed from {resume_from}") + f" at epoch {res.start_epoch}")
        # every rank holds the best parameters under mesh (the final test
        # eval is collective), rank 0 alone under host
        final = None
        if ctl.best_recovered is False:
            pass            # a launch lacks them: every launch restarts
        elif best_acc > 0 and mesh_eval:
            final = lead_read(pr, lambda: ckpt.final_best_payload(
                cfg, best_acc, log))
        elif best_acc > 0 and lead:
            final = ckpt.final_best_payload(cfg, best_acc, log)
        if final is not None:
            # full on rank 0 under host eval, each rank's shard under mesh
            best_state = params_from_jax(final["params"], spec)
            if mesh_eval:
                best_state = fns.shard_state(best_state)
        else:
            best_acc = 0.0      # no matching best parameters: restart
    fns.set_nonce(nonce, rnonce)
    coord = None
    if ctl.on and launch_lead:
        coord = (ctl.coord if ctl.coord is not None
                 else Coordinator.adopt(ctl.handoff, log))
    link = (CoordLink(coord, launch if launch is not None
                      and launch.world > 1 else None,
                      world if launch is not world else None)
            if ctl.on else None)
    obs = (obs_mod.make_obs(cfg, rank=ctl.rank, log=log)
           if launch_lead and wants_obs(cfg) else None)
    if obs is not None:
        emit_header(obs, pr)
    result_file = None
    if lead and cfg.eval:
        os.makedirs(cfg.results_path, exist_ok=True)
        result_file = results_file(cfg)
    ev_val = mesh_eval_part(pr, "-val", log) if mesh_eval else None
    modes = ("val",) if cfg.inductive else ("val", "test")
    host = (HostEval(pr, model, log, result_file, obs)
            if cfg.eval and lead and not mesh_eval else None)

    def mean(xs):
        # past the warm-up, without the epochs a trace window or a retune's
        # rebuild ran in (res.clean), as the JAX package's timer records
        return warm_mean([x if c else None for x, c in zip(xs, res.clean)],
                         res.start_epoch)

    clock = "P=1" if world is None else (
        "events" if device.type == "cuda" else "host")
    peak_mb, steady_mb = wire_mbs(pr)
    # --halo-refresh K > 1: the halo cache, held on the device by this
    # process and never checkpointed. None runs the next step on the full
    # exchange, which rebuilds it: at the run's start, after a resume and
    # after a rollback or a resize (bnsgcn_tpu/run.py:1074-1080)
    use_refresh = fns.train_step_full is not None
    halo_cache = None
    cache_reason = "resume" if res.start_epoch > 0 else "start"
    resil = None
    if cfg.resilience == "on":
        resil = ResilienceManager(
            cfg, log, start_epoch=res.start_epoch, retry_nonce=nonce,
            rank=ctl.rank, lead=lead, launch_lead=launch_lead,
            find_ckpt=(partial(_lead_find, pr) if world is not None
                       else None),
            forwarded=ctx.forwarded if ctx is not None else None,
            link=link, obs=obs, resize_nonce=rnonce)
        # the rollback source before the first checkpoint: this rank's
        # fresh (or resumed) state, its shard under a feat axis
        resil.set_initial_snapshot(model, opt)
        if device.type == "cuda":
            # a cold build directory's nvcc runs can outlast the watchdog's
            # grace: every kernel is built before it starts
            _prebuild(cfg)
        resil.start()
    elif cfg.inject or os.environ.get("BNSGCN_FAULT"):
        log("[resilience] WARNING: --inject is armed but the resilience "
            "loop is disabled here — no fault will fire")
    held = resil.watchdog.held if resil is not None else nullcontext
    # $BNSGCN_EPOCH_THROTTLE_S: a least wall time per epoch, slept before
    # the timed region (the JAX package's test knob: a run slow enough for a
    # signal to land mid-run, or for a replacement launch to rejoin)
    throttle = float(os.environ.get("BNSGCN_EPOCH_THROTTLE_S", 0) or 0)
    per_epoch = (res.losses, res.epoch_times, res.comm_times,
                 res.reduce_times, res.feat_times, res.clean)
    loss_base = epoch = res.start_epoch     # res.losses[0]'s epoch
    loss_f = float("nan")
    # --strict-exec: every step guarded (strict.py); the loss read audited
    strict = (StrictExec(obs=obs, log=log, device=device)
              if cfg.strict_exec else None)
    # --tune: the controller, bound to the resolved levers (bnsgcn_tpu/
    # run.py:549-570); under auto at P > 1 rank 0 decides for every rank
    tuner = None
    if cfg.tune != "off":
        tuner = tune_mod.Tuner(cfg, levers=tuned_levers(cfg, fns), log=log)
        if ctl.tune_start is not None:
            ent0 = tuner.record_startup(*ctl.tune_start)
            res.tune_decisions.append(ent0)
            if obs is not None:
                obs.emit("tune_decision", **ent0)
        if cfg.tune == "auto" and pr.art is not None:
            tuner.strategy_alt = retune_strategy(
                pr.art.n_b, pr.art.pad_inner, pr.art.pad_boundary,
                cfg.sampling_rate, current=fns.halo_strategy,
                wire=tuned_levers(cfg, fns)["halo_wire"])
    decides = world is None or world.rank == 0

    def tune_ckpt():
        return tuner.state_dict() if tuner is not None else None
    retune_cool = -1        # epochs <= this ran a retune's rebuild: not
                            # recorded in the means, as warm-up epochs

    def apply_tune(changes: dict, reason: str, trigger: dict, at_epoch: int):
        """A retune at an epoch boundary (bnsgcn_tpu/run.py:1109-1185):
        the step functions rebuilt on the run's layouts with the new
        levers, the halo cache dropped (the next epoch is a logged full
        refresh), --strict-exec re-armed, the watchdog touched."""
        nonlocal cfg, fns, pr, use_refresh, peak_mb, steady_mb
        nonlocal halo_cache, cache_reason, retune_cool
        t0 = time.perf_counter()
        cfg = cfg.replace(**changes)
        fns = build_step_fns(cfg, spec, pr.art, device, log=log,
                             rank=pr.rank, comm=comm, reuse=fns, axes=axes,
                             cache=fns.cache)
        fns.set_nonce(nonce, rnonce)
        pr = dataclasses.replace(pr, cfg=cfg, fns=fns)
        use_refresh = fns.train_step_full is not None
        peak_mb, steady_mb = wire_mbs(pr)
        halo_cache = None
        cache_reason = (reason if reason in ("resume", "rollback", "resize")
                        else "retune")
        if strict is not None and strict.steps:
            strict.rearm(reason)
        retune_cool = at_epoch + 1
        if resil is not None:
            resil.watchdog.touch()      # the rebuild is boundary work
        res.retune_seconds.append((at_epoch, time.perf_counter() - t0))
        label = halo_label(cfg.replace(halo_exchange=fns.halo_strategy),
                           fns, axes)
        wire = tuned_levers(cfg, fns)["halo_wire"]
        log(f"[tune] epoch {at_epoch}: {reason} -> " + ", ".join(
            f"{k}={v}" for k, v in sorted(changes.items()))
            + f" (halo {label}/{wire}, steady {steady_mb:.2f} MB/exchange)")
        ent = dict(epoch=int(at_epoch), reason=reason, changes=dict(changes),
                   trigger=dict(trigger or {}), halo=label, wire=wire,
                   wire_mb_steady=round(steady_mb, 4),
                   wire_mb_peak=round(peak_mb, 4))
        res.tune_decisions.append(ent)
        if obs is not None:
            obs.emit("tune_decision", **ent)

    # the profiler window (bnsgcn_tpu/run.py:1008-1031): --profile-dir, or
    # under --comm-trace a temporary directory, in one launch of P > 1
    # ranks (a P=1 run has no collective to attribute; a node launch keeps
    # the port's own column, as a JAX multi-host run keeps [sampled]);
    # clamped into the epochs this run executes, after the first ones
    prof_start = max(WARMUP_EPOCHS + 1, res.start_epoch + 2)
    prof_stop = min(prof_start + 3, cfg.n_epochs - 1)
    trace_dir, auto_trace = cfg.profile_dir, False
    if trace_dir and ctl.rank > 0:
        # a harness launch's ranks beside coordination rank 0's
        trace_dir = os.path.join(trace_dir, f"launch{ctl.rank}")
    elif (not trace_dir and cfg.comm_trace and world is not None
          and cfg.n_nodes == 1 and prof_stop > prof_start):
        auto_trace = True
        trace_dir = world.broadcast_object(
            tempfile.mkdtemp(prefix="bnsgcn_commtrace_")
            if world.rank == 0 else None)
    me = world.global_rank(world.rank) if world is not None else 0
    prof = None                 # the open torch.profiler session
    tracing = trace_done = False
    # SIGUSR1 (the telemetry bus on): a bounded window into the post-mortem
    # directory; at P > 1 the launch's rank 0 takes the signal and every
    # rank opens the window at the boundary after the step's agreement
    usr1_tracing, usr1_stop, usr1_dir, prof_usr1 = False, -1, None, None
    usr1_go = usr1_asked = False

    def rewind(restart: int) -> None:
        """Drop the epochs from `restart` on: they are run again."""
        nonlocal loss_base
        if restart < loss_base:
            for xs in per_epoch:
                xs.clear()
            loss_base = res.start_epoch = restart
        else:
            for xs in per_epoch:
                del xs[restart - loss_base:]

    def full_states():
        """(full parameters, Adam's moments in the JAX layout) on the ranks
        that gather them for rank 0's files, else (None, None)."""
        if not gathers:
            return None, None
        return (fns.full_state(model.state_dict()),
                opt_state_to_jax(opt, model, fns.full_state))

    t_loop = time.perf_counter()
    try:
        if ctl.joiner and resil is not None:
            epoch = _rejoin(ctl, link, resil, model, opt, fns, log)
            nonce, rnonce = resil.nonce, resil.resize_nonce
            res.start_epoch = loss_base = epoch
            halo_cache, cache_reason = None, "resize"
        if tuner is not None and res.start_epoch > 0 and not ctl.joiner:
            # resumed: the controller's history adopted (or, for a schedule,
            # rebuilt) and the levers live at the resume point actuated
            # before the first step
            tdiff = tuner.restore(res.start_epoch, tune_state)
            if tdiff:
                apply_tune(tdiff, "resume", {}, res.start_epoch)
        while epoch < cfg.n_epochs:
            if throttle > 0:
                time.sleep(throttle)
            if resil is not None:
                resil.watchdog.beat(epoch)
                # 'nan' poisons the parameters, so the divergence shows up
                # through the real loss
                if resil.fire_injections(epoch)["nan"]:
                    with torch.no_grad():
                        for p in model.parameters():
                            p.mul_(float("nan"))
                if obs is not None and resil.take_profile_request():
                    usr1_asked = True
                    usr1_go = usr1_go or world is None
                if usr1_go:
                    usr1_go = False
                    with held():
                        usr1_dir, prof_usr1 = _profile_request(
                            cfg, obs, resil, epoch, log, device,
                            busy=tracing or usr1_tracing)
                    if usr1_dir is not None:
                        usr1_tracing, usr1_stop = True, epoch + 2
                if ctx is not None:
                    ctx.beat(epoch)
            # >= (not ==): a SIGUSR1 window over prof_start only delays the
            # comm-trace window, never cancels it
            if (trace_dir and prof_start <= epoch < prof_stop
                    and not tracing and not trace_done and not usr1_tracing):
                tracing = True
                try:
                    prof = _profiler(device)
                except Exception as e:     # noqa: BLE001 - the run goes on
                    log(f"[trace] the profiler did not start ({e}); no "
                        f"traced window")
            if world is not None:
                world.reset_seconds()
            key = dropout_key(seed, epoch, pr.rank, replica, nonce, rnonce)
            t_ep = time.perf_counter()
            res.epoch_starts.append(t_ep)
            refresh_full = use_refresh and halo_cache is None
            log_point = (epoch + 1) % cfg.log_every == 0
            pnorm = None
            # the epoch's host values (the dropout key, the epoch) are
            # kernel arguments and the sample key lives on the device, so
            # nothing is uploaded inside the guard; full and cached are two
            # step functions, each its own --strict-exec variant
            variant = (("full" if refresh_full else "cached") if use_refresh
                       else "step")
            try:
                with (strict.step(variant) if strict is not None
                      else nullcontext()), (
                        record_function("train_step") if tracing
                        or usr1_tracing else nullcontext()):
                    if refresh_full:
                        loss, halo_cache = fns.train_step_full(
                            model, opt, blk, epoch, key)
                    elif use_refresh:
                        loss, halo_cache = fns.train_step_cached(
                            model, opt, blk, epoch, key, halo_cache)
                    else:
                        loss = fns.train_step(model, opt, blk, epoch, key)
                # waits for the device; under strict the audited read
                loss_f = (strict.fetch(loss) if strict is not None
                          else float(loss))
                dt = time.perf_counter() - t_ep
                usr1_in_step = usr1_tracing     # profiler overhead rides dt
                secs = (world.seconds() if world else
                        {"exchange": 0.0, "reduce": 0.0, "feat": 0.0})
                bad = preempt = False
                if resil is not None:
                    # the loss is all-reduced: the check is every rank's
                    bad = not np.isfinite(loss_f)
                    if not bad and log_point:
                        pnorm = param_global_norm(model)
                        bad = not np.isfinite(pnorm)
                    asked = resil.preempt_requested is not None
                    preempt = asked
                    # the launch's verdict under a coordinator, else the
                    # world's
                    agree = launch if link is not None else world
                    if agree is not None and agree.world > 1:
                        # the probe's verdict (a feat shard's own) and the
                        # preemption flag, at this boundary
                        t_ag = time.perf_counter()
                        g = agree.global_rank(agree.rank)
                        pre_rank, bad_any, prof_any = agree.agree_max(
                            [g + 1 if asked else 0, int(bad),
                             int(usr1_asked)])
                        res.agree_times.append(time.perf_counter() - t_ag)
                        preempt, bad = pre_rank > 0, bad_any > 0
                        # SIGUSR1 on the launch's rank 0: every rank opens
                        # the window at the next boundary
                        usr1_go, usr1_asked = prof_any > 0, False
            except RuntimeError as e:
                if resil is not None and collective_timed_out(e):
                    raise StepHung(f"rank {world.rank if world else 0}: a "
                                   f"collective of epoch {epoch}'s step "
                                   f"timed out ({e})") from e
                raise
            if refresh_full:
                if obs is not None:
                    obs.emit("halo_refresh", epoch=epoch,
                             k=int(fns.halo_refresh), reason=cache_reason)
                log(f"  halo cache: full refresh at epoch {epoch} "
                    f"({cache_reason}); next {fns.halo_refresh - 1}+ epochs "
                    f"reuse cached blocks")
            if link is not None:
                # the agreed verdict: every launch acts on one decision
                t_co = time.perf_counter()
                decision = resil.agree_step(
                    epoch, ("diverged" if bad else "preempted" if preempt
                            else "ok"), loss_f,
                    summary=({"loss": round(loss_f, 6),
                              "step_ms": round(dt * 1e3, 3)}
                             if obs is not None else None),
                    final=epoch + 1 >= cfg.n_epochs)
                res.coord_times.append(time.perf_counter() - t_co)
                if link.comm is not None:
                    res.relay_times.append(link.relay_s)
                act = decision["decision"]
                if act == "abort":
                    resil.raise_abort(decision)
                if act == "preempt":
                    ppath = ckpt.periodic_path(cfg, epoch)
                    with held():
                        full, opt_j = full_states()
                        if lead:
                            _save_periodic(pr, epoch, full, opt_j, best_acc,
                                           seed, nonce, rnonce, tune_ckpt())
                        log(f"[resilience] agreed preemption (requested by "
                            f"rank(s) {decision.get('ranks')}) at the epoch-"
                            f"{epoch} step boundary: resumable checkpoint "
                            f"at {ppath}")
                        if obs is not None:
                            obs.emit("preempt", epoch=epoch, ckpt=ppath,
                                     agreed=True,
                                     ranks=decision.get("ranks"))
                        if world is not None:
                            world.barrier()     # rank 0's file is on disk
                    raise PreemptedError(epoch, ppath)
                if act in ("rollback", "resize"):
                    if act == "resize":
                        link.call(lambda c: c.apply_resize(decision))
                    resil.coord_restore(decision, model, opt,
                                        fns.shard_state, ack_name=act)
                    restart = int(decision["restart"])
                    if act == "resize":
                        nonce = int(decision["retry_nonce"])
                        rnonce = int(decision["nonce"])
                    else:
                        nonce = int(decision["nonce"])
                    fns.set_nonce(nonce, rnonce)
                    rewind(restart)
                    halo_cache, cache_reason = None, act
                    if tuner is not None:
                        # the levers live when `restart` first ran; the
                        # kept history replays from there
                        td = tuner.rewind(restart)
                        if td:
                            apply_tune(td, act, {} if act == "rollback" else
                                       {"world": decision.get("world"),
                                        "trigger": decision.get("trigger")},
                                       restart)
                    if act == "resize":
                        log(f"[elastic] epoch {epoch}: "
                            f"{decision.get('trigger')} resize to world "
                            f"{decision.get('world')} (members "
                            f"{decision.get('members')}); parts now "
                            + slot_desc(decision.get("slots") or (),
                                        decision.get("members") or [])
                            + f"; resuming from epoch {restart}")
                    resil.watchdog.touch()
                    epoch = restart
                    continue
                preempt = False
            elif bad:
                # before the checkpoint below: a non-finite state never
                # becomes the last good one
                restart, nonce = resil.rollback(epoch, loss_f, model, opt,
                                                fns.shard_state)
                fns.set_nonce(nonce, rnonce)
                # the retried epochs are recorded again on the healthy pass
                rewind(restart)
                halo_cache, cache_reason = None, "rollback"
                if tuner is not None:
                    td = tuner.rewind(restart)
                    if td:
                        apply_tune(td, "rollback", {}, restart)
                resil.watchdog.touch()
                epoch = restart
                continue
            if not np.isfinite(loss_f) and resil is None:
                raise FloatingPointError(f"epoch {epoch}: loss is {loss_f}")
            if tracing and epoch >= prof_stop:
                with held():        # stop, export, parse: boundary work
                    _close_window(prof, trace_dir, me, world, cfg, fns,
                                  res, epoch, obs, log)
                prof, tracing, trace_done = None, False, True
                if auto_trace and world.rank == 0:
                    shutil.rmtree(trace_dir, ignore_errors=True)
            if usr1_tracing and epoch >= usr1_stop:
                if prof_usr1 is not None:
                    with held():
                        _export(prof_usr1,
                                traceparse.trace_file(usr1_dir, me))
                usr1_tracing, prof_usr1 = False, None
                log(f"[obs] SIGUSR1 profiler window written to {usr1_dir}")
                if obs is not None:
                    obs.emit("profile", epoch=epoch, trace_dir=usr1_dir)
                if trace_dir and not trace_done and epoch >= prof_start:
                    # the SIGUSR1 window took the comm-trace window's
                    # epochs: it opens right after, delayed, never cancelled
                    prof_start = epoch + 1
                    prof_stop = min(prof_start + 3, cfg.n_epochs - 1)
            # the epochs of a trace window carry the profiler's overhead and
            # a retune's the rebuild: not recorded in the means
            clean = (not (trace_dir and prof_start <= epoch <= prof_stop)
                     and not usr1_in_step and epoch > retune_cool)
            exch_s = (res.comm_traced if res.comm_traced is not None
                      else secs["exchange"] if world is not None else None)
            res.losses.append(loss_f)
            res.epoch_times.append(dt)
            res.comm_times.append(secs["exchange"])
            res.reduce_times.append(secs["reduce"])
            res.feat_times.append(secs["feat"])
            res.clean.append(clean)
            if obs is not None:
                _emit_epoch(obs, epoch, loss_f, dt, pnorm,
                            steady_mb if use_refresh and not refresh_full
                            else peak_mb, exch_s,
                            "traced" if res.comm_traced is not None
                            else clock, clean)
            if tuner is not None:
                # the decision point, after the epoch's record: a retune
                # takes effect from the next epoch, rebuilt here
                metrics = {"loss": loss_f, "step_s": dt,
                           "comm_s": exch_s or None,
                           "wire_mb": (steady_mb if use_refresh
                                       and not refresh_full else peak_mb)}
                dec = (tuner.on_epoch_end(epoch, metrics)
                       if cfg.tune == "schedule" or decides else None)
                if cfg.tune == "auto" and world is not None:
                    dec = _tune_follow(tuner, world, dec)
                if dec is not None and dec["changes"]:
                    apply_tune(dec["changes"], dec["reason"],
                               dec.get("trigger") or {}, epoch + 1)
            if not (log_point or preempt):
                epoch += 1
                continue
            full = opt_j = None
            with held():
                full, opt_j = full_states()
                if log_point:
                    best_acc, best_state = _log_point(
                        pr, model, res, epoch, loss_f, full, opt_j, seed,
                        nonce, rnonce, best_acc, best_state, host, ev_val,
                        modes, result_file, mean, clock, log, lead,
                        launch_lead, save=not bad, obs=obs,
                        tune=tune_ckpt())
            if log_point and resil is not None:
                resil.note_progress(epoch)
            if preempt:
                ppath = ckpt.periodic_path(cfg, epoch)
                with held():
                    if lead and not log_point:
                        _save_periodic(pr, epoch, full, opt_j, best_acc,
                                       seed, nonce, rnonce, tune_ckpt())
                    who = (f"{resil.preempt_requested}" if world is None
                           else f"agreed preemption (requested on rank "
                                f"{pre_rank - 1})")
                    log(f"[resilience] {who} honored at the epoch-{epoch} "
                        f"step boundary: resumable checkpoint at {ppath}")
                    if obs is not None:
                        obs.emit("preempt", epoch=epoch, ckpt=ppath,
                                 signal=resil.preempt_requested)
                    if world is not None:
                        world.barrier()     # rank 0's file is on disk
                raise PreemptedError(epoch, ppath)
            epoch += 1
    except BaseException as e:
        if host is not None:
            host.close(wait=False)
        if strict is not None:
            # the audit lands on every exit path, before the run's end
            res.strict, strict = strict.finish(), None
        if obs is not None:
            # an interrupted run ends its log with a terminal record too
            obs.emit("run_end", interrupted=type(e).__name__,
                     epochs_done=len(res.losses), final_loss=loss_f,
                     epoch_time_s=round(mean(res.epoch_times), 6))
            obs.close()
        raise
    finally:
        # a crash or preemption anywhere in the loop leaves no profiler
        # session or temporary trace directory behind
        for p_open in (prof, prof_usr1):
            if p_open is not None:
                try:
                    p_open.stop()
                except Exception:       # noqa: BLE001
                    pass
        if usr1_tracing and sys.exc_info()[0] is not None:
            log(f"[obs] SIGUSR1 profiler window written to {usr1_dir}")
            if obs is not None:
                obs.emit("profile", epoch=epoch, trace_dir=usr1_dir,
                         at_exit=True)
        if auto_trace and not trace_done and world.rank == 0:
            shutil.rmtree(trace_dir, ignore_errors=True)
        if strict is not None:
            res.strict = strict.finish()
        if resil is not None:
            res.rollbacks = list(resil.rollbacks)
            resil.close()
        if coord is not None and sys.exc_info()[0] is None:
            # a peer up to one boundary behind may still be reading its
            # last decision from rank 0's server
            coord.finish()
        if coord is not None and coord is not ctl.coord:
            coord.close()
    if host is not None:
        done = host.drain(res, cfg.n_epochs)
        if done is not None and done[1] > best_acc:
            best_acc, best_state = done[1], done[0]
        host.close()
    res.loop_seconds = time.perf_counter() - t_loop
    res.epoch_time = mean(res.epoch_times)
    res.best_val_acc = res.val_acc = best_acc
    if cfg.eval and best_state is not None:
        # the best parameters with the run's final SyncBatchNorm state;
        # under mesh eval every rank's shard, gathered for the file
        best_state = with_bn_state(best_state, model)
        best_full = (fns.full_state(best_state) if mesh_eval and gathers
                     else best_state)
        if lead:
            ckpt.save_checkpoint(ckpt.final_path(cfg),
                                 params=params_to_jax(best_full, spec),
                                 bn_state=bn_state_to_jax(best_full, spec),
                                 epoch=cfg.n_epochs - 1, best_acc=best_acc,
                                 seed=seed)
            log("model saved")
            log("Max Validation Accuracy {:.2%}".format(best_acc))
        best = copy.deepcopy(model) if mesh_eval else full_model(pr, model)
        best.load_state_dict(best_state)
        t_ev = time.perf_counter()
        if mesh_eval:
            # the full graph's partition, built now (inductive) as the JAX
            # package builds it after the loop; every rank joins
            ev = mesh_eval_part(pr, "-test", log) if cfg.inductive else ev_val
            res.test_acc = evaluate_mesh("Test Result", ev[0].eval_forward,
                                         best, ev[1], ev[2], ("test",),
                                         None, comm, log)["test"]
        elif lead:
            # transductive: the test graph is the val graph, already on
            # the device
            test_g = (host.val if host is not None and pr.test_g is pr.val_g
                      else pr.test_g)
            res.test_acc = evaluate_induc("Test Result", best, test_g,
                                          device, "test", log=log)
        if lead:
            res.eval_seconds.append(time.perf_counter() - t_ev)
    if cfg.dump_embeddings:
        full = None
        if not (mesh_eval and not cfg.inductive):
            # the host branch scores full parameters: the best ones as the
            # final checkpoint holds them, else the trained ones, gathered
            # over rank 0's feat group as for a checkpoint
            if cfg.eval and best_state is not None:
                full = best_full
            elif gathers:
                full = fns.full_state(model.state_dict())
        dump_embeddings(pr, best if cfg.eval and best_state is not None
                        else model, full, ev_val, lead, best_acc, log)
    if obs is not None:
        obs.emit("run_end", final_loss=res.losses[-1] if res.losses
                 else loss_f, epoch_time_s=round(res.epoch_time, 6),
                 comm_time_s=round(mean(res.comm_times), 6),
                 reduce_time_s=round(mean(res.reduce_times), 6),
                 best_val_acc=round(res.best_val_acc, 6),
                 test_acc=round(res.test_acc, 6),
                 rollbacks=len(res.rollbacks),
                 step_hist=obs.registry.histogram("train/step_s").snapshot())
        obs.close()
    return res, model


def dump_embeddings(pr: Prepared, model: GNN, full: Optional[dict],
                    ev_val, lead: bool, best_acc: float, log) -> None:
    """--dump-embeddings after the final eval (bnsgcn_tpu/run.py:1875-1916):
    the all-node table (the final layer's input and the logits) of the
    best parameters (the trained ones without an eval) in global node
    order, written by rank 0 through serve.save_table with the JAX meta
    keys. Under --eval-device mesh, transductive, every rank runs
    embed_forward on its part (K1 and K2, counted under 'eval') and rank 0
    gathers the ranks' inner rows once, over the world's wait group;
    otherwise rank 0 runs full_graph_embeddings (the serving forward) on
    the full graph with `full` (a state_dict of full parameters). Skipped,
    with the JAX line, across nodes or without an eval graph."""
    cfg = pr.cfg
    mesh = cfg.eval and cfg.eval_device == "mesh" and not cfg.inductive
    if cfg.n_nodes > 1:
        if lead:
            log("[serve] --dump-embeddings skipped: multi-host export needs "
                "a gather of remote part rows (single-host only for now)")
        return
    if not mesh and (not lead or pr.test_g is None):
        if lead:
            log("[serve] --dump-embeddings skipped: no eval graph loaded "
                "(run with --eval, or --eval-device mesh transductive)")
        return
    from bnsgcn_tpu_torch import serve as serve_mod
    from bnsgcn_tpu_torch.evaluate import _to_host, full_graph_embeddings
    t0 = time.time()
    if mesh:
        fns_e, blk_e, art_e = ev_val
        hid, lg = fns_e.embed_forward(model, blk_e)
        rows = torch.from_numpy(np.concatenate(
            [_to_host(hid.float()), _to_host(lg.float())], 1))
        row = local_row(art_e, pr.rank)
        ids = torch.from_numpy(np.where(art_e.inner_mask[row],
                                        art_e.global_nid[row], -1)
                               .astype(np.int64))
        axes = pr.axes
        if axes is not None and (axes.r or axes.f):
            ids[:] = -1             # one copy of each part: replica 0's,
                                    # feat shard 0's
        world = pr.world
        if world is None:
            got_rows, got_ids = [rows], [ids]
        else:
            got_rows, got_ids = world.gather_host(rows), world.gather_host(ids)
        if not lead:
            return
        n = sum(int((i >= 0).sum()) for i in got_ids)
        table = np.zeros((n, rows.shape[1]), np.float32)
        for r, i in zip(got_rows, got_ids):
            keep = i >= 0
            table[i[keep].numpy()] = r[keep].numpy()
        h_w = hid.shape[1]
        hidden, logits = table[:, :h_w], table[:, h_w:]
    else:
        dt = next(model.parameters()).dtype
        m = GNN(pr.spec, cfg.seed, dt).to(device=pr.device, dtype=dt)
        m.load_state_dict(full)
        hidden, logits = full_graph_embeddings(m, pr.test_g, pr.device)
    serve_mod.save_table(cfg.dump_embeddings, hidden, logits, meta={
        "graph_name": cfg.graph_name or cfg.derive_graph_name(),
        "model": cfg.model, "n_nodes": int(hidden.shape[0]),
        "epoch": cfg.n_epochs - 1, "best_acc": float(best_acc)})
    log(f"[serve] embedding table [{hidden.shape[0]} x {hidden.shape[1]}] "
        f"+ logits [{logits.shape[1]} classes] -> {cfg.dump_embeddings} "
        f"({time.time() - t0:.1f}s)")


def tuned_levers(cfg: Config, fns: StepFns) -> dict:
    """The levers --tune moves, as the step functions resolved them."""
    grad_only = resolve_halo_mode(cfg, log=lambda m: None)[1]
    return {"halo_refresh": int(fns.halo_refresh),
            "halo_mode": "grad-only" if grad_only else "exchange",
            "halo_exchange": fns.halo_strategy,
            "halo_wire": fns.halo.wire if fns.halo is not None
            else cfg.halo_wire}


def _profiler(device: torch.device):
    """A started torch.profiler session: the host's ops, and on a card its
    kernels."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=acts, acc_events=True)
    except TypeError:           # a torch without acc_events
        prof = profile(activities=acts)
    prof.start()
    return prof


def _export(prof, path: str) -> None:
    prof.stop()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)


def wants_obs(cfg: Config) -> bool:
    """Whether the launch builds the telemetry bus: --obs on with somewhere
    to write (an event log, --obs-log or $BNSGCN_OBS_LOG, or --obs-dir's
    post-mortem files). A run given neither builds none, as --obs off."""
    return cfg.obs == "on" and bool(
        cfg.obs_log or os.environ.get("BNSGCN_OBS_LOG") or cfg.obs_dir)


def halo_label(cfg: Config, fns: StepFns, axes: Optional[Axes]) -> str:
    """The halo label of the JAX package's Mesh line and run header
    (bnsgcn_tpu/run.py:447-475): the resolved strategy, then +ovl, +repR,
    +featT, +go or +hrK, +ro."""
    label = (f"auto->{fns.halo_strategy}" if cfg.halo_exchange == "auto"
             else fns.halo_strategy)
    label += "+ovl" if fns.overlap == "split" else ""
    label += f"+rep{axes.R}" if axes is not None and axes.R > 1 else ""
    label += f"+feat{axes.T}" if axes is not None and axes.T > 1 else ""
    grad_only = resolve_halo_mode(cfg, log=lambda m: None)[1]
    label += ("+go" if grad_only else
              f"+hr{fns.halo_refresh}" if fns.halo_refresh > 1 else "")
    return label + ("+ro" if cfg.reorder != "off" else "")


def wire_mbs(pr: Prepared) -> tuple[float, float]:
    """(MB a rank sends per exchange on a full-exchange epoch, on a
    --halo-refresh cached one) at the hidden width (its feat slice), the
    compute dtype's bytes on the native wire; 0 under grad-only and at
    P=1."""
    fns, cfg = pr.fns, pr.cfg
    if fns.halo is None or resolve_halo_mode(cfg, log=lambda m: None)[1]:
        return 0.0, 0.0
    nb = 2 if cfg.dtype == "bfloat16" else 4
    T = pr.axes.T if pr.axes is not None else 1
    hid_w = shard_width(cfg.n_hidden, T, cfg.model in ("gcn", "graphsage"))
    peak = wire_bytes(fns.halo, hid_w, nb) / 1e6
    steady = (wire_bytes(fns.halo_refresh_spec, hid_w, nb) / 1e6
              if fns.halo_refresh_spec is not None else peak)
    return peak, steady


HEADER_CONFIG = (
    "dataset", "graph_name", "model", "n_layers", "n_hidden", "heads",
    "sampling_rate", "lr", "dtype", "spmm", "use_pallas", "spmm_gather",
    "spmm_dense", "halo_exchange", "halo_wire", "halo_refresh", "halo_mode",
    "overlap", "reorder", "tune", "tune_schedule", "tune_prior", "n_epochs",
    "log_every", "seed", "inductive", "use_pp", "resilience", "coord")


def emit_header(obs, pr: Prepared) -> None:
    """The events before the first epoch, as the JAX package emits them:
    `reorder` (an active --reorder), `layout_build` per layout this rank
    built or loaded (the JAX package's stage names), `run_header`."""
    cfg, fns, axes = pr.cfg, pr.fns, pr.axes
    if pr.reorder_info:
        obs.emit("reorder", **pr.reorder_info)
    for key, (how, secs) in fns.layout_times.items():
        parts = key.split(":")
        obs.emit("layout_build",
                 stage=parts[0] + ("_split" if "ovl" in parts else ""),
                 ms=round(secs * 1e3, 1), cached=how == "loaded")
    R, T = (axes.R, axes.T) if axes is not None else (1, 1)
    peak, steady = wire_mbs(pr)
    art, hs = pr.art, fns.halo
    obs.emit(
        "run_header", mesh=mesh_desc(R, cfg.n_partitions, T), replicas=R,
        parts=int(cfg.n_partitions), feat=T, halo=halo_label(cfg, fns, axes),
        wire=hs.wire if hs is not None else cfg.halo_wire,
        wire_mb_per_exchange=round(peak, 4), wire_mb_steady=round(steady, 4),
        halo_refresh=int(fns.halo_refresh),
        halo_mode=("grad-only" if resolve_halo_mode(
            cfg, log=lambda m: None)[1] else "exchange"),
        partition={"pad_inner": int(art.pad_inner),
                   "pad_boundary": int(art.pad_boundary),
                   "pad_send": int(hs.pad_send) if hs is not None else 0,
                   "edges_per_part": int(art.pad_edges)},
        config={k: getattr(cfg, k) for k in HEADER_CONFIG})


def _emit_epoch(obs, epoch: int, loss_f: float, dt: float, pnorm,
                wire_mb: float, exchange_s, clock: str,
                clean: bool = True) -> None:
    """The per-epoch record (bnsgcn_tpu/run.py:1643-1663): the loss, the
    step's seconds, this epoch's wire MB, the norm probe's value at a log
    point and, at P > 1, the epoch's exchange seconds (the port's own
    measure: CUDA events on a card, the host clock on the CPU, until a
    trace window gives the traced in-step seconds, tag 'traced'). Past the
    warm-up a `clean` step time (no trace window, no retune) feeds the
    registry's p50/p99 histogram."""
    if epoch >= WARMUP_EPOCHS and clean:
        obs.registry.histogram("train/step_s").observe(dt)
    rec = {"epoch": epoch, "loss": round(loss_f, 6), "step_s": round(dt, 6),
           "wire_mb": round(wire_mb, 4)}
    if pnorm is not None:
        rec["param_norm"] = round(pnorm, 6)
    if exchange_s is not None:
        rec["comm_s"] = round(exchange_s, 6)
        rec["comm_tag"] = clock
    obs.emit("epoch", **rec)


def _profile_request(cfg: Config, obs, resil: ResilienceManager,
                     epoch: int, log, device: torch.device, busy: bool):
    """SIGUSR1 (bnsgcn_tpu/run.py:1261-1290), training on: on the rank with
    the bus, every thread's stack and a registry snapshot into the
    post-mortem directory; on every rank, unless a window is open
    (`busy`), a profiler window into its trace_E<epoch> directory, which
    the loop closes two epochs on. Returns (the window's directory or
    None, the profiler or None if it did not start)."""
    pm = resil.postmortem_dir or obs_mod.postmortem_dir(cfg)
    snap = None
    if obs is not None:
        snap = obs_mod.write_postmortem(
            pm, f"sigusr1_E{epoch}",
            text=f"SIGUSR1 snapshot at epoch {epoch}",
            registry=obs.registry) or None
        log(f"[obs] SIGUSR1: stacks + metrics snapshot -> {snap}" if snap
            else "[obs] SIGUSR1: post-mortem snapshot write FAILED (disk?); "
                 "still arming the trace window")
    trace_dir = prof = None
    if not busy:
        trace_dir = os.path.join(pm, f"trace_E{epoch}")
        try:
            prof = _profiler(device)
            log(f"[obs] SIGUSR1: profiling epochs {epoch}..{epoch + 2} -> "
                f"{trace_dir}")
        except Exception as ex:     # noqa: BLE001 - the run goes on
            log(f"[obs] SIGUSR1 trace failed to start: {ex}")
    if obs is not None:
        obs.emit("profile_request", epoch=epoch, snapshot=snap,
                 trace_dir=trace_dir if prof is not None else None)
    resil.watchdog.touch()
    return trace_dir, prof


def _close_window(prof, trace_dir: str, me: int, world: Optional[Comm],
                  cfg: Config, fns: StepFns, res: RunResult, epoch: int,
                  obs, log) -> None:
    """The comm-trace window's end (bnsgcn_tpu/run.py:1527-1590): every
    rank exports its trace (rank_<g>.json), then after a barrier rank 0
    reads them all (utils/traceparse.py): the in-step exchange and reduce
    seconds per step, min over the ranks, go to res.comm_traced /
    reduce_traced (the epoch line's [traced] Comm column, the `trace`
    event) and, under --overlap split, the phases' overlap (the `overlap`
    event, the overlap[traced] line). A second barrier holds the others
    while rank 0 parses."""
    if prof is not None:
        _export(prof, traceparse.trace_file(trace_dir, me))
    if world is not None:
        world.barrier()
    if world is None or world.rank == 0:
        if cfg.profile_dir:
            log(f"profiler trace written to {trace_dir}")
        try:
            events, _ = traceparse.load_trace_events(trace_dir)
        except Exception:               # noqa: BLE001 - no trace, no column
            events = None
        parsed = (traceparse.step_comm_from_events(events)
                  if events is not None else None)
        if parsed is not None:
            res.comm_traced, res.reduce_traced = parsed[0], parsed[1]
            if obs is not None:
                obs.emit("trace", epoch=epoch,
                         comm_s=round(res.comm_traced, 6),
                         reduce_s=round(res.reduce_traced, 6),
                         trace_dir=cfg.profile_dir or None)
        if fns.overlap == "split":
            rep = (traceparse.overlap_from_events(events)
                   if events is not None else None)
            if rep is None:
                log("overlap[traced]: no interior/frontier scope spans in "
                    "the trace window")
            else:
                if obs is not None:
                    obs.emit("overlap", epoch=epoch,
                             **{k: round(float(rep[k]), 4) for k in (
                                 "exchange_ms", "interior_ms",
                                 "frontier_ms", "hidden_ms")},
                             overlapped=bool(rep["overlapped"]))
                log("overlap[traced]: exchange {exchange_ms:.3f} ms | "
                    "interior {interior_ms:.3f} ms | frontier "
                    "{frontier_ms:.3f} ms | hidden {hidden_ms:.3f} ms per "
                    "step — collective overlapped interior compute: "
                    "{verdict}".format(
                        verdict="YES" if rep["overlapped"] else "NO",
                        **{k: rep[k] for k in rep}))
    if world is not None:
        world.barrier()


def _tune_follow(tuner: "tune_mod.Tuner", world: Comm, dec):
    """--tune auto at P > 1: the P ranks read P clocks, so rank 0's
    decision (and its controller's history, which a rollback rewinds) is
    every rank's, over the wait group at the epoch boundary."""
    got = world.broadcast_object(
        (dec, tuner.state_dict(), dict(tuner.levers)) if world.rank == 0
        else None)
    dec, state, levers = got
    if world.rank != 0:
        tuner.history = [dict(e) for e in state["history"]]
        tuner._by_epoch = {int(e["epoch"]): e for e in tuner.history}
        tuner.max_seen = int(state["max_seen"])
        tuner.levers = dict(levers)
    return dec


def _rejoin(ctl: Control, link: CoordLink, resil: ResilienceManager,
            model, opt, fns: StepFns, log) -> int:
    """A replacement launch's rejoin handshake (bnsgcn_tpu/run.py:
    1184-1226): rank 0 asks coordination rank 0 to rejoin; the grant names
    the agreed restore, both nonces, the part map and the survivors'
    schedule position, so the first exchange this launch joins is the grow
    restore's ack, beside the survivors' own. Returns the epoch to replay
    from."""
    token = f"{os.getpid():x}-{os.urandom(4).hex()}"
    log(f"[elastic] rank {ctl.rank}: requesting rejoin (token {token})")

    def rejoin(c):
        grant = c.request_rejoin(token)
        c.adopt_grant(grant)
        return grant

    grant = link.call(rejoin)
    restart = int(grant["restart"])
    resil.nonce = int(grant["retry_nonce"])
    resil.resize_nonce = int(grant["nonce"])
    resil.coord_restore(grant, model, opt, fns.shard_state,
                        ack_name="resize")
    fns.set_nonce(resil.nonce, resil.resize_nonce)
    resil._emit("resize", epoch=int(grant["epoch"]),
                old_world=int(grant["old_world"]), world=int(grant["world"]),
                members=[int(r) for r in grant["members"]], lost=[],
                slots=[int(s) for s in grant.get("slots", [])],
                trigger="rejoin", nonce=resil.resize_nonce,
                restart=restart, source=str(grant["source"]))
    log(f"[elastic] rank {ctl.rank}: rejoined world {grant.get('world')} "
        f"(members {grant.get('members')}); parts now "
        + slot_desc(grant.get("slots") or (), grant.get("members") or [])
        + f"; replaying from epoch {restart} in lockstep")
    resil.watchdog.touch()
    return restart


def _lead_find(pr: Prepared, cfg: Config, log=None,
               before_epoch: Optional[int] = None):
    """The rollback's checkpoint at P > 1: rank 0's pick and read, handed
    to every rank, so that no two ranks restore different files."""
    return lead_read(pr, lambda: ckpt.latest_valid_checkpoint(
        cfg, log=log, before_epoch=before_epoch))


def _save_periodic(pr: Prepared, epoch: int, full: dict, opt_j: dict,
                   best_acc: float, seed: int, nonce: int,
                   rnonce: int = 0, tune: Optional[dict] = None) -> None:
    """Rank 0's periodic (or preemption) checkpoint of `epoch`, pruned to
    cfg.keep_ckpt; `extra` carries the retry nonce, under --elastic on or
    once a resize happened the resize nonce, and under --tune the
    controller's state (`tune`), as the JAX package's
    (bnsgcn_tpu/run.py:1087-1097)."""
    cfg, spec = pr.cfg, pr.spec
    extra = {"retry_nonce": nonce}
    if cfg.elastic == "on" or rnonce:
        extra["resize_nonce"] = rnonce
    if tune is not None:
        extra["tune"] = tune
    ckpt.save_checkpoint(
        ckpt.periodic_path(cfg, epoch), params=params_to_jax(full, spec),
        opt_state=opt_j, bn_state=bn_state_to_jax(full, spec), epoch=epoch,
        best_acc=best_acc, seed=seed, extra=extra)
    ckpt.prune_checkpoints(cfg, cfg.keep_ckpt)


def _log_point(pr: Prepared, model: GNN, res: RunResult, epoch: int,
               loss_f: float, full, opt_j, seed: int, nonce: int,
               rnonce: int, best_acc: float, best_state, host, ev_val, modes,
               result_file, mean, clock: str, log, lead: bool,
               launch_lead: bool, save: bool = True, obs=None,
               tune: Optional[dict] = None):
    """A log point's work, in the JAX package's order: the launch's epoch
    line and rank 0's periodic checkpoint (before this point's eval: it
    holds the best of the evals drained so far; none from a state whose
    divergence is not agreed yet, `save`), the previous host eval's drain,
    the barrier, then this point's eval (submitted to the thread, or on the
    ranks). Returns the best (accuracy, parameters)."""
    world, fns = pr.world, pr.fns
    if launch_lead:
        feat_s = ("" if not fns.feat_dims else
                  " | Feat(s) {:.4f}".format(mean(res.feat_times)))
        # after the trace window the traced in-step seconds, [traced]
        traced = res.comm_traced is not None
        log("Process 000 | Epoch {:05d} | Time(s) {:.4f} | Comm(s) "
            "{:.4f} [{}] | Reduce(s) {:.4f}{} | Loss {:.4f}".format(
                epoch, mean(res.epoch_times),
                res.comm_traced if traced else mean(res.comm_times),
                "traced" if traced else clock,
                res.reduce_traced if traced else mean(res.reduce_times),
                feat_s, loss_f))
    if lead and save:
        _save_periodic(pr, epoch, full, opt_j, best_acc, seed, nonce, rnonce,
                       tune)
    if host is not None:
        done = host.drain(res, epoch)
        if done is not None and done[1] > best_acc:
            best_acc, best_state = done[1], done[0]
    if world is not None:
        # the peers wait here, under the wait group's long timeout rather
        # than in the next step's collectives (60 s), for rank 0's
        # checkpoint write and for a previous eval that outlasted these
        # log_every epochs; the eval submitted below runs on while they
        # train
        world.barrier()
    if host is not None:
        host.submit(epoch, full)
    elif ev_val is not None:
        t_ev = time.perf_counter()
        accs = evaluate_mesh("Epoch %05d" % epoch, ev_val[0].eval_forward,
                             model, ev_val[1], ev_val[2], modes,
                             result_file, pr.comm, log)
        res.eval_spans.append((epoch, t_ev, time.perf_counter()))
        res.eval_seconds.append(time.perf_counter() - t_ev)
        if obs is not None:
            obs.emit("eval", epoch=epoch,
                     **{f"{m}_acc": round(float(accs[m]), 6) for m in modes})
        if accs["val"] > best_acc:
            best_acc, best_state = accs["val"], snapshot(model)
    return best_acc, best_state


def run_training(cfg: Config, g: Optional[Graph] = None, log=print,
                 model_init: Optional[dict] = None,
                 prepared: Optional[Prepared] = None,
                 rank_hook: Optional[Callable[[Prepared], dict]] = None
                 ) -> RunResult:
    """Train cfg: in this process at P=1, on R x P x T spawned ranks
    otherwise.
    `g` is the full graph (loaded from cfg when None); `model_init` (a
    state_dict) replaces the seeded initialization (the parity tests carry
    JAX parameters over); `prepared` reuses an earlier prepare_run of the
    same P=1 cfg (under --tune, of the launch's folded levers); `rank_hook`
    (P > 1, a module-level function) runs in every
    rank on its prepared part before the epoch loop and the launch
    counters' reset, its result in the rank's report under 'hook'. With a
    rank coordinator (Control) the launch first makes the JAX package's
    set-up exchanges: the partition barrier, the seed, the agreed resume."""
    # a malformed or unported term exits 2 before any rank starts, under
    # --resilience off too (where no fault fires)
    check_inject(cfg.inject or os.environ.get("BNSGCN_FAULT", ""))
    if (cfg.coord_world > 1 and not cfg.skip_partition
            and (cfg.resilience != "on" or cfg.coord == "off")):
        # the harness's partition barrier is the coordinator's
        # (bnsgcn_tpu/main.py:76-88)
        raise ConfigError(
            "--coord-world > 1 with coordination disabled (--coord off / "
            "--resilience off) has no cross-process partition barrier: "
            "pre-partition with partition_cli and pass --skip-partition")
    if cfg.n_partitions > 1 or cfg.replicas > 1 or cfg.feat > 1:
        return run_parts(cfg, g, log, model_init, rank_hook)
    ctl = open_control(cfg, log)
    try:
        cfg = tune_launch(cfg, ctl, log)
        box = {}

        def build(skip):
            # P=1's artifacts are in memory (a directory only under
            # --skip-partition or the streaming builder, loaded when there)
            if prepared is None:
                box["pr"] = prepare_run(cfg, g, log)

        parts_ready(cfg, ctl, build)
        synced, resume_from = harness_sync(cfg, ctl, log)
        pr = prepared if prepared is not None else box["pr"]
        if synced.seed != pr.cfg.seed:
            pr = dataclasses.replace(pr, cfg=pr.cfg.replace(seed=synced.seed))
        return train_loop(pr, model_init, log, resume_from, ctl=ctl)[0]
    finally:
        ctl.close()


# ----------------------------------------------------------------------------
# P > 1
# ----------------------------------------------------------------------------

def artifacts_dir(cfg: Config) -> str:
    return os.path.join(cfg.part_path,
                        cfg.graph_name or cfg.derive_graph_name())


def streams(cfg: Config, g: Graph) -> bool:
    """Whether the artifacts of `g` go through the streaming builder:
    --streaming-artifacts always, or auto above STREAMING_MIN_EDGES edges."""
    return (cfg.streaming_artifacts == "always" or
            (cfg.streaming_artifacts == "auto"
             and g.n_edges > STREAMING_MIN_EDGES))


def prepare_partition(cfg: Config, g: Optional[Graph] = None,
                      force: bool = False, load: bool = True
                      ) -> Optional[PartitionArtifacts]:
    """Offline partitioning (bnsgcn_tpu/run.py prepare_partition) of `g`,
    the train graph (or an eval graph under its eval_cfg); without `g`, of
    the dataset's graph, or under --inductive its train subgraph. The
    artifact directory is loaded when it exists, as the reference's
    config-JSON check does, unless `force`; under --skip-partition it must
    exist. The streaming builder writes it when `streams` says so, with the
    features stored as --feat-storage; else the in-memory builder. `load=
    False` returns None instead of loading the directory."""
    path = artifacts_dir(cfg)
    exists = os.path.exists(os.path.join(path, "meta.json"))
    if not force and (exists or cfg.skip_partition):
        if not exists:
            raise ConfigError(
                f"--skip-partition: no partition artifacts at {path}; write "
                f"them first with python -m bnsgcn_tpu_torch.partition_cli "
                f"and the same flags")
        return load_artifacts(path) if load else None
    if g is None:
        g, _, _ = load_data(cfg)
        if cfg.inductive:
            g = g.subgraph(g.train_mask)
    pid = partition_graph(g, cfg.n_partitions, method=cfg.partition_method,
                          obj=cfg.partition_obj, seed=cfg.seed)
    if streams(cfg, g):
        build_artifacts_streaming(g, pid, path, feat_dtype=cfg.feat_storage,
                                  log=print)
        return load_artifacts(path) if load else None
    art = build_artifacts(g, pid)
    save_artifacts(art, path)
    return art if load else None


def _prebuild(cfg: Config) -> None:
    """Build every native library the ranks load before spawning them, so
    P ranks never compile the same library at once."""
    from bnsgcn_tpu_torch import native
    specs = [(native.LIB_NAME, "cxx", [native.SOURCE])]
    if cfg.device == "cuda":
        specs += [(name, "cuda", [src])
                  for m in (bucket_sum, tile_matmul, dropout)
                  for name, src in m.BUILDS]
    buildlib.build_many(specs)


def rank_axes(ctx: RankContext, cfg: Config) -> Optional[Axes]:
    """The rank's replica and feat axes (every rank creates every group),
    or None at R = T = 1."""
    return make_axes(ctx.comm, cfg.replicas, cfg.n_partitions, cfg.feat)


def prepare_rank(ctx: RankContext, cfg: Config, path: str,
                 eval_graphs: Optional[tuple], log,
                 axes: Optional[Axes] = None) -> Prepared:
    """The rank's part of the artifacts at `path`, loaded alone, with the
    --reorder pass applied before its layouts and their digest
    (bnsgcn_tpu/run.py:317-321), prepared (prepare_part). The part is
    ctx.rank, or with `axes` (rank_axes) axes.p, over its 'parts' group
    (none at P = 1)."""
    part, comm = ctx.rank, ctx.comm
    if axes is not None:
        part, comm = axes.p, (axes.parts if axes.P > 1 else None)
    art = load_artifacts(path, parts=[part])
    art, resolved, info = maybe_reorder(cfg, art, log, comm, part)
    pr = prepare_part(cfg.replace(reorder=resolved), art, eval_graphs,
                      ctx.device, log, part, comm, axes=axes)
    pr.reorder_info = info
    return pr


def node_comm(ctx: RankContext, cfg: Config) -> Comm:
    """The Comm of this rank's launch in a multi-node run (--n-nodes > 1):
    its node's ranks, over a gloo group with the wait group's timeout.
    Every rank creates every node's group, in node order."""
    import datetime

    import torch.distributed as dist

    from bnsgcn_tpu_torch.parallel.mesh import WAIT_TIMEOUT_S
    mine = None
    for k in range(cfg.n_nodes):
        ranks = list(node_ranks(cfg.replace(node_rank=k)))
        grp = dist.new_group(ranks, backend="gloo",
                             timeout=datetime.timedelta(
                                 seconds=WAIT_TIMEOUT_S))
        if ctx.rank in ranks:
            mine = (ranks, grp)
    return ctx.comm.sub(*mine)


def _rank_main(ctx: RankContext, cfg: Config, path: str,
               model_init: Optional[dict], eval_graphs: Optional[tuple],
               rank_hook: Optional[Callable[[Prepared], dict]],
               resume_from: Optional[str],
               ctl: Optional[Control] = None) -> dict:
    """One rank of an R x P x T > 1 run: load its part, train (from rank
    0's read of the checkpoint on every rank when resuming), check
    replication, report. The launch's first rank logs and, with a
    coordinator (`ctl`), carries the launcher's exchanges on."""
    ctl = ctl if ctl is not None else Control()
    launch = node_comm(ctx, cfg) if ctl.on and cfg.n_nodes > 1 else None
    first = ctx.rank == node_ranks(cfg).start
    log = ctx.log if first else (lambda m: None)
    axes = rank_axes(ctx, cfg)
    pr = prepare_rank(ctx, cfg, path, eval_graphs, log, axes)
    hook = rank_hook(pr) if rank_hook is not None else None
    ctx.comm.barrier()          # the ranks build their layouts at own speeds
    bucket_sum.launches.reset()
    tile_matmul.launches.reset()
    dropout.launches.reset()
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    res, model = train_loop(pr, model_init, log, resume_from, ctx, ctl,
                            launch)
    if cfg.eval:
        ctx.comm.barrier()          # rank 0's final checkpoint and eval
    assert_replicated(model.parameters(), ctx.comm,
                      [pr.fns.feat_dims.get(n) for n, _ in
                       model.named_parameters()],
                      axes.f if axes is not None else 0)
    return {
        "rank": ctx.rank, "device": str(ctx.device),
        "replica": axes.r if axes is not None else 0, "part": pr.rank,
        "feat": axes.f if axes is not None else 0,
        "losses": res.losses, "epoch_times": res.epoch_times,
        "epoch_time": res.epoch_time, "start_epoch": res.start_epoch,
        "comm_times": res.comm_times, "reduce_times": res.reduce_times,
        "feat_times": res.feat_times,
        "launches": {"K1": dict(bucket_sum.launches.by_phase),
                     "K2": dict(tile_matmul.launches.by_phase)},
        "kinds": {"K1": dict(bucket_sum.launches.by_kind),
                  "K2": dict(tile_matmul.launches.by_kind)},
        "d1": {"phases": dict(dropout.launches.by_phase),
               "kinds": dict(dropout.launches.by_kind)},
        "max_memory_bytes": (torch.cuda.max_memory_allocated(ctx.device)
                             if ctx.device.type == "cuda" else None),
        "dense_edges": res.dense_edges, "n_edges": res.n_edges,
        "best_val_acc": res.best_val_acc, "val_acc": res.val_acc,
        "test_acc": res.test_acc, "eval_seconds": res.eval_seconds,
        "eval_spans": res.eval_spans, "drain_waits": res.drain_waits,
        "epoch_starts": res.epoch_starts, "loop_seconds": res.loop_seconds,
        "layout_times": pr.fns.layout_times, "hook": hook,
        "rollbacks": res.rollbacks, "agree_times": res.agree_times,
        "coord_times": res.coord_times, "relay_times": res.relay_times,
        "clean": res.clean, "comm_traced": res.comm_traced,
        "reduce_traced": res.reduce_traced,
        "tune_decisions": res.tune_decisions,
        "retune_seconds": res.retune_seconds, "strict": res.strict,
    }


def run_parts(cfg: Config, g: Optional[Graph] = None, log=print,
              model_init: Optional[dict] = None,
              rank_hook: Optional[Callable[[Prepared], dict]] = None
              ) -> RunResult:
    """R x P x T > 1: this node's launcher. Node 0's (the only one by
    default)
    picks the checkpoint to resume from, writes the artifacts unless
    --skip-partition (under --eval-device mesh with --inductive the eval
    graphs' '-val' and '-test' too) and builds the native libraries; with
    --n-nodes > 1 it then hands its seed and resume choice, through the
    NodeStore it serves, to the other nodes' launchers, which built their
    libraries meanwhile and adopt both (the JAX package's
    broadcast_one_to_all and sync_global_devices). A launcher
    reads only the artifacts' meta.json and shared.npz, never a part: each
    rank loads its own. Each then spawns its ranks (config.node_ranks) into
    one world of R x P x T; under --eval-device host global rank 0 alone
    gets the
    eval graphs. The result is this node's first rank's, with every local
    rank's report in `ranks`."""
    require_device(cfg.device)
    ranks = node_ranks(cfg)
    R, P, T = cfg.replicas, cfg.n_partitions, cfg.feat
    check_mesh_budget(P, cfg.dist_backend, cfg.device, len(ranks), R, T)
    mesh_eval = cfg.eval and cfg.eval_device == "mesh"
    path = artifacts_dir(cfg)
    t0 = time.perf_counter()
    nodes = (NodeStore(cfg.master_addr, cfg.port, cfg.n_nodes, cfg.node_rank)
             if cfg.n_nodes > 1 else None)
    held = []           # the launch's Control, once open
    try:
        cfg, resume_from, evals = _launcher_setup(cfg, g, log, nodes,
                                                  mesh_eval, held)
        return _launch_ranks(cfg, log, model_init, rank_hook, ranks, path,
                             resume_from, evals, held[0], t0)
    finally:
        for ctl in held:
            ctl.close()


def _launcher_setup(cfg: Config, g: Optional[Graph], log, nodes,
                    mesh_eval: bool, held: list):
    """run_parts before the spawn: (cfg with the run's seed, the checkpoint
    to resume from or None, the eval graphs for rank 0 or None); the
    launch's Control goes to `held` as soon as it is open. Node 0's launcher (every harness launch's) opens
    the coordinator, builds or checks the artifacts behind the harness's
    partition barrier, agrees the seed and the resume, and hands the seed,
    the resume choice and the coordinator's port to the other nodes'."""
    val_g = test_g = resume_from = None
    if cfg.node_rank == 0:
        try:
            ctl = open_control(cfg, log,
                               node_coord_port(cfg) if nodes else None)
            held.append(ctl)
            cfg = tune_launch(cfg, ctl, log)
            harness = harness_mode(cfg, ctl)
            if not harness:
                cfg, resume_from = resume_point(cfg, log)
            host_eval = cfg.eval and not mesh_eval and ctl.rank == 0
            # --dump-embeddings' host branch scores the full graph on rank 0
            host_eval = host_eval or (
                bool(cfg.dump_embeddings) and ctl.rank == 0
                and cfg.n_nodes == 1 and not (mesh_eval and not cfg.inductive))
            builds = not cfg.skip_partition and not (harness and ctl.rank)
            if g is None and (host_eval or builds):
                g, _, _ = load_data(cfg)
            if g is not None:
                train_g, val_g, test_g = split_graphs(cfg, g)
            else:
                train_g = None

            def build(skip):
                c = cfg.replace(skip_partition=True) if skip else cfg
                prepare_partition(c, train_g, load=False)
                if mesh_eval and cfg.inductive:
                    for suffix, sub in (("-val", val_g), ("-test", test_g)):
                        # built when missing (from the graph, which
                        # --skip-partition does not load: then they must
                        # be there, as the training's)
                        prepare_partition(eval_cfg(c, suffix), sub,
                                          load=False)

            parts_ready(cfg, ctl, build)
            if harness:
                cfg, resume_from = harness_sync(cfg, ctl, log)
            if not host_eval:
                val_g = test_g = None
            del g, train_g          # no graph in the launcher while it trains
            _prebuild(cfg)
        except BaseException as e:
            if nodes is not None:
                nodes.publish("ready", {"error": f"{type(e).__name__}: {e}"})
            raise
        if nodes is not None:
            nodes.publish("ready", {
                "seed": cfg.seed, "resume_from": resume_from,
                "coord_port": (ctl.coord.transport.port if ctl.coord
                               is not None and cfg.coord != "file" else None)})
    else:
        _prebuild(cfg)
        got = nodes.fetch("ready")
        if "error" in got:
            raise RuntimeError(f"node 0 failed before the launch: "
                               f"{got['error']}")
        cfg, resume_from = cfg.replace(seed=got["seed"]), got["resume_from"]
        log(f"seed {cfg.seed} (node 0's)"
            + (f"; resuming from {resume_from}" if resume_from else ""))
        ctl = open_control(cfg, log, got.get("coord_port"))
        held.append(ctl)
        cfg = tune_launch(cfg, ctl, log)
    if nodes is not None:
        node_resume_ack(ctl, resume_from)
    evals = (val_g, test_g) if val_g is not None else None
    return cfg, resume_from, evals


def _launch_ranks(cfg: Config, log, model_init, rank_hook, ranks: range,
                  path: str, resume_from: Optional[str], evals,
                  ctl: Control, t0: float) -> RunResult:
    """run_parts from the Mesh line on: spawn this node's ranks and map
    their outcome."""
    R, P, T = cfg.replicas, cfg.n_partitions, cfg.feat
    meta = read_meta(path)
    strategy, _ = resolve_strategy(cfg, meta.n_b, meta.pad_inner,
                                   meta.pad_boundary, cfg.sampling_rate)
    hspec, _ = make_halo_spec(meta.n_b, meta.pad_inner, meta.pad_boundary,
                              cfg.sampling_rate, strategy=strategy,
                              wire=cfg.halo_wire)
    hfull, _ = full_rate_spec(meta.n_b, meta.pad_inner, meta.pad_boundary)
    nb = 2 if cfg.dtype == "bfloat16" else 4     # the native wire's bytes
    # the halo label of the JAX package's Mesh line (bnsgcn_tpu/run.py:
    # 447-517): the resolved strategy, +ovl, +go or +hrK; the ranks log the
    # auto pick and the fallbacks
    refresh_k, grad_only = resolve_halo_mode(cfg, log=lambda m: None)
    overlap, _ = resolve_overlap(cfg, cfg.model, grad_only)
    label = (f"auto->{strategy}" if cfg.halo_exchange == "auto"
             else strategy)
    label += "+ovl" if overlap == "split" else ""
    label += ("+go" if grad_only else
              f"+hr{refresh_k}" if refresh_k > 1 else "")
    # the replica and feat axes (bnsgcn_tpu/run.py:455-483): each replica
    # row runs its own exchange, so the wire MB are per replica; a feat
    # shard's GCN / GraphSAGE exchange carries its H/T slice (GAT's stays
    # full width: it shards heads)
    label += f"+rep{R}" if R > 1 else ""
    label += f"+feat{T}" if T > 1 else ""
    hid_w = shard_width(cfg.n_hidden, T, cfg.model in ("gcn", "graphsage"))
    peak_mb = wire_bytes(hspec, hid_w, nb) / 1e6
    devs = [str(rank_device(cfg.device, cfg.dist_backend, i))
            for i in range(len(ranks))]
    staged = cfg.dist_backend == "gloo" and cfg.device == "cuda"
    where = ("" if cfg.n_nodes == 1 else
             f" | node {cfg.node_rank} of {cfg.n_nodes}: ranks "
             f"{ranks.start}..{ranks.stop - 1}")
    shape = (f"{P} ranks" if R * T == 1 else
             f"{mesh_desc(R, P, T)} = {R * P * T} ranks")
    per_rep = "/replica" if R > 1 else ""
    feat_note = (f" (H/T={hid_w} of {cfg.n_hidden} on the parts wire: "
                 f"~{cfg.n_hidden // max(hid_w, 1)}x less than feat=1)"
                 if hid_w != cfg.n_hidden else "")
    log(f"Mesh: {shape} | {cfg.dist_backend}"
        + (" (collectives staged through host memory)" if staged else "")
        + f"{where} | devices {','.join(devs)} | pad_inner={meta.pad_inner} "
        f"pad_boundary={meta.pad_boundary} pad_send={hspec.pad_send} "
        f"edges/part={meta.pad_edges} | {cfg.dtype} spmm={cfg.spmm} "
        f"gather={cfg.spmm_gather} dense={cfg.spmm_dense} | halo "
        f"{label}/{hspec.wire} at sampling rate {cfg.sampling_rate:g}: "
        f"{peak_mb:.2f} MB/exchange/rank{per_rep} at hidden width "
        f"{cfg.n_hidden}{feat_note} "
        f"({wire_bytes(hfull, meta.n_feat, nb) / 1e6:.2f} MB at feature "
        f"width {meta.n_feat}, the precompute's full-rate exchange) | "
        f"artifacts {path}"
        + (f" ({meta.feat_dtype} features)"
           if meta.feat_dtype != "float32" else "")
        + f" {time.perf_counter() - t0:.1f}s")
    note = unshardable_note(spec_from_config(cfg.replace(
        n_feat=meta.n_feat, n_class=meta.n_class)), T)
    if note is not None:
        # the JAX package's stderr line (bnsgcn_tpu/trainer.py:447-461)
        print(note, file=sys.stderr)
    if grad_only:
        log("  halo grad-only: 0.00 MB/exchange steady-state (no activation "
            "exchange; the gradient all-reduce is the only collective)")
    elif refresh_k > 1:
        hspec_r, _ = make_refresh_spec(meta.n_b, meta.pad_inner,
                                       meta.pad_boundary, cfg.sampling_rate,
                                       refresh_k, strategy=strategy,
                                       wire=cfg.halo_wire)
        steady_mb = wire_bytes(hspec_r, hid_w, nb) / 1e6
        log(f"  halo refresh K={refresh_k}: peak {peak_mb:.2f} MB/exchange "
            f"(full-refresh epochs), steady-state {steady_mb:.2f} MB "
            f"({steady_mb / max(peak_mb, 1e-12):.0%} of peak)")
    ctl_r = ctl.for_ranks()
    try:
        reports = launch(
            _rank_main, R * P * T,
            [(cfg, path, model_init, evals if r == 0 else None, rank_hook,
              resume_from, ctl_r) for r in ranks],
            cfg.dist_backend, cfg.device, log=log, ranks=ranks,
            addr=cfg.master_addr if cfg.n_nodes > 1 else "127.0.0.1",
            port=cfg.port + 1 if cfg.n_nodes > 1 else None,
            forward_signals=cfg.resilience == "on",
            forward_profile=cfg.resilience == "on" and wants_obs(cfg))
    except RankExit as e:
        # the ranks' PreemptedError (75), DivergenceError (76), StepHung or
        # CoordTimeout (77), CoordAbort (78) or RankLostExit (0), as a P=1
        # run raises them
        exc = e.exc
        if exc is not None and (e.code != 77 or isinstance(exc, CoordTimeout)):
            raise exc from None
        raise StepHung(str(e)) from None
    lead = reports[0]
    # one copy of each part: replica 0's, feat shard 0's
    parts = reports if R * T == 1 else dedup_replica0(reports, R, P, T)
    return RunResult(
        losses=lead["losses"], epoch_times=lead["epoch_times"],
        epoch_time=lead["epoch_time"], start_epoch=lead["start_epoch"],
        comm_times=lead["comm_times"], reduce_times=lead["reduce_times"],
        feat_times=lead["feat_times"],
        best_val_acc=lead["best_val_acc"], val_acc=lead["val_acc"],
        test_acc=lead["test_acc"], eval_seconds=lead["eval_seconds"],
        eval_spans=lead["eval_spans"], drain_waits=lead["drain_waits"],
        epoch_starts=lead["epoch_starts"],
        loop_seconds=lead["loop_seconds"],
        dense_edges=sum(r["dense_edges"] for r in parts),
        n_edges=sum(r["n_edges"] for r in parts), ranks=reports,
        rollbacks=lead["rollbacks"], agree_times=lead["agree_times"],
        coord_times=lead["coord_times"], relay_times=lead["relay_times"],
        clean=lead["clean"], comm_traced=lead["comm_traced"],
        reduce_traced=lead["reduce_traced"],
        tune_decisions=lead["tune_decisions"],
        retune_seconds=lead["retune_seconds"], strict=lead["strict"])
