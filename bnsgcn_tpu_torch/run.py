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
epoch, rank), so the resumed epochs replay the uninterrupted run's. The resilience and coordination layers
wait for later slices.

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
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from bnsgcn_tpu_torch import buildlib
from bnsgcn_tpu_torch import checkpoint as ckpt
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
from bnsgcn_tpu_torch.parallel.halo import (full_rate_spec, make_halo_spec,
                                            make_refresh_spec, wire_bytes)
from bnsgcn_tpu_torch.parallel.mesh import (Comm, NodeStore, RankContext,
                                            check_mesh_budget, launch,
                                            rank_device)
from bnsgcn_tpu_torch.parallel.reducer import (assert_replicated,
                                               broadcast_parameters)
from bnsgcn_tpu_torch.parallel.replicas import (Axes, dedup_replica0,
                                                make_axes, mesh_desc)
from bnsgcn_tpu_torch.trainer import (StepFns, build_block_arrays,
                                      bn_state_to_jax, build_step_fns,
                                      compute_dtype, dropout_key,
                                      local_row, make_tx, opt_state_from_jax,
                                      opt_state_to_jax, params_from_jax,
                                      params_to_jax, resolve_halo_mode,
                                      resolve_overlap, resolve_strategy,
                                      to_device, with_bn_state)

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
    start_epoch + i: what EpochTimer(warmup=5).means() gives for the same
    values; 0.0 when no epoch is past the warm-up."""
    xs = xs[max(WARMUP_EPOCHS - start_epoch, 0):]
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
    art, resolved, _ = maybe_reorder(cfg, p1_artifacts(cfg, train_g), log)
    return prepare_part(cfg.replace(reorder=resolved), art, (val_g, test_g),
                        device, log)


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

    def __init__(self, pr: Prepared, model: GNN, log, result_file):
        self.pr, self.log, self.result_file = pr, log, result_file
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
        return done

    def close(self, wait: bool = True) -> None:
        if wait:
            self.pool.shutdown(wait=True)
            if self.stream is not None:
                self.stream.synchronize()
        else:
            self.pool.shutdown(wait=False, cancel_futures=True)


def train_loop(pr: Prepared, model_init: Optional[dict] = None,
               log=print, resume_from: Optional[str] = None
               ) -> tuple[RunResult, GNN]:
    """The epoch loop of one process (P=1) or one rank, from epoch 0 or,
    with `resume_from` (a periodic checkpoint), from the epoch after it.
    Every `log_every` epochs, in the JAX package's order
    (bnsgcn_tpu/run.py:1693-1745): rank 0 logs and writes a periodic
    checkpoint, pruned to cfg.keep_ckpt; with cfg.eval, under
    --eval-device host rank 0 drains the previous evaluation and submits
    this epoch's to its thread (HostEval), under --eval-device mesh every
    rank joins the evaluation on the ranks. An evaluation becomes the best
    only if its accuracy is above the best so far, from 0.0. After the
    loop: the last drain, and only if an evaluation ran, rank 0's final
    checkpoint of the best parameters and their `Test Result` accuracy on
    the full graph's test mask (on a copy; on the ranks under mesh). The
    epoch time is taken after the step's gradient all-reduce and ends in
    float(loss). Returns the trained model, which every rank holds
    alike."""
    cfg, spec, fns, device, comm = pr.cfg, pr.spec, pr.fns, pr.device, pr.comm
    world, axes = pr.world, pr.axes
    lead = world is None or world.rank == 0
    # under a feat axis rank 0's feat group gathers the full parameters and
    # moments for its checkpoints and host evals (a collective of the group)
    gathers = lead or (bool(fns.feat_dims) and axes.r == 0 and axes.p == 0)
    replica = axes.replica if axes is not None else None
    mesh_eval = cfg.eval and cfg.eval_device == "mesh"
    res = RunResult(dense_edges=fns.dense_edges, n_edges=pr.n_edges)
    blk, model, opt = init_training(pr, model_init)
    seed, best_acc, best_state = cfg.seed, 0.0, None
    if resume_from is not None:
        payload = lead_read(pr, lambda: ckpt.read_blob(resume_from))
        model.load_state_dict(fns.shard_state(params_from_jax(
            payload["params"], spec, payload.get("bn_state"))))
        opt_state_from_jax(payload["opt_state"], opt, model, fns.shard_state)
        res.start_epoch = int(payload["epoch"]) + 1
        seed, best_acc = int(payload["seed"]), float(payload["best_acc"])
        log(f"Resumed from {resume_from} at epoch {res.start_epoch}")
        # every rank holds the best parameters under mesh (the final test
        # eval is collective), rank 0 alone under host
        final = None
        if best_acc > 0 and mesh_eval:
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
    result_file = None
    if lead and cfg.eval:
        os.makedirs(cfg.results_path, exist_ok=True)
        result_file = results_file(cfg)
    ev_val = mesh_eval_part(pr, "-val", log) if mesh_eval else None
    modes = ("val",) if cfg.inductive else ("val", "test")
    host = (HostEval(pr, model, log, result_file)
            if cfg.eval and lead and not mesh_eval else None)

    def mean(xs):
        return warm_mean(xs, res.start_epoch)

    clock = "P=1" if world is None else (
        "events" if device.type == "cuda" else "host")
    # --halo-refresh K > 1: the halo cache, held on the device by this
    # process and never checkpointed. None runs the next step on the full
    # exchange, which rebuilds it: at the run's start and after a resume
    # (bnsgcn_tpu/run.py:1074-1080)
    use_refresh = fns.train_step_full is not None
    halo_cache = None
    cache_reason = "resume" if res.start_epoch > 0 else "start"
    t_loop = time.perf_counter()
    try:
        for epoch in range(res.start_epoch, cfg.n_epochs):
            if world is not None:
                world.reset_seconds()
            key = dropout_key(seed, epoch, pr.rank, replica)
            t_ep = time.perf_counter()
            res.epoch_starts.append(t_ep)
            refresh_full = use_refresh and halo_cache is None
            if refresh_full:
                loss, halo_cache = fns.train_step_full(model, opt, blk,
                                                       epoch, key)
            elif use_refresh:
                loss, halo_cache = fns.train_step_cached(
                    model, opt, blk, epoch, key, halo_cache)
            else:
                loss = fns.train_step(model, opt, blk, epoch, key)
            loss_f = float(loss)                    # waits for the device
            dt = time.perf_counter() - t_ep
            secs = (world.seconds() if world else
                    {"exchange": 0.0, "reduce": 0.0, "feat": 0.0})
            res.losses.append(loss_f)
            res.epoch_times.append(dt)
            res.comm_times.append(secs["exchange"])
            res.reduce_times.append(secs["reduce"])
            res.feat_times.append(secs["feat"])
            if refresh_full:
                log(f"  halo cache: full refresh at epoch {epoch} "
                    f"({cache_reason}); next {fns.halo_refresh - 1}+ epochs "
                    f"reuse cached blocks")
            if not np.isfinite(loss_f):
                raise FloatingPointError(f"epoch {epoch}: loss is {loss_f}")
            if (epoch + 1) % cfg.log_every != 0:
                continue
            full = opt_j = None
            if gathers:
                full = fns.full_state(model.state_dict())
                opt_j = opt_state_to_jax(opt, model, fns.full_state)
            if lead:
                feat_s = ("" if not fns.feat_dims else
                          " | Feat(s) {:.4f}".format(mean(res.feat_times)))
                log("Process 000 | Epoch {:05d} | Time(s) {:.4f} | Comm(s) "
                    "{:.4f} [{}] | Reduce(s) {:.4f}{} | Loss {:.4f}".format(
                        epoch, mean(res.epoch_times), mean(res.comm_times),
                        clock, mean(res.reduce_times), feat_s, loss_f))
                # periodic checkpoint whether or not eval runs, before this
                # log point's eval: it holds the best of the evals drained
                # so far
                ckpt.save_checkpoint(
                    ckpt.periodic_path(cfg, epoch),
                    params=params_to_jax(full, spec),
                    opt_state=opt_j,
                    bn_state=bn_state_to_jax(full, spec),
                    epoch=epoch,
                    best_acc=best_acc, seed=seed, extra={"retry_nonce": 0})
                ckpt.prune_checkpoints(cfg, cfg.keep_ckpt)
            if host is not None:
                done = host.drain(res, epoch)
                if done is not None and done[1] > best_acc:
                    best_acc, best_state = done[1], done[0]
            if world is not None:
                # the peers wait here, under the wait group's long timeout
                # rather than in the next step's collectives (60 s), for
                # rank 0's checkpoint write and for a previous eval that
                # outlasted these log_every epochs; the eval submitted
                # below runs on while they train
                world.barrier()
            if host is not None:
                host.submit(epoch, full)
            elif mesh_eval:
                t_ev = time.perf_counter()
                accs = evaluate_mesh("Epoch %05d" % epoch,
                                     ev_val[0].eval_forward, model,
                                     ev_val[1], ev_val[2], modes,
                                     result_file, comm, log)
                res.eval_spans.append((epoch, t_ev, time.perf_counter()))
                res.eval_seconds.append(time.perf_counter() - t_ev)
                if accs["val"] > best_acc:
                    best_acc, best_state = accs["val"], snapshot(model)
    except BaseException:
        if host is not None:
            host.close(wait=False)
        raise
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
    return res, model


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
    same P=1 cfg; `rank_hook` (P > 1, a module-level function) runs in every
    rank on its prepared part before the epoch loop and the launch
    counters' reset, its result in the rank's report under 'hook'."""
    if cfg.n_partitions > 1 or cfg.replicas > 1 or cfg.feat > 1:
        return run_parts(cfg, g, log, model_init, rank_hook)
    cfg, resume_from = resume_point(cfg, log)
    pr = prepared if prepared is not None else prepare_run(cfg, g, log)
    return train_loop(pr, model_init, log, resume_from)[0]


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
    art, resolved, _ = maybe_reorder(cfg, art, log, comm, part)
    return prepare_part(cfg.replace(reorder=resolved), art, eval_graphs,
                        ctx.device, log, part, comm, axes=axes)


def _rank_main(ctx: RankContext, cfg: Config, path: str,
               model_init: Optional[dict], eval_graphs: Optional[tuple],
               rank_hook: Optional[Callable[[Prepared], dict]],
               resume_from: Optional[str]) -> dict:
    """One rank of an R x P x T > 1 run: load its part, train (from rank
    0's read of the checkpoint on every rank when resuming), check
    replication, report."""
    lead = ctx.rank == 0
    log = ctx.log if lead else (lambda m: None)
    axes = rank_axes(ctx, cfg)
    pr = prepare_rank(ctx, cfg, path, eval_graphs, log, axes)
    hook = rank_hook(pr) if rank_hook is not None else None
    ctx.comm.barrier()          # the ranks build their layouts at own speeds
    bucket_sum.launches.reset()
    tile_matmul.launches.reset()
    dropout.launches.reset()
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    res, model = train_loop(pr, model_init, log, resume_from)
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
    val_g = test_g = resume_from = None
    if cfg.node_rank == 0:
        try:
            cfg, resume_from = resume_point(cfg, log)
            host_eval = cfg.eval and not mesh_eval
            if g is None and (host_eval or not cfg.skip_partition):
                g, _, _ = load_data(cfg)
            if g is not None:
                train_g, val_g, test_g = split_graphs(cfg, g)
            else:
                train_g = None
            prepare_partition(cfg, train_g, load=False)
            if mesh_eval and cfg.inductive:
                for suffix, sub in (("-val", val_g), ("-test", test_g)):
                    # built when missing (from the graph, which
                    # --skip-partition does not load: then they must be
                    # there, as the training's)
                    prepare_partition(eval_cfg(cfg, suffix), sub, load=False)
            if not host_eval:
                val_g = test_g = None
            del g, train_g          # no graph in the launcher while it trains
            _prebuild(cfg)
        except BaseException as e:
            if nodes is not None:
                nodes.publish("ready", {"error": f"{type(e).__name__}: {e}"})
            raise
        if nodes is not None:
            nodes.publish("ready", {"seed": cfg.seed,
                                    "resume_from": resume_from})
    else:
        _prebuild(cfg)
        got = nodes.fetch("ready")
        if "error" in got:
            raise RuntimeError(f"node 0 failed before the launch: "
                               f"{got['error']}")
        cfg, resume_from = cfg.replace(seed=got["seed"]), got["resume_from"]
        log(f"seed {cfg.seed} (node 0's)"
            + (f"; resuming from {resume_from}" if resume_from else ""))
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
    evals = (val_g, test_g) if val_g is not None else None
    reports = launch(
        _rank_main, R * P * T,
        [(cfg, path, model_init, evals if r == 0 else None, rank_hook,
          resume_from) for r in ranks],
        cfg.dist_backend, cfg.device, log=log, ranks=ranks,
        addr=cfg.master_addr if cfg.n_nodes > 1 else "127.0.0.1",
        port=cfg.port + 1 if cfg.n_nodes > 1 else None)
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
        n_edges=sum(r["n_edges"] for r in parts), ranks=reports)
