"""The training loop (counterpart of bnsgcn_tpu/run.py `run_training`).

P=1 runs in this process: graph -> P=1 artifacts in memory -> SpMM layout ->
use_pp precompute -> `n_epochs` epochs printing the JAX package's epoch line
-> a full-graph eval every `log_every` epochs -> the best-validation
parameters' accuracy line.

P > 1 runs one process per part (parallel/mesh.py): this process builds the
graph and writes the partition artifacts once (host numpy only), then
spawns P ranks. Rank r loads only part r, builds its own layout and runs the
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
on. Every `log_every` epochs rank 0 appends the eval line to the results
file and writes a periodic checkpoint in the JAX package's format
(checkpoint.py); after the loop, the best-validation parameters' final
checkpoint. --resume continues from the newest valid periodic checkpoint
with its parameters, optimizer, seed and best accuracy; each epoch's
dropout is keyed by (seed, epoch, rank), so the resumed epochs replay the
uninterrupted run's. The resilience and coordination layers wait for later
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
from bnsgcn_tpu_torch import checkpoint as ckpt
from bnsgcn_tpu_torch.config import Config, ConfigError
from bnsgcn_tpu_torch.data.artifacts import (PartitionArtifacts,
                                             build_artifacts, load_artifacts,
                                             save_artifacts)
from bnsgcn_tpu_torch.data.datasets import load_data
from bnsgcn_tpu_torch.data.graph import Graph, inductive_split
from bnsgcn_tpu_torch.data.partitioner import partition_graph
from bnsgcn_tpu_torch.evaluate import evaluate_induc, evaluate_trans
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
                                      build_step_fns, compute_dtype,
                                      dropout_generator,
                                      local_row, make_tx, opt_state_from_jax,
                                      opt_state_to_jax, params_from_jax,
                                      params_to_jax, to_device)

# epochs excluded from the Time(s), Comm(s) and Reduce(s) means, as the JAX
# package's EpochTimer(warmup=5) and the reference (train.py:415) exclude
# them: the epoch numbers 0-4, whether or not this run executed them
WARMUP_EPOCHS = 5

TRAIN_KEYS = ("feat", "label", "train_mask", "in_norm", "out_norm")


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
    eval_seconds: list = field(default_factory=list)  # rank 0's evals, the
                                       # final one last (host clock; each
                                       # ends in a copy to the host)
    best_val_acc: float = 0.0
    val_acc: float = 0.0               # of the final evaluation (inductive:
                                       # the best validation accuracy)
    test_acc: float = 0.0
    dense_edges: int = 0
    n_edges: int = 0
    ranks: list = field(default_factory=list)   # P > 1: each rank's report


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
    rank: int = 0
    comm: Optional[Comm] = None        # None at P=1
    art: Optional[PartitionArtifacts] = None   # what the layout came from


def prepare_part(cfg: Config, art: PartitionArtifacts,
                 eval_graphs: Optional[tuple], device, log, rank: int = 0,
                 comm: Optional[Comm] = None,
                 reuse: Optional[StepFns] = None, **spmm_kw) -> Prepared:
    """Artifacts -> this part's SpMM layout (on the device) -> block arrays.
    `eval_graphs` is (val graph, test graph) where eval runs, else None. The
    use_pp precompute is the first step of the loop. `reuse` and `spmm_kw`
    (row_cap) go to trainer.build_step_fns: another dtype configuration of
    an earlier prepared run reuses its layout."""
    set_float32_math()
    cfg = cfg.replace(n_feat=art.n_feat, n_class=art.n_class,
                      n_train=art.n_train)
    spec = spec_from_config(cfg)
    t0 = time.perf_counter()
    fns = build_step_fns(cfg, spec, art, device, log=log, rank=rank,
                         comm=comm, reuse=reuse, **spmm_kw)
    row = local_row(art, rank)
    n_edges = int((art.dst[row] < art.pad_inner).sum())
    log(("Graph: " if comm is None else f"Part {rank} of {art.n_parts}: ")
        + f"{int(art.n_inner[rank])} nodes, {n_edges} edges, "
        f"F={art.n_feat}, {art.n_class} classes | {cfg.dtype} "
        f"spmm={fns.spmm_kind} gather={cfg.spmm_gather} "
        f"dense={cfg.spmm_dense} layout {time.perf_counter() - t0:.1f}s"
        + (f" | dense tiles carry {fns.dense_edges} edges "
           f"({fns.dense_edges / max(n_edges, 1):.1%})"
           if fns.spmm_kind == "hybrid" else ""))
    blk = to_device({k: v for k, v in build_block_arrays(
        art, spec.model).items() if k in TRAIN_KEYS}, device, row)
    val_g, test_g = eval_graphs if eval_graphs is not None else (None, None)
    return Prepared(cfg, spec, val_g, test_g, fns, blk, device, n_edges,
                    rank, comm, art)


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
    art = (prepare_partition(cfg, train_g) if cfg.skip_partition else
           build_artifacts(train_g, partition_graph(train_g, 1)))
    return prepare_part(cfg, art, (val_g, test_g), device, log)


def init_training(pr: Prepared, model_init: Optional[dict] = None):
    """(block arrays with the use_pp precompute applied, model, optimizer)
    for a prepared run. The model is initialized on the host from cfg.seed,
    so the draw does not depend on the device; `model_init` (a state_dict)
    replaces it. Under --dtype bfloat16 the parameters (and so Adam's
    moments) are bf16, and the features are cast to bf16 on the device
    before the precompute, whose result is cast to bf16 too
    (bnsgcn_tpu/run.py:429-438). Under P > 1 every rank then takes rank 0's
    parameters."""
    dtype = compute_dtype(pr.cfg)
    blk = dict(pr.blk)
    blk["feat"] = blk["feat"].to(dtype)
    if pr.spec.use_pp:
        blk["feat"] = pr.fns.precompute(blk).to(dtype)
    model = GNN(pr.spec, torch.Generator().manual_seed(pr.cfg.seed))
    if model_init is not None:
        model.load_state_dict(model_init)
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


def train_loop(pr: Prepared, model_init: Optional[dict] = None,
               log=print, resume_from: Optional[str] = None
               ) -> tuple[RunResult, GNN]:
    """The epoch loop of one process (P=1) or one rank, from epoch 0 or,
    with `resume_from` (a periodic checkpoint), from the epoch after it.
    Every `log_every` epochs rank 0 logs, with cfg.eval evaluates (on the
    val graph; the line also goes to the results file) and writes a
    periodic checkpoint, pruned to cfg.keep_ckpt; the peers wait at a
    barrier. After the loop rank 0 writes the best-validation parameters'
    final checkpoint and evaluates them on a copy. The epoch time is taken
    after the step's gradient all-reduce and ends in float(loss). Returns
    the trained model, which every rank holds alike."""
    cfg, spec, fns, device, comm = pr.cfg, pr.spec, pr.fns, pr.device, pr.comm
    lead = pr.rank == 0
    res = RunResult(dense_edges=fns.dense_edges, n_edges=pr.n_edges)
    blk, model, opt = init_training(pr, model_init)
    seed, best_acc, best_state = cfg.seed, 0.0, None
    if resume_from is not None:
        payload = ckpt.read_blob(resume_from)
        model.load_state_dict(params_from_jax(payload["params"], spec))
        opt_state_from_jax(payload["opt_state"], opt, model)
        res.start_epoch = int(payload["epoch"]) + 1
        seed, best_acc = int(payload["seed"]), float(payload["best_acc"])
        log(f"Resumed from {resume_from} at epoch {res.start_epoch}")
        final = (ckpt.final_best_payload(cfg, best_acc, log)
                 if best_acc > 0 and lead else None)
        if final is not None:
            best_state = params_from_jax(final["params"], spec)
        else:
            best_acc = 0.0      # no matching best parameters: restart
    result_file = None
    if lead and cfg.eval:
        os.makedirs(cfg.results_path, exist_ok=True)
        result_file = results_file(cfg)

    def mean(xs):
        return warm_mean(xs, res.start_epoch)

    clock = "P=1" if comm is None else (
        "events" if device.type == "cuda" else "host")
    for epoch in range(res.start_epoch, cfg.n_epochs):
        if comm is not None:
            comm.reset_seconds()
        gen = (dropout_generator(seed, epoch, pr.rank, device)
               if spec.dropout > 0 else None)
        t_ep = time.perf_counter()
        loss = fns.train_step(model, opt, blk, epoch, gen)
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
            name = "Epoch %05d" % epoch
            t_ev = time.perf_counter()
            val = (evaluate_induc(name, model, pr.val_g, device, "val",
                                  log=log, result_file=result_file)
                   if cfg.inductive else
                   evaluate_trans(name, model, pr.val_g, device, log=log,
                                  result_file=result_file)[0])
            res.eval_seconds.append(time.perf_counter() - t_ev)
            if best_state is None or val > best_acc:
                best_acc = val
                best_state = copy.deepcopy(model.state_dict())
        if lead:
            # periodic checkpoint whether or not eval runs
            ckpt.save_checkpoint(
                ckpt.periodic_path(cfg, epoch),
                params=params_to_jax(model.state_dict(), spec),
                opt_state=opt_state_to_jax(opt, model), epoch=epoch,
                best_acc=best_acc, seed=seed, extra={"retry_nonce": 0})
            ckpt.prune_checkpoints(cfg, cfg.keep_ckpt)
        if comm is not None:
            comm.barrier()                      # the peers wait for rank 0
    res.epoch_time = mean(res.epoch_times)
    res.best_val_acc = best_acc
    if cfg.eval and lead:
        best = model
        if best_state is not None:
            best = copy.deepcopy(model)
            best.load_state_dict(best_state)
            ckpt.save_checkpoint(ckpt.final_path(cfg),
                                 params=params_to_jax(best_state, spec),
                                 epoch=cfg.n_epochs - 1, best_acc=best_acc,
                                 seed=seed)
            log("model saved")
            log("Max Validation Accuracy {:.2%}".format(best_acc))
        t_ev = time.perf_counter()
        if cfg.inductive:
            res.val_acc = best_acc
            res.test_acc = evaluate_induc("Test Result", best, pr.test_g,
                                          device, "test", log=log)
        else:
            res.val_acc, res.test_acc = evaluate_trans(
                "Test Result", best, pr.test_g, device, log=log)
        res.eval_seconds.append(time.perf_counter() - t_ev)
    return res, model


def run_training(cfg: Config, g: Optional[Graph] = None, log=print,
                 model_init: Optional[dict] = None,
                 prepared: Optional[Prepared] = None,
                 rank_hook: Optional[Callable[[Prepared], dict]] = None
                 ) -> RunResult:
    """Train cfg: in this process at P=1, on P spawned ranks otherwise.
    `g` is the full graph (loaded from cfg when None); `model_init` (a
    state_dict) replaces the seeded initialization (the parity tests carry
    JAX parameters over); `prepared` reuses an earlier prepare_run of the
    same P=1 cfg; `rank_hook` (P > 1, a module-level function) runs in every
    rank on its prepared part before the epoch loop and the launch
    counters' reset, its result in the rank's report under 'hook'."""
    cfg, resume_from = resume_point(cfg, log)
    if cfg.n_partitions > 1:
        return run_parts(cfg, g, log, model_init, rank_hook, resume_from)
    pr = prepared if prepared is not None else prepare_run(cfg, g, log)
    return train_loop(pr, model_init, log, resume_from)[0]


# ----------------------------------------------------------------------------
# P > 1
# ----------------------------------------------------------------------------

def artifacts_dir(cfg: Config) -> str:
    return os.path.join(cfg.part_path,
                        cfg.graph_name or cfg.derive_graph_name())


def prepare_partition(cfg: Config, g: Optional[Graph] = None,
                      force: bool = False) -> PartitionArtifacts:
    """Offline partitioning (bnsgcn_tpu/run.py prepare_partition, without
    its streaming branch) of `g`, the train graph; without `g`, of the
    dataset's graph, or under --inductive its train subgraph. The artifact
    directory is loaded when it exists, as the reference's config-JSON check
    does, unless `force`; under --skip-partition it must exist."""
    path = artifacts_dir(cfg)
    exists = os.path.exists(os.path.join(path, "meta.json"))
    if not force and (exists or cfg.skip_partition):
        if not exists:
            raise ConfigError(
                f"--skip-partition: no partition artifacts at {path}; write "
                f"them first with python -m bnsgcn_tpu_torch.partition_cli "
                f"and the same flags")
        return load_artifacts(path)
    if g is None:
        g, _, _ = load_data(cfg)
        if cfg.inductive:
            g = g.subgraph(g.train_mask)
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
        specs += [(name, "cuda", [src]) for m in (bucket_sum, tile_matmul)
                  for name, src in m.BUILDS]
    buildlib.build_many(specs)


def _rank_main(ctx: RankContext, cfg: Config, path: str,
               model_init: Optional[dict], eval_graphs: Optional[tuple],
               rank_hook: Optional[Callable[[Prepared], dict]],
               resume_from: Optional[str]) -> dict:
    """One rank of a P > 1 run: load part r, train (from the same
    checkpoint on every rank when resuming), check replication, report."""
    lead = ctx.rank == 0
    log = ctx.log if lead else (lambda m: None)
    art = load_artifacts(path, parts=[ctx.rank])
    pr = prepare_part(cfg, art, eval_graphs, ctx.device, log, ctx.rank,
                      ctx.comm)
    hook = rank_hook(pr) if rank_hook is not None else None
    ctx.comm.barrier()          # the ranks build their layouts at own speeds
    bucket_sum.launches.reset()
    tile_matmul.launches.reset()
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    res, model = train_loop(pr, model_init, log, resume_from)
    if cfg.eval:
        ctx.comm.barrier()                  # rank 0's final evaluation
    assert_replicated(model.parameters(), ctx.comm)
    return {
        "rank": ctx.rank, "device": str(ctx.device),
        "losses": res.losses, "epoch_times": res.epoch_times,
        "epoch_time": res.epoch_time, "start_epoch": res.start_epoch,
        "comm_times": res.comm_times, "reduce_times": res.reduce_times,
        "launches": {"K1": dict(bucket_sum.launches.by_phase),
                     "K2": dict(tile_matmul.launches.by_phase)},
        "kinds": {"K1": dict(bucket_sum.launches.by_kind),
                  "K2": dict(tile_matmul.launches.by_kind)},
        "max_memory_bytes": (torch.cuda.max_memory_allocated(ctx.device)
                             if ctx.device.type == "cuda" else None),
        "dense_edges": res.dense_edges, "n_edges": res.n_edges,
        "best_val_acc": res.best_val_acc, "val_acc": res.val_acc,
        "test_acc": res.test_acc, "eval_seconds": res.eval_seconds,
        "hook": hook,
    }


def run_parts(cfg: Config, g: Optional[Graph] = None, log=print,
              model_init: Optional[dict] = None,
              rank_hook: Optional[Callable[[Prepared], dict]] = None,
              resume_from: Optional[str] = None) -> RunResult:
    """P > 1: write (or, under --skip-partition, load) the artifacts here,
    then train on P spawned ranks; rank 0 alone gets the eval graphs."""
    require_device(cfg.device)
    check_mesh_budget(cfg.n_partitions, cfg.dist_backend, cfg.device)
    P = cfg.n_partitions
    if g is None and (cfg.eval or not cfg.skip_partition):
        g, _, _ = load_data(cfg)
    train_g, val_g, test_g = (split_graphs(cfg, g) if g is not None
                              else (None, None, None))
    t0 = time.perf_counter()
    art = prepare_partition(cfg, train_g)
    path = artifacts_dir(cfg)
    _prebuild(cfg)
    hspec, _ = make_halo_spec(art.n_b, art.pad_inner, art.pad_boundary,
                              cfg.sampling_rate, wire=cfg.halo_wire)
    hfull, _ = full_rate_spec(art.n_b, art.pad_inner, art.pad_boundary)
    nb = 2 if cfg.dtype == "bfloat16" else 4     # the native wire's bytes
    devs = [str(rank_device(cfg.device, cfg.dist_backend, r))
            for r in range(P)]
    staged = cfg.dist_backend == "gloo" and cfg.device == "cuda"
    log(f"Mesh: {P} ranks | {cfg.dist_backend}"
        + (" (collectives staged through host memory)" if staged else "")
        + f" | devices {','.join(devs)} | pad_inner={art.pad_inner} "
        f"pad_boundary={art.pad_boundary} pad_send={hspec.pad_send} "
        f"edges/part={art.pad_edges} | {cfg.dtype} spmm={cfg.spmm} "
        f"gather={cfg.spmm_gather} dense={cfg.spmm_dense} | halo "
        f"{hspec.strategy}/{hspec.wire} at sampling rate "
        f"{cfg.sampling_rate:g}: "
        f"{wire_bytes(hspec, cfg.n_hidden, nb) / 1e6:.2f} MB/exchange/rank "
        f"at hidden width {cfg.n_hidden} "
        f"({wire_bytes(hfull, art.n_feat, nb) / 1e6:.2f} MB at feature width "
        f"{art.n_feat}, the precompute's full-rate exchange) | artifacts "
        f"{path} {time.perf_counter() - t0:.1f}s")
    evals = (val_g, test_g) if cfg.eval else None
    reports = launch(_rank_main, P,
                     [(cfg, path, model_init, evals if r == 0 else None,
                       rank_hook, resume_from) for r in range(P)],
                     cfg.dist_backend, cfg.device, log=log)
    lead = reports[0]
    return RunResult(
        losses=lead["losses"], epoch_times=lead["epoch_times"],
        epoch_time=lead["epoch_time"], start_epoch=lead["start_epoch"],
        comm_times=lead["comm_times"], reduce_times=lead["reduce_times"],
        best_val_acc=lead["best_val_acc"], val_acc=lead["val_acc"],
        test_acc=lead["test_acc"], eval_seconds=lead["eval_seconds"],
        dense_edges=sum(r["dense_edges"] for r in reports),
        n_edges=sum(r["n_edges"] for r in reports), ranks=reports)
