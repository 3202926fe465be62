"""Where one training epoch's device time goes, on the card.

    python -m bnsgcn_tpu_torch.epoch_profile --dataset synth-reddit:1.0 \\
        --n-partitions 1 --model graphsage --n-layers 4 --n-hidden 256 \\
        --use-pp --spmm hybrid --dropout 0.5 [--profile-epochs 3] \\
        [--warmup 2]

Runs the slice's train step (trainer.StepFns.train_step with the run's
dropout key, after run.init_training) for `warmup` epochs, then
`profile-epochs` more under torch.profiler, and prints per epoch: wall
time, device busy time and idle share, and the device time of each kernel
by name, largest first; the same as one JSON line last. Device times come
from the profiler's CUDA activity trace; the wall time is the host clock
around epochs that end in a synchronize.

With --n-partitions P > 1, or --replicas R / --feat T above 1 (and the
run's --dist-backend, gloo to share one card) the artifacts are written as
a run writes them and R x P x T ranks are spawned through the port's
launcher (parallel/mesh.launch); each rank takes its place on the axes,
loads its part (and applies --reorder) as a run's rank does
(run.rank_axes, run.prepare_rank), profiles its own process's train steps
with its dropout key and prints its table; the last line is one JSON
object with every rank's table under "ranks", in global rank order (rank
(r P + p) T + f). On one shared card the
ranks' processes take turns on it: a rank's profile holds its own kernels
only, while its wall time also covers the other ranks' work and its waits
in their collectives, so its idle share is not the card's; the output says
so.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from bnsgcn_tpu_torch.config import Config, ConfigError, parse_config
from bnsgcn_tpu_torch.parallel.mesh import RankContext, launch
from bnsgcn_tpu_torch.run import (_prebuild, artifacts_dir, init_training,
                                  prepare_partition, prepare_rank,
                                  prepare_run, rank_axes, require_device)
from bnsgcn_tpu_torch.trainer import dropout_key


def profile_steps(pr, warmup: int, n: int, top: int) -> dict:
    """Profile `n` train steps of a prepared run (or rank) after `warmup`
    steps: {'epoch_wall_ms', 'device_busy_ms', 'kernels_ms' (the `top`
    kernels by device ms per epoch), 'device'}."""
    blk, model, opt = init_training(pr)

    replica = pr.axes.replica if pr.axes is not None else None

    def step(epoch):
        pr.fns.train_step(model, opt, blk, epoch,
                          dropout_key(pr.cfg.seed, epoch, pr.rank, replica))

    for epoch in range(warmup):
        step(epoch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for epoch in range(warmup, warmup + n):
            step(epoch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = {}
    for evt in prof.key_averages():
        # device activities only (kernels, copies): a CPU op's device time
        # re-counts the kernels launched under it
        if evt.device_type == DeviceType.CUDA:
            kernels[evt.key] = (kernels.get(evt.key, 0.0)
                                + evt.device_time_total / 1e3 / n)
    top_k = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    return {"epoch_wall_ms": wall_ms, "device_busy_ms": sum(kernels.values()),
            "kernels_ms": dict(top_k),
            "device": torch.cuda.get_device_name(pr.device)}


def table(t: dict, n: int, prefix: str = "") -> list:
    """The printed lines of one profile."""
    busy, wall = t["device_busy_ms"], t["epoch_wall_ms"]
    lines = [f"{prefix}epoch wall {wall:.3f} ms | device busy {busy:.3f} "
             f"ms | idle share {max(0.0, 1 - busy / wall):.1%} (mean of {n} "
             f"epochs, {t['device']})"]
    for name, ms in t["kernels_ms"].items():
        lines.append(f"{prefix}  {ms:10.3f} ms  {ms / max(busy, 1e-9):6.1%}"
                     f"  {name[:100]}")
    return lines


def _profile_rank(ctx: RankContext, cfg: Config, path: str, warmup: int,
                  n: int, top: int) -> dict:
    """One rank: its part, as a run's rank prepares it, then profile_steps;
    its table goes to the launcher's log."""
    pr = prepare_rank(ctx, cfg, path, None,
                      ctx.log if ctx.rank == 0 else (lambda m: None),
                      rank_axes(ctx, cfg))
    ctx.comm.barrier()
    out = profile_steps(pr, warmup, n, top)
    ctx.comm.barrier()
    ctx.log("\n".join(table(out, n, f"[rank {ctx.rank}] ")))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--profile-epochs", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    args, rest = ap.parse_known_args(argv)
    n = args.profile_epochs
    try:
        cfg = parse_config(rest)
        if cfg.device != "cuda":
            raise ConfigError("epoch_profile: device time needs the GPU")
        require_device(cfg.device)
        n_ranks = cfg.replicas * cfg.n_partitions * cfg.feat
        if n_ranks > 1:
            prepare_partition(cfg, load=False)
            _prebuild(cfg)
        else:
            pr = prepare_run(cfg)
    except ConfigError as e:
        print(f"[config] {e}", file=sys.stderr)
        return 2
    if n_ranks == 1:
        out = profile_steps(pr, args.warmup, n, args.top)
        print("\n".join(table(out, n)))
        print(json.dumps(out))
        return 0
    P = n_ranks
    reports = launch(_profile_rank, P,
                     [(cfg, artifacts_dir(cfg), args.warmup, n, args.top)
                      for _ in range(P)],
                     cfg.dist_backend, cfg.device)
    shared = torch.cuda.device_count() < P
    if shared:
        print(f"note: the {P} ranks share one card: each rank's device "
              f"time is its own kernels', while its wall time overlaps the "
              f"other ranks' work and its waits for them, so its idle share "
              f"is not the card's")
    print(json.dumps({"n_partitions": cfg.n_partitions,
                      "replicas": cfg.replicas, "feat": cfg.feat,
                      "backend": cfg.dist_backend,
                      "shared_card": shared, "ranks": reports}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
