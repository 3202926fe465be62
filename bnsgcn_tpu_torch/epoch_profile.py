"""Where one training epoch's device time goes, on the card.

    python -m bnsgcn_tpu_torch.epoch_profile --dataset synth-reddit:1.0 \\
        --n-partitions 1 --model graphsage --n-layers 4 --n-hidden 256 \\
        --use-pp --spmm hybrid --dropout 0.5 [--profile-epochs 3] \\
        [--warmup 2]

Runs the slice's train step (run.prepare_run, run.init_training,
trainer.StepFns.train_step) at P=1
for `warmup` epochs, then `profile-epochs` more under torch.profiler, and
prints per epoch: wall time, device busy time and idle share, and the
device time of each kernel by name, largest first; the same as one JSON
line last. Device times come from the profiler's CUDA activity trace; the
wall time is the host clock around epochs that end in a synchronize.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from bnsgcn_tpu_torch.config import ConfigError, parse_config
from bnsgcn_tpu_torch.run import init_training, prepare_run
from bnsgcn_tpu_torch.trainer import dropout_generator


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--profile-epochs", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    args, rest = ap.parse_known_args(argv)
    try:
        cfg = parse_config(rest)
        if cfg.n_partitions != 1:
            raise ConfigError("epoch_profile profiles P=1: pass "
                              "--n-partitions 1")
        pr = prepare_run(cfg)
    except ConfigError as e:
        print(f"[config] {e}", file=sys.stderr)
        return 2
    if pr.device.type != "cuda":
        print("epoch_profile: device time needs the GPU", file=sys.stderr)
        return 2
    blk, model, opt = init_training(pr)

    def step(epoch):
        gen = (dropout_generator(cfg.seed, epoch, 0, pr.device)
               if cfg.dropout > 0 else None)
        pr.fns.train_step(model, opt, blk, epoch, gen)

    for epoch in range(args.warmup):
        step(epoch)
    torch.cuda.synchronize()
    n = args.profile_epochs
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for epoch in range(args.warmup, args.warmup + n):
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
    busy_ms = sum(kernels.values())
    print(f"epoch wall {wall_ms:.3f} ms | device busy {busy_ms:.3f} ms | "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.1%} "
          f"(mean of {n} epochs, {torch.cuda.get_device_name(0)})")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])
    for name, ms in top[:args.top]:
        print(f"  {ms:10.3f} ms  {ms / max(busy_ms, 1e-9):6.1%}  {name[:100]}")
    print(json.dumps({"epoch_wall_ms": wall_ms, "device_busy_ms": busy_ms,
                      "kernels_ms": dict(top[:args.top]),
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
