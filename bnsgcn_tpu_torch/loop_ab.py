"""The P-rank run loop's wall time and evaluations, for comparing trees on
the card: the flagship's P=4 inductive main path (GraphSAGE 4x256, use_pp,
dropout 0.5, rate 0.1, hybrid SpMM) on synth-reddit at --scale through
run.run_training of whichever bnsgcn_tpu_torch is first on the path, with
an eval every --log-every epochs.

    PYTHONPATH=<tree> python3 bnsgcn_tpu_torch/loop_ab.py NAME \\
        [--scale 0.5] [--epochs 16] [--log-every 4] [--backend gloo] \\
        [--resilience on|off] \\
        [--part-path DIR] [--out chiprun_out/loop_ab.jsonl]

Run as a file, it times the package <tree> holds: this checkout (`.`) or
an earlier commit's unpacked beside it (`git archive <commit>
bnsgcn_tpu_torch | tar -x -C <dir>`), in turns in one call, with one
--part-path so that the runs share the artifacts. It appends one JSON line
per run: rank 0's epoch times and eval seconds, and, where the tree
records them (the overlapped loop), each eval's span, the drain waits, the
epoch starts and every rank's loop wall time, and two means: the epoch
time of epochs 1.. (the step, ending in float(loss)) and the steady
interval, the mean time from one epoch's start to the next's over the
epochs that are no log point (the step plus what the loop does around it:
resilience.py's agreement all-reduce, the beats), and under --resilience
on rank 0's mean agreement all-reduce (host clock). `--resilience on|off`
sets the run's --resilience (a tree from before fault tolerance was ported
takes no such flag: leave it out there). `--backend nccl` puts one rank on
each card (4 cards). Exits 2 without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("name")
    ap.add_argument("--scale", type=float, default=0.5)
    ap.add_argument("--epochs", type=int, default=16)
    ap.add_argument("--log-every", type=int, default=4)
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    ap.add_argument("--resilience", choices=["on", "off"], default=None)
    ap.add_argument("--part-path", default="partition")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "loop_ab.jsonl"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("loop_ab needs the GPU", file=sys.stderr)
        return 2
    import bnsgcn_tpu_torch
    from bnsgcn_tpu_torch.config import Config
    from bnsgcn_tpu_torch.data.datasets import load_data
    from bnsgcn_tpu_torch.run import run_training
    work = f"loop_ab_{args.name}_{os.getpid()}"
    cfg = Config(dataset=f"synth-reddit:{args.scale}", n_partitions=4,
                 model="graphsage", n_layers=4, n_hidden=256, use_pp=True,
                 norm="layer", dropout=0.5, lr=0.01, spmm="hybrid",
                 use_pallas=True, n_epochs=args.epochs,
                 log_every=args.log_every, seed=0, device="cuda",
                 dist_backend=args.backend, sampling_rate=0.1,
                 inductive=True, part_path=args.part_path,
                 ckpt_path=os.path.join(tempfile.gettempdir(), work, "ckpt"),
                 results_path=os.path.join(tempfile.gettempdir(), work,
                                           "results"))
    if args.resilience is not None:
        cfg = cfg.replace(resilience=args.resilience)
    g, _, _ = load_data(cfg)
    t0 = time.perf_counter()
    res = run_training(cfg, g=g, log=lambda m: None)
    rec = {"name": args.name, "tree": os.path.dirname(
        os.path.dirname(os.path.abspath(bnsgcn_tpu_torch.__file__))),
        "backend": args.backend, "run_s": time.perf_counter() - t0,
        "epoch_times": res.epoch_times, "eval_seconds": res.eval_seconds,
        "losses": res.losses, "resilience": args.resilience}
    starts = res.epoch_starts
    steady = [b - a for i, (a, b) in enumerate(zip(starts, starts[1:]))
              if i >= 1 and (i + 1) % args.log_every != 0]
    rec["epoch_ms_from_1"] = 1e3 * sum(res.epoch_times[1:]) / max(
        len(res.epoch_times) - 1, 1)
    rec["steady_interval_ms"] = 1e3 * sum(steady) / max(len(steady), 1)
    agree = getattr(res, "agree_times", None) or []
    rec["agree_ms"] = 1e3 * sum(agree) / len(agree) if agree else None
    for k in ("eval_spans", "drain_waits", "epoch_starts", "loop_seconds"):
        rec[k] = getattr(res, k, None)
    rec["ranks_loop_seconds"] = [r.get("loop_seconds") for r in res.ranks]
    print(json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
