"""K1 (csrc/bucket_sum.cu) of this tree against other builds of the same C
interface, on the card: whether their sums are bitwise this tree's, and
how long each takes at the main path's shapes.

    python -m bnsgcn_tpu_torch.k1_ab OTHER.cu [OTHER.cu ...] [--scale 1.0]
        [--reps 20] [--out JSON]

OTHER is a copy of bucket_sum.cu: an earlier commit's (`git show
<commit>:bnsgcn_tpu_torch/csrc/bucket_sum.cu`) or a variant of this one.
Each builds into a library of its own, named by its file. On the residual
rows of the P=1 main path's hybrid layout (synth-reddit at --scale,
GraphSAGE 4x256), forward and backward, at H=256 and 64, for each row kind
as the main paths hand it to K1 (f32 and bf16 rows as they are, int8 and
e4m3 quantized with a bf16 out), without a base, with K2's output shape as
the base, and with that base 4 bytes off 16-byte alignment: whether each
OTHER returns this tree's bits. Then one forward pass at H=256 with the
base, per row kind, timed with CUDA events over --reps launches after two
warm-ups, in turns: this tree, the others, the others again in reverse,
this tree. Prints a line per comparison and timing, and all of it as one
JSON line last; exits 1 when an OTHER's bits differ anywhere.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from bnsgcn_tpu_torch import buildlib
from bnsgcn_tpu_torch.config import Config
from bnsgcn_tpu_torch.ops import bucket_sum as k1
from bnsgcn_tpu_torch.ops.ell import gather_quant
from bnsgcn_tpu_torch.run import prepare_run

KINDS = ("bf16", "f32", "int8", "fp8")
WIDTHS = (256, 64)


def as_rows(h: torch.Tensor, kind: str):
    """(rows, ell_apply keywords) of a row kind as the main paths call K1."""
    if kind == "f32":
        return h, {}
    if kind == "bf16":
        return h.to(torch.bfloat16), {}
    q, scale = gather_quant(h, kind)
    return q, {"scale": scale, "out_dtype": torch.bfloat16}


def events_ms(fn, reps: int) -> float:
    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("others", nargs="+", help="other bucket_sum.cu sources")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_ab: needs the GPU", file=sys.stderr)
        return 2
    sources = {"tree": k1.SOURCE}
    for path in args.others:
        sources[os.path.splitext(os.path.basename(path))[0]] = \
            os.path.abspath(path)
    others = [n for n in sources if n != "tree"]
    buildlib.build_many([(f"{k1.LIB_NAME}_{n}", "cuda", [p])
                         for n, p in sources.items()])
    kernels = {n: buildlib.Kernel(f"{k1.LIB_NAME}_{n}", p, "bnsgcn_ell_rows",
                                  k1._kernel.argtypes,
                                  "bnsgcn_ell_rows_error")
               for n, p in sources.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    cfg = Config(dataset=f"synth-reddit:{args.scale}", n_partitions=1,
                 model="graphsage", n_layers=4, n_hidden=256, use_pp=True,
                 spmm="hybrid", use_pallas=True, eval=False, seed=0,
                 device="cuda")
    op = prepare_run(cfg, log=lambda m: None).fns.spmm
    home = k1._kernel

    def call(name, *a, **kw):
        k1._kernel = kernels[name]
        try:
            return k1.ell_apply(*a, phase="check", **kw)
        finally:
            k1._kernel = home

    gen = torch.Generator(device="cuda").manual_seed(1234)
    report = {"card": card, "sources": sources, "bitwise": [], "ms": {}}
    timed = None
    for direction in ("fwd", "bwd"):
        rows = op.residual.rows[direction]
        spec = op.fwd if direction == "fwd" else op.bwd
        base_row = op.arrays["blk_perm_inner" if direction == "fwd"
                             else "blk_perm_ext"]
        for hdim in WIDTHS:
            h = torch.randn((rows.n_src, hdim), generator=gen, device="cuda")
            base = torch.randn((spec.n_row_blocks * spec.row_tile, hdim),
                               generator=gen, device="cuda")
            odd = torch.empty(base.numel() + 1, device="cuda")[1:]
            odd = odd.view_as(base).copy_(base)
            for kind in KINDS:
                hq, kw = as_rows(h, kind)
                for label, b in (("no base", None), ("base", base),
                                 ("base off 16 B", odd)):
                    br = None if b is None else base_row
                    ref = call("tree", rows, hq, b, br, **kw)
                    for n in others:
                        same = torch.equal(call(n, rows, hq, b, br, **kw),
                                           ref)
                        report["bitwise"].append(
                            [n, direction, hdim, kind, label, same])
                        print(f"[bitwise] {n} {direction} H={hdim} {kind} "
                              f"{label}: {'equal' if same else 'DIFFERS'}",
                              flush=True)
            if direction == "fwd" and hdim == WIDTHS[0]:
                timed = (rows, h, base, base_row)
    rows, h, base, base_row = timed
    for kind in KINDS:
        hq, kw = as_rows(h, kind)
        for n in ["tree"] + others + others[::-1] + ["tree"]:
            ms = events_ms(lambda: call(n, rows, hq, base, base_row, **kw),
                           args.reps)
            report["ms"].setdefault(kind, {}).setdefault(n, []).append(ms)
            print(f"[time] {kind} {n}: {ms:.4f} ms (fwd H={hq.shape[1]}, "
                  f"base, {args.reps} launches)", flush=True)
    line = json.dumps(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if all(b[-1] for b in report["bitwise"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
