#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (bnsgcn_tpu_torch).

    python3 chip_smoke.py                 # the full check, on one GPU
    python3 chip_smoke.py --scale 0.02 --epochs 3 --parts-scale 0.01 \
        --parts-epochs 4                  # a quick rehearsal

Phases, each of which fails the run (non-zero exit, no result line):

  1. build the CUDA kernels K1-K4 from csrc/ (one nvcc per source, in
     parallel);
  2. hold each kernel to its plain PyTorch version on the card, at the main
     path's own shapes: the ELL residual's one-launch SpMM (K1) with K2's
     output shape as its base, and the dense tile stack (K2), forward and
     backward layouts, at H=256 and at the raw feature width, K1 also
     bitwise against a second call; K3 (the width-axis bucket reduce, on no
     path) at the shapes it ran on the TPU, f32 [3592, 32, 602] and
     [64, 16, 602], and in bf16; K4 (the manual-copy probe, on no path)
     bitwise at the probe's [4, 8, 128]; and time kernel, plain version
     and a one-call PyTorch yardstick with CUDA events (K1 and K2 against
     torch.sparse.mm, K2 also against torch.bmm of its tiles; K3 and K4
     also by host microseconds per call); probe the L2's rate; print K2's
     tiles per row-block and the time the layout's packing took; then
     [lowp]: K1 on bf16, int8 and e4m3 rows and K2 on bf16, int8 and
     per-slab int8 slabs (the tensor-core kernel), as the low-precision
     path calls them (int8 bitwise equal to the plain version, bf16 and
     e4m3 within a stated per-element bound, each with a control the check
     must reject), timed beside their bounds, K2 also beside its design's
     floor and a dense-equivalent GEMM;
  3. a small-input agreement check: the same short training run on the card
     and on the CPU (plain versions) must give the same losses;
  4. drive the main path through the entry point a user calls
     (run.run_training): GraphSAGE 4x256, use_pp, LayerNorm, dropout 0.5,
     lr 0.01, --spmm hybrid on synth-reddit, with every kernel's launch
     count reset just before and read just after; the loss must stay finite
     and fall, K1 and K2 must each have launched once per aggregation (the
     3 layers after the precompute, forward and backward, every epoch,
     plus the precompute's one); the run
     ends with the full-graph eval's accuracy line, which must beat twice
     chance;
  5. the P-rank path on synth-reddit at --parts-scale, the same model: at
     sampling rate 1.0, 4 ranks sharing this one card over gloo (NCCL
     refuses two ranks on one card) and P=1, 3 epochs without dropout from
     the same parameters, transductive, must give the same losses to 1e-4
     (relative); then the main path at P=4 with the flagship's command
     line, --inductive (the train subgraph partitioned, rank 0 evaluating
     on the train+val subgraph and, last, the full graph), boundary-node
     sampling at rate 0.1 and dropout 0.5, through run.run_training, in
     which each rank first holds K1 and K2 to
     their plain versions on its own part's layout (its own hybrid tiles and
     ELL residual and its own row schedule, forward and backward, at
     H=256 and the raw feature width, with phase 2's bounds) and then hands
     back its launch counts: K1 and K2 must have launched as at P=1 on
     every rank, the loss must stay finite and fall, rank 0's inductive
     val and test accuracies must beat twice chance, and every rank must end
     with rank 0's parameters;
     then [bns] at those artifacts: every rank's BNS plan for epochs 0 and
     1 built on the card must be array-equal to the CPU's, and the ranks'
     plans must agree pair by pair (sender p's rows are the ones receiver
     j's slots stand for, the rest trashed); it prints each rank's wire MB
     per exchange, the plan's ms, the exchange's share and the epoch at
     rate 0.1 beside rate 1.0's;
  5b. [lowp] on the P=1 graph and layouts (shared, not rebuilt): the
     TPU recipe with its finer knobs, --dtype bfloat16 --spmm auto
     --use-pallas --spmm-dense int8 --spmm-gather int8 (auto must pick the
     hybrid):
     finite losses, K1 and K2 launched int8 on every aggregation and bf16
     in the precompute (K2 on the tensor cores, as its launch count names
     the route), the epoch beside the f32 one, peak memory; then the
     guard's route, 2 epochs with e4m3 gathers and the dense tiles past
     their int8 row cap (the per-slab mode);
  5c. [recipe]: the TPU recipe's own knobs (RECIPE_TPU, scripts/reddit.sh's
     --dtype bfloat16 --spmm auto --use-pallas --halo-wire int8): at P=1 on
     the same graph and layouts, the P=1 main path's model for --epochs
     epochs (auto must pick the hybrid; K1 on bf16 rows and K2 on bf16
     slabs exactly once per aggregation and once in the precompute; the
     loss finite and falling; the epoch beside the f32 and [lowp] ones,
     peak memory); at P=4, appended to the P=4 main path's command line on
     its artifacts (no repartitioning), 4 epochs, in which each rank first
     holds K1 and K2 on bf16 to their plain versions on its own layout
     (phase 2's bounds and controls), then launches them as at P=1; the
     loss finite, every rank ending with rank 0's parameters; it prints
     each rank's epoch and exchange share and the int8 wire's MB per
     exchange beside the f32 path's;
  6. [cli]: the flagship's command line as a user types it,
     scripts/reddit_torch.sh, in a subprocess on synth-reddit:0.02 at P=4
     over gloo, 12 epochs, an eval and a checkpoint every 4: it must exit 0,
     print epoch, accuracy and Test Result lines, and leave 3 periodic
     checkpoints, the final one and the results file; rerun with --resume
     --skip-partition --n-epochs 16 it must start at epoch 12, and its
     losses for epochs 12-15 must equal an uninterrupted 16-epoch run's to
     1e-5 (relative);
  7. [anchor]: the JAX package's calibrated accuracy gate
     (bnsgcn_tpu_torch/anchor.py), 200 epochs: exact (P=1, rate 1.0, f32)
     inside (0.93, 0.985), the quantized stack of the recipe's finer knobs
     at P=4 and rate 0.1 within 0.005 of it, the same stack in bf16
     recorded;
  8. print the card's name and power limit, one {"kernels": [...]} line
     (every kernel variant) and, last, {"ok": true, "device": {...}}.

Short runs report their own mean of epochs 1.. (labelled so), beside the
epoch line's Time(s), which drops 5 warm-up epochs as the JAX package does.

Exits non-zero without a CUDA device and when the port is not beside it.
--out FILE also writes the details (per-check errors, times, losses) as JSON.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

# H100 SXM (NVIDIA data sheet): device memory rate, f32 peak outside the
# tensor cores. The least time a kernel could take is the larger of its
# bytes over the first and its f32 operations over the second.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# the tensor cores' dense peaks (the same data sheet): the least time of an
# operation of the type, whatever unit the kernel uses
BF16_TC_FLOPS_PER_S = 989e12
INT8_TC_OPS_PER_S = 1979e12
U32 = 2.0 ** -24               # f32 unit roundoff

K1_SRC, K2_SRC, K2_MMA_SRC = ("bnsgcn_tpu_torch/csrc/bucket_sum.cu",
                              "bnsgcn_tpu_torch/csrc/tile_matmul.cu",
                              "bnsgcn_tpu_torch/csrc/tile_mma.cu")
# every kernel variant of the kernels line: (source, the TPU kernel it
# replaces, which launch count and variant it reads)
KERNELS = {
    "ell_bucket_sum": (K1_SRC, "tools/pallas_spmm.py:35", "K1", "f32"),
    "ell_bucket_sum_bf16": (K1_SRC, "tools/pallas_spmm.py:35", "K1", "bf16"),
    "ell_bucket_sum_int8": (K1_SRC, "tools/pallas_spmm.py:35", "K1", "int8"),
    "ell_bucket_sum_fp8": (K1_SRC, "tools/pallas_spmm.py:35", "K1", "fp8"),
    "tile_matmul": (K2_SRC, "bnsgcn_tpu/ops/pallas_block.py:30", "K2",
                    "f32"),
    "tile_matmul_bf16": (K2_MMA_SRC, "bnsgcn_tpu/ops/pallas_block.py:30",
                         "K2", "tc-bf16"),
    "tile_matmul_int8": (K2_MMA_SRC, "bnsgcn_tpu/ops/pallas_block.py:30",
                         "K2", "tc-int8"),
    "tile_matmul_int8_slab": (K2_MMA_SRC,
                              "bnsgcn_tpu/ops/pallas_block.py:30", "K2",
                              "tc-int8-slab"),
    "bucket_reduce": ("bnsgcn_tpu_torch/csrc/bucket_reduce.cu",
                      "tools/pallas_spmm.py:104", None, None),
    "copy_probe": ("bnsgcn_tpu_torch/csrc/copy_probe.cu",
                   "tools/hw_session.py:102", None, None),
}
LOWP_GUARD_EPOCHS = 2   # [lowp]'s run of the guard's route
# K3 at the shapes it ran on the TPU (hw_logs/bench_tb3g.log:93,136), f32,
# and once in bf16
K3_CASES = (((3592, 32, 602), "float32"), ((64, 16, 602), "float32"),
            ((3592, 32, 602), "bfloat16"))
# the L2 probe: a table of this many rows (16 MiB at H=256, in the 50 MB
# L2) and a gather of [rows, width] random indices into it
L2_PROBE_ROWS = 16384
L2_PROBE_GATHER = (65536, 32)
PARTS = 4
HOST_CALLS = 200        # calls per host-time measurement of a small kernel
LAW_EPOCHS = 3
LAW_RTOL = 1e-4
BNS_RATE = 0.1          # the flagship's sampling rate (scripts/reddit.sh)
BNS_EPOCHS = (0, 1)     # epochs whose plans the [bns] phase checks
ROOT = os.path.dirname(os.path.abspath(__file__))
# [cli]: the flagship's script with small overrides, 12 epochs then a
# resume to 16 beside an uninterrupted 16-epoch run
CLI_SCRIPT = os.path.join("scripts", "reddit_torch.sh")
CLI_FLAGS = ["--dataset", "synth-reddit:0.02", "--n-partitions", str(PARTS),
             "--dist-backend", "gloo", "--log-every", "4", "--fix-seed"]
CLI_EPOCHS = (12, 16)
CLI_RTOL = 1e-5
CLI_TIMEOUT_S = 300
# the TPU recipe's own perf knobs, as scripts/reddit.sh's comment lists
# them ("append --dtype bfloat16 ..."): K1 on bf16 rows and K2 on bf16
# slabs on every aggregation. The int8 gathers and tiles of [lowp] are its
# finer knobs.
RECIPE_TPU = ["--dtype", "bfloat16", "--spmm", "auto", "--use-pallas",
              "--halo-wire", "int8"]
RECIPE_P4_EPOCHS = 4    # [recipe]'s run at P=4


def log(msg):
    print(msg, flush=True)


def recipe_fields():
    """RECIPE_TPU as Config fields: those the port's parser sets otherwise
    than for an empty command line."""
    import dataclasses
    from bnsgcn_tpu_torch.config import parse_config
    got, default = parse_config(RECIPE_TPU), parse_config([])
    return {f.name: getattr(got, f.name) for f in dataclasses.fields(got)
            if getattr(got, f.name) != getattr(default, f.name)}


def mean_from_1(xs):
    """The mean of epochs 1.. of a short run (epoch 0 alone when that is
    all there is): chip_smoke's own label, not the epoch line's Time(s)."""
    xs = xs[1:] or xs
    return sum(xs) / len(xs)


def cuda_ms(fn, reps):
    """Mean ms of fn() over `reps` launches between CUDA events, after two
    warm-up calls."""
    import torch
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


def check(name, got, ref, bound):
    """(max |got - ref|, that over max |ref|) after checking that every
    element is finite and within its bound."""
    import torch
    err = (got - ref).abs()
    ok = bool(torch.isfinite(got).all()) and bool((err <= bound).all())
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max err {float(err.max()):.3e}, "
                             f"max bound {float(bound.max()):.3e})")
    if not err.numel():
        return 0.0, 0.0
    e = float(err.max())
    return e, e / max(float(ref.abs().max()), 1e-30)


def k1_inputs(op, direction, hdim, gen):
    """Random h, and a base with its rows, at the shapes the hybrid's pass
    gives K1 in `direction`: K2's output [n_row_blocks TR, H] in cluster
    order, gathered by the permutation back to row order."""
    import torch
    rows = op.residual.rows[direction]
    spec = op.fwd if direction == "fwd" else op.bwd
    a = op.arrays
    h = torch.randn((rows.n_src, hdim), generator=gen, device="cuda")
    base = torch.randn((spec.n_row_blocks * spec.row_tile, hdim),
                       generator=gen, device="cuda")
    base_row = a["blk_perm_inner" if direction == "fwd" else "blk_perm_ext"]
    return rows, h, base, base_row


def k1_bound(rows, h, base=None, base_row=None):
    """Per element: two f32 sums of the same n terms in different orders
    differ by at most 2 n u sum|x| (n the row's terms, +1 with a base;
    sum|x| from the plain version on |h| and |base|)."""
    from bnsgcn_tpu_torch.ops.bucket_sum import ell_apply_plain
    n = (rows.row_ptr[1:] - rows.row_ptr[:-1]).long()[:, None]
    if base is not None:
        n = n + 1
    return 2 * n.clamp(min=1) * U32 * ell_apply_plain(
        rows, h.abs(), None if base is None else base.abs(), base_row)


def compare_k1(fns, widths, gen, reps, detail):
    """K1 against its plain version on the hybrid's residual layout, both
    directions, at each width, with K2's output shape as the base (the main
    path's call), within k1_bound per element and bitwise equal to itself
    on a second call. With reps > 0, times one forward pass at widths[0]
    (time_k1)."""
    import torch
    from bnsgcn_tpu_torch.ops.bucket_sum import ell_apply, ell_apply_plain
    op = fns.spmm
    max_err = max_rel = 0.0
    timing = None
    for direction in ("fwd", "bwd"):
        for hdim in widths:
            rows, h, base, base_row = k1_inputs(op, direction, hdim, gen)
            got = ell_apply(rows, h, base, base_row, phase="check")
            again = ell_apply(rows, h, base, base_row, phase="check")
            ref = ell_apply_plain(rows, h, base, base_row)
            e, rel = check(f"K1 {direction} H={hdim}", got, ref,
                           k1_bound(rows, h, base, base_row))
            if not torch.equal(got, again):
                raise AssertionError(f"K1 {direction} H={hdim}: two calls "
                                     f"differ")
            max_err, max_rel = max(max_err, e), max(max_rel, rel)
            detail.append({"kernel": "ell_bucket_sum", "dir": direction,
                           "rows": rows.n_rows, "terms": int(rows.src.numel()),
                           "long_rows": rows.n_long, "H": hdim, "max_abs_err": e, "max_rel_err": rel,
                           "bitwise_repeat": True})
            del ref
            if direction == "fwd" and hdim == widths[0] and reps:
                timing = time_k1(rows, h, base, base_row, reps)
            del got, again
    return (max_err, max_rel), timing


def schedule_csr(rows):
    """The schedule's CSR as one f32 sparse matrix [n_rows, n_src] (repeated
    terms coalesced into their multiplicity): what torch.sparse.mm needs to
    compute K1's function without the base."""
    import torch
    deg = (rows.row_ptr[1:] - rows.row_ptr[:-1]).long()
    r = torch.repeat_interleave(torch.arange(rows.n_rows, device=deg.device),
                                deg)
    coo = torch.sparse_coo_tensor(
        torch.stack([r, rows.src.long()]),
        torch.ones(rows.src.numel(), device=deg.device),
        (rows.n_rows, rows.n_src), check_invariants=False)
    return coo.coalesce().to_sparse_csr()


def time_k1(rows, h, base, base_row, reps):
    """One forward residual pass of the hybrid (base included): K1, its
    plain version, and torch.sparse.mm (cuSPARSE) on the schedule's CSR,
    which computes the row sums without the base (held to k1_bound). Bytes
    bound: the CSR once, each h row the layout uses once, the base rows and
    their indices once, the output once."""
    import torch
    from bnsgcn_tpu_torch.ops import bucket_sum as k1
    hdim = h.shape[1]
    n_rows, nnz = rows.n_rows, int(rows.src.numel())
    n_used = int(torch.unique(rows.src).numel())
    nbytes = ((n_rows + 1) * 4 + nnz * 4 + n_used * hdim * 4
              + n_rows * 4 + 2 * n_rows * hdim * 4)
    flops = (nnz + n_rows) * hdim
    csr = schedule_csr(rows)
    lib_out = torch.sparse.mm(csr, h)
    check("K1 yardstick torch.sparse.mm", lib_out,
          k1.ell_apply(rows, h, phase="check"), k1_bound(rows, h))
    del lib_out
    t = {
        "H": hdim, "rows": n_rows, "nnz": nnz, "long_rows": rows.n_long,
        "h_rows_used": n_used, "bytes": nbytes, "flops": flops,
        "gathered_bytes": nnz * hdim * 4,
        "ms": cuda_ms(lambda: k1.ell_apply(rows, h, base, base_row,
                                           phase="check"), reps),
        "ms_no_base": cuda_ms(lambda: k1.ell_apply(rows, h, phase="check"),
                              reps),
        "plain_ms": cuda_ms(lambda: k1.ell_apply_plain(rows, h, base,
                                                       base_row), reps),
        "library_ms": cuda_ms(lambda: torch.sparse.mm(csr, h), reps),
        "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                        flops / F32_FLOPS_PER_S) * 1e3,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= flops / F32_FLOPS_PER_S else "operations"),
    }
    del csr
    torch.cuda.empty_cache()
    return t


def tf32_round(x):
    """x rounded to TF32 (10 mantissa bits, to nearest): what a kernel that
    ran K2 on the tensor cores in TF32 would read."""
    bits = x.contiguous().view(torch_int32())
    return ((bits + 0x1000) & ~0x1FFF).view(x.dtype)


def torch_int32():
    import torch
    return torch.int32


def compare_k2(fns, widths, gen, reps, detail):
    """K2 against its plain version on the forward and backward tile stacks
    at each width. Tolerance per element: a product with a zero tile entry
    adds exactly, so both sum only the row's n nonzero int8 x f32 products
    in f32 (fused or rounded once each) and differ by at most 2 n u sum|a x|
    (n from the tiles, sum|a x| the plain version on |x|; tiles are >= 0).
    Control: the same check must reject the plain version run on x rounded
    to TF32. With reps > 0, times one forward dense pass at widths[0] beside
    two one-call yardsticks: torch.sparse.mm (cuSPARSE) of the tiles'
    entries as one CSR matrix in cluster order, which computes the same
    function (held to the same bound), and torch.bmm of the dense tiles,
    which skips the segment sum. Its bound counts what the output needs
    whatever computes it: the packed entries, offsets, slabs and output over
    3.35 TB/s against 2 entries H FLOPs over 67 TFLOP/s; the dense-stack
    bound of the earlier kernels (the int8 tiles in place of the entries,
    2 nnz H FLOPs) stands beside it."""
    import torch
    from bnsgcn_tpu_torch.ops.block_spmm import build_x_slabs
    from bnsgcn_tpu_torch.ops.tile_matmul import (tile_matmul,
                                                  tile_matmul_plain)
    op = fns.spmm
    a = op.arrays
    max_err = max_rel = 0.0
    timing = None
    for direction, spec in (("fwd", op.fwd), ("bwd", op.bwd)):
        nrb = spec.n_row_blocks
        tiles = a[f"blk_tiles_{direction}"]
        rowb, colb = a[f"blk_rowb_{direction}"], a[f"blk_colb_{direction}"]
        off = a[f"blk_off_{direction}"]
        ent, ent_off = a[f"blk_ent_{direction}"], a[f"blk_entoff_{direction}"]
        perm_src = a["blk_perm_ext" if direction == "fwd" else "blk_perm_inner"]
        # nonzero terms of each output row: [n_row_blocks, TR, 1]
        n_row = torch.zeros((nrb + 1, spec.row_tile), dtype=torch.int64,
                            device=tiles.device).index_add_(
            0, rowb.long(), (tiles != 0).sum(-1))[:nrb, :, None]
        per_rb = (off[1:] - off[:-1]).long()
        for hdim in widths:
            h = torch.randn((spec.n_src, hdim), generator=gen, device="cuda")
            x = build_x_slabs(spec, perm_src, h)
            got = tile_matmul(tiles, rowb, colb, off, ent, ent_off, x, nrb,
                              phase="check")
            ref = tile_matmul_plain(tiles, rowb, colb, x, nrb)
            bound = 2 * n_row.clamp(min=1) * U32 * tile_matmul_plain(
                tiles, rowb, colb, x.abs(), nrb)
            e, rel = check(f"K2 {direction} H={hdim}", got, ref, bound)
            max_err, max_rel = max(max_err, e), max(max_rel, rel)
            detail.append({"kernel": "tile_matmul", "dir": direction,
                           "tiles": int(tiles.shape[0]), "H": hdim,
                           "entries": int(ent.numel()),
                           "max_row_terms": int(n_row.max()),
                           "tiles_per_row_block_max": int(per_rb.max()),
                           "tiles_per_row_block_mean":
                               float(per_rb.float().mean()),
                           "max_abs_err": e, "max_rel_err": rel})
            if hdim == widths[0]:
                try:
                    check("control", tile_matmul_plain(
                        tiles, rowb, colb, tf32_round(x), nrb), ref, bound)
                except AssertionError:
                    pass
                else:
                    raise AssertionError(
                        f"K2 {direction}: the tolerance admits x rounded to "
                        f"TF32; it cannot tell f32 from TF32")
            if direction == "fwd" and hdim == widths[0] and reps:
                timing = time_k2(spec, tiles, rowb, colb, off, ent, ent_off,
                                 x, ref, bound, per_rb, reps)
    return (max_err, max_rel), timing


def entries_csr(spec, rowb, colb, ent, ent_off):
    """The tiles' entries as one f32 CSR matrix [n_row_blocks TR, n_cb TC]
    in cluster order: what torch.sparse.mm needs to compute K2's function."""
    import torch
    b, tr1 = ent_off.shape
    tr, tc = tr1 - 1, spec.col_tile
    counts = (ent_off[:, 1:] - ent_off[:, :-1]).reshape(-1).long()
    tile_row = torch.repeat_interleave(
        torch.arange(b * tr, device=ent.device), counts)
    tile = tile_row // tr
    rows = rowb.long()[tile] * tr + tile_row % tr
    cols = colb.long()[tile] * tc + (ent >> 8).long()
    vals = (ent & 0xFF).to(torch.uint8).view(torch.int8).float()
    n_cb = (spec.n_src + tc - 1) // tc
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                  (spec.n_row_blocks * tr, n_cb * tc),
                                  check_invariants=False)
    return coo.coalesce().to_sparse_csr()


def time_k2(spec, tiles, rowb, colb, off, ent, ent_off, x, ref, bound,
            per_rb, reps):
    """One forward dense pass: K2, its plain version, torch.sparse.mm and
    torch.bmm, with the entries bound and the dense-stack bound."""
    import torch
    from bnsgcn_tpu_torch.ops.tile_matmul import (tile_matmul,
                                                  tile_matmul_plain)
    nrb = spec.n_row_blocks
    tr, tc = spec.row_tile, spec.col_tile
    hdim = x.shape[-1]
    live = rowb < nrb
    b_real = int(live.sum())
    nnz = int(tiles[live].sum(dtype=torch.int64))
    entries = int(ent.numel())
    out_bytes = nrb * tr * hdim * 4
    nbytes = (entries * 4 + b_real * (tr + 1) * 4 + (nrb + 1) * 4
              + b_real * 4 + x.numel() * 4 + out_bytes)
    flops = 2 * entries * hdim
    dense_bytes = (b_real * tr * tc + b_real * 8 + x.numel() * 4
                   + out_bytes)
    dense_flops = 2 * nnz * hdim
    csr = entries_csr(spec, rowb, colb, ent, ent_off)
    xf = x.view(-1, hdim)
    check("K2 yardstick torch.sparse.mm",
          torch.sparse.mm(csr, xf).view(nrb, tr, hdim), ref, bound)
    sparse_ms = cuda_ms(lambda: torch.sparse.mm(csr, xf), reps)
    del csr
    bmm_ms = None
    if b_real and b_real * (tr * tc + tc * hdim + tr * hdim) * 4 < 24 << 30:
        tf = tiles[live].float()
        xg = x[colb[live].long()]
        bmm_ms = cuda_ms(lambda: torch.bmm(tf, xg), reps)
        del tf, xg
    torch.cuda.empty_cache()
    return {
        "H": hdim, "tiles": b_real, "nnz": nnz, "entries": entries,
        "bytes": nbytes, "flops": flops,
        "tiles_per_row_block_max": int(per_rb.max()),
        "tiles_per_row_block_mean": float(per_rb.float().mean()),
        "ms": cuda_ms(lambda: tile_matmul(
            tiles, rowb, colb, off, ent, ent_off, x, nrb, phase="check"),
            reps),
        "plain_ms": cuda_ms(lambda: tile_matmul_plain(
            tiles, rowb, colb, x, nrb), reps),
        "library_ms": sparse_ms, "bmm_ms": bmm_ms,
        "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                        flops / F32_FLOPS_PER_S) * 1e3,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= flops / F32_FLOPS_PER_S else "operations"),
        "dense_bound_ms": max(dense_bytes / HBM_BYTES_PER_S,
                              dense_flops / F32_FLOPS_PER_S) * 1e3,
        "dense_flops": 2 * b_real * tr * tc * hdim,
    }


def l2_probe(gen, hdim, reps):
    """How fast the card serves rows that sit in its 50 MB L2, which the
    data sheet does not state: a probe, not a published rate. A table of
    L2_PROBE_ROWS x hdim f32 (16 MiB at 256) stays in L2 after a warm-up
    and is read three ways, each rate bytes read over time: a plain sum over
    32 stacked views of it (512 MiB read per call, so no launch-bound
    time), embedding_bag(mode="sum") gathering L2_PROBE_GATHER random rows
    and summing each row of indices (its output, 1/32 of the bytes read, is
    written besides), and K1 on the same gather as a CSR (one row of 32
    terms per output row). The L2 rate is the fastest of the three: the
    least the L2 is known to deliver."""
    import torch
    import torch.nn.functional as F
    from bnsgcn_tpu_torch.ops.bucket_sum import ell_apply, pack_rows
    from bnsgcn_tpu_torch.ops.ell import EllSpec
    table = torch.randn((L2_PROBE_ROWS, hdim), generator=gen, device="cuda")
    idx = torch.randint(0, L2_PROBE_ROWS, L2_PROBE_GATHER, generator=gen,
                        device="cuda")
    n_out, width = L2_PROBE_GATHER
    rows = pack_rows(EllSpec(widths=(width,), rows=(n_out,), n_rows=n_out,
                             n_src=L2_PROBE_ROWS), [idx.to(torch.int32)],
                     torch.arange(n_out, dtype=torch.int32, device="cuda"))
    gathered = idx.numel() * hdim * 4
    stacked = table.expand(32, *table.shape)
    stream_ms = cuda_ms(lambda: stacked.sum(), reps)
    bag_ms = cuda_ms(lambda: F.embedding_bag(idx, table, mode="sum"), reps)
    k1_ms = cuda_ms(lambda: ell_apply(rows, table, phase="check"), reps)
    out = {"table_bytes": table.numel() * 4, "gathered_bytes": gathered,
           "stream_bytes_per_s": stacked.numel() * 4 / (stream_ms * 1e-3),
           "gather_bytes_per_s": gathered / (bag_ms * 1e-3),
           "k1_bytes_per_s": gathered / (k1_ms * 1e-3)}
    out["l2_bytes_per_s"] = max(out["stream_bytes_per_s"],
                                out["gather_bytes_per_s"],
                                out["k1_bytes_per_s"])
    return out


def host_us(fn, n=HOST_CALLS):
    """Host microseconds per call of fn() (perf_counter over n calls, after
    a warm-up, without waiting for the device): the Python and launch cost
    that a short kernel's event time also records."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def compare_k3(gen, reps, detail):
    """K3 against its plain version at each of K3_CASES. Tolerance per
    element: two f32 sums of the same W terms differ by at most
    2 W u sum|x| (u = 2^-24, sum|x| the plain version on |g|); a bf16 result
    may also round to the neighbouring bf16 value, one ulp <= 2^-7 |ref|.
    Times every case; the first is the one the kernels line reports. Bound:
    each input element read once, each output written once, over 3.35 TB/s
    (the R W H adds over 67 TFLOP/s take far less)."""
    import torch
    from bnsgcn_tpu_torch.ops.bucket_reduce import (bucket_reduce,
                                                    bucket_reduce_plain)
    max_err, timings = 0.0, []
    for shape, dtype in K3_CASES:
        dt = getattr(torch, dtype)
        r, w, h = shape
        g = torch.randn(shape, generator=gen, device="cuda").to(dt)
        got = bucket_reduce(g, phase="check")
        ref = bucket_reduce_plain(g)
        bound = 2 * w * U32 * bucket_reduce_plain(g.abs().float())
        if dt == torch.bfloat16:
            bound = bound * (1 + 2.0 ** -7) + 2.0 ** -7 * ref.float().abs()
        e, rel = check(f"K3 {dtype} {shape}", got.float(), ref.float(),
                       bound)
        max_err = max(max_err, e)
        nbytes = (r * w * h + r * h) * g.element_size()
        adds = r * w * h
        t = {"shape": list(shape), "dtype": dtype, "max_abs_err": e,
             "max_rel_err": rel, "bytes": nbytes,
             "ms": cuda_ms(lambda: bucket_reduce(g, phase="check"), reps),
             "plain_ms": cuda_ms(lambda: bucket_reduce_plain(g), reps),
             "library_ms": cuda_ms(lambda: g.sum(1), reps),
             "host_us": host_us(lambda: bucket_reduce(g, phase="check")),
             "library_host_us": host_us(lambda: g.sum(1)),
             "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                             adds / F32_FLOPS_PER_S) * 1e3,
             "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                          >= adds / F32_FLOPS_PER_S else "operations")}
        timings.append(t)
        detail.append(dict(t, kernel="bucket_reduce"))
    return max_err, timings


def compare_k4(gen, reps, detail):
    """K4 bitwise against x[0:1] at the probe's shape; its time is launch
    latency (its bytes over 3.35 TB/s take nanoseconds), so besides the
    event times it reports the host microseconds per call of K4,
    x[0:1].clone() (its plain version, allocation included) and copy_, and
    where K4's go: the output's allocation alone and the C entry point's
    call alone (ctypes and the launch, no checks, no allocation)."""
    import torch
    from bnsgcn_tpu_torch import buildlib
    from bnsgcn_tpu_torch.ops import copy_probe as k4
    from bnsgcn_tpu_torch.ops.copy_probe import (PROBE_SHAPE, copy_probe,
                                                 copy_probe_plain)
    x = torch.randn(PROBE_SHAPE, generator=gen, device="cuda")
    got = copy_probe(x, phase="check")
    torch.cuda.synchronize()
    if not torch.equal(got, x[0:1]):
        raise AssertionError("K4: the copy differs from x[0:1]")
    out = torch.empty_like(got)
    nbytes = 2 * got.numel() * got.element_size()
    t = {"shape": list(PROBE_SHAPE), "bytes": nbytes, "max_abs_err": 0.0,
         "ms": cuda_ms(lambda: copy_probe(x, phase="check"), reps),
         "plain_ms": cuda_ms(lambda: copy_probe_plain(x), reps),
         "library_ms": cuda_ms(lambda: out.copy_(x[0:1]), reps),
         "host_us": host_us(lambda: copy_probe(x, phase="check")),
         "plain_host_us": host_us(lambda: copy_probe_plain(x)),
         "library_host_us": host_us(lambda: out.copy_(x[0:1])),
         "alloc_host_us": host_us(lambda: x.new_empty((1,) + x.shape[1:])),
         "launch_host_us": host_us(lambda: k4._kernel(
             x.data_ptr(), out.data_ptr(), nbytes // 2,
             buildlib.raw_stream(x.get_device()))),
         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    detail.append(dict(t, kernel="copy_probe"))
    return t


def rank_kernel_check(pr):
    """Run in every rank of the P-rank main path on its prepared part,
    before its launch counters are reset: K1 and K2 against their plain
    versions on the part's own layout, at H=n_hidden and the raw feature
    width. A disagreement raises, which fails the rank and the run."""
    import torch
    gen = torch.Generator(device=pr.device).manual_seed(1234 + pr.rank)
    widths = (pr.cfg.n_hidden, pr.cfg.n_feat)
    detail = []
    e1, _ = compare_k1(pr.fns, widths, gen, 0, detail)
    e2, _ = compare_k2(pr.fns, widths, gen, 0, detail)
    torch.cuda.empty_cache()
    return {"K1": e1, "K2": e2, "widths": widths, "detail": detail}


def plan_agreement(spec, tables, plans, bnd, gnid):
    """The BNS plans of all ranks agree without exchanging an index: for
    every pair (p, j) and every row k below send_size[p, j], the global id
    of sender p's sel[j, k] is the global id that receiver j's slot
    slots[p, k] stands for (the entry slots[p, k] - p B_pad of p's boundary
    list toward j), and the sender weighs it by inv_ratio[p, j]; every
    later row goes to the receiver's trash slot n_halo with weight 0.
    plans[r] = (sel, weight, slots) of rank r as numpy [P, S_pad]; bnd
    [P, P, B_pad] and gnid [P, pad_inner] the artifacts'. Returns the
    number of rows checked; raises on the first disagreement."""
    import numpy as np
    P, Bp, Sp = spec.n_parts, spec.pad_boundary, spec.pad_send
    rows = 0
    for p in range(P):
        sel, weight = plans[p][0], plans[p][1]
        for j in range(P):
            slots = plans[j][2][p]
            s = int(tables["send_size"][p, j])
            k = slots[:s] - p * Bp
            if not ((0 <= k) & (k < int(tables["n_b"][p, j]))).all():
                raise AssertionError(f"pair {p}->{j}: receiver slots outside "
                                     f"the sender's boundary list")
            sent = gnid[p, sel[j, :s]]
            meant = gnid[p, bnd[p, j, k]]
            bad = np.flatnonzero((sent != meant) | (sent < 0))
            if bad.size:
                raise AssertionError(
                    f"pair {p}->{j}: sender and receiver drew different rows "
                    f"(first at k={bad[0]})")
            if not ((slots[s:] == spec.n_halo).all()
                    and (weight[j, s:] == 0).all()
                    and (weight[j, :s] == tables["inv_ratio"][p, j]).all()):
                raise AssertionError(f"pair {p}->{j}: rows past send_size {s} "
                                     f"of {Sp} not trashed, or weights wrong")
            rows += s
    return rows


def parts_runs(cfg, args, part_path):
    """The P-rank path at --parts-scale: the P=4 == P=1 law, then the main
    path at P=4. Returns the details for the report."""
    import torch
    from bnsgcn_tpu_torch.data.datasets import load_data
    from bnsgcn_tpu_torch.run import run_training
    base = cfg.replace(dataset=f"synth-reddit:{args.parts_scale}",
                       part_path=part_path, dist_backend="gloo",
                       n_partitions=1, inductive=False)
    t0 = time.perf_counter()
    g, _, _ = load_data(base)
    log(f"[parts] synth-reddit:{args.parts_scale}: {g.n_nodes} nodes, "
        f"{g.n_edges} edges ({time.perf_counter() - t0:.1f} s)")

    # the law: P=4 (4 ranks sharing this card over gloo) == P=1
    law = base.replace(dropout=0.0, n_epochs=LAW_EPOCHS, log_every=1,
                       eval=False)
    t0 = time.perf_counter()
    r4 = run_training(law.replace(n_partitions=PARTS), g=g, log=log)
    r1 = run_training(law, g=g, log=log)
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(r4.losses, r1.losses))
    if not (len(r4.losses) == len(r1.losses) == LAW_EPOCHS
            and rel <= LAW_RTOL):
        raise AssertionError(f"P={PARTS} losses {r4.losses} differ from "
                             f"P=1's {r1.losses} by {rel:.3e} (relative)")
    log(f"[parts] law P={PARTS} == P=1, {LAW_EPOCHS} epochs, dropout 0: "
        f"max relative loss difference {rel:.3e} <= {LAW_RTOL} "
        f"({time.perf_counter() - t0:.1f} s)")

    # the main path at P=4 with the flagship's command line (inductive, at
    # its sampling rate), through the user's entry point; each rank checks
    # K1 and K2 on its own layout, resets its launch counts just before its
    # epoch loop and hands them back
    main4 = base.replace(n_partitions=PARTS, n_epochs=args.parts_epochs,
                         log_every=max(args.parts_epochs // 2, 1),
                         sampling_rate=BNS_RATE, inductive=True)
    res = run_training(main4, g=g, log=log, rank_hook=rank_kernel_check)
    for rep in res.ranks:
        hk = rep["hook"]
        log(f"[check] rank {rep['rank']}'s own layout: K1 max abs err "
            f"{hk['K1'][0]:.3e} (relative {hk['K1'][1]:.3e}), K2 "
            f"{hk['K2'][0]:.3e} ({hk['K2'][1]:.3e}) over "
            f"{len(hk['detail'])} checks at H={tuple(hk['widths'])}; every "
            f"element within its bound")
    log(f"[parts] inductive main path: {res.n_edges} edges of the train "
        f"subgraph over {PARTS} parts (the graph: {g.n_edges}); rank 0's "
        f"evaluations took " + ", ".join(f"{t:.2f}" for t in res.eval_seconds)
        + " s (on the train+val subgraph every "
        f"{main4.log_every} epochs, last the full graph's test)")
    passes = (main4.n_layers - 1) * main4.n_epochs
    want = {"fwd": passes, "bwd": passes, "pre": 1}
    for rep in res.ranks:
        for name, c in rep["launches"].items():
            if c != want:
                raise AssertionError(f"rank {rep['rank']}: {name} launched "
                                     f"{c}, not {want}")
    if not all(math.isfinite(x) for x in res.losses):
        raise AssertionError(f"P={PARTS}: non-finite loss: {res.losses}")
    if not res.losses[-1] < res.losses[0]:
        raise AssertionError(f"P={PARTS}: loss did not fall: {res.losses}")
    # inductive: the best validation accuracy on the train+val subgraph and
    # the test accuracy of those parameters on the full graph
    chance = 1.0 / g.n_class
    if not (2 * chance < res.val_acc <= 1.0
            and 2 * chance < res.test_acc <= 1.0):
        raise AssertionError(f"P={PARTS}: inductive val / test accuracy "
                             f"{res.val_acc:.3f} / {res.test_acc:.3f} is not "
                             f"above twice chance ({2 * chance:.3f})")
    ranks = []
    for rep in res.ranks:
        ep, ex, rd = (mean_from_1(rep[k]) for k in
                      ("epoch_times", "comm_times", "reduce_times"))
        share = ex / max(ep, 1e-12)
        ranks.append({"rank": rep["rank"], "device": rep["device"],
                      "epoch_s": ep, "exchange_s": ex, "reduce_s": rd,
                      "exchange_share": share,
                      "epoch_line_s": rep["epoch_time"],
                      "max_memory_gib": rep["max_memory_bytes"] / 2 ** 30,
                      "launches": rep["launches"]})
        log(f"[parts] rank {rep['rank']} ({rep['device']}; 4 ranks sharing "
            f"one card over gloo, not a 4-card number) at rate {BNS_RATE}, "
            f"inductive: mean of epochs 1.. {ep * 1e3:.1f} ms (the epoch "
            f"line's, epochs 5..: {rep['epoch_time'] * 1e3:.1f}), exchange "
            f"{ranks[-1]['exchange_s'] * 1e3:.1f} ms ({share:.1%} of the "
            f"epoch), gradient all-reduce {ranks[-1]['reduce_s'] * 1e3:.1f} "
            f"ms, peak memory {ranks[-1]['max_memory_gib']:.2f} GiB, "
            f"launches K1 {rep['launches']['K1']} K2 {rep['launches']['K2']}")
    bns = bns_phase(main4, r4, ranks, args.reps)
    recipe = recipe_p4(main4, g)
    return {"scale": args.parts_scale, "recipe": recipe,
            "law_losses_p4": r4.losses,
            "law_losses_p1": r1.losses, "law_max_rel": rel,
            "law_p1_epoch_s": mean_from_1(r1.epoch_times),
            "rate": BNS_RATE, "losses": res.losses, "val_acc": res.val_acc,
            "eval_seconds": res.eval_seconds,
            "test_acc": res.test_acc, "ranks": ranks, "bns": bns,
            "rank_checks": [rep["hook"] for rep in res.ranks]}, res


def bns_phase(cfg, law, ranks, reps):
    """[bns] at the P=4 artifacts: (a) every rank's plan for BNS_EPOCHS
    built on the card is array-equal to the same plan built on the CPU;
    (b) the card's plans agree across ranks (plan_agreement); (c) per rank,
    the wire MB of one exchange at H=n_hidden at cfg's rate beside rate
    1.0's, the plan's ms per epoch on the card (CUDA events over `reps`
    builds), and the exchange's share and the epoch at cfg's rate beside
    rate 1.0's (the law run: the same P and graph, dropout 0)."""
    import torch
    from bnsgcn_tpu_torch.data.artifacts import load_artifacts
    from bnsgcn_tpu_torch.parallel.halo import (make_halo_plan,
                                                make_halo_spec, tables_to,
                                                wire_bytes)
    from bnsgcn_tpu_torch.run import artifacts_dir
    from bnsgcn_tpu_torch.utils import prng
    t0 = time.perf_counter()
    art = load_artifacts(artifacts_dir(cfg))
    spec, tables = make_halo_spec(art.n_b, art.pad_inner, art.pad_boundary,
                                  cfg.sampling_rate)
    full, _ = make_halo_spec(art.n_b, art.pad_inner, art.pad_boundary, 1.0)
    on_card = tables_to(tables, "cuda")
    key_cpu, key_card = prng.key(cfg.seed), prng.key(cfg.seed, "cuda")
    plans = {e: [] for e in BNS_EPOCHS}
    out = []
    for r in range(PARTS):
        bnd = torch.from_numpy(art.bnd[r])
        bnd_card = bnd.cuda()
        for e in BNS_EPOCHS:
            want = make_halo_plan(spec, tables, bnd, r, e, key_cpu)
            got = make_halo_plan(spec, on_card, bnd_card, r, e, key_card)
            for name in ("sel", "weight", "slots"):
                if not torch.equal(getattr(got, name).cpu(),
                                   getattr(want, name)):
                    raise AssertionError(f"[bns] rank {r} epoch {e}: the "
                                         f"card's {name} differs from the "
                                         f"CPU's")
            plans[e].append(tuple(getattr(got, n).cpu().numpy()
                                  for n in ("sel", "weight", "slots")))
        plan_ms = cuda_ms(lambda: make_halo_plan(spec, on_card, bnd_card, r,
                                                 0, key_card), reps)
        rep1 = law.ranks[r]
        ep1 = mean_from_1(rep1["epoch_times"])
        ex1 = mean_from_1(rep1["comm_times"])
        out.append({
            "rank": r, "plan_ms": plan_ms,
            "wire_mb": wire_bytes(spec, cfg.n_hidden) / 1e6,
            "wire_mb_rate1": wire_bytes(full, cfg.n_hidden) / 1e6,
            "sampled_rows": int(tables["send_size"][r].sum()),
            "boundary_rows": int(tables["n_b"][r].sum()),
            "epoch_s": ranks[r]["epoch_s"],
            "exchange_share": ranks[r]["exchange_share"],
            "epoch_s_rate1": ep1,
            "exchange_share_rate1": ex1 / max(ep1, 1e-12)})
    rows = [plan_agreement(spec, tables, plans[e], art.bnd, art.global_nid)
            for e in BNS_EPOCHS]
    log(f"[bns] rate {cfg.sampling_rate} on {int(art.n_inner.sum())} nodes"
        f"{' (the train subgraph)' if cfg.inductive else ''}: S_pad "
        f"{spec.pad_send} (rate 1.0: {full.pad_send}); every rank's plan "
        f"for epochs {BNS_EPOCHS} built "
        f"on the card is array-equal to the CPU's; the ranks' plans agree "
        f"pair by pair ({rows} sampled rows, the rest trashed) "
        f"({time.perf_counter() - t0:.1f} s)")
    for x in out:
        log(f"[bns] rank {x['rank']} (4 ranks sharing one card over gloo): "
            f"{x['sampled_rows']} of {x['boundary_rows']} boundary rows sent; "
            f"wire {x['wire_mb']:.2f} MB per exchange at H={cfg.n_hidden} "
            f"(rate 1.0: {x['wire_mb_rate1']:.2f}); plan {x['plan_ms']:.3f} "
            f"ms per epoch (events); exchange {x['exchange_share']:.1%} of a "
            f"{x['epoch_s'] * 1e3:.1f} ms epoch, means of epochs 1.. (rate "
            f"1.0, dropout 0, transductive: "
            f"{x['exchange_share_rate1']:.1%} of {x['epoch_s_rate1'] * 1e3:.1f}"
            f" ms)")
    return {"pad_send": spec.pad_send, "pad_send_rate1": full.pad_send,
            "agreed_rows": rows, "ranks": out}


def run_cli(argv, timeout_s=CLI_TIMEOUT_S):
    """Run `bash scripts/reddit_torch.sh argv` from the repo root in a
    session of its own; returns its stdout. A non-zero exit raises with
    the end of its output; past the timeout the whole session (the CLI and
    the ranks it spawned) is killed."""
    env = dict(os.environ, PYTHON=sys.executable)
    p = subprocess.Popen(["bash", CLI_SCRIPT] + argv, cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise AssertionError(f"[cli] {' '.join(argv)}: no exit within "
                             f"{timeout_s} s")
    if p.returncode != 0:
        raise AssertionError(f"[cli] {' '.join(argv)} exited "
                             f"{p.returncode}:\n{out[-3000:]}")
    return out


def cli_losses(out):
    """(first epoch, losses) from the CLI's `LOSSES from_epoch=E ...`."""
    line = [ln for ln in out.splitlines() if ln.startswith("LOSSES ")][-1]
    _, start, values = line.split(" ")
    return int(start.split("=")[1]), [float(x) for x in values.split(",")]


def cli_phase(work):
    """[cli]: scripts/reddit_torch.sh with CLI_FLAGS trains CLI_EPOCHS[0]
    epochs (epoch lines, inductive accuracy lines, Test Result, periodic
    and final checkpoints, the results file), resumes to CLI_EPOCHS[1]
    from the newest checkpoint, and an uninterrupted CLI_EPOCHS[1]-epoch run
    beside it gives the resumed epochs' losses to CLI_RTOL (relative).
    Returns the details."""
    t0 = time.perf_counter()
    d = {k: os.path.join(work, "cli", k)
         for k in ("parts", "results", "ckpt", "ckpt_whole")}
    paths = ["--part-path", d["parts"], "--results-path", d["results"]]
    first, last = CLI_EPOCHS
    out1 = run_cli(CLI_FLAGS + paths + ["--n-epochs", str(first),
                                        "--ckpt-path", d["ckpt"]])
    lines = out1.splitlines()
    evals = [ln for ln in lines if ln.startswith("Epoch ")
             and " | Accuracy " in ln]
    want = {"epoch lines": f"Process 000 | Epoch {first - 1:05d} | Time(s)",
            "Test Result": "Test Result | Accuracy ",
            "model saved": "model saved"}
    missing = [k for k, v in want.items() if not any(v in ln for ln in lines)]
    if missing or len(evals) != first // 4:
        raise AssertionError(f"[cli] the {first}-epoch run printed no "
                             f"{missing or 'accuracy lines'}:\n{out1[-3000:]}")
    ckpts = sorted(os.listdir(d["ckpt"]))
    periodic = [f for f in ckpts if not f.endswith("_final.ckpt")]
    finals = [f for f in ckpts if f.endswith("_final.ckpt")]
    results = os.listdir(d["results"])
    if len(periodic) != first // 4 or len(finals) != 1 or len(results) != 1:
        raise AssertionError(f"[cli] checkpoints {ckpts}, results {results}: "
                             f"expected {first // 4} periodic, the final and "
                             f"one results file")
    with open(os.path.join(d["results"], results[0])) as f:
        if f.read().splitlines() != evals:
            raise AssertionError("[cli] the results file is not the run's "
                                 "accuracy lines")
    out2 = run_cli(CLI_FLAGS + paths + ["--n-epochs", str(last),
                                        "--ckpt-path", d["ckpt"], "--resume",
                                        "--skip-partition"])
    out3 = run_cli(CLI_FLAGS + paths + ["--n-epochs", str(last),
                                        "--ckpt-path", d["ckpt_whole"],
                                        "--skip-partition"])
    start, resumed = cli_losses(out2)
    start3, whole = cli_losses(out3)
    if not (start == first and f"at epoch {first}" in out2
            and start3 == 0 and len(whole) == last
            and len(resumed) == last - first):
        raise AssertionError(f"[cli] the resumed run started at epoch {start} "
                             f"with {len(resumed)} losses, the whole run at "
                             f"{start3} with {len(whole)}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, whole[first:]))
    if not rel <= CLI_RTOL:
        raise AssertionError(f"[cli] resumed losses {resumed} differ from the "
                             f"uninterrupted run's {whole[first:]} by "
                             f"{rel:.3e} (relative)")
    secs = time.perf_counter() - t0
    log(f"[cli] bash {CLI_SCRIPT} {' '.join(CLI_FLAGS)}: {first} epochs with "
        f"{len(evals)} inductive evals ({evals[-1]}), {len(periodic)} "
        f"periodic checkpoints + the final, the results file; --resume "
        f"--n-epochs {last} started at epoch {first}, its losses equal the "
        f"uninterrupted run's to {rel:.3e} (relative, <= {CLI_RTOL}) "
        f"({secs:.1f} s for the three runs)")
    return {"losses_resumed": resumed, "losses_whole": whole, "max_rel": rel,
            "evals": evals, "checkpoints": ckpts, "seconds": secs}


def small_agreement(base_cfg):
    """The same short dropout-free hybrid run on the card (kernels) and on
    the CPU (plain versions): the losses must agree to 1e-4 (f32 sums in
    another order, over 4 epochs of Adam)."""
    from bnsgcn_tpu_torch.run import run_training
    cfg = base_cfg.replace(dataset="sbm", n_layers=3, n_hidden=64,
                           dropout=0.0, block_tile=64, block_occupancy=8,
                           n_epochs=4, log_every=1000, eval=False)
    quiet = lambda m: None
    gpu = run_training(cfg.replace(device="cuda"), log=quiet).losses
    cpu = run_training(cfg.replace(device="cpu"), log=quiet).losses
    diff = max(abs(a - b) for a, b in zip(gpu, cpu))
    if not diff <= 1e-4:
        raise AssertionError(f"card and CPU losses differ by {diff:.3e}: "
                             f"{gpu} vs {cpu}")
    log(f"[agree] sbm 3x64 hybrid, 4 epochs: card {gpu[-1]:.6f} vs CPU "
        f"{cpu[-1]:.6f}, max |diff| {diff:.2e} <= 1e-4")


def lowp_k1_bound(rows, h, scale, acc_ref, ref):
    """Per element, for K1 on rows of a narrow float type: the f32
    accumulators differ by at most 2 n u sum|x| (n the row's terms, u =
    2^-24, sum|x| the plain version on |x|, times the scale); a bf16 out
    rounds the residual and then base + residual, each a half ulp on either
    side, 2^-7 (|a| + |out|) together (acc_ref: the plain accumulator times
    the scale, in f32); (1 + 2^-6) covers the bound's own rounding."""
    from bnsgcn_tpu_torch.ops.bucket_sum import ell_apply_plain
    n = (rows.row_ptr[1:] - rows.row_ptr[:-1]).long()[:, None]
    mag = ell_apply_plain(rows, h.float().abs())
    if scale is not None:
        mag = mag * scale
    return (1 + 2.0 ** -6) * (2 * n.clamp(min=1) * U32 * mag + 2.0 ** -7 * (
        acc_ref.abs() + ref.float().abs()))


def last_terms(rows, hf):
    """[n_rows, H]: each row's last term of hf (zero for an empty row), what
    a K1 that dropped each row's last index would miss."""
    import torch
    deg = rows.row_ptr[1:] - rows.row_ptr[:-1]
    out = torch.zeros((rows.n_rows, hf.shape[1]), device=hf.device)
    has = deg > 0
    out[has] = hf[rows.src[(rows.row_ptr[1:][has] - 1).long()].long()]
    return out


def compare_k1_lowp(fns, widths, gen, reps, detail,
                    kinds=("bf16", "int8", "fp8")):
    """K1's narrow-row variants (`kinds`) on the hybrid's residual layout,
    both directions, as the low-precision main path calls them: bf16, int8
    and e4m3 rows with K2's f32 output shape as the base, out bf16, at
    widths[0] (bf16 also at widths[1], the precompute's raw feature width).
    int8: bitwise equal to the
    plain version, and its raw int32 sums too; bf16 and e4m3 within
    lowp_k1_bound, and the plain version minus each row's last term must be
    rejected (the control). Times each forward at widths[0]. Returns
    {variant: (max abs err, timing)}."""
    import torch
    from bnsgcn_tpu_torch.ops.bucket_sum import ell_apply, ell_apply_plain
    from bnsgcn_tpu_torch.ops.ell import gather_quant
    op = fns.spmm
    out = {}
    for kind, ws in (("bf16", widths), ("int8", widths[:1]),
                     ("fp8", widths[:1])):
        if kind not in kinds:
            continue
        max_err, timing = 0.0, None
        for direction in ("fwd", "bwd"):
            for hdim in ws:
                rows, h, base, base_row = k1_inputs(op, direction, hdim, gen)
                hq, scale = ((h.to(torch.bfloat16), None) if kind == "bf16"
                             else gather_quant(h, kind))
                args = (rows, hq, base, base_row)
                kw = dict(scale=scale, out_dtype=torch.bfloat16)
                got = ell_apply(*args, phase="check", **kw)
                again = ell_apply(*args, phase="check", **kw)
                ref = ell_apply_plain(*args, **kw)
                if not torch.equal(got, again):
                    raise AssertionError(f"K1 {kind} {direction} H={hdim}: "
                                         f"two calls differ")
                hf = hq.float()
                acc = ell_apply_plain(rows, hf)
                if scale is not None:
                    acc = acc * scale
                wrong = ref.float() - last_terms(rows, hf) * (
                    1.0 if scale is None else scale)
                if kind == "int8":
                    raw = ell_apply(rows, hq, phase="check")
                    if not (torch.equal(got, ref) and torch.equal(
                            raw, ell_apply_plain(rows, hq))):
                        raise AssertionError(f"K1 int8 {direction} H={hdim}: "
                                             f"not bitwise the plain version")
                    e = 0.0
                    if torch.equal(got.float(), wrong):
                        raise AssertionError("K1 int8 control: dropping "
                                             "each row's last term passed")
                else:
                    bound = lowp_k1_bound(rows, hq, scale, acc, ref)
                    e, _ = check(f"K1 {kind} {direction} H={hdim}",
                                 got.float(), ref.float(), bound)
                    try:
                        check("control", wrong, ref.float(), bound)
                    except AssertionError:
                        pass
                    else:
                        raise AssertionError(
                            f"K1 {kind}: the bound admits dropping each "
                            f"row's last term")
                max_err = max(max_err, e)
                detail.append({"kernel": f"ell_bucket_sum_{kind}",
                               "dir": direction, "H": hdim,
                               "max_abs_err": e, "bitwise": kind == "int8"})
                if direction == "fwd" and hdim == widths[0] and reps:
                    timing = time_k1_lowp(kind, rows, hq, scale, base,
                                          base_row, reps)
                del got, again, ref, acc, wrong
        out[kind] = (max_err, timing)
        torch.cuda.empty_cache()
    return out


def time_k1_lowp(kind, rows, hq, scale, base, base_row, reps):
    """One forward residual pass of a narrow-row variant as the main path
    calls it (base f32, out bf16): kernel, plain version, and the one
    PyTorch call that computes the same sums where there is one:
    torch.sparse.mm on bf16 (cuSPARSE), none for int8 -> int32 or e4m3.
    Bound: the CSR, each used row of hq, the base rows and indices and
    the bf16 output once over 3.35 TB/s, against the adds over the 67
    TFLOP/s outside the tensor cores."""
    import torch
    from bnsgcn_tpu_torch.ops.bucket_sum import ell_apply, ell_apply_plain
    hdim = hq.shape[1]
    n_rows, nnz = rows.n_rows, int(rows.src.numel())
    n_used = int(torch.unique(rows.src).numel())
    nbytes = ((n_rows + 1) * 4 + nnz * 4 + n_used * hdim * hq.element_size()
              + n_rows * 4 + n_rows * hdim * 4 + n_rows * hdim * 2)
    ops = (nnz + n_rows) * hdim
    kw = dict(scale=scale, out_dtype=torch.bfloat16)
    lib = lib_error = None
    if kind == "bf16":
        try:
            csr = schedule_csr(rows).to(torch.bfloat16)
            lib = cuda_ms(lambda: torch.sparse.mm(csr, hq), reps)
            del csr
        except (RuntimeError, NotImplementedError) as e:
            lib_error = str(e)[:200]    # no bf16 sparse.mm in this build
    t = {"kind": kind, "H": hdim, "rows": n_rows, "nnz": nnz,
         "bytes": nbytes, "ops": ops, "library_error": lib_error,
         "gathered_bytes": nnz * hdim * hq.element_size(),
         "ms": cuda_ms(lambda: ell_apply(rows, hq, base, base_row,
                                         phase="check", **kw), reps),
         "plain_ms": cuda_ms(lambda: ell_apply_plain(rows, hq, base,
                                                     base_row, **kw), reps),
         "library_ms": lib,
         "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                         ops / F32_FLOPS_PER_S) * 1e3,
         "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                      >= ops / F32_FLOPS_PER_S else "operations")}
    torch.cuda.empty_cache()
    return t


def compare_k2_lowp(fns, widths, gen, reps, detail,
                    kinds=("bf16", "int8", "int8-slab")):
    """K2's narrow-slab variants (`kinds`) on the forward and backward tile
    stacks at widths[0]: bf16 slabs (also at widths[1], the raw feature
    width) within 2 n u sum|a x| (the products are exact in f32); int8
    slabs with one per-call scale (raw int32 sums) and with per-slab scales
    (each tile's int32 sums scaled and added in tile order), both bitwise
    equal to the plain version. Control:
    the plain version skipping each row-block's last tile must be rejected.
    Times each forward at widths[0]. Returns {variant: (max abs err,
    timing)}."""
    import torch
    from bnsgcn_tpu_torch.ops.block_spmm import build_x_slabs, quantize_slabs
    from bnsgcn_tpu_torch.ops.tile_matmul import (k_major, tile_matmul,
                                                  tile_matmul_plain)
    op = fns.spmm
    a = op.arrays
    out = {}
    for kind, ws in (("bf16", widths), ("int8", widths[:1]),
                     ("int8-slab", widths[:1])):
        if kind not in kinds:
            continue
        max_err, timing = 0.0, None
        for direction, spec in (("fwd", op.fwd), ("bwd", op.bwd)):
            nrb = spec.n_row_blocks
            tiles = a[f"blk_tiles_{direction}"]
            rowb, colb = (a[f"blk_rowb_{direction}"],
                          a[f"blk_colb_{direction}"])
            off = a[f"blk_off_{direction}"]
            ent, ent_off = (a[f"blk_ent_{direction}"],
                            a[f"blk_entoff_{direction}"])
            perm = a["blk_perm_ext" if direction == "fwd"
                     else "blk_perm_inner"]
            last = off[1:][off[1:] > off[:-1]].long() - 1
            keep = torch.ones(len(rowb), dtype=torch.int8, device="cuda")
            keep[last] = 0
            for hdim in ws:
                h = torch.randn((spec.n_src, hdim), generator=gen,
                                device="cuda")
                x = build_x_slabs(spec, perm, h)
                scale = None
                if kind == "bf16":
                    x = k_major(x.to(torch.bfloat16))
                else:
                    x, sc = quantize_slabs(x, per_slab=kind == "int8-slab")
                    scale = sc if kind == "int8-slab" else None
                got = tile_matmul(tiles, rowb, colb, off, ent, ent_off, x,
                                  nrb, slab_scale=scale, phase="check")
                ref = tile_matmul_plain(tiles, rowb, colb, x, nrb, scale)
                skipped = tile_matmul_plain(tiles * keep[:, None, None],
                                            rowb, colb, x, nrb, scale)
                if kind == "bf16":
                    n_row = torch.zeros((nrb + 1, spec.row_tile),
                                        dtype=torch.int64,
                                        device="cuda").index_add_(
                        0, rowb.long(), (tiles != 0).sum(-1))[:nrb, :, None]
                    bound = 2 * n_row.clamp(min=1) * U32 * tile_matmul_plain(
                        tiles, rowb, colb, x.abs(), nrb)
                    e, _ = check(f"K2 bf16 {direction} H={hdim}", got, ref,
                                 bound)
                    try:
                        check("control", skipped, ref, bound)
                    except AssertionError:
                        pass
                    else:
                        raise AssertionError("K2 bf16: the bound admits "
                                             "skipping each row-block's last "
                                             "tile")
                    del n_row, bound
                else:
                    if not torch.equal(got, ref):
                        raise AssertionError(f"K2 {kind} {direction} "
                                             f"H={hdim}: not bitwise the "
                                             f"plain version")
                    if torch.equal(got, skipped):
                        raise AssertionError(f"K2 {kind} control: skipping "
                                             f"each row-block's last tile "
                                             f"passed")
                    e = 0.0
                max_err = max(max_err, e)
                detail.append({"kernel": f"tile_matmul_{kind}",
                               "dir": direction, "H": hdim,
                               "max_abs_err": e, "bitwise": kind != "bf16"})
                if direction == "fwd" and hdim == widths[0] and reps:
                    timing = time_k2_lowp(kind, spec, tiles, rowb, colb, off,
                                          ent, ent_off, x, scale, reps)
                del got, ref, skipped, x
        out[kind] = (max_err, timing)
        torch.cuda.empty_cache()
    return out


def time_k2_lowp(kind, spec, tiles, rowb, colb, off, ent, ent_off, x, scale,
                 reps):
    """One forward dense pass of a narrow-slab variant (the tensor-core
    kernel): kernel, plain version, and torch.sparse.mm on bf16 (cuSPARSE)
    where PyTorch has the function (none for int8 x int8 -> int32). Bound:
    the packed entries, offsets, slabs (and scales) and the output once
    over 3.35 TB/s, against 2 entries H operations over the tensor cores'
    dense peak for the type (989 TFLOP/s bf16, 1979 TOPS int8): what the
    function needs, whatever computes it. Beside it, the floor of the
    tensor-core design, which computes every tile entry: the dense tile
    bytes, slabs, scales and output over 3.35 TB/s against 2 B TR TC H
    operations over the same peak; a dense-equivalent GEMM, not the same
    function: one torch._int_mm (int8) or torch.matmul (bf16) of the tile
    stack as [B TR, TC] with one slab [TC, H], the same multiply-adds over
    the same tile bytes without the segment sum (an error string where
    PyTorch refuses the call); and the card's device-memory rate on these
    tiles: one copy of the tile stack (its bytes read and written once)."""
    import torch
    from bnsgcn_tpu_torch.ops.tile_matmul import (slab_dims, tile_matmul,
                                                  tile_matmul_plain)
    nrb, tr, tc = spec.n_row_blocks, spec.row_tile, spec.col_tile
    hdim = slab_dims(x)[2]
    b_real = int((rowb < nrb).sum())
    entries = int(ent.numel())
    out_bytes = nrb * tr * hdim * 4
    slab_bytes = (x.numel() * x.element_size()
                  + (0 if scale is None else scale.numel() * 4))
    nbytes = (entries * 4 + b_real * (tr + 1) * 4 + (nrb + 1) * 4
              + b_real * 4 + slab_bytes + out_bytes)
    ops = 2 * entries * hdim
    peak = BF16_TC_FLOPS_PER_S if kind == "bf16" else INT8_TC_OPS_PER_S
    dense_bytes = b_real * tr * tc + b_real * 4 + (nrb + 1) * 8 + \
        slab_bytes + out_bytes
    dense_ops = 2 * b_real * tr * tc * hdim
    lib = lib_error = None
    if kind == "bf16":
        try:
            csr = entries_csr(spec, rowb, colb, ent, ent_off).to(
                torch.bfloat16)
            xf = x.transpose(1, 2).reshape(-1, hdim)   # [n_cb TC, H]
            lib = cuda_ms(lambda: torch.sparse.mm(csr, xf), reps)
            del csr
        except (RuntimeError, NotImplementedError) as e:
            lib_error = str(e)[:200]    # no bf16 sparse.mm in this build
    gemm = gemm_error = None
    try:
        a = tiles[:b_real].view(-1, tc)     # pads lie past the real tiles
        if kind == "bf16":                  # x[0].t(): [TC, H], K-major
            a = a.to(torch.bfloat16)
            gemm = cuda_ms(lambda: torch.matmul(a, x[0].t()), reps)
        else:
            gemm = cuda_ms(lambda: torch._int_mm(a, x[0].t()), reps)
        del a
    except (RuntimeError, NotImplementedError) as e:
        gemm_error = str(e)[:200]
    t = {"kind": kind, "H": hdim, "entries": entries, "bytes": nbytes,
         "ops": ops, "peak_ops_per_s": peak, "library_error": lib_error,
         "ms": cuda_ms(lambda: tile_matmul(tiles, rowb, colb, off, ent,
                                           ent_off, x, nrb, slab_scale=scale,
                                           phase="check"), reps),
         "plain_ms": cuda_ms(lambda: tile_matmul_plain(tiles, rowb, colb, x,
                                                       nrb, scale), reps),
         "library_ms": lib,
         "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / peak) * 1e3,
         "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / peak
                      else "operations"),
         "dense_bytes": dense_bytes, "dense_ops": dense_ops,
         "floor_ms": max(dense_bytes / HBM_BYTES_PER_S,
                         dense_ops / peak) * 1e3,
         "floor_by": ("bytes" if dense_bytes / HBM_BYTES_PER_S
                      >= dense_ops / peak else "operations"),
         "gemm_ms": gemm, "gemm_error": gemm_error,
         "tile_copy_ms": cuda_ms(lambda: torch.empty_like(tiles).copy_(tiles),
                                 reps),
         "tile_bytes": tiles.numel()}
    torch.cuda.empty_cache()
    return t


def dtype_run(name, c, pr, want, **kw):
    """One training run of c on the P=1 phase's graph and layouts (no
    rebuild: the operator shares them and changes only its dtypes; `kw`,
    the row cap, goes to prepare_part): the SpMM must be the hybrid, the
    launch counts by variant, reset just before the run and read just
    after, must be `want` (K1's, K2's), and the losses finite."""
    import torch
    from bnsgcn_tpu_torch.ops import bucket_sum, tile_matmul
    from bnsgcn_tpu_torch.run import prepare_part, run_training
    t0 = time.perf_counter()
    pl = prepare_part(c, pr.art, (pr.val_g, pr.test_g), pr.device, log,
                      reuse=pr.fns, **kw)
    setup_s = time.perf_counter() - t0
    if pl.fns.spmm_kind != "hybrid":
        raise AssertionError(f"{name}: spmm={c.spmm} resolved to "
                             f"{pl.fns.spmm_kind}, not hybrid")
    bucket_sum.launches.reset()
    tile_matmul.launches.reset()
    torch.cuda.reset_peak_memory_stats()
    res = run_training(c, log=log, prepared=pl)
    k1 = dict(bucket_sum.launches.by_kind)
    k2 = dict(tile_matmul.launches.by_kind)
    if (k1, k2) != want:
        raise AssertionError(f"{name}: K1 launched {k1}, K2 {k2}; expected "
                             f"{want[0]} and {want[1]}")
    if not all(math.isfinite(x) for x in res.losses):
        raise AssertionError(f"{name}: non-finite loss {res.losses}")
    out = {"losses": res.losses, "epoch_times_s": res.epoch_times,
           "epoch_from_1_s": mean_from_1(res.epoch_times),
           "launches": {"K1": k1, "K2": k2}, "setup_s": setup_s,
           "modes": dict(pl.fns.spmm.mode),
           "max_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "val_acc": res.val_acc, "test_acc": res.test_acc}
    del pl, res
    torch.cuda.empty_cache()
    return out


def lowp_runs(cfg, pr, args):
    """[lowp] training on the P=1 phase's graph and layouts (dtype_run):
    the recipe's finer knobs, args.epochs epochs of --dtype bfloat16 --spmm
    auto --use-pallas --spmm-dense int8 --spmm-gather int8 (auto must pick
    the hybrid), K1 and K2 launched int8 on every aggregation and bf16 in
    the precompute, K2 on the tensor cores; then the guard's route,
    LOWP_GUARD_EPOCHS epochs of the same stack (--spmm hybrid, the pick
    made) with e4m3 gathers and the dense tiles held past their int8 row
    cap (row_cap 0), so they take the per-slab mode."""
    lc = cfg.replace(dtype="bfloat16", spmm="auto", use_pallas=True,
                     spmm_dense="int8", spmm_gather="int8")
    out = {}
    for name, c, n_ep, kw in (
            ("main", lc, args.epochs, {}),
            ("guard", lc.replace(spmm="hybrid", spmm_gather="fp8",
                                 eval=False),
             LOWP_GUARD_EPOCHS, {"row_cap": 0})):
        passes = (c.n_layers - 1) * n_ep * 2
        q1 = "int8" if c.spmm_gather == "int8" else "fp8"
        q2 = "tc-int8" if name == "main" else "tc-int8-slab"
        out[name] = dtype_run(f"[lowp] {name}",
                              c.replace(n_epochs=n_ep, log_every=n_ep), pr,
                              ({q1: passes, "bf16": 1},
                               {q2: passes, "tc-bf16": 1}), **kw)
    return out


def recipe_want(c):
    """The launch counts by variant of a RECIPE_TPU run of c, on every
    rank: K1 on bf16 rows and K2 on bf16 slabs once per aggregation (the
    n_layers - 1 layers after the precompute, forward and backward, every
    epoch) plus the precompute's one."""
    n = (c.n_layers - 1) * c.n_epochs * 2 + 1
    return {"bf16": n}, {"tc-bf16": n}


def recipe_p1(cfg, pr, args):
    """[recipe] at P=1: args.epochs epochs of the P=1 main path's model
    with RECIPE_TPU on its graph and layouts (dtype_run: auto must pick the
    hybrid; K1 and K2 bf16 on every aggregation); the loss must fall."""
    c = cfg.replace(**recipe_fields(), n_epochs=args.epochs,
                    log_every=args.epochs)
    x = dtype_run("[recipe] P=1", c, pr, recipe_want(c))
    if not x["losses"][-1] < x["losses"][0]:
        raise AssertionError(f"[recipe] P=1: loss did not fall: "
                             f"{x['losses']}")
    return x


def rank_kernel_check_bf16(pr):
    """[recipe]'s rank hook at P=4: K1 on bf16 rows and K2 on bf16 slabs
    against their plain versions on the rank's own layout, at H=n_hidden
    and the raw feature width, with phase 2's bounds and controls
    (compare_k1_lowp, compare_k2_lowp)."""
    import torch
    if pr.fns.spmm_kind != "hybrid":
        raise AssertionError(f"[recipe] rank {pr.rank}: spmm={pr.cfg.spmm} "
                             f"resolved to {pr.fns.spmm_kind}, not hybrid")
    gen = torch.Generator(device=pr.device).manual_seed(4321 + pr.rank)
    widths = (pr.cfg.n_hidden, pr.cfg.n_feat)
    detail = []
    k1 = compare_k1_lowp(pr.fns, widths, gen, 0, detail, kinds=("bf16",))
    k2 = compare_k2_lowp(pr.fns, widths, gen, 0, detail, kinds=("bf16",))
    torch.cuda.empty_cache()
    return {"K1": k1["bf16"][0], "K2": k2["bf16"][0], "widths": widths,
            "detail": detail}


def recipe_p4(main4, g):
    """[recipe] at P=4: RECIPE_TPU appended to the P=4 main path's command
    line (the flagship's: --inductive, rate 0.1, dropout 0.5; 4 ranks
    sharing the card over gloo), RECIPE_P4_EPOCHS epochs on its artifacts
    (--skip-partition). Each rank first holds K1 and K2 on bf16 to their
    plain versions (rank_kernel_check_bf16); then every rank's launch
    counts must be recipe_want's, the loss finite, and the ranks end with
    rank 0's parameters (run_training checks). Returns the details, with
    the int8 wire's MB per exchange beside the f32 path's."""
    from bnsgcn_tpu_torch.data.artifacts import load_artifacts
    from bnsgcn_tpu_torch.parallel.halo import make_halo_spec, wire_bytes
    from bnsgcn_tpu_torch.run import artifacts_dir, run_training
    c = main4.replace(**recipe_fields(), n_epochs=RECIPE_P4_EPOCHS,
                      log_every=RECIPE_P4_EPOCHS, skip_partition=True)
    t0 = time.perf_counter()
    res = run_training(c, g=g, log=log, rank_hook=rank_kernel_check_bf16)
    secs = time.perf_counter() - t0
    want = dict(zip(("K1", "K2"), recipe_want(c)))
    for rep in res.ranks:
        if rep["kinds"] != want:
            raise AssertionError(f"[recipe] P={PARTS} rank {rep['rank']}: "
                                 f"launched {rep['kinds']}, not {want}")
    if not all(math.isfinite(x) for x in res.losses):
        raise AssertionError(f"[recipe] P={PARTS}: non-finite loss "
                             f"{res.losses}")
    art = load_artifacts(artifacts_dir(c), parts=[0])
    wire = {}
    for name in ("native", c.halo_wire):
        spec, _ = make_halo_spec(art.n_b, art.pad_inner, art.pad_boundary,
                                 c.sampling_rate, wire=name)
        wire[name] = wire_bytes(spec, c.n_hidden) / 1e6
    ranks = []
    for rep in res.ranks:
        ep, ex = (mean_from_1(rep[k]) for k in ("epoch_times", "comm_times"))
        ranks.append({"rank": rep["rank"], "epoch_s": ep, "exchange_s": ex,
                      "exchange_share": ex / max(ep, 1e-12),
                      "reduce_s": mean_from_1(rep["reduce_times"]),
                      "max_memory_gib": rep["max_memory_bytes"] / 2 ** 30,
                      "launches": rep["kinds"], "check": rep["hook"]})
    for x in ranks:
        log(f"[recipe] P={PARTS} rank {x['rank']} (4 ranks sharing one card "
            f"over gloo, not a 4-card number), {' '.join(RECIPE_TPU)}, "
            f"inductive, rate {c.sampling_rate}: mean of epochs 1.. "
            f"{x['epoch_s'] * 1e3:.1f} ms, exchange "
            f"{x['exchange_s'] * 1e3:.1f} ms ({x['exchange_share']:.1%} of "
            f"the epoch), all-reduce {x['reduce_s'] * 1e3:.1f} ms, peak "
            f"memory {x['max_memory_gib']:.2f} GiB; launches K1 "
            f"{x['launches']['K1']} K2 {x['launches']['K2']}; K1 bf16 max "
            f"abs err {x['check']['K1']:.3e}, K2 bf16 "
            f"{x['check']['K2']:.3e} on its own layout at H="
            f"{tuple(x['check']['widths'])} (within their bounds, the "
            f"controls rejected)")
    log(f"[recipe] P={PARTS}: {c.n_epochs} epochs, losses "
        + " ".join(f"{v:.4f}" for v in res.losses)
        + f"; int8 wire {wire[c.halo_wire]:.2f} MB per exchange at H="
        f"{c.n_hidden} (the f32 main path's: {wire['native']:.2f}); val "
        f"{res.val_acc:.3f}, test {res.test_acc:.3f}; every rank ends with "
        f"rank 0's parameters ({secs:.1f} s)")
    return {"losses": res.losses, "val_acc": res.val_acc,
            "test_acc": res.test_acc, "wire_mb": wire[c.halo_wire],
            "wire_mb_f32": wire["native"], "ranks": ranks, "seconds": secs}


def anchor_phase(work):
    """[anchor]: the JAX package's calibrated accuracy gate on the card
    (bnsgcn_tpu_torch/anchor.py; tests/test_accuracy_anchor.py's bands):
    exact (P=1, rate 1.0, f32, ELL) inside EXACT_BAND; the stack of the
    recipe's finer knobs (P=4 ranks sharing the card over gloo, rate 0.1,
    hybrid, int8 dense tiles, int8 gathers, int8 halo wire) within
    QUANT_TOL of exact; the same stack in bf16 recorded beside them, not
    gated."""
    from bnsgcn_tpu_torch import anchor
    g = anchor.anchor_graph()
    quant = dict(spmm="hybrid", use_pallas=True, spmm_gather="int8",
                 spmm_dense="int8", halo_wire="int8")
    out = {}
    for name, P, rate, kw in (("exact", 1, 1.0, {}),
                              ("quant", PARTS, BNS_RATE, quant),
                              ("quant_bf16", PARTS, BNS_RATE,
                               dict(quant, dtype="bfloat16"))):
        t0 = time.perf_counter()
        acc = anchor.train_eval(g, P, rate, epochs=anchor.EPOCHS,
                                device="cuda",
                                work=os.path.join(work, "anchor", name),
                                **kw)
        out[name] = {"val_acc": acc, "seconds": time.perf_counter() - t0}
    e, q, b = (out[k]["val_acc"] for k in ("exact", "quant", "quant_bf16"))
    lo, hi = anchor.EXACT_BAND
    log(f"[anchor] reddit_like_graph {g.n_nodes} nodes, {g.n_edges} edges, "
        f"GraphSAGE 3x32, {anchor.EPOCHS} epochs: exact (P=1, rate 1.0, f32, "
        f"ELL) val {e:.4f} (band ({lo}, {hi})); quant (P={PARTS} over gloo "
        f"on one card, rate {BNS_RATE}, hybrid, int8 dense, int8 gathers, "
        f"int8 wire) val {q:.4f}, |quant - exact| {abs(q - e):.4f} <= "
        f"{anchor.QUANT_TOL}; the same in bf16 (recorded) val {b:.4f} ("
        + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in out.items())
        + ")")
    if not lo < e < hi:
        raise AssertionError(f"[anchor] exact accuracy {e:.4f} outside "
                             f"({lo}, {hi})")
    if not abs(q - e) <= anchor.QUANT_TOL:
        raise AssertionError(f"[anchor] quantized stack {q:.4f} is "
                             f"{abs(q - e):.4f} from exact {e:.4f}, over "
                             f"{anchor.QUANT_TOL}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="synth-reddit scale (1.0: the Reddit-shaped graph, "
                         "232,965 nodes, ~115M edges)")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--parts-scale", type=float, default=0.5,
                    help="synth-reddit scale of the P-rank phases")
    ap.add_argument("--parts-epochs", type=int, default=8,
                    help="epochs of the P=4 main-path run")
    ap.add_argument("--out", default="",
                    help="also write the run's details to this JSON file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from bnsgcn_tpu_torch import buildlib
        from bnsgcn_tpu_torch.config import Config
        from bnsgcn_tpu_torch.ops import (bucket_reduce, bucket_sum,
                                          copy_probe, tile_matmul)
        from bnsgcn_tpu_torch.run import prepare_run, run_training
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    device_kind = torch.cuda.get_device_name(0)
    t_all = time.perf_counter()

    # 1. build
    t0 = time.perf_counter()
    kmods = (bucket_sum, tile_matmul, bucket_reduce, copy_probe)
    buildlib.build_many([(name, "cuda", [src]) for m in kmods
                         for name, src in m.BUILDS])
    for m in kmods:
        m.lib()
    log(f"[build] K1-K4 built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc, sm_90a)")

    work = tempfile.mkdtemp(prefix="chip_smoke_")   # checkpoints, results
    cfg = Config(dataset=f"synth-reddit:{args.scale}", n_partitions=1,
                 model="graphsage", n_layers=4, n_hidden=256, use_pp=True,
                 norm="layer", dropout=0.5, lr=0.01, spmm="hybrid",
                 use_pallas=True, n_epochs=args.epochs, log_every=1,
                 eval=True, seed=0, device="cuda",
                 ckpt_path=os.path.join(work, "checkpoint"),
                 results_path=os.path.join(work, "results"))
    t0 = time.perf_counter()
    pr = prepare_run(cfg, log=log)
    log(f"[setup] graph + artifacts + layout {time.perf_counter() - t0:.1f} s")

    # 2. kernels against their plain versions at the main path's shapes
    gen = torch.Generator(device="cuda").manual_seed(1234)
    widths = (cfg.n_hidden, pr.cfg.n_feat)
    detail = []
    e1, t1 = compare_k1(pr.fns, widths, gen, args.reps, detail)
    e2, t2 = compare_k2(pr.fns, widths, gen, args.reps, detail)
    log(f"[check] K1 max abs err {e1[0]:.3e} (relative to max |ref| "
        f"{e1[1]:.3e}), K2 {e2[0]:.3e} ({e2[1]:.3e}); every element within "
        f"2 n u sum|x| (n: the row's terms, +1 with K1's base, u = 2^-24) at "
        f"H={widths}; K1 bitwise equal on a second call; K2's check rejects "
        f"TF32-rounded inputs")
    l2 = l2_probe(gen, widths[0], args.reps)
    t1["l2_probe"] = l2
    t1["gathered_over_l2_ms"] = (t1["gathered_bytes"]
                                 / l2["l2_bytes_per_s"] * 1e3)
    log(f"[probe] L2-resident rows ({l2['table_bytes'] / 2 ** 20:.0f} MiB "
        f"table): stacked sum {l2['stream_bytes_per_s'] / 1e12:.3f} TB/s, "
        f"embedding_bag gather {l2['gather_bytes_per_s'] / 1e12:.3f} TB/s, "
        f"K1 on the same gather {l2['k1_bytes_per_s'] / 1e12:.3f} TB/s; "
        f"L2 rate (probe) {l2['l2_bytes_per_s'] / 1e12:.3f} TB/s")
    log(f"[time] K1 fwd residual pass H={t1['H']} ({t1['rows']} rows, "
        f"{t1['nnz']} terms, "
        f"{t1['long_rows']} long rows): kernel {t1['ms']:.3f} ms with K2's "
        f"output as base ({t1['ms_no_base']:.3f} without), plain "
        f"{t1['plain_ms']:.3f}, torch.sparse.mm {t1['library_ms']:.3f} "
        f"(no base), bound {t1['bound_ms']:.3f} ({t1['bound_by']}); "
        f"diagnostic, not a bound: the {t1['gathered_bytes'] / 1e9:.2f} GB "
        f"gathered over the probed L2 rate take "
        f"{t1['gathered_over_l2_ms']:.3f}")
    log(f"[time] K2 fwd dense pass H={t2['H']}: kernel {t2['ms']:.3f} ms, "
        f"plain {t2['plain_ms']:.3f}, torch.sparse.mm "
        f"{t2['library_ms']:.3f}, bmm {t2['bmm_ms']}, bound "
        f"{t2['bound_ms']:.3f} ({t2['bound_by']}; {t2['entries']} entries "
        f"carrying {t2['nnz']} edges in {t2['tiles']} tiles, "
        f"{t2['flops']:.4e} needed FLOPs); dense-stack bound "
        f"{t2['dense_bound_ms']:.3f} (a dense product of the whole tiles "
        f"does {t2['dense_flops']:.4e})")
    log(f"[layout] K2 tiles per row-block: max "
        f"{t2['tiles_per_row_block_max']}, mean "
        f"{t2['tiles_per_row_block_mean']:.2f}; packing K2's entries and K1's "
        f"row schedules took {pr.fns.spmm.pack_seconds:.2f} s (K1's "
        f"{pr.fns.spmm.residual.pack_seconds:.2f} s)")
    e3, t3s = compare_k3(gen, args.reps, detail)
    t4 = compare_k4(gen, args.reps, detail)
    t3 = t3s[0]
    for t in t3s:
        log(f"[check] K3 {t['dtype']} {t['shape']}: max abs err "
            f"{t['max_abs_err']:.3e} (every element within 2 W u sum|x|"
            f"{' + 1 bf16 ulp' if t['dtype'] == 'bfloat16' else ''}); "
            f"kernel {t['ms']:.3f} ms ({t['host_us']:.2f} us host per "
            f"call), plain {t['plain_ms']:.3f}, g.sum(1) "
            f"{t['library_ms']:.3f} ({t['library_host_us']:.2f} us host), "
            f"bound {t['bound_ms']:.3f} ({t['bound_by']})")
    log(f"[check] K4 {t4['shape']}: bitwise equal to x[0:1]; kernel "
        f"{t4['ms'] * 1e3:.2f} us by events ({t4['host_us']:.2f} us host per "
        f"call), x[0:1].clone() {t4['plain_ms'] * 1e3:.2f} us "
        f"({t4['plain_host_us']:.2f} us host), copy_ "
        f"{t4['library_ms'] * 1e3:.2f} us ({t4['library_host_us']:.2f} us "
        f"host), bound {t4['bound_ms'] * 1e3:.4f} us (bytes); of K4's host "
        f"time, the output's allocation {t4['alloc_host_us']:.2f} us and the "
        f"C call with its launch {t4['launch_host_us']:.2f} us")

    lk1 = compare_k1_lowp(pr.fns, widths, gen, args.reps, detail)
    lk2 = compare_k2_lowp(pr.fns, widths, gen, args.reps, detail)
    for name, res_k in (("K1", lk1), ("K2", lk2)):
        for kind, (err, t) in res_k.items():
            lib = ("none" if t["library_ms"] is None
                   else f"{t['library_ms']:.3f}")
            extra = ""
            if name == "K1":
                # the design's floor, as [time] K1 gives f32's: the row
                # slices the terms gather, over the probed L2 rate
                t["floor_ms"] = (t["gathered_bytes"] / l2["l2_bytes_per_s"]
                                 * 1e3)
                extra = (f"; the design's floor {t['floor_ms']:.3f} (the "
                         f"{t['gathered_bytes'] / 1e9:.2f} GB gathered over "
                         f"the probed L2 rate)")
            if name == "K2":
                gemm = (f"{t['gemm_ms']:.3f}" if t["gemm_ms"] is not None
                        else f"refused ({t['gemm_error']})")
                extra = (f"; the dense tensor-core design's floor "
                         f"{t['floor_ms']:.3f} ({t['floor_by']}; "
                         f"{t['dense_ops']:.4e} dense-stack operations), "
                         f"dense-equivalent GEMM, not the same function, "
                         f"{gemm}; a copy of the tile stack "
                         f"{t['tile_copy_ms']:.3f} ("
                         f"{2 * t['tile_bytes'] / t['tile_copy_ms'] / 1e9:.2f}"
                         f" TB/s)")
            log(f"[lowp] {name} {kind} H={t['H']}: max abs err {err:.3e} "
                f"({'bitwise equal' if kind.startswith('int8') else 'every element within its bound'}"
                f"; the control rejected); kernel {t['ms']:.3f} ms, plain "
                f"{t['plain_ms']:.3f}, library {lib}, bound "
                f"{t['bound_ms']:.3f} ({t['bound_by']}){extra}")

    # 3. small-input agreement, card vs CPU
    small_agreement(cfg)

    # 4. the main path, through the user's entry point
    bucket_sum.launches.reset()
    tile_matmul.launches.reset()
    res = run_training(cfg, log=log, prepared=pr)
    k1 = dict(bucket_sum.launches.by_phase)
    k2 = dict(tile_matmul.launches.by_phase)
    p1_kinds = {"K1": dict(bucket_sum.launches.by_kind),
                "K2": dict(tile_matmul.launches.by_kind)}
    log(f"[launches] K1 {k1} | K2 {k2}")
    log(f"[hybrid] dense tiles carry {res.dense_edges} of {res.n_edges} "
        f"edges ({res.dense_edges / max(res.n_edges, 1):.1%})")
    # one launch of each per aggregation: the n_layers - 1 layers after the
    # use_pp precompute, forward and backward, every epoch, plus the
    # precompute's one
    passes = (cfg.n_layers - 1) * args.epochs
    want = {"fwd": passes, "bwd": passes, "pre": 1}
    for name, c in (("K1", k1), ("K2", k2)):
        if c != want:
            raise AssertionError(f"{name} launched {c} on the main path, not "
                                 f"{want}")
    if not all(math.isfinite(x) for x in res.losses):
        raise AssertionError(f"non-finite loss: {res.losses}")
    if not res.losses[-1] < res.losses[0]:
        raise AssertionError(f"loss did not fall: {res.losses}")
    val, test = res.val_acc, res.test_acc
    chance = 1.0 / pr.cfg.n_class
    if not (2 * chance < val <= 1.0 and 2 * chance < test <= 1.0):
        raise AssertionError(f"accuracy {val:.3f} / {test:.3f} is not above "
                             f"twice chance ({2 * chance:.3f})")

    log(f"[main] P=1 epoch: mean of epochs 1.. "
        f"{mean_from_1(res.epoch_times) * 1e3:.1f} ms; the epoch line's "
        f"(epochs 5..) {res.epoch_time * 1e3:.1f} ms; val {val:.3f}, test "
        f"{test:.3f}")
    p1 = {"scale": args.scale, "epochs": args.epochs, "losses": res.losses,
          "epoch_times_s": res.epoch_times, "epoch_time_s": res.epoch_time,
          "epoch_from_1_s": mean_from_1(res.epoch_times),
          "launches": {"K1": k1, "K2": k2}, "dense_edges": res.dense_edges,
          "n_edges": res.n_edges, "val_acc": val, "test_acc": test}
    del res
    torch.cuda.empty_cache()

    # [lowp]: the low-precision main path on the same graph and layouts
    lowp = lowp_runs(cfg, pr, args)
    for name, x in lowp.items():
        log(f"[lowp] {name}: losses "
            + " ".join(f"{v:.4f}" for v in x["losses"])
            + f"; epoch {x['epoch_from_1_s'] * 1e3:.1f} ms, mean of epochs "
            f"1.. (f32: {p1['epoch_from_1_s'] * 1e3:.1f}); dense modes "
            f"{x['modes']}; launches K1 {x['launches']['K1']} K2 "
            f"{x['launches']['K2']}; peak memory {x['max_memory_gib']:.2f} "
            f"GiB; layout reused, set-up {x['setup_s']:.1f} s")
    # [recipe]: the TPU recipe's own knobs on the same graph and layouts
    rec1 = recipe_p1(cfg, pr, args)
    log(f"[recipe] P=1 {' '.join(RECIPE_TPU)}: spmm=auto -> hybrid; losses "
        + " ".join(f"{v:.4f}" for v in rec1["losses"])
        + f"; epoch {rec1['epoch_from_1_s'] * 1e3:.1f} ms, mean of epochs "
        f"1.. (f32: {p1['epoch_from_1_s'] * 1e3:.1f}, [lowp] main: "
        f"{lowp['main']['epoch_from_1_s'] * 1e3:.1f}); launches K1 "
        f"{rec1['launches']['K1']} K2 {rec1['launches']['K2']}; peak memory "
        f"{rec1['max_memory_gib']:.2f} GiB; val {rec1['val_acc']:.3f}, test "
        f"{rec1['test_acc']:.3f}")
    del pr
    torch.cuda.empty_cache()

    # 5. the P-rank path
    t0 = time.perf_counter()
    parts, res4 = parts_runs(cfg, args, os.path.join(os.getcwd(),
                                                     "partition"))
    log(f"[parts] done in {time.perf_counter() - t0:.1f} s")

    # 6. the flagship's script: train, checkpoint, resume
    cli = cli_phase(work)

    # 7. [anchor]: the calibrated accuracy gate, on the card
    anc = anchor_phase(work)
    shutil.rmtree(work, ignore_errors=True)
    # launches by variant on the main paths: the P=1 run, every rank of the
    # P=4 main path, [lowp]'s two runs, and [recipe]'s at P=1 and P=4
    counts = {"K1": {}, "K2": {}}
    for src in ([{"K1": p1_kinds["K1"], "K2": p1_kinds["K2"]}]
                + [rep["kinds"] for rep in res4.ranks]
                + [x["launches"] for x in lowp.values()]
                + [rec1["launches"]]
                + [x["launches"] for x in parts["recipe"]["ranks"]]):
        for name in ("K1", "K2"):
            for kind, n in src[name].items():
                counts[name][kind] = counts[name].get(kind, 0) + n
    # the largest error of each kernel's checks, P=1's and every rank's
    errs = {"ell_bucket_sum": max([e1[0]] + [rep["hook"]["K1"][0]
                                             for rep in res4.ranks]),
            "tile_matmul": max([e2[0]] + [rep["hook"]["K2"][0]
                                          for rep in res4.ranks]),
            "bucket_reduce": e3, "copy_probe": 0.0}
    times = {"ell_bucket_sum": t1, "tile_matmul": t2, "bucket_reduce": t3,
             "copy_probe": t4}
    for prefix, res_k in (("ell_bucket_sum", lk1), ("tile_matmul", lk2)):
        for kind, (err, t) in res_k.items():
            name = f"{prefix}_{kind.replace('-', '_')}"
            errs[name], times[name] = err, t
    # and the bf16 variants' checks on every rank of [recipe] at P=4
    for name, k in (("ell_bucket_sum_bf16", "K1"), ("tile_matmul_bf16", "K2")):
        errs[name] = max([errs[name]] + [x["check"][k] for x in
                                          parts["recipe"]["ranks"]])

    # 8. report
    out = {"card": smi, "p1": p1, "lowp": lowp, "recipe_p1": rec1,
           "parts": parts, "cli": cli,
           "anchor": anc, "times": times, "launches": counts,
           "checks": detail, "seconds": time.perf_counter() - t_all}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    kernels = []
    for name, (src, replaces, count, variant) in KERNELS.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": counts[count].get(variant, 0) if count else 0,
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
