#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (bnsgcn_tpu_torch).

    python3 chip_smoke.py                 # the full check, on one GPU
    python3 chip_smoke.py --scale 0.02 --epochs 3 --parts-scale 0.01 \
        --parts-epochs 4                  # a quick rehearsal

Phases, each of which fails the run (non-zero exit, no result line):

  1. build the CUDA kernels K1-K4 and D1 from csrc/ (one nvcc per source,
     in parallel);
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
     floor and a dense-equivalent GEMM; then D1 (the dropout draw) at the
     main path's dropout shapes, [232,965, 1204] and [232,965, 256], f32
     and bf16: bitwise its plain version forward and backward, the next
     epoch's key rejected, timed beside its bound (threefry's int32
     operations) and torch.nn.functional.dropout;
  3. a small-input agreement check: the same short training run at dropout
     0.5 on the card and on the CPU (plain versions; the masks are jax's on
     both) must give the same losses;
  4. drive the main path through the entry point a user calls
     (run.run_training): GraphSAGE 4x256, use_pp, LayerNorm, dropout 0.5,
     lr 0.01, --spmm hybrid on synth-reddit, with every kernel's launch
     count reset just before and read just after; the loss must stay finite
     and fall, K1 and K2 must each have launched once per aggregation (the
     3 layers after the precompute, forward and backward, every epoch,
     plus the precompute's one), D1 once per layer forward and once per
     layer backward but layer 0's; the run
     evaluates once, at its end, and ends with the best parameters' Test
     Result on the full graph, whose val and test accuracies must beat
     twice chance;
  5. the P-rank path on synth-reddit at --parts-scale, the same model (its
     P=4 artifacts written by a child process while phases 1-4 run: host
     work beside the card's, the directories its launchers then load): at
     sampling rate 1.0, 4 ranks sharing this one card over gloo (NCCL
     refuses two ranks on one card) and P=1, 3 epochs without dropout from
     the same parameters, transductive, must give the same losses to 1e-4
     (relative; the P=1 side runs later, beside [cli]); then the main
     path at P=4 with the flagship's command line, --inductive (the train
     subgraph partitioned, rank 0 evaluating on the train+val subgraph
     and, last, the full graph), boundary-node
     sampling at rate 0.1 and dropout 0.5, through run.run_training, in
     which each rank first holds K1 and K2 to
     their plain versions on its own part's layout (its own hybrid tiles and
     ELL residual and its own row schedule, forward and backward, at
     H=256 and the raw feature width, with phase 2's bounds) and then hands
     back its launch counts: K1 and K2 must have launched as at P=1 on
     every rank, the loss must stay finite and fall, rank 0's inductive
     val and test accuracies must beat twice chance, the eval lines, the
     best accuracy and the Test Result must print, and every rank must end
     with rank 0's parameters; rank 0 evaluates in its eval thread on its
     own stream while the ranks train (the JAX package's overlap), and the
     phase prints each eval's duration, rank 0's wait for it at the drain
     and the epochs in flight beside the others, and each rank's loop wall
     time outside its steps beside the evals' sum (what an inline eval
     stalls);
     then [bns] at those artifacts: every rank's BNS plan for epochs 0 and
     1 built on the card must be array-equal to the CPU's, and the ranks'
     plans must agree pair by pair (sender p's rows are the ones receiver
     j's slots stand for, the rest trashed); it prints each rank's wire MB
     per exchange, the plan's ms, the exchange's share and the epoch at
     rate 0.1 beside rate 1.0's;
     then [meval]: --eval-device mesh on the law run's transductive
     artifacts at rate 0.1, 2 epochs, an eval every epoch (4 and 2 before
     [serve]), with --dump-embeddings: each rank first runs
     the mesh eval forward of the main path's best parameters, whose
     logits must agree with the host eval's (COO) on the full graph within
     1e-4 of the largest and whose predictions must too, apart from
     near-ties; K1 and K2 must launch once per aggregation of training and
     of each eval and of the export (under 'eval'); it prints the mesh
     eval's seconds beside the host eval's; the exported table (every
     rank's embed_forward, rank 0's gather) must hold every node with the
     JAX meta keys and agree with the host branch's (full_graph_embeddings,
     the serving forward, on the card: [serve]'s precompute) for the run's
     best parameters within 1e-4 of the largest value, its predictions too
     apart from near-ties; then [serve], alone: a server over that graph
     and those parameters in this process (build_core; a ServeServer on a
     free port): two
     precomputes (fixed-order sums) bitwise equal and within 1e-4 of the
     table, timed beside the same forward with index_add_'s sums; 400
     tier-A predicts over TCP from 4 client threads, each bitwise the
     table's row; 8 clean nodes in tier B (4 predicts, 4 in a predict_many
     beside them: two buckets in flight) within 1e-4 of tier A; each
     tier's p50 and p99 from the stats op; one tier-B step of a node alone
     timed by its parts (the closure's build, the transfer, the forward),
     its buckets, the peak memory; beside [cli] (phase 6) the same node in
     a full bucket of --serve-max-batch targets must get the same bits, an
     edge between the two nodes of least out-degree must mark exactly its
     4-hop forward closure, and one step over the dirty set must leave the
     clean rows bitwise untouched and the dirty ones within 1e-4 of a
     scratch eval of the mutated graph;
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
     its artifacts (no repartitioning), 2 epochs (4 before [serve]), in
     which each rank first holds K1 and K2 on bf16 to their plain
     versions on its own layout (phase 2's bounds and controls), then
     launches them as at P=1; the
     loss finite, every rank ending with rank 0's parameters; it prints
     each rank's epoch and exchange share and the int8 wire's MB per
     exchange beside the f32 path's;
  5d. [gat]: the P=4 main path's command line with --model gat --heads 2
     on its artifacts, 2 epochs, rank 0 evaluating every 2 (COO, the
     segment softmax): each rank's presence masks for epochs 0 and 1 must
     be those of the plans [bns] checked, the loss finite and falling, no
     K1 or K2 launch, every rank ending with rank 0's parameters; it prints
     each rank's epoch, exchange and reduce seconds, peak memory, the GAT
     layouts' build seconds and the attention's device ms per layer
     forward and backward (CUDA events), the evals' seconds; the GAT law
     at [cli]'s scale (P=4 == P=1 at rate 1.0, dropout 0, 3 epochs, to
     1e-4 relative) runs later, beside [cli] (phase 6);
  5e. [halo]: the exchange's variants on the P=4 main path's artifacts (its
     command line: --inductive, rate 0.1), in one spawned group of 4 ranks
     over gloo that loads its parts once, 2 epochs per variant from the
     same parameters: on epoch 0's plan the shift and ragged exchanges'
     outputs bitwise padded's (backward within 1e-6); auto's pick;
     --halo-exchange shift and ragged, --overlap split on the hybrid and
     on ELL (each side first holding K1 and K2 on its interior or frontier
     layout to the plain versions), --halo-refresh 2 and 4, --halo-mode
     grad-only and --sampling-rate 0.0, with the checks of `halo_phase`
     (losses to 1e-5 relative: shift, ragged and split against padded,
     ELL split against ELL, rate 0.0 against grad-only; one full-refresh
     epoch; no exchange span under grad-only; K1 and K2 once per
     aggregation, the split ones once per side); it prints each variant's
     wire MB (peak, steady), Comm(s), epoch and peak memory, and for split
     the interior, frontier and exchange ms (events) and the hidden ms;
  5f. [knobs], in [halo]'s group on the same artifacts and layouts: D1
     bitwise its plain version on every rank's layer shapes (f32, bf16,
     forward, backward, the next epoch's key rejected) and the card's
     mask the CPU's; on the flagship at dropout 0.5 D1 once per layer
     forward and backward but layer 0's; 2 epochs each of --norm batch
     (its running statistics bitwise on every rank), --remat and --remat
     --norm batch (losses and parameters against the twin without
     --remat: bitwise, or within 1e-6 relative, said which; each run's
     own peak memory), and --reorder cluster and auto on the hybrid and on
     ELL at rate 1.0 without dropout (coverage before and after, the
     order's ms, the layout set-up; losses against --reorder off: ELL to
     1e-6 of max(|loss|, 1), the hybrid to 1e-4; auto's bitwise the
     variant its verdict names);
  5f'. [tune], in [halo]'s group on the same artifacts and layouts: the
     flagship's command line with --tune schedule K=4@0,K=2@2,K=1@4,
     --strict-exec and the default comm-trace window, 12 epochs: every
     rank applies the three decisions, the K=2 retune logs one full
     refresh (retune), the strict audit is clean on every rank (2 re-arms,
     the host-staged copies counted as fetches), the window's traced Comm
     (gloo's host ops) is positive and the epoch line reads [traced]
     after it, and K1, K2 and D1 launch one step's worth every epoch,
     before and after both rebuilds; it prints the rebuilds' seconds, the
     first step after each, the traced epochs and the clean ones, and the
     traced Comm beside the CUDA-event column;
  5g. [axes]: --replicas 2 and --feat 2 in one spawned group of 8 ranks
     sharing the card over gloo, on the P=4 law's and main path's
     artifacts, each rank on both of the port's rank maps (2 replicas x 4
     parts, 4 parts x 2 feat shards): (a) R=2 and (b) T=2 at rate 1.0
     without dropout, 2 epochs from the seed's parameters, must give the
     P=4 law's first two losses, and (c) T=2 on the flagship's command line
     (--inductive, rate 0.1, dropout 0.5), 2 epochs, the P=4 main path's
     first two, all to 1e-4 (relative); each feat rank first holds K1 and
     K2 to their plain versions on its own layout at H/T=128 and the raw
     feature width; (d) R=2 on the flagship's command line, 2 epochs:
     every rank ends with the same parameters, bitwise, each rank's epoch-0
     plan on the card is the CPU's for its replica's fold, and replica 1's
     plans differ from replica 0's; K1 and K2 once per aggregation and D1
     once per layer forward and backward but layer 0's (at dropout) on
     every rank; it prints each run's epoch (mean of epochs 1..), Comm(s)
     split into exchange, feat and reduce, the wire MB per exchange per
     replica beside --replicas 1 --feat 1's, and each run's set-up and
     loop seconds;
  6. [cli]: the flagship's command line as a user types it,
     scripts/reddit_torch.sh, in a subprocess on synth-reddit:0.02 at P=4
     over gloo, 8 epochs, an eval and a checkpoint every 4: it must exit 0,
     print epoch, accuracy and Test Result lines, and leave 2 periodic
     checkpoints, the final one and the results file; rerun with --resume
     --skip-partition --n-epochs 12 it must start at epoch 8, and its
     losses for epochs 8-11 must equal an uninterrupted 12-epoch run's to
     1e-5 (relative); meanwhile, with --eval-device mesh: partition_cli writes
     the train subgraph's artifacts and the eval graphs' ('-val', '-test'),
     and the script trains 8 epochs from them (--skip-partition), the
     ranks evaluating; the 8-epoch run also writes --dump-embeddings,
     and the CLI server over it ([serve], `python -m bnsgcn_tpu_torch.main
     serve`) must cold-start from that table and answer predict (bitwise
     the table) and predict_many, take a delta and exit 75 on a SIGTERM
     with the delta log flushed; a relaunch must replay it to the same
     dirty count and, under --serve-compact-deltas 1, fold it and a second
     delta into the snapshot and exit 0 on the shutdown op; the launch
     after it must resume from the snapshot and exit 0;
     [resil] rides these runs: the 8-epoch and the uninterrupted 12-epoch
     run carry --inject nan@E5 and must log the rollback to _3.ckpt;
     the resume to 12 (an eval and a checkpoint every 2) gets a real
     SIGTERM to its launcher after its epoch-9 line and must exit 75; a
     second --resume must then give the uninterrupted run's losses to
     1e-5 (the retry nonce rides the files); beside [anchor], once the
     --eval-device mesh run is done, a 2-epoch --inject hang@E1 launch
     with the watchdog shrunk must exit 77, naming the rank whose beat is
     oldest;
     [coord] beside them: two coordinated pairs (two launches of the
     flagship's command line each, --coord tcp --coord-world 2, on a P=2
     partition of [cli]'s graph): under --inject nan@E5:r1 both launches
     must log the agreed rollback to _3.ckpt (restart 4, retry-nonce 1) and
     train bitwise equal, finite losses, and each rank of its launch 0 (run
     here, through run.run_training) must launch K1, K2 and D1; under
     --elastic on --inject ranklost@E3:r1 launch 1 must exit 0 without a
     RESULT line and launch 0 log the resize (world 2 -> 1, resize-nonce
     1), end with RESULT and leave one `resize` event in its --obs-log;
  6b. [yelp] (beside [cli]): the multilabel path, scripts/yelp_torch.sh's
     model (GraphSAGE 4 layers, 2 of them linear, H=512, use_pp, dropout 0.1, lr
     0.001, inductive, rate 0.1) with --spmm hybrid at P=4 over gloo on a
     multilabel power-law graph at Yelp's widths (300 features, 100 labels,
     50,000 nodes: Yelp's 716,847 cut), written in the GraphSAINT layout
     and read through --dataset yelp --data-path: each rank first holds K1
     and K2 to their plain versions at H=512 and F=300 on its own layout;
     the BCE loss finite and falling over 10 epochs (20 before [serve]),
     the micro-F1 lines;
  6c. [papers]: scripts/ogbn-papers100m_torch.sh's two steps (BASELINE
     config 5: GCN 3x128, rate 0.01, bf16, fp8 wire, --eval-device mesh)
     on an OGB binary directory at papers100M's widths, 1,000,000 nodes:
     the script's streaming partition step with bf16 feature storage at
     P=4 (wall time, peak RSS; started beside step 1's set-up, whose host
     work leaves cores idle), then 2 epochs (4 before [serve]) twice with
     one --cache-dir:
     one launch of 4 ranks through run.run_training, cold (each rank first
     holds K1 on bf16 rows to its plain version on its own ELL layout; K1
     once per aggregation of training and of each mesh eval, K2 never),
     and the script itself as two concurrent launches of 2 (--n-nodes 2),
     warm: the losses equal to 1e-6 (relative), the RESULT lines equal;
     each rank's epoch, exchange share, peak memory, the fp8 wire's MB per
     exchange, the layouts' build seconds cold against the load warm;
  7. [anchor] (beside [cli], [yelp] and the laws): the JAX package's
     calibrated accuracy gate
     (bnsgcn_tpu_torch/anchor.py), 200 epochs: exact (P=1, rate 1.0, f32)
     inside (0.93, 0.985); at P=4 and rate 0.1, the quantized stack of the
     recipe's finer knobs and the recipe's own knobs (RECIPE_TPU; the line
     names what --spmm auto resolved to) each within 0.005 of it, the
     finer stack in bf16 recorded; the biased-sampler mutation below
     exact - 0.05;
  8. print every phase's seconds ([phases]), the card's name and power
     limit, one {"kernels": [...]} line
     (every kernel variant) and, last, {"ok": true, "device": {...}}.

Short runs report their own mean of epochs 1.. (labelled so), beside the
epoch line's Time(s), which drops 5 warm-up epochs as the JAX package does.

Exits non-zero without a CUDA device and when the port is not beside it.
--out FILE also writes the details (per-check errors, times, losses) as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

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

# int32 operations outside the tensor cores: half the f32 lanes (64 a clock
# on each of the 132 SMs, against 128 for f32) at the f32 peak's clock,
# 67e12 / (2 * 128 * 132) = 1.98 GHz, and no fused pair (67e12 counts an FMA
# as two)
INT32_OPS_PER_S = 64 * 132 * 67e12 / (2 * 128 * 132)
# D1's 32-bit integer operations per element, threefry2x32 as written:
# two counter adds, 20 rounds of add, rotate and xor, 5 key injections of
# two adds, the xor of the two output words
D1_OPS_PER_ELEMENT = 2 + 20 * 3 + 5 * 2 + 1

K1_SRC, K2_SRC, K2_MMA_SRC = ("bnsgcn_tpu_torch/csrc/bucket_sum.cu",
                              "bnsgcn_tpu_torch/csrc/tile_matmul.cu",
                              "bnsgcn_tpu_torch/csrc/tile_mma.cu")
D1_SRC = "bnsgcn_tpu_torch/csrc/dropout.cu"
# D1 replaces no Pallas kernel: the JAX package's `_dropout`, which XLA fuses
D1_REPLACES = "bnsgcn_tpu/models/gnn.py:230"
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
    "dropout": (D1_SRC, D1_REPLACES, "D1", "f32"),
    "dropout_bf16": (D1_SRC, D1_REPLACES, "D1", "bf16"),
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
# [cli]: the flagship's script with small overrides, 8 epochs then a
# resume to 12 beside an uninterrupted 12-epoch run
CLI_SCRIPT = os.path.join("scripts", "reddit_torch.sh")
CLI_FLAGS = ["--dataset", "synth-reddit:0.02", "--n-partitions", str(PARTS),
             "--dist-backend", "gloo", "--log-every", "4", "--fix-seed",
             "--no-comm-trace"]
CLI_EPOCHS = (8, 12)
CLI_TABLE = "table.tbl"     # the first run's --dump-embeddings ([serve])
CLI_RTOL = 1e-5
CLI_TIMEOUT_S = 300
# [resil]: the fault injected into [cli]'s 8- and 12-epoch runs, the
# preempted resume's log cadence, the epoch line after which its launcher
# gets the SIGTERM and its least seconds an epoch (so that the signal lands
# mid-run); the hung launch's fault and its shrunk watchdog
RESIL_INJECT = "nan@E5"
RESIL_LOG_EVERY = 2
RESIL_SIGTERM_AFTER = 9
RESIL_THROTTLE_S = "1.0"
RESIL_HANG = "hang@E1"
RESIL_HANG_ENV = {"BNSGCN_WATCHDOG_GRACE_S": "240",
                  "BNSGCN_WATCHDOG_FACTOR": "3",
                  "BNSGCN_WATCHDOG_MIN_S": "10"}
# [coord]: the coordinated pairs' partition, epochs (pair A, pair B),
# faults (the launch of coordination rank 1) and the alive-beat age that
# proves a launch lost
COORD_PARTS = 2
COORD_EPOCHS = (6, 5)
COORD_NAN = "nan@E5:r1"
COORD_LOST = "ranklost@E3:r1"
COORD_DEAD_S = 3
# the TPU recipe's own perf knobs, as scripts/reddit.sh's comment lists
# them ("append --dtype bfloat16 ..."): K1 on bf16 rows and K2 on bf16
# slabs on every aggregation. The int8 gathers and tiles of [lowp] are its
# finer knobs.
RECIPE_TPU = ["--dtype", "bfloat16", "--spmm", "auto", "--use-pallas",
              "--halo-wire", "int8"]
RECIPE_P4_EPOCHS = 2    # [recipe]'s run at P=4 (4 before [serve])
# [meval]: --eval-device mesh on the law run's transductive artifacts, and
# the bound on its logits against the host eval's (COO) for the same
# parameters: 1e-4 of the largest |logit| (two f32 forwards through 4
# layers that sum each aggregation in another order, LayerNorm between;
# 3.4e-6 of it measured on an H100 at synth-reddit:0.5)
MEVAL_EPOCHS, MEVAL_LOG_EVERY = 2, 1    # 4, 2 before [serve] (its cut)
MEVAL_LOGIT_FRAC = 1e-4
# [serve]: [meval]'s run exports its table (--dump-embeddings under
# --eval-device mesh: every rank's embed_forward through K1 and K2, rank 0's
# gather), held to the host branch's table of the same parameters within
# SERVE_FRAC of the largest value; then a server over that graph and those
# parameters in this process (build_core, a ServeServer on a free port,
# client threads over TCP: SERVE_TIER_A requests of tier A, SERVE_TIER_B of
# tier B, some in a predict_many beside the batcher's step: two buckets in
# flight), its delta and flush beside [cli]; and the CLI server over [cli]'s
# first run (its table, a SIGTERM, the replay, the compaction)
SERVE_FRAC = 1e-4
SERVE_TIER_A, SERVE_CLIENTS = 400, 4
SERVE_TIER_B = 8
SERVE_TIMEOUT_S = 600
# [cli]'s run of the script with --eval-device mesh
CLI_MESH_EPOCHS = 8
# [yelp]: scripts/yelp_torch.sh (the reference's Yelp model) on a
# multilabel power-law graph at Yelp's widths, written in the GraphSAINT
# layout; Yelp's 716,847 nodes and ~14M edges cut to YELP_NODES nodes of
# mean degree YELP_DEGREE, and 20 epochs, to keep the script under ~950 s
YELP_SCRIPT = os.path.join("scripts", "yelp_torch.sh")
YELP_NODES, YELP_DEGREE = 50_000, 20
YELP_FEAT, YELP_CLASSES = 300, 100
YELP_EPOCHS, YELP_LOG_EVERY = 10, 5    # 20, 10 before [serve]
# [gat]: the flagship's command line with --model gat --heads 2 on the P=4
# main path's artifacts, an eval every GAT_LOG_EVERY epochs; the law at
# [cli]'s scale, P=4 against P=1, rate 1.0, dropout 0
GAT_HEADS = 2
GAT_EPOCHS, GAT_LOG_EVERY = 2, 2
GAT_LAW_DATASET = CLI_FLAGS[1]
# [papers]: scripts/ogbn-papers100m_torch.sh (BASELINE config 5: GCN 3x128,
# rate 0.01, bf16, fp8 wire, mesh eval) on an OGB binary directory at
# papers100M's widths (128 features, 172 classes, NaN labels outside the
# splits, the splits' shares, mean degree ~14.5); 111,059,956 nodes cut to
# PAPERS_NODES, P=64 to 4 ranks on the one card over gloo, 200 epochs to
# PAPERS_EPOCHS; one launch of 4 against two launches of 2 (--n-nodes 2)
PAPERS_SCRIPT = os.path.join("scripts", "ogbn-papers100m_torch.sh")
PAPERS_NODES, PAPERS_DEGREE = 1_000_000, 14.5
PAPERS_FEAT, PAPERS_CLASSES = 128, 172
PAPERS_SPLIT = (0.011, 0.0011, 0.0019)      # train, valid, test shares
PAPERS_EPOCHS, PAPERS_LOG_EVERY = 2, 2  # 4, 2 before [serve]
PAPERS_RTOL = 1e-6
# [halo]: the exchange's variants on the P=4 main path's artifacts, each
# (name, Config fields over that path's command line)
HALO_EPOCHS = 2          # 3 before [tune] joined the group (its cut)
HALO_RTOL = 1e-5
HALO_VARIANTS = (("padded", {}),
                 ("shift", {"halo_exchange": "shift"}),
                 ("ragged", {"halo_exchange": "ragged"}),
                 ("split", {"overlap": "split"}),
                 ("ell", {"spmm": "ell"}),
                 ("ell+split", {"spmm": "ell", "overlap": "split"}),
                 ("hr2", {"halo_refresh": 2}),
                 ("hr4", {"halo_refresh": 4}),
                 ("grad-only", {"halo_mode": "grad-only"}),
                 ("rate0", {"sampling_rate": 0.0}))
# [knobs]: the main path's last knobs in [halo]'s group, on the same
# artifacts, HALO_EPOCHS epochs each from the same parameters. The reorder
# variants run at rate 1.0 without dropout, as the JAX package's reorder
# tests do: both draws are keyed by row position, so under a permutation
# they select other rows by design; each is held to its ro-base twin.
KNOB_VARIANTS = (("bn", {"norm": "batch"}),
                 ("remat", {"remat": True}),
                 ("remat+bn", {"remat": True, "norm": "batch"}),
                 ("ro-base", {"sampling_rate": 1.0, "dropout": 0.0}),
                 ("ro-cluster", {"sampling_rate": 1.0, "dropout": 0.0,
                                 "reorder": "cluster"}),
                 ("ro-auto", {"sampling_rate": 1.0, "dropout": 0.0,
                              "reorder": "auto"}),
                 ("ell+ro-base", {"sampling_rate": 1.0, "dropout": 0.0,
                                  "spmm": "ell"}),
                 ("ell+ro-cluster", {"sampling_rate": 1.0, "dropout": 0.0,
                                     "spmm": "ell", "reorder": "cluster"}),
                 ("ell+ro-auto", {"sampling_rate": 1.0, "dropout": 0.0,
                                  "spmm": "ell", "reorder": "auto"}))
# each --remat variant against its twin without it: (twin, the relative
# bound that applies when the two are not bitwise equal)
REMAT_TWINS = {"remat": "padded", "remat+bn": "bn"}
REMAT_RTOL = 1e-6
# the reorder variants against their twins: ELL as the JAX package's
# tests/test_reorder.py:126 holds it (1e-6 of max(|loss|, 1)), the hybrid
# within 1e-4 relative (its dense/residual split moves with the order)
REORDER_TWINS = {"ro-cluster": ("ro-base", 1e-4),
                 "ell+ro-cluster": ("ell+ro-base", 1e-6)}
# [tune]: the flagship's command line with --tune schedule and
# --strict-exec in [halo]'s group (same ranks, same artifacts, layouts
# lent), the default comm-trace window on: K=4 folded in at launch, the
# retunes to K=2 and K=1 at epochs 2 and 4, the window over epochs 6..9 and
# two clean epochs after it (10, 11) to time against
TUNE_SCHEDULE = "K=4@0,K=2@2,K=1@4"
TUNE_EPOCHS = 12
TUNE_TRAIL = [(0, {"halo_refresh": 4}, "schedule@0"),
              (2, {"halo_refresh": 2}, "schedule"),
              (4, {"halo_refresh": 1}, "schedule")]
# [axes]: --replicas 2 and --feat 2 on the P=4 artifacts, in one spawned
# group of AXES_RANKS ranks: (name, which artifacts, R, T, epochs). The law
# runs (rate 1.0, no dropout) against the P=4 law's losses, the flagship's
# T=2 run (--inductive, rate 0.1, dropout 0.5) against the P=4 main path's
# first epochs, all to LAW_RTOL (relative); the flagship's R=2 run, whose
# replicas draw their own samples and masks, is held to its replication
AXES_R, AXES_T = 2, 2
AXES_RANKS = AXES_R * PARTS
AXES_RUNS = (("law R=2", "law", AXES_R, 1, 2),   # LAW_EPOCHS before [tune]
             ("law T=2", "law", 1, AXES_T, 2),
             ("main T=2", "main", 1, AXES_T, 2),
             ("main R=2", "main", AXES_R, 1, 2))


def log(msg):
    print(msg, flush=True)


class Tee:
    """A log function that prints each line and keeps it."""

    def __init__(self):
        self.lines = []

    def __call__(self, msg):
        self.lines.extend(str(msg).splitlines())
        log(msg)

    def having(self, text):
        return [ln for ln in self.lines if text in ln]


def script_flags(script):
    """The flags a scripts/*_torch.sh passes to the port's main, as a list
    (each `${VAR:-default}` at its default)."""
    with open(os.path.join(ROOT, script)) as f:
        lines = f.read().splitlines()
    at = next(i for i, ln in enumerate(lines) if "bnsgcn_tpu_torch.main" in ln)
    out = []
    for ln in lines[at + 1:]:
        ln = ln.strip().rstrip("\\").strip()
        if ln.startswith('"$@"'):
            break
        out += re.sub(r"\$\{\w+:-([^}]*)\}", r"\1", ln).split()
    return out


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
            # the control needs a nonzero tile (a split side may have
            # none: its stack is one zero tile, which K2 sums to zeros)
            if hdim == widths[0] and bool((tiles != 0).any()):
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


def parts_cfgs(cfg, args, part_path):
    """The P-rank path's configs at --parts-scale: (base, the law at P=1,
    the main path at P=4)."""
    base = cfg.replace(dataset=f"synth-reddit:{args.parts_scale}",
                       part_path=part_path, dist_backend="gloo",
                       n_partitions=1, inductive=False)
    law = base.replace(dropout=0.0, n_epochs=LAW_EPOCHS, log_every=1,
                       eval=False)
    main4 = base.replace(n_partitions=PARTS, n_epochs=args.parts_epochs,
                         log_every=max(args.parts_epochs // 4, 1),
                         sampling_rate=BNS_RATE, inductive=True)
    return base, law, main4


def write_parts(law4, main4):
    """A child process's job: the P=4 law's and main path's artifact
    directories, written as their launchers would write them (run.py
    prepare_partition: the train graph, streamed above its edge
    threshold), while the P=1 phases keep the card busy; the launchers
    then find and load them."""
    from bnsgcn_tpu_torch.data.datasets import load_data
    from bnsgcn_tpu_torch.run import prepare_partition, split_graphs
    t0 = time.perf_counter()
    g, _, _ = load_data(law4)
    prepare_partition(law4, g, load=False)
    prepare_partition(main4, split_graphs(main4, g)[0], load=False)
    log(f"[parts] the P=4 artifacts written beside the P=1 phases in "
        f"{time.perf_counter() - t0:.1f} s")


def start_write_parts(cfg, args, part_path):
    """write_parts in a spawned child process, started now."""
    import multiprocessing
    _, law, main4 = parts_cfgs(cfg, args, part_path)
    proc = multiprocessing.get_context("spawn").Process(
        target=write_parts, args=(law.replace(n_partitions=PARTS), main4),
        daemon=True)
    proc.start()
    return proc


def parts_runs(cfg, args, part_path, writer):
    """The P-rank path at --parts-scale: the P=4 == P=1 law, then the main
    path at P=4, on the artifacts `writer` (start_write_parts) wrote.
    Returns the details for the report."""
    import torch
    from bnsgcn_tpu_torch.data.datasets import load_data
    from bnsgcn_tpu_torch.run import run_training
    base, law, main4 = parts_cfgs(cfg, args, part_path)
    phases, t_sub = {}, [time.perf_counter()]

    def sub_done(name):
        now = time.perf_counter()
        phases[name] = now - t_sub[0]
        t_sub[0] = now

    t0 = time.perf_counter()
    g, _, _ = load_data(base)
    log(f"[parts] synth-reddit:{args.parts_scale}: {g.n_nodes} nodes, "
        f"{g.n_edges} edges ({time.perf_counter() - t0:.1f} s)")

    writer.join()
    if writer.exitcode != 0:
        raise RuntimeError(f"[parts] writing the P=4 artifacts failed (exit "
                           f"code {writer.exitcode})")
    # the law: P=4 (4 ranks sharing this card over gloo) == P=1; the P=1
    # side runs later, beside [cli] (law_p1_phase): it reads no time
    r4 = run_training(law.replace(n_partitions=PARTS), g=g, log=log)
    torch.cuda.empty_cache()
    sub_done("graph+law P=4")

    # the main path at P=4 with the flagship's command line (inductive, at
    # its sampling rate), through the user's entry point; each rank checks
    # K1 and K2 on its own layout, resets its launch counts just before its
    # epoch loop and hands them back
    # an eval every quarter of the run: each after the first (which holds
    # the epoch beside it) overlaps the epochs that follow it
    tee = Tee()
    res = run_training(main4, g=g, log=tee, rank_hook=rank_kernel_check)
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
        f"{main4.log_every} epochs, in its eval thread while the ranks "
        f"trained; last the full graph's test)")
    overlap = overlap_report(res, "[parts]")
    evals = [ln for ln in tee.lines if ln.startswith("Epoch ")
             and " | Accuracy " in ln]
    wanted = ("Max Validation Accuracy ", "Test Result | Accuracy ")
    if (len(evals) != main4.n_epochs // main4.log_every
            or not all(tee.having(w) for w in wanted)):
        raise AssertionError(f"[parts] eval lines {evals}; "
                             f"{[tee.having(w) for w in wanted]}")
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
    sub_done("main")
    bns = bns_phase(main4, r4, ranks, args.reps)
    sub_done("bns")
    from bnsgcn_tpu_torch import checkpoint as ckpt
    meval = meval_phase(base, g, ckpt.final_path(main4))
    sub_done("meval")
    held, alone, serve_d = serve_phase(meval_cfg(base), g, meval["export"])
    sub_done("serve")
    gat = gat_phase(main4, g)
    sub_done("gat")
    halo = halo_phase(main4, args)
    recipe = halo.pop("recipe")
    sub_done("halo+knobs+recipe+tune")
    axes = axes_phase(law, main4, r4.losses, res.losses)
    sub_done("axes")
    return {"scale": args.parts_scale, "recipe": recipe, "meval": meval,
            "serve": serve_d,
            "serve_held": (meval_cfg(base), g, held, alone),
            "phases": phases,
            "gat": gat, "halo": halo, "axes": axes,
            "overlap": overlap,
            "law_losses_p4": r4.losses, "law_p1": (law, g, r4.losses),
            "rate": BNS_RATE, "losses": res.losses, "val_acc": res.val_acc,
            "eval_seconds": res.eval_seconds,
            "test_acc": res.test_acc, "ranks": ranks, "bns": bns,
            "rank_checks": [rep["hook"] for rep in res.ranks]}, res


def overlap_report(res, tag):
    """The eval overlap of one run, on rank 0's host clock: for each
    periodic eval, its own duration, rank 0's wait for it at the drain, and
    the epochs that ran while it was in flight with their mean time beside
    the other epochs' (1..); and each rank's loop wall time minus the sum
    of its step times (what it spent outside steps: log points,
    checkpoints, drains, barriers). Logged under `tag`; returns the
    details."""
    starts, times = res.epoch_starts, res.epoch_times
    ends = [s + t for s, t in zip(starts, times)]
    evals, busy = [], set()
    for (e, t0, t1), (_, wait) in zip(res.eval_spans, res.drain_waits):
        fl = [i for i in range(len(starts)) if starts[i] < t1 and ends[i] > t0]
        busy |= set(fl)
        evals.append({"epoch": e, "seconds": t1 - t0, "drain_wait_s": wait,
                      "epochs_in_flight": [res.start_epoch + i for i in fl],
                      "in_flight_mean_s": (sum(times[i] for i in fl) / len(fl)
                                           if fl else None)})
    rest = [times[i] for i in range(1, len(times)) if i not in busy]
    other = sum(rest) / len(rest) if rest else None
    outside = [{"rank": rep["rank"], "loop_s": rep["loop_seconds"],
                "steps_s": sum(rep["epoch_times"]),
                "outside_s": rep["loop_seconds"] - sum(rep["epoch_times"])}
               for rep in res.ranks]
    for x in evals:
        fl = x["epochs_in_flight"]
        log(f"{tag} eval of epoch {x['epoch']}: {x['seconds']:.3f} s in "
            f"rank 0's eval thread; rank 0 waited {x['drain_wait_s']:.3f} s "
            f"for it at the drain; epochs {fl} ran while it was in flight, "
            + (f"mean {x['in_flight_mean_s'] * 1e3:.1f} ms" if fl else "none")
            + (f" (the other epochs 1..: {other * 1e3:.1f} ms)"
               if other is not None else " (no other epoch past 0)"))
    syn = sum(x["seconds"] for x in evals)
    for o in outside:
        log(f"{tag} rank {o['rank']}: loop {o['loop_s']:.3f} s wall, "
            f"{o['steps_s']:.3f} s in steps, {o['outside_s']:.3f} s outside "
            f"them; the evals took {syn:.3f} s, which a loop that evaluates "
            f"inline (the peers at a barrier) adds to every rank")
    return {"evals": evals, "other_epochs_mean_s": other,
            "evals_s": syn, "ranks": outside}


def meval_hook(params_file, pr):
    """[meval]'s rank hook: the mesh eval forward of `params_file`'s
    parameters on the rank's part (a collective: every rank runs it), its
    second call timed with the device synchronized; its launches come
    before the counters' reset and do not count. Returns the inner rows'
    logits and their global ids."""
    import torch
    from bnsgcn_tpu_torch import checkpoint as ckpt
    from bnsgcn_tpu_torch.models.gnn import GNN
    from bnsgcn_tpu_torch.trainer import params_from_jax
    model = GNN(pr.spec)
    model.load_state_dict(params_from_jax(ckpt.read_blob(params_file)["params"],
                                          pr.spec))
    model = model.to(pr.device)
    sync = (torch.cuda.synchronize if pr.device.type == "cuda"
            else lambda d: None)
    pr.fns.eval_forward(model, pr.blk)                  # warm-up
    sync(pr.device)
    t0 = time.perf_counter()
    logits = pr.fns.eval_forward(model, pr.blk)
    sync(pr.device)
    secs = time.perf_counter() - t0
    inner = pr.art.inner_mask[0]
    return {"logits": logits.float().cpu().numpy()[inner],
            "gnid": pr.art.global_nid[0][inner], "seconds": secs}


def meval_cfg(base):
    """[meval]'s run: --eval-device mesh on the law's transductive
    artifacts, with --dump-embeddings."""
    return base.replace(n_partitions=PARTS, n_epochs=MEVAL_EPOCHS,
                        log_every=MEVAL_LOG_EVERY, sampling_rate=BNS_RATE,
                        eval_device="mesh", skip_partition=True,
                        dump_embeddings=os.path.join(base.ckpt_path,
                                                     "meval_table.tbl"))


def meval_phase(base, g, params_file):
    """[meval]: --eval-device mesh, the P=4 main path's model on the law
    run's transductive artifacts (--skip-partition) at rate BNS_RATE,
    MEVAL_EPOCHS epochs, an eval every MEVAL_LOG_EVERY. Each rank first runs
    the mesh eval forward of `params_file`'s parameters (meval_hook); the
    assembled logits must agree with the host eval's (COO, evaluate.py) on
    the full graph with the same parameters within MEVAL_LOGIT_FRAC of the
    largest |logit|, and its val and test predictions with the host's
    apart from rows whose host top two logits lie within twice that bound.
    Then every rank's K1 and K2 must have launched once per aggregation of
    training and of each eval forward (all n_layers layers: use_pp's layer
    0 aggregates the raw features in eval) under 'eval', the eval lines and
    the Test Result printed. Returns the details."""
    import functools

    import numpy as np
    import torch
    from bnsgcn_tpu_torch import checkpoint as ckpt
    from bnsgcn_tpu_torch.evaluate import full_graph_logits
    from bnsgcn_tpu_torch.models.gnn import GNN, spec_from_config
    from bnsgcn_tpu_torch.run import run_training
    from bnsgcn_tpu_torch.trainer import params_from_jax
    c = meval_cfg(base)
    table = c.dump_embeddings
    tee = Tee()
    t0 = time.perf_counter()
    res = run_training(c, g=g, log=tee,
                       rank_hook=functools.partial(meval_hook, params_file))
    secs = time.perf_counter() - t0
    n_evals = MEVAL_EPOCHS // MEVAL_LOG_EVERY + 1
    evals = [ln for ln in tee.lines if ln.startswith("Epoch ")
             and "| Validation Accuracy " in ln]
    if len(evals) != n_evals - 1 or not tee.having("Test Result | Accuracy"):
        raise AssertionError(f"[meval] eval lines {evals}; Test Result "
                             f"{tee.having('Test Result')}")
    # the host eval of the same parameters on the full graph, on the card
    spec = spec_from_config(c.replace(n_feat=g.n_feat, n_class=g.n_class))
    model = GNN(spec)
    model.load_state_dict(params_from_jax(ckpt.read_blob(params_file)["params"],
                                          spec))
    dev = torch.device(c.device)
    model = model.to(dev)
    full_graph_logits(model, g, dev)                    # warm-up
    t_h = time.perf_counter()
    host = full_graph_logits(model, g, dev)             # ends on the host
    host_s = time.perf_counter() - t_h
    mesh = np.zeros_like(host)
    for rep in res.ranks:
        mesh[rep["hook"]["gnid"]] = rep["hook"]["logits"]
    bound = MEVAL_LOGIT_FRAC * float(np.abs(host).max())
    err = float(np.abs(mesh - host).max())
    if not err <= bound:
        raise AssertionError(f"[meval] mesh logits differ from the host "
                             f"eval's by {err:.3e} > {bound:.3e}")
    top2 = np.sort(host, 1)[:, -2:]
    near = (top2[:, 1] - top2[:, 0]) <= 2 * bound
    accs = {}
    for mode, mask in (("val", g.val_mask), ("test", g.test_mask)):
        lab = np.asarray(g.label)[mask]
        pm, ph = mesh[mask].argmax(1), host[mask].argmax(1)
        if not (pm == ph)[~near[mask]].all():
            raise AssertionError(f"[meval] {mode}: the mesh eval predicts "
                                 f"other classes than the host eval on rows "
                                 f"that are no near-ties")
        accs[mode] = (float((pm == lab).mean()), float((ph == lab).mean()),
                      int((pm != ph).sum()))
    mesh_s = [rep["hook"]["seconds"] for rep in res.ranks]
    # each eval and the export's embed_forward: one launch of each a layer
    passes = (c.n_layers - 1) * c.n_epochs
    want = {"fwd": passes, "bwd": passes, "pre": 1,
            "eval": c.n_layers * (n_evals + 1)}
    for rep in res.ranks:
        for name, cnt in rep["launches"].items():
            if cnt != want:
                raise AssertionError(f"[meval] rank {rep['rank']}: {name} "
                                     f"launched {cnt}, not {want}")
    export = export_check(c, g, tee, table)
    log(f"[meval] --eval-device mesh, P={PARTS} transductive, rate "
        f"{c.sampling_rate}, {c.n_epochs} epochs: mesh logits of the P={PARTS}"
        f" main path's best parameters against the host eval's (COO) on the "
        f"full graph: max |diff| {err:.3e} <= {bound:.3e} ({MEVAL_LOGIT_FRAC}"
        f" of max |logit|); val accuracy {accs['val'][0]:.4f} (host "
        f"{accs['val'][1]:.4f}), test {accs['test'][0]:.4f} (host "
        f"{accs['test'][1]:.4f}); {accs['val'][2] + accs['test'][2]} rows "
        f"predicted otherwise, all within {2 * bound:.3e} of a tie "
        f"({int(near.sum())} such rows)")
    log(f"[meval] one mesh eval forward (synchronized, after a warm-up): "
        + ", ".join(f"{s:.3f}" for s in mesh_s) + " s on ranks 0-3 beside "
        f"the host eval's {host_s:.3f} s (rank 0's device, the whole graph);"
        f" the run's evals on rank 0: "
        + ", ".join(f"{s:.3f}" for s in res.eval_seconds)
        + f" s (the last the Test Result); launches per rank K1 "
        f"{res.ranks[0]['launches']['K1']} K2 "
        f"{res.ranks[0]['launches']['K2']} ({secs:.1f} s)")
    return {"max_abs_err": err, "bound": bound, "accs": accs,
            "near_ties": int(near.sum()), "mesh_forward_s": mesh_s,
            "host_eval_s": host_s, "eval_seconds": res.eval_seconds,
            "evals": evals, "losses": res.losses,
            "launches": [rep["kinds"] for rep in res.ranks],
            "export": export, "seconds": secs}


def export_check(c, g, tee, table):
    """[meval]'s --dump-embeddings (transductive, --eval-device mesh: the
    ranks' embed_forward and rank 0's gather): one export line, and a table
    of every node with the JAX meta keys; serve_phase holds its values to
    the host branch's. Returns the details, with the export's seconds as
    the run logged them."""
    from bnsgcn_tpu_torch import serve
    line = tee.having("[serve] embedding table [")
    if len(line) != 1:
        raise AssertionError(f"[serve] the export logged {line}")
    secs = float(re.search(r"\(([\d.]+)s\)$", line[0]).group(1))
    hidden, logits, meta = serve.load_table(table)
    want = {"graph_name": c.derive_graph_name(), "model": c.model,
            "n_nodes": g.n_nodes, "epoch": c.n_epochs - 1}
    if (any(meta.get(k) != v for k, v in want.items())
            or hidden.shape != (g.n_nodes, c.n_hidden)
            or logits.shape != (g.n_nodes, g.n_class)):
        raise AssertionError(f"[serve] the table {hidden.shape} "
                             f"{logits.shape}, meta {meta}, not {want}")
    return {"seconds": secs, "table": table, "shape": list(hidden.shape)}


def serve_phase(c, g, export):
    """[serve] in this process, alone on the card: over the P=4 graph with
    [meval]'s best parameters (`export`, export_check's). Two precomputes
    (the serving forward, full_graph_embeddings with the fixed-order sum)
    must be bitwise equal, and the exported table (export_check's) within
    SERVE_FRAC of theirs, its predictions too apart from near-ties; the
    same forward with index_add_'s sums (the host eval's earlier route) is
    timed beside them. Then
    build_core over them and a ServeServer on a free port: SERVE_CLIENTS
    client threads send SERVE_TIER_A predicts over TCP, each bitwise the
    table's row; SERVE_TIER_B clean nodes go to tier B, half as predicts
    (the batcher's steps) and half in one predict_many beside them (two
    buckets in flight), each within SERVE_FRAC of its tier-A row; the
    stats op gives each tier's p50 and p99. Last, one tier-B step of a node
    alone, timed by its parts (the closure's build on the host, the
    arrays' transfer, the forward with the copy back). Returns (the core
    and its server, that step's result, the details) for serve_checks."""
    import numpy as np
    import torch
    from bnsgcn_tpu_torch import serve
    from bnsgcn_tpu_torch.evaluate import (EvalGraph, _to_host,
                                           full_graph_embeddings)
    from bnsgcn_tpu_torch.models.gnn import apply_model
    from bnsgcn_tpu_torch.ops.spmm import agg_sum
    dev = torch.device("cuda")
    t_all = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    # the run's best parameters, as the server loads them
    model, _, _ = serve.load_model(c.replace(
        n_feat=g.n_feat, n_class=g.n_class, n_train=g.n_train), dev, log)
    hidden_x, logits_x, _ = serve.load_table(export["table"])
    secs = {}
    t0 = time.perf_counter()
    fixed = EvalGraph(g, c.model, dev)
    torch.cuda.synchronize()
    secs["fixed_graph"] = time.perf_counter() - t0
    pre = []
    for i in range(2):
        t0 = time.perf_counter()
        pre.append(full_graph_embeddings(model, fixed, dev))
        secs[f"precompute_{i + 1}"] = time.perf_counter() - t0
    if not all(np.array_equal(a, b) for a, b in zip(pre[0], pre[1])):
        raise AssertionError("[serve] two precomputes differ in their bits")
    # the yardstick: the same forward with index_add_'s sums (atomics on
    # the card), the host eval's earlier route
    env = fixed.env
    plain = dataclasses.replace(env, fixed_sum=None, aggregate=lambda h: (
        agg_sum(h, env.src, env.dst, env.n_dst)))
    t0 = time.perf_counter()
    with torch.no_grad():
        plain_logits = _to_host(apply_model(model, fixed.feat, plain))
    secs["index_add_eval"] = time.perf_counter() - t0
    del fixed, plain, env
    # the precompute is the host branch's table: the export's must agree
    hidden, logits = pre[1]
    errs = {}
    for name, got, ref in (("hidden", hidden_x, hidden),
                           ("logits", logits_x, logits),
                           ("index_add_ logits", plain_logits, logits)):
        bound = SERVE_FRAC * float(np.abs(ref).max())
        errs[name] = (float(np.abs(got - ref).max()), bound)
        if not errs[name][0] <= bound:
            raise AssertionError(f"[serve] the {name} differ from the "
                                 f"precompute's by {errs[name][0]:.3e} > "
                                 f"{bound:.3e}")
    top2 = np.sort(logits, 1)[:, -2:]
    near = (top2[:, 1] - top2[:, 0]) <= 2 * errs["logits"][1]
    apart = logits_x.argmax(1) != logits.argmax(1)
    if (apart & ~near).any():
        raise AssertionError("[serve] the exported logits predict other "
                             "classes than the host branch's on rows that "
                             "are no near-ties")
    t0 = time.perf_counter()
    cs = c.replace(serve_max_batch=64)
    core = serve.build_core(cs, g, model, log=log, hidden=hidden,
                            logits=logits)
    secs["serving_graph"] = time.perf_counter() - t0
    server = serve.ServeServer(core, 0, "127.0.0.1", log=log)
    table = logits.copy()
    rng = np.random.default_rng(0)
    nodes_a = rng.integers(0, g.n_nodes, SERVE_TIER_A).tolist()
    errors = []

    def tier_a(part):
        for v in part:
            r = serve.request(server.port, {"op": "predict", "node": v})
            if not (r.get("tier") == "A" and np.array_equal(
                    np.asarray(r["scores"], np.float32), table[v])):
                errors.append(("A", v, r.get("tier")))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=tier_a,
                                args=(nodes_a[k::SERVE_CLIENTS],))
               for k in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    secs["tier_a_requests"] = time.perf_counter() - t0
    nodes_b = rng.choice(g.n_nodes, SERVE_TIER_B, replace=False).tolist()
    got_b = {}

    def tier_b(v):
        got_b[v] = serve.request(server.port, {"op": "predict", "node": v,
                                               "tier": "B"},
                                 timeout_s=SERVE_TIMEOUT_S)

    def tier_b_many(vs):
        r = serve.request(server.port, {"op": "predict_many", "nodes": vs,
                                        "tier": "B"},
                          timeout_s=SERVE_TIMEOUT_S)
        got_b.update({x["node"]: x for x in r["results"]})

    half = SERVE_TIER_B // 2
    t0 = time.perf_counter()
    threads = ([threading.Thread(target=tier_b, args=(v,))
                for v in nodes_b[:half]]
               + [threading.Thread(target=tier_b_many,
                                   args=(nodes_b[half:],))])
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    secs["tier_b_requests"] = time.perf_counter() - t0
    bound = SERVE_FRAC * float(np.abs(table).max())
    err_b = 0.0
    for v in nodes_b:
        r = got_b.get(v, {})
        if r.get("tier") != "B":
            errors.append(("B", v, r))
            continue
        err_b = max(err_b, float(np.abs(np.asarray(r["scores"], np.float32)
                                        - table[v]).max()))
    if errors or not err_b <= bound:
        raise AssertionError(f"[serve] over TCP: {errors[:5]}; tier B of "
                             f"clean nodes {err_b:.3e} from tier A (bound "
                             f"{bound:.3e})")
    stats = serve.request(server.port, {"op": "stats"})
    v = int(np.argmin(core.graph.in_deg))
    alone = core.scorer.score(core.graph, model, [v])
    step = dict(core.scorer.last)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    log(f"[serve] --dump-embeddings under --eval-device mesh (P={PARTS}, "
        f"transductive): table {export['shape']} + logits in "
        f"{export['seconds']:.1f} s (the run's line: embed_forward on every "
        f"rank, rank 0's gather, the write); against the host branch's "
        f"table of the same parameters (the precompute below): hidden max "
        f"|diff| {errs['hidden'][0]:.3e} <= {errs['hidden'][1]:.3e}, logits "
        f"{errs['logits'][0]:.3e} <= {errs['logits'][1]:.3e} ({SERVE_FRAC} "
        f"of the largest); {int(apart.sum())} rows predicted otherwise, all "
        f"near-ties ({int(near.sum())} such rows)")
    log(f"[serve] in process, synth-reddit:{g.n_nodes} nodes: precompute "
        f"(the serving forward, fixed-order sums) {secs['precompute_1']:.3f} "
        f"s, then {secs['precompute_2']:.3f} s, bitwise equal (its sort and "
        f"the edges to the card {secs['fixed_graph']:.3f} s once); the "
        f"same forward with index_add_'s sums (the eval's earlier route) "
        f"{secs['index_add_eval']:.3f} s (its logits "
        f"{errs['index_add_ logits'][0]:.3e} from the precompute's); the "
        f"serving graph (two CSR indexes) {secs['serving_graph']:.3f} s")
    log(f"[serve] over TCP ({SERVE_CLIENTS} client threads): "
        f"{SERVE_TIER_A} tier-A predicts bitwise the table "
        f"({secs['tier_a_requests']:.3f} s), {SERVE_TIER_B} tier-B of clean "
        f"nodes ({half} predicts, {SERVE_TIER_B - half} in a predict_many "
        f"beside them) within {err_b:.3e} <= {bound:.3e} of tier A "
        f"({secs['tier_b_requests']:.3f} s, {stats['batches']} batcher "
        f"steps); the stats op: tier A p50 {stats['tier_a_p50_ms']:.3f} ms "
        f"p99 {stats['tier_a_p99_ms']:.3f} ms, tier B p50 "
        f"{stats['tier_b_p50_ms']:.1f} ms p99 {stats['tier_b_p99_ms']:.1f} "
        f"ms")
    log(f"[serve] one tier-B step, node {v} alone (in-degree "
        f"{int(core.graph.in_deg[v])}): its {core.hops}-hop closure "
        f"{step['nodes']} nodes, {step['edges']} edges (buckets "
        f"{step['node_bucket']} x {step['edge_bucket']}): build "
        f"{step['build_s']:.3f} s (host), transfer {step['transfer_s']:.3f} "
        f"s, forward with the copy back {step['forward_s']:.3f} s; peak "
        f"memory {peak:.2f} GiB ({time.perf_counter() - t_all:.1f} s)")
    return (core, server, model), (v, alone), {
        "seconds": secs, "stats": stats, "tier_b_err": err_b,
        "export": dict(export, errors={k: list(v) for k, v in errs.items()},
                       apart=int(apart.sum()), near_ties=int(near.sum())),
        "bound": bound, "step": step, "peak_gib": peak,
        "phase_s": time.perf_counter() - t_all}


def serve_checks(c, g, held, alone):
    """[serve]'s delta and flush, beside [cli] (no time read): the node of
    serve_phase's step (`alone`) in a full bucket of --serve-max-batch
    targets must get the same bits; an edge between the two nodes of least
    out-degree must mark exactly their 4-hop forward closure (a BFS over the
    mutated edge list, apart from DynamicGraph's); one step over the whole
    dirty set then leaves every clean row bitwise untouched and the dirty
    rows within SERVE_FRAC of a scratch full eval of the mutated graph
    (the serving forward). Closes the server. Returns the details."""
    import numpy as np
    import torch
    from bnsgcn_tpu_torch.data.graph import Graph
    from bnsgcn_tpu_torch.evaluate import full_graph_logits
    core, server, model = held
    v, got = alone
    t0 = time.perf_counter()
    try:
        others = [x for x in range(g.n_nodes) if x != v]
        full = core.scorer.score(
            core.graph, model,
            sorted([v] + others[:core.cfg.serve_max_batch - 1]))
        if not all(np.array_equal(a, b) for a, b in zip(got[v], full[v])):
            raise AssertionError(f"[serve] node {v} alone and in a full "
                                 f"bucket differ in their bits")
        bucket = dict(core.scorer.last)
        u, w = (int(x) for x in np.argsort(core.graph.out_deg,
                                           kind="stable")[:2])
        before_h, before_l = core.hidden.copy(), core.logits.copy()
        core.add_edges([(u, w)])
        src = np.concatenate([g.src, [u]])
        dst = np.concatenate([g.dst, [w]])
        reach = np.zeros(g.n_nodes, bool)
        reach[[u, w]] = True
        frontier = reach.copy()
        for _ in range(core.hops):
            nxt = np.zeros(g.n_nodes, bool)
            nxt[dst[frontier[src]]] = True
            frontier = nxt & ~reach
            reach |= nxt
        expected = set(np.nonzero(reach)[0].tolist())
        if core.dirty != expected:
            raise AssertionError(f"[serve] the delta marked {len(core.dirty)} "
                                 f"nodes, not the {len(expected)} of its "
                                 f"forward closure")
        n_dirty = len(expected)
        picked = core.refresh_some(n_dirty)
        core.flush()
        flush = dict(core.scorer.last)
        clean = np.setdiff1d(np.arange(g.n_nodes), sorted(expected))
        if not (np.array_equal(core.hidden[clean], before_h[clean])
                and np.array_equal(core.logits[clean], before_l[clean])):
            raise AssertionError("[serve] the flush touched clean rows")
        g2 = Graph(g.n_nodes, src, dst, g.feat, g.label, g.train_mask,
                   g.val_mask, g.test_mask, g.multilabel)
        ref = full_graph_logits(model, g2, torch.device("cuda"))
        ids = sorted(expected)
        bound = SERVE_FRAC * float(np.abs(ref).max())
        err = float(np.abs(core.logits[ids] - ref[ids]).max())
        if picked != n_dirty or core.dirty or not err <= bound:
            raise AssertionError(f"[serve] the flush picked {picked} of "
                                 f"{n_dirty}, left {len(core.dirty)} dirty, "
                                 f"its rows {err:.3e} from the scratch eval "
                                 f"(bound {bound:.3e})")
    finally:
        server.drain()
        core.close()
    log(f"[serve] node {v} alone and in a full bucket of "
        f"{core.cfg.serve_max_batch} ({bucket['nodes']} nodes, "
        f"{bucket['edges']} edges): bitwise equal; an edge {u} -> {w} (the "
        f"least out-degrees) marked exactly its {core.hops}-hop forward "
        f"closure, {n_dirty} nodes; one step over them (build "
        f"{flush['build_s']:.3f} s, transfer {flush['transfer_s']:.3f} s, "
        f"forward {flush['forward_s']:.3f} s; beside [cli]) left the "
        f"{clean.size} clean rows bitwise untouched, the dirty rows within "
        f"{err:.3e} <= {bound:.3e} of a scratch eval of the mutated graph "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"dirty": n_dirty, "clean": int(clean.size), "flush_err": err,
            "bound": bound, "bucket": bucket, "flush_step": flush,
            "seconds": time.perf_counter() - t0}


def serve_cli_phase(work, table):
    """[serve] through the CLI (`python -m bnsgcn_tpu_torch.main serve`)
    over [cli]'s first run (its final checkpoint and the table its
    --dump-embeddings wrote, `table`, awaited), beside [cli]: a cold start
    from the table answers predict and predict_many and takes a delta; a
    SIGTERM makes it exit 75 with the delta log flushed; a relaunch replays
    it (the same dirty count), then, under --serve-compact-deltas 1,
    folds it and a second delta into the snapshot and exits 0 on the
    shutdown op; the launch after it resumes from the snapshot and the
    (empty) tail and exits 0. Returns the details."""
    import numpy as np
    from bnsgcn_tpu_torch import serve
    t_all = time.perf_counter()
    end = time.monotonic() + CLI_TIMEOUT_S
    while not os.path.exists(table) and time.monotonic() < end:
        time.sleep(0.5)
    sd = os.path.join(work, "cli_serve")
    argv = (script_flags(CLI_SCRIPT) + CLI_FLAGS
            + ["--ckpt-path", os.path.join(work, "cli", "ckpt"),
               "--serve-dir", sd, "--serve-port", "0", "--serve-refresh-s",
               "0"])
    cmd = [sys.executable, "-m", "bnsgcn_tpu_torch.main", "serve"]
    hidden, logits, _ = serve.load_table(table)
    launches = []

    def start(extra):
        t0 = time.perf_counter()
        p = start_cli(argv + extra, cmd=cmd)
        launches.append(p)
        head = read_until(p, "[serve] ready on port ")
        m = re.search(r"\[serve\] ready on port (\d+)", head)
        if not m:
            finish_cli(p, argv + extra, SERVE_TIMEOUT_S)
            raise AssertionError(f"[serve] the CLI server did not start:\n"
                                 f"{head[-3000:]}")
        return p, int(m.group(1)), head, time.perf_counter() - t0

    try:
        p, port, head, up_a = start(["--embeddings", table])
        if "cold start from embedding table" not in head:
            raise AssertionError(f"[serve] no cold start:\n{head[-2000:]}")
        r = serve.request(port, {"op": "predict", "node": 7})
        many = serve.request(port, {"op": "predict_many",
                                    "nodes": [0, 1, 2, 3]})
        if not (r["tier"] == "A" and np.array_equal(
                np.asarray(r["scores"], np.float32), logits[7])
                and len(many["results"]) == 4):
            raise AssertionError(f"[serve] cold start answers {r} {many}")
        d1 = serve.request(port, {"op": "add_edges", "edges": [[3, 7]]})
        os.kill(p.pid, signal.SIGTERM)
        out_a = head + finish_cli(p, argv, SERVE_TIMEOUT_S, rc=75)
        with open(os.path.join(sd, serve.DELTA_LOG)) as f:
            logged = [json.loads(x) for x in f if x.strip()]
        if (logged != [{"op": "add_edges", "edges": [[3, 7]]}]
                or "1 delta(s) flushed" not in out_a):
            raise AssertionError(f"[serve] SIGTERM flushed {logged}:\n"
                                 f"{out_a[-2000:]}")
        p, port, head, up_b = start(["--serve-compact-deltas", "1"])
        m = re.search(r"replayed from the tail log \((\d+) nodes dirty",
                      head)
        if not (m and int(m.group(1)) == d1["dirty_total"]):
            raise AssertionError(f"[serve] the relaunch replayed to "
                                 f"{m and m.group(1)} dirty nodes, not "
                                 f"{d1['dirty_total']}:\n{head[-2000:]}")
        serve.request(port, {"op": "add_edges", "edges": [[5, 9]]})
        stats_b = serve.request(port, {"op": "stats"})
        serve.request(port, {"op": "shutdown"})
        out_b = head + finish_cli(p, argv, SERVE_TIMEOUT_S)
        if ("[serve] compacted delta log: 2 delta(s) folded into "
                f"{serve.SNAPSHOT}, 0 left in the tail" not in out_b
                or not os.path.exists(os.path.join(sd, serve.SNAPSHOT))):
            raise AssertionError(f"[serve] no compaction:\n{out_b[-2000:]}")
        p, port, head, up_c = start([])
        stats_c = serve.request(port, {"op": "stats"})
        serve.request(port, {"op": "shutdown"})
        out_c = head + finish_cli(p, argv, SERVE_TIMEOUT_S)
        if not (f"[serve] snapshot {serve.SNAPSHOT}: 2 folded delta(s)"
                in out_c and "[serve] resumed: 2 delta(s) from the snapshot "
                "+ 0 replayed" in out_c and stats_c["deltas"] == 2):
            raise AssertionError(f"[serve] the launch after the compaction "
                                 f"did not resume from it:\n{out_c[-2000:]}")
    finally:
        for p in launches:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    secs = time.perf_counter() - t_all
    log(f"[serve] python -m bnsgcn_tpu_torch.main serve over [cli]'s run "
        f"({hidden.shape[0]} nodes): a cold start from its "
        f"--dump-embeddings table (ready in {up_a:.1f} s) answered predict "
        f"and predict_many, took a delta ({d1['dirty_total']} nodes dirty), "
        f"exited 75 on SIGTERM with it flushed; the relaunch replayed it "
        f"({d1['dirty_total']} dirty; ready in {up_b:.1f} s), under "
        f"--serve-compact-deltas 1 folded it and a second into "
        f"{serve.SNAPSHOT} and exited 0 on shutdown ({stats_b['deltas']} "
        f"deltas); the next launch resumed from the snapshot and the empty "
        f"tail (ready in {up_c:.1f} s) and exited 0 ({secs:.1f} s, beside "
        f"[cli])")
    return {"dirty": d1["dirty_total"], "ready_s": [up_a, up_b, up_c],
            "seconds": secs}


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


def gat_hook(pr):
    """[gat]'s rank hook: a CUDA-event timer on the rank's GAT attention
    (handed back with the report as each call's ms), the layouts' build
    seconds, and the presence masks of epochs BNS_EPOCHS' plans built on
    the card as the training builds them."""
    import torch
    from bnsgcn_tpu_torch.ops.ell_attention import EventTimer
    from bnsgcn_tpu_torch.parallel.halo import make_halo_plan, make_halo_spec
    from bnsgcn_tpu_torch.utils import prng
    art, c = pr.art, pr.cfg
    timer = EventTimer()
    pr.fns.gat.timer = timer
    spec, tables = make_halo_spec(art.n_b, art.pad_inner, art.pad_boundary,
                                  c.sampling_rate, wire=c.halo_wire)
    bnd = torch.from_numpy(art.bnd[0]).to(pr.device)
    key = prng.key(c.seed, pr.device)
    pres = [make_halo_plan(spec, tables, bnd, pr.rank, e, key).presence
            .cpu().numpy() for e in BNS_EPOCHS]
    return {"timer": timer, "build_s": pr.fns.gat.build_seconds,
            "presence": pres, "n_ext": art.n_ext}


def gat_phase(main4, g):
    """[gat]: the P=4 main path's command line (the flagship's, --inductive,
    rate 0.1, dropout 0.5) with --model gat --heads GAT_HEADS on its
    artifacts (--skip-partition), GAT_EPOCHS epochs, rank 0 evaluating every
    GAT_LOG_EVERY on the train+val subgraph (COO, the segment softmax) and
    last the full graph's test. Every rank's presence masks for BNS_EPOCHS
    must be the CPU plans' that [bns] checked (the inner rows and the
    received slots); the loss finite and falling, no K1 or K2 launch, every
    rank ending with rank 0's parameters. Prints the epoch, exchange and
    reduce seconds, peak memory, the layouts' build seconds and the
    attention's device ms per layer forward and backward (CUDA events,
    means of epochs 1..; 4 ranks share the card), the evals' seconds and
    the losses (its law is gat_law_phase). Returns the details."""
    import numpy as np
    import torch
    from bnsgcn_tpu_torch.data.artifacts import load_artifacts
    from bnsgcn_tpu_torch.parallel.halo import (make_halo_plan,
                                                make_halo_spec, plan_presence)
    from bnsgcn_tpu_torch.run import artifacts_dir, run_training
    from bnsgcn_tpu_torch.utils import prng
    root = os.path.dirname(main4.ckpt_path.rstrip("/"))
    c = main4.replace(model="gat", heads=GAT_HEADS, n_epochs=GAT_EPOCHS,
                      log_every=GAT_LOG_EVERY, skip_partition=True,
                      ckpt_path=os.path.join(root, "gat", "ckpt"),
                      results_path=os.path.join(root, "gat", "results"))
    tee = Tee()
    t0 = time.perf_counter()
    res = run_training(c, g=g, log=tee, rank_hook=gat_hook)
    secs = time.perf_counter() - t0
    if not all(math.isfinite(x) for x in res.losses):
        raise AssertionError(f"[gat] non-finite loss {res.losses}")
    if not res.losses[-1] < res.losses[0]:
        raise AssertionError(f"[gat] loss did not fall: {res.losses}")
    evals = [ln for ln in tee.lines if ln.startswith("Epoch ")
             and " | Accuracy " in ln]
    if (len(evals) != GAT_EPOCHS // GAT_LOG_EVERY
            or not tee.having("Test Result | Accuracy ")):
        raise AssertionError(f"[gat] eval lines {evals}")
    # the presence masks against the CPU plans [bns] held to the card's
    art = load_artifacts(artifacts_dir(c))
    spec, tables = make_halo_spec(art.n_b, art.pad_inner, art.pad_boundary,
                                  c.sampling_rate)
    present = []
    for rep in res.ranks:
        r = rep["rank"]
        if rep["launches"] != {"K1": {}, "K2": {}}:
            raise AssertionError(f"[gat] rank {r} launched {rep['launches']}")
        for e, got in zip(BNS_EPOCHS, rep["hook"]["presence"]):
            plan = make_halo_plan(spec, tables, torch.from_numpy(art.bnd[r]),
                                  r, e, prng.key(c.seed))
            want = plan_presence(spec, plan.slots).numpy()
            halo = int(got[art.pad_inner:].sum())
            if not (np.array_equal(got, want) and got[:art.pad_inner].all()
                    and halo == int(tables["send_size"][:, r].sum())):
                raise AssertionError(f"[gat] rank {r} epoch {e}: presence "
                                     f"is not the plan's")
            present.append(halo)
    L = c.n_layers - c.n_linear
    ranks = []
    for rep in res.ranks:
        ms = rep["hook"]["timer"].ms
        per = {}
        for kind in ("fwd", "bwd"):
            calls = np.asarray(ms[kind]).reshape(c.n_epochs, L)[1:]
            if kind == "bwd":
                calls = calls[:, ::-1]          # the backward runs last first
            per[kind] = calls.mean(0).tolist()
        ep, ex, rd = (mean_from_1(rep[k]) for k in
                      ("epoch_times", "comm_times", "reduce_times"))
        ranks.append({"rank": rep["rank"], "epoch_s": ep, "exchange_s": ex,
                      "reduce_s": rd,
                      "max_memory_gib": rep["max_memory_bytes"] / 2 ** 30,
                      "build_s": rep["hook"]["build_s"],
                      "attention_ms": per, "n_edges": rep["n_edges"]})
    for x in ranks:
        att = x["attention_ms"]
        log(f"[gat] rank {x['rank']} (4 ranks sharing one card over gloo, "
            f"not a 4-card number), {x['n_edges']} edges: mean of epochs "
            f"1.. {x['epoch_s'] * 1e3:.1f} ms, exchange "
            f"{x['exchange_s'] * 1e3:.1f} ms, all-reduce "
            f"{x['reduce_s'] * 1e3:.1f} ms, peak memory "
            f"{x['max_memory_gib']:.2f} GiB, GAT layouts built in "
            f"{x['build_s']:.2f} s; the attention's device ms per layer "
            f"(events) forward " + " / ".join(f"{v:.2f}" for v in att["fwd"])
            + ", backward " + " / ".join(f"{v:.2f}" for v in att["bwd"]))
    log(f"[gat] --model gat --heads {c.heads}, the flagship's command line on "
        f"the P={PARTS} artifacts (inductive, rate {c.sampling_rate}, "
        f"dropout {c.dropout}), {c.n_epochs} epochs: losses "
        + " ".join(f"{v:.4f}" for v in res.losses)
        + f"; rank 0's evals " + ", ".join(f"{t:.2f}" for t in
                                          res.eval_seconds)
        + f" s (every {c.log_every} epochs on the train+val subgraph, then "
        f"the full graph's test; COO, the segment softmax); val "
        f"{res.val_acc:.3f}, test {res.test_acc:.3f}; presence masks of "
        f"epochs {BNS_EPOCHS} equal the checked plans' ({sum(present)} "
        f"halo slots present); no K1/K2 launch; every rank ends with rank "
        f"0's parameters ({secs:.1f} s)")
    torch.cuda.empty_cache()
    return {"losses": res.losses, "eval_seconds": res.eval_seconds,
            "val_acc": res.val_acc, "test_acc": res.test_acc,
            "ranks": ranks, "seconds": secs}


def law_p1_phase(law, g, losses_p4):
    """The P-rank law's P=1 side: `law` (the P=4 run's config at
    n_partitions 1: rate 1.0, dropout 0, LAW_EPOCHS epochs, transductive)
    on the same graph `g`; the P=4 run's losses within LAW_RTOL (relative)
    of its. It reads no time, so it runs beside [cli] and [anchor].
    Returns the details."""
    import torch
    from bnsgcn_tpu_torch.run import run_training
    t0 = time.perf_counter()
    r1 = run_training(law, g=g, log=lambda m: None)
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses_p4, r1.losses))
    if not (len(losses_p4) == len(r1.losses) == LAW_EPOCHS
            and rel <= LAW_RTOL):
        raise AssertionError(f"P={PARTS} losses {losses_p4} differ from "
                             f"P=1's {r1.losses} by {rel:.3e} (relative)")
    log(f"[parts] law P={PARTS} == P=1, {LAW_EPOCHS} epochs, dropout 0: "
        f"max relative loss difference {rel:.3e} <= {LAW_RTOL} (the P=1 "
        f"run {time.perf_counter() - t0:.1f} s)")
    return {"law_losses_p1": r1.losses, "law_max_rel": rel,
            "law_p1_epoch_s": mean_from_1(r1.epoch_times)}


def gat_law_phase(cfg, work):
    """[gat]'s law: GAT at GAT_LAW_DATASET (cfg's model otherwise: [cli]'s
    scale), P=4 against P=1, rate 1.0, dropout 0, LAW_EPOCHS epochs, losses
    within LAW_RTOL (relative). It reads no time, so it runs beside [cli]
    and [anchor]. Returns the details."""
    from bnsgcn_tpu_torch.data.datasets import load_data
    from bnsgcn_tpu_torch.run import run_training
    law = cfg.replace(dataset=GAT_LAW_DATASET, model="gat", heads=GAT_HEADS,
                      dropout=0.0, n_epochs=LAW_EPOCHS, log_every=1,
                      eval=False, sampling_rate=1.0, dist_backend="gloo",
                      part_path=os.path.join(work, "gat_law", "parts"))
    t0 = time.perf_counter()
    g_law, _, _ = load_data(law)
    quiet = lambda m: None                                   # noqa: E731
    r4 = run_training(law.replace(n_partitions=PARTS), g=g_law, log=quiet)
    r1 = run_training(law, g=g_law, log=quiet)
    rel = max(abs(a - b) / abs(b) for a, b in zip(r4.losses, r1.losses))
    if not (len(r4.losses) == len(r1.losses) == LAW_EPOCHS
            and rel <= LAW_RTOL):
        raise AssertionError(f"[gat] law: P={PARTS} losses {r4.losses} differ "
                             f"from P=1's {r1.losses} by {rel:.3e}")
    log(f"[gat] law P={PARTS} == P=1 at {GAT_LAW_DATASET} ({g_law.n_nodes} "
        f"nodes, {g_law.n_edges} edges), rate 1.0, dropout 0, {LAW_EPOCHS} "
        f"epochs: max relative loss difference {rel:.3e} <= {LAW_RTOL} "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"law_losses_p4": r4.losses, "law_losses_p1": r1.losses,
            "law_max_rel": rel}


def start_cli(argv, cmd=None, env=None):
    """Start `bash scripts/reddit_torch.sh argv` (or `cmd + argv`) from the
    repo root in a session of its own, with `env` added to the
    environment; its output (stderr too) in a pipe."""
    env = dict(os.environ, PYTHON=sys.executable, **(env or {}))
    return subprocess.Popen((cmd or ["bash", CLI_SCRIPT]) + argv, cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def finish_cli(p, argv, timeout_s=CLI_TIMEOUT_S, rc=0):
    """Wait for start_cli's process; returns its output. An exit other than
    `rc` raises with the end of its output; past the timeout the whole
    session (the CLI and the ranks it spawned) is killed."""
    try:
        out, _ = p.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise AssertionError(f"[cli] {' '.join(argv)}: no exit within "
                             f"{timeout_s} s")
    if p.returncode != rc:
        raise AssertionError(f"[cli] {' '.join(argv)} exited "
                             f"{p.returncode}, not {rc}:\n{out[-3000:]}")
    return out


def read_until(p, marker):
    """Read start_cli's output up to and with the first line starting with
    `marker` (or to its end); returns what was read."""
    out = []
    for line in p.stdout:
        out.append(line)
        if line.startswith(marker):
            break
    return "".join(out)


def wait_for_file(path, suffix, timeout_s=CLI_TIMEOUT_S):
    """The name of the first file in `path` ending with `suffix`, once one
    is there (a checkpoint appears whole: it is written under a temporary
    name and renamed)."""
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        got = [fn for fn in os.listdir(path) if fn.endswith(suffix)]
        if got:
            return got[0]
        time.sleep(0.1)
    raise AssertionError(f"[cli] no *{suffix} in {path} within {timeout_s} s")


def sigterm_launcher(p):
    """SIGTERM to start_cli's launcher: the script's python child, as a
    user's kill or a scheduler's would reach it."""
    with open(f"/proc/{p.pid}/task/{p.pid}/children") as f:
        kids = [int(x) for x in f.read().split()]
    os.kill(kids[0] if kids else p.pid, signal.SIGTERM)


def finish_clis(runs, timeout_s=CLI_TIMEOUT_S):
    """finish_cli for each (process, argv) of runs started side by side;
    when one fails, the sessions of the others are killed before its error
    goes on."""
    try:
        return [finish_cli(p, argv, timeout_s) for p, argv in runs]
    finally:
        for p, _ in runs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()


def run_cli(argv, timeout_s=CLI_TIMEOUT_S, cmd=None, env=None, rc=0):
    """start_cli, then finish_cli."""
    return finish_cli(start_cli(argv, cmd, env), argv, timeout_s, rc)


def cli_losses(out):
    """(first epoch, losses) from the CLI's `LOSSES from_epoch=E ...`."""
    line = [ln for ln in out.splitlines() if ln.startswith("LOSSES ")][-1]
    _, start, values = line.split(" ")
    return int(start.split("=")[1]), [float(x) for x in values.split(",")]


def cli_phase(work):
    """[cli]: scripts/reddit_torch.sh with CLI_FLAGS trains CLI_EPOCHS[0]
    epochs (epoch lines, inductive accuracy lines, Test Result, periodic
    and final checkpoints, the results file) and resumes to CLI_EPOCHS[1]
    from the newest checkpoint (a copy of the periodic ones, taken while
    the first run ends), preempted by a SIGTERM and resumed again
    ([resil]); an uninterrupted CLI_EPOCHS[1]-epoch run beside the
    resumes gives the last resume's losses to CLI_RTOL (relative). Returns
    the details."""
    t0 = time.perf_counter()
    d = {k: os.path.join(work, "cli", k)
         for k in ("parts", "results", "results_whole", "ckpt", "ckpt_whole",
                   "ckpt_resume")}
    paths = ["--part-path", d["parts"], "--results-path", d["results"]]
    first, last = CLI_EPOCHS
    inject = ["--inject", RESIL_INJECT]
    argv1 = CLI_FLAGS + paths + ["--n-epochs", str(first), "--ckpt-path",
                                 d["ckpt"], "--dump-embeddings",
                                 os.path.join(work, "cli", CLI_TABLE)] + inject
    argv3 = CLI_FLAGS + ["--part-path", d["parts"], "--results-path",
                         d["results_whole"], "--n-epochs", str(last),
                         "--ckpt-path", d["ckpt_whole"], "--skip-partition",
                         "--no-eval"] + inject
    procs = []
    try:
        return cli_runs(d, paths, argv1, argv3, procs, t0)
    finally:
        # a failed check leaves no run behind
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()


def cli_runs(d, paths, argv1, argv3, procs, t0):
    """cli_phase's runs and checks; every process it starts goes to
    `procs`."""
    first, last = CLI_EPOCHS
    no_backoff = {"BNSGCN_RETRY_BACKOFF_S": "0"}

    def spawn(argv, env):
        procs.append(start_cli(argv, env=env))
        return procs[-1]

    p1 = spawn(argv1, no_backoff)
    # the resume starts from a copy of the run's periodic checkpoints once
    # its last one is on disk, while the run evaluates and ends
    head = read_until(p1, f"Process 000 | Epoch {first - 1:05d}")
    wait_for_file(d["ckpt"], f"_{first - 1}.ckpt")
    os.makedirs(d["ckpt_resume"])
    for fn in os.listdir(d["ckpt"]):
        if fn.endswith(".ckpt") and not fn.endswith("_final.ckpt"):
            shutil.copy(os.path.join(d["ckpt"], fn), d["ckpt_resume"])
    t2 = t3 = time.perf_counter()
    resume = CLI_FLAGS + paths + ["--n-epochs", str(last), "--ckpt-path",
                                  d["ckpt_resume"], "--resume",
                                  "--skip-partition"]
    argv2 = resume + ["--log-every", str(RESIL_LOG_EVERY)]
    p3 = spawn(argv3, no_backoff)
    p2 = spawn(argv2, {"BNSGCN_EPOCH_THROTTLE_S": RESIL_THROTTLE_S})
    out1 = head + finish_cli(p1, argv1)
    secs = {"run": time.perf_counter() - t0}
    rollback = resil_rollback(out1, "8-epoch")
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
    # the resume and the uninterrupted run run side by side (8 ranks on
    # the card): each reads the artifacts only and writes its own files.
    # The resume ([resil]) evaluates and checkpoints every RESIL_LOG_EVERY
    # epochs, and its launcher gets a SIGTERM after its
    # epoch-RESIL_SIGTERM_AFTER line: it must exit 75 with a resumable
    # checkpoint; the second resume then runs beside the uninterrupted run
    # (neither evaluates: only their losses are compared)
    head = read_until(p2, f"Process 000 | Epoch {RESIL_SIGTERM_AFTER:05d}")
    sigterm_launcher(p2)
    out2 = head + finish_cli(p2, argv2, rc=75)
    secs["resume"] = time.perf_counter() - t2
    t4 = time.perf_counter()
    out4 = finish_cli(spawn(resume + ["--no-eval"], None), resume)
    secs["second resume"] = time.perf_counter() - t4
    out3 = finish_cli(p3, argv3)
    secs["uninterrupted"] = time.perf_counter() - t3
    pre = re.search(r"preempted at epoch (\d+); resumable checkpoint at "
                    r"(\S+)", out2)
    if not (pre and "Resumed from " in out2 and f"at epoch {first}" in out2
            and "SIGTERM received by the launcher" in out2
            and RESIL_SIGTERM_AFTER < int(pre.group(1)) < last - 1):
        raise AssertionError(f"[resil] the resume to {last} was not "
                             f"preempted after epoch {RESIL_SIGTERM_AFTER} "
                             f"and before {last - 1}:\n{out2[-3000:]}")
    stop = int(pre.group(1))
    rollback_whole = resil_rollback(out3, f"{last}-epoch")
    # the second resume ran from the preemption's checkpoint (its retry
    # nonce 1, carried from the 8-epoch run's files) to the end
    start, resumed = cli_losses(out4)
    start3, whole = cli_losses(out3)
    if not (start == stop + 1 and f"at epoch {stop + 1}" in out4
            and start3 == 0 and len(whole) == last
            and len(resumed) == last - stop - 1):
        raise AssertionError(f"[cli] the second resume started at epoch "
                             f"{start} with {len(resumed)} losses, the whole "
                             f"run at {start3} with {len(whole)}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, whole[start:]))
    if not rel <= CLI_RTOL:
        raise AssertionError(f"[cli] resumed losses {resumed} differ from the "
                             f"uninterrupted run's {whole[start:]} by "
                             f"{rel:.3e} (relative)")
    total = time.perf_counter() - t0
    log(f"[cli] bash {CLI_SCRIPT} {' '.join(CLI_FLAGS)}: {first} epochs with "
        f"{len(evals)} inductive evals ({evals[-1]}), {len(periodic)} "
        f"periodic checkpoints + the final, the results file; --resume "
        f"--n-epochs {last} started at epoch {first}, preempted, a second "
        f"--resume at epoch {start}: its losses equal the uninterrupted "
        f"run's to {rel:.3e} (relative, <= {CLI_RTOL}) ({total:.1f} s for "
        f"the four runs: "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()) + ")")
    log(f"[resil] --inject {RESIL_INJECT}: the {first}- and the {last}-epoch "
        f"run rolled back to {rollback['source']} (restart "
        f"{rollback['restart']}, retry-nonce {rollback['nonce']}; the same "
        f"in both: {rollback == rollback_whole}); SIGTERM to the resume's "
        f"launcher after its epoch-{RESIL_SIGTERM_AFTER} line: exit 75 at "
        f"epoch {stop}, {os.path.basename(pre.group(2))}; the second "
        f"--resume from it equals the uninterrupted run to {rel:.3e}")
    return {"losses_resumed": resumed, "losses_whole": whole, "max_rel": rel,
            "evals": evals, "checkpoints": ckpts, "seconds": total,
            "run_seconds": secs,
            "resil": {"rollback": rollback, "preempted_at": stop,
                      "second_resume_from": start}}


def resil_rollback(out, what):
    """[resil]: the rollback line of a run carrying RESIL_INJECT: to
    _3.ckpt, restarting at 4 with retry-nonce 1 (the JAX package's
    record)."""
    m = re.search(r"\[resilience\] non-finite training state at epoch (\d+) "
                  r"\(loss=\S+\): rolled back to (\S+), restarting at epoch "
                  r"(\d+) with retry-nonce (\d+)", out)
    got = (m and {"epoch": int(m.group(1)), "source": m.group(2),
                  "restart": int(m.group(3)), "nonce": int(m.group(4))})
    if not (got and got["epoch"] == 5 and got["source"].endswith("_3.ckpt")
            and got["restart"] == 4 and got["nonce"] == 1):
        raise AssertionError(f"[resil] the {what} run with --inject "
                             f"{RESIL_INJECT} logged no rollback to _3.ckpt "
                             f"at epoch 5:\n{out[-3000:]}")
    return got


def resil_hang_phase(work, after=None):
    """[resil] beside [anchor]: the script at CLI_FLAGS' scale, 2 epochs,
    --inject RESIL_HANG with the watchdog shrunk (RESIL_HANG_ENV) must exit
    77 with the watchdog's dump and name the rank that stalled the step
    (every rank hangs: the one whose beat is oldest). It starts once `after` (a future) is done, on [cli]'s
    artifacts, without an eval. Returns the details."""
    if after is not None:
        after.result()
    t0 = time.perf_counter()
    d = os.path.join(work, "resil_hang")
    argv = CLI_FLAGS + ["--part-path", os.path.join(work, "cli", "parts"),
                        "--skip-partition", "--no-eval",
                        "--results-path", os.path.join(d, "results"),
                        "--ckpt-path", os.path.join(d, "ckpt"),
                        "--n-epochs", "2", "--inject", RESIL_HANG]
    out = run_cli(argv, env=RESIL_HANG_ENV, rc=77)
    stalled = re.search(r"rank (\d+) stalled the step", out)
    want = ("[watchdog] step hung", "live arrays", "Thread 0x")
    missing = [w for w in want if w not in out]
    if missing or not stalled:
        raise AssertionError(f"[resil] --inject {RESIL_HANG} exited 77 "
                             f"without {missing or 'naming a rank'}:\n"
                             f"{out[-3000:]}")
    line = next(ln for ln in out.splitlines() if "stalled the step" in ln)
    secs = time.perf_counter() - t0
    log(f"[resil] --inject {RESIL_HANG} "
        f"({', '.join(f'{k}={v}' for k, v in RESIL_HANG_ENV.items())}): "
        f"exit 77 with the stacks and the live arrays; {line.strip()} "
        f"({secs:.1f} s)")
    return {"line": line.strip(), "seconds": secs}


def coord_phase(work, after=None):
    """[coord] beside [cli]: two coordinated pairs side by side, each two
    launches of the flagship's command line (GRAPH at CLI_FLAGS' scale, a
    P=COORD_PARTS partition of it, --spmm hybrid, --no-eval, a checkpoint
    every 2 epochs) meeting at a coordinator (--coord tcp --coord-world 2).
    Pair A, --inject COORD_NAN: both launches log the agreed rollback to
    _3.ckpt (restart 4, retry-nonce 1), and their losses are bitwise equal
    and finite; its launch 0 runs through run.run_training here, its
    ranks' launches counted. Pair B, --elastic on --inject COORD_LOST: the
    lost launch exits 0 without a RESULT line, the survivor logs the
    resize (world 2 -> 1, resize-nonce 1), ends with RESULT and exit 0,
    and its --obs-log holds one `resize` event. It starts once `after` (a
    future) is done. Returns the details."""
    from bnsgcn_tpu_torch.config import config_from_args, create_parser
    from bnsgcn_tpu_torch.run import run_training
    if after is not None:
        after.result()
    t0 = time.perf_counter()
    d = os.path.join(work, "coord")
    os.environ["BNSGCN_RETRY_BACKOFF_S"] = "0"
    os.environ["BNSGCN_ELASTIC_DEAD_S"] = str(COORD_DEAD_S)
    flags = [f for f in CLI_FLAGS]
    flags[flags.index("--n-partitions") + 1] = str(COORD_PARTS)
    parts = ["--part-path", os.path.join(d, "parts")]
    run_cli(script_flags(CLI_SCRIPT) + flags + parts,
            cmd=[sys.executable, "-m", "bnsgcn_tpu_torch.partition_cli"])
    flags += parts + ["--skip-partition", "--no-eval", "--log-every", "2",
                      "--spmm", "hybrid"]
    t_parts = time.perf_counter() - t0

    def pair_argv(name, rank, port, extra):
        return flags + ["--coord", "tcp", "--coord-port", str(port),
                        "--coord-world", "2", "--coord-rank", str(rank),
                        "--ckpt-path", os.path.join(d, name, "ck"),
                        "--results-path", os.path.join(d, name, "res")
                        ] + extra

    def pair_a():
        t = time.perf_counter()
        port = free_port_pair()
        extra = ["--n-epochs", str(COORD_EPOCHS[0]), "--inject", COORD_NAN]
        argv1 = pair_argv("a", 1, port, extra)
        p1 = start_cli(argv1)
        try:
            cfg = config_from_args(create_parser().parse_args(
                script_flags(CLI_SCRIPT) + pair_argv("a", 0, port, extra)))
            cfg = cfg.replace(graph_name=cfg.derive_graph_name())
            lines = []
            res = run_training(cfg, log=lines.append)
        except BaseException:
            os.killpg(p1.pid, signal.SIGKILL)
            p1.communicate()
            raise
        out1 = finish_cli(p1, argv1)
        out0 = "\n".join(lines)
        rec1 = re.search(r"agreed rollback \(decided by rank 0\): epoch "
                         r"(\d+) -> restart (\d+) from (\S+), retry-nonce "
                         r"(\d+)", out1)
        rec1 = rec1 and {"epoch": int(rec1.group(1)),
                         "restart": int(rec1.group(2)),
                         "source": rec1.group(3), "nonce": int(rec1.group(4))}
        losses0 = ["%.9e" % x for x in res.losses]
        losses1 = [ln for ln in out1.splitlines()
                   if ln.startswith("LOSSES ")][-1].split(" ")[2].split(",")
        if not (len(res.rollbacks) == 1 and res.rollbacks[0] == rec1
                and rec1["epoch"] == 5 and rec1["restart"] == 4
                and rec1["nonce"] == 1 and rec1["source"].endswith("_3.ckpt")
                and "agreed rollback to" in out0
                and "restarting all ranks at epoch 4 with retry-nonce 1"
                in out0):
            raise AssertionError(f"[coord] pair A's records: launch 0 "
                                 f"{res.rollbacks}, launch 1 {rec1}:\n"
                                 f"{out0[-2000:]}\n{out1[-2000:]}")
        if losses0 != losses1 or not all(math.isfinite(x)
                                         for x in res.losses):
            raise AssertionError(f"[coord] pair A's losses differ or are not "
                                 f"finite: {losses0} against {losses1}")
        co = res.coord_times[1:] or res.coord_times
        rl = res.relay_times[1:] or res.relay_times
        for rep in res.ranks:
            if not (sum(rep["launches"]["K1"].values())
                    and sum(rep["launches"]["K2"].values())
                    and sum(rep["d1"]["phases"].values())):
                raise AssertionError(f"[coord] pair A's rank {rep['rank']} "
                                     f"launched K1 {rep['launches']['K1']}, "
                                     f"K2 {rep['launches']['K2']}, D1 "
                                     f"{rep['d1']['phases']}")
        return {"record": rec1, "losses": res.losses,
                "coord_ms": 1e3 * sum(co) / max(len(co), 1),
                "relay_ms": 1e3 * sum(rl) / max(len(rl), 1),
                "epoch_s": mean_from_1(res.epoch_times),
                "ranks": [{"kinds": rep["kinds"], "d1": rep["d1"]}
                          for rep in res.ranks],
                "seconds": time.perf_counter() - t}

    def pair_b():
        t = time.perf_counter()
        port = free_port_pair()
        log_path = os.path.join(d, "b", "obs.jsonl")
        extra = ["--n-epochs", str(COORD_EPOCHS[1]), "--elastic", "on",
                 "--inject", COORD_LOST, "--obs-log", log_path]
        runs = [(start_cli(argv), argv) for argv in
                (pair_argv("b", r, port, extra) for r in (0, 1))]
        out0, out1 = finish_clis(runs)
        want0 = ("agreed resize, world 2 -> 1", "world resized to 1",
                 "resize-nonce 1", "RESULT final_loss=")
        missing = [w for w in want0 if w not in out0]
        if missing or "injected rank loss" not in out1 or "RESULT" in out1:
            raise AssertionError(f"[coord] pair B: launch 0 without "
                                 f"{missing}, or launch 1 not lost:\n"
                                 f"{out0[-2000:]}\n{out1[-2000:]}")
        with open(log_path) as f:
            ev = [e for e in map(json.loads, f) if e["kind"] == "resize"]
        keys = {"slots", "members", "lost", "trigger", "nonce"}
        if not (len(ev) == 1 and keys <= ev[0].keys()
                and ev[0]["lost"] == [1] and ev[0]["nonce"] == 1):
            raise AssertionError(f"[coord] pair B's resize events: {ev}")
        line = next(ln for ln in out0.splitlines() if "[elastic] epoch" in ln)
        return {"event": ev[0], "line": line.strip(),
                "seconds": time.perf_counter() - t}

    with ThreadPoolExecutor(2) as pool:
        fa, fb = pool.submit(pair_a), pool.submit(pair_b)
        a, b = fa.result(), fb.result()
    secs = time.perf_counter() - t0
    log(f"[coord] pair A (--coord tcp, 2 launches of {COORD_PARTS} ranks, "
        f"--inject {COORD_NAN}): both rolled back to "
        f"{a['record']['source']} (restart 4, retry-nonce 1), losses bitwise "
        f"equal; the coordinator's exchange {a['coord_ms']:.2f} ms a step on "
        f"launch 0's rank 0 (host clock; of it the relay to its launch "
        f"{a['relay_ms']:.2f} ms), epoch "
        f"{a['epoch_s'] * 1e3:.1f} ms (mean of epochs 1..) ({a['seconds']:.1f}"
        f" s); pair B (--elastic on --inject {COORD_LOST}): {b['line']}; "
        f"resize event slots {b['event']['slots']} members "
        f"{b['event']['members']} lost {b['event']['lost']} "
        f"({b['seconds']:.1f} s); partition {t_parts:.1f} s, {secs:.1f} s "
        f"in all")
    return {"a": a, "b": b, "partition_s": t_parts, "seconds": secs}


def cli_mesh_phase(work):
    """[cli] with --eval-device mesh: partition_cli with the script's flags
    and CLI_FLAGS writes the train subgraph's artifacts and the eval
    graphs' ('-val', '-test'); then the script trains CLI_MESH_EPOCHS epochs
    from them (--skip-partition), the ranks evaluating on the '-val'
    partition every 4 epochs and on '-test' at the end. It must exit 0,
    print the accuracy lines, the Test Result and the final checkpoint,
    and build no artifacts. Returns the details."""
    t0 = time.perf_counter()
    d = {k: os.path.join(work, "cli_mesh", k)
         for k in ("parts", "results", "ckpt")}
    flags = (CLI_FLAGS + ["--eval-device", "mesh", "--part-path", d["parts"],
                          "--results-path", d["results"], "--ckpt-path",
                          d["ckpt"], "--n-epochs", str(CLI_MESH_EPOCHS)])
    out0 = run_cli(script_flags(CLI_SCRIPT) + flags,
                   cmd=[sys.executable, "-m", "bnsgcn_tpu_torch.partition_cli"])
    dirs = sorted(os.listdir(d["parts"]))
    if not (len(dirs) == 3 and {x[len(dirs[0]):] for x in dirs}
            == {"", "-test", "-val"}):
        raise AssertionError(f"[cli] partition_cli --eval-device mesh wrote "
                             f"{dirs}:\n{out0[-2000:]}")
    out = run_cli(flags + ["--skip-partition"])
    lines = out.splitlines()
    evals = [ln for ln in lines if ln.startswith("Epoch ")
             and " | Accuracy " in ln]
    want = ["Test Result | Accuracy ", "model saved", "[eval-val] Part 0",
            "[eval-test] Part 0"]
    missing = [w for w in want if not any(ln.startswith(w) for ln in lines)]
    if missing or len(evals) != CLI_MESH_EPOCHS // 4:
        raise AssertionError(f"[cli] --eval-device mesh printed no "
                             f"{missing or 'accuracy lines'}:\n{out[-3000:]}")
    if sorted(os.listdir(d["parts"])) != dirs:
        raise AssertionError("[cli] --skip-partition wrote artifacts")
    secs = time.perf_counter() - t0
    test = next(ln for ln in lines if ln.startswith("Test Result"))
    log(f"[cli] --eval-device mesh: partition_cli wrote {', '.join(dirs)}; "
        f"bash {CLI_SCRIPT} ... --skip-partition trained {CLI_MESH_EPOCHS} "
        f"epochs, the ranks evaluating on the '-val' partition ("
        + "; ".join(evals) + f") and on '-test': {test} ({secs:.1f} s for "
        f"both)")
    return {"dirs": dirs, "evals": evals, "test": test, "seconds": secs}


def write_yelp_saint(g, root):
    """g in the GraphSAINT layout load_yelp_saint reads:
    {root}/yelp/adj_full.npz (scipy.sparse.save_npz's CSR, written with
    numpy), feats.npy, class_map.json (node -> multi-hot list), role.json
    ('tr', 'va', 'te' node lists)."""
    import numpy as np
    d = os.path.join(root, "yelp")
    os.makedirs(d, exist_ok=True)
    n = g.n_nodes
    order = np.argsort(g.src, kind="stable")
    indptr = np.concatenate([[0], np.cumsum(np.bincount(g.src,
                                                        minlength=n))])
    np.savez(os.path.join(d, "adj_full.npz"), format=np.bytes_("csr"),
             shape=np.array([n, n]), data=np.ones(len(order), np.float32),
             indices=g.dst[order].astype(np.int32),
             indptr=indptr.astype(np.int64))
    np.save(os.path.join(d, "feats.npy"), g.feat)
    with open(os.path.join(d, "class_map.json"), "w") as f:
        json.dump({str(i): row for i, row in
                   enumerate(g.label.astype(np.int8).tolist())}, f)
    with open(os.path.join(d, "role.json"), "w") as f:
        json.dump({k: np.flatnonzero(m).tolist() for k, m in
                   (("tr", g.train_mask), ("va", g.val_mask),
                    ("te", g.test_mask))}, f)


def yelp_phase(work, hook=None, extra=()):
    """[yelp]: the multilabel path through the user's entry point
    (run.run_training on scripts/yelp_torch.sh's flags, plus --spmm hybrid
    --use-pallas so K2 runs) at P=4 over gloo, --dataset yelp --data-path
    on a multilabel power-law graph at Yelp's widths written in the
    GraphSAINT layout (load_yelp_saint, the train rows' feature scaling).
    Each rank first holds K1 and K2 to their plain versions at H=512 and
    F=300 on its own layout (rank_kernel_check); then the launches per
    aggregation, the BCE loss finite and falling, the micro-F1 lines
    ('Accuracy', as the JAX package prints them) and the Test Result.
    Returns the details."""
    from bnsgcn_tpu_torch.config import parse_config
    from bnsgcn_tpu_torch.data.graph import synthetic_graph
    from bnsgcn_tpu_torch.run import run_training
    t0 = time.perf_counter()
    g = synthetic_graph(n_nodes=YELP_NODES, avg_degree=YELP_DEGREE,
                        n_feat=YELP_FEAT, n_class=YELP_CLASSES, seed=0,
                        multilabel=True, power_law=True)
    data = os.path.join(work, "yelp_data")
    write_yelp_saint(g, data)
    prep_s = time.perf_counter() - t0
    c = parse_config(script_flags(YELP_SCRIPT) + [
        "--data-path", data, "--n-partitions", str(PARTS), "--dist-backend",
        "gloo", "--spmm", "hybrid", "--use-pallas", "--n-epochs",
        str(YELP_EPOCHS), "--log-every", str(YELP_LOG_EVERY), "--fix-seed",
        "--part-path", os.path.join(work, "yelp_parts"), "--ckpt-path",
        os.path.join(work, "yelp_ckpt"), "--results-path",
        os.path.join(work, "yelp_results"), *extra])
    tee = Tee()
    res = run_training(c, log=tee, rank_hook=hook or rank_kernel_check)
    secs = time.perf_counter() - t0
    if not all(math.isfinite(x) for x in res.losses):
        raise AssertionError(f"[yelp] non-finite loss {res.losses}")
    if not res.losses[-1] < res.losses[0]:
        raise AssertionError(f"[yelp] loss did not fall: {res.losses}")
    f1 = [ln for ln in tee.lines if ln.startswith("Epoch ")
          and " | Accuracy " in ln]
    if len(f1) != YELP_EPOCHS // YELP_LOG_EVERY:
        raise AssertionError(f"[yelp] micro-F1 lines {f1}")
    # the best parameters' line, when an eval scored above 0
    test = tee.having("Test Result | Accuracy ") or ["no Test Result"]
    for rep in res.ranks:
        if tuple(rep["hook"]["widths"]) != (c.n_hidden, YELP_FEAT):
            raise AssertionError(f"[yelp] rank {rep['rank']} checked "
                                 f"{rep['hook']['widths']}")
    passes = (c.n_layers - c.n_linear - 1) * c.n_epochs
    want = {"fwd": passes, "bwd": passes, "pre": 1}
    for rep in res.ranks:
        for name, cnt in rep["launches"].items():
            if cnt != want:
                raise AssertionError(f"[yelp] rank {rep['rank']}: {name} "
                                     f"launched {cnt}, not {want}")
    for rep in res.ranks:
        hk = rep["hook"]
        log(f"[yelp] rank {rep['rank']}'s own layout: K1 max abs err "
            f"{hk['K1'][0]:.3e}, K2 {hk['K2'][0]:.3e} over "
            f"{len(hk['detail'])} checks at H={tuple(hk['widths'])}; every "
            f"element within its bound; mean of epochs 1.. "
            f"{mean_from_1(rep['epoch_times']) * 1e3:.1f} ms (4 ranks "
            f"sharing one card over gloo, beside [cli], [anchor] and the "
            f"laws)")
    log(f"[yelp] {' '.join(script_flags(YELP_SCRIPT)[:2])} through "
        f"load_yelp_saint: {g.n_nodes} nodes, {g.n_edges} edges, "
        f"{YELP_FEAT} features, {YELP_CLASSES} labels (multi-hot, mean "
        f"{float(g.label.sum(1).mean()):.1f} per node); BCE losses "
        + " ".join(f"{v:.4f}" for v in res.losses)
        + f"; micro-F1 lines: " + "; ".join(f1) + f"; {test[0]}; launches "
        f"per rank K1 {res.ranks[0]['launches']['K1']} K2 "
        f"{res.ranks[0]['launches']['K2']} (graph written in "
        f"{prep_s:.1f} s; {secs:.1f} s in all)")
    return {"losses": res.losses, "f1_lines": f1, "test": test[0],
            "n_nodes": g.n_nodes, "n_edges": g.n_edges,
            "launches": [rep["kinds"] for rep in res.ranks],
            "rank_checks": [rep["hook"] for rep in res.ranks],
            "epoch_from_1_s": [mean_from_1(rep["epoch_times"])
                               for rep in res.ranks], "seconds": secs}


def write_papers100m(root, n_nodes, seed=0):
    """An OGB binary directory at papers100M's widths, the layout
    load_ogb_disk reads: {root}/ogbn_papers100M/raw/data.npz (edge_index,
    node_feat f32 [N, 128], num_nodes_list), raw/node-label.npz (float
    labels over 172 classes, NaN outside the splits) and
    split/time/{train,valid,test}.npz at papers100M's shares. Classes of
    Zipf-like sizes, each node's features around its class's center;
    N * 14.5 edges whose endpoints are drawn with a weight falling as
    rank^-0.5 over a random order of the nodes (power-law degrees; rank
    floor(N u^2) for a uniform u, the inverse of that weight's CDF), 70%
    of them re-aimed at a node of the source's class. Everything from
    `seed`. Returns the edge count."""
    import numpy as np
    rng = np.random.default_rng(seed)
    d = os.path.join(root, "ogbn_papers100M")
    sd = os.path.join(d, "split", "time")
    os.makedirs(os.path.join(d, "raw"), exist_ok=True)
    os.makedirs(sd, exist_ok=True)
    n, c = n_nodes, PAPERS_CLASSES
    e = int(n * PAPERS_DEGREE)
    size = 1.0 / np.arange(1, c + 1) ** 0.8
    lab = rng.choice(c, size=n, p=size / size.sum())
    feat = rng.standard_normal((n, PAPERS_FEAT), dtype=np.float32)
    feat += rng.standard_normal((c, PAPERS_FEAT), dtype=np.float32)[lab]
    order = rng.permutation(n)
    src, dst = (order[np.minimum((n * rng.random(e) ** 2).astype(np.int64),
                                 n - 1)] for _ in range(2))
    same = np.flatnonzero(rng.random(e) < 0.7)
    by_class = np.argsort(lab, kind="stable")
    start = np.concatenate([[0], np.cumsum(np.bincount(lab, minlength=c))])
    k = lab[src[same]]
    dst[same] = by_class[start[k] + (rng.random(len(same))
                                     * (start[k + 1] - start[k])).astype(
                                         np.int64)]
    np.savez(os.path.join(d, "raw", "data.npz"),
             edge_index=np.stack([src, dst]).astype(np.int64),
             node_feat=feat, num_nodes_list=np.array([n]))
    ids = rng.permutation(n)
    cuts = np.cumsum([round(n * x) for x in PAPERS_SPLIT])
    label = np.full(n, np.nan, dtype=np.float32)
    label[ids[:cuts[-1]]] = lab[ids[:cuts[-1]]]
    np.savez(os.path.join(d, "raw", "node-label.npz"),
             node_label=label[:, None])
    for name, part in zip(("train", "valid", "test"),
                          np.split(ids[:cuts[-1]], cuts[:-1])):
        np.savez(os.path.join(sd, f"{name}.npz"), ids=part)
    return e


def papers_hook(pr):
    """[papers]' rank hook: K1 on bf16 rows against its plain version on
    the rank's own ELL layout (the script's --spmm ell), both directions,
    at H=n_hidden and the feature width, as the bf16 main path calls it
    (no base, out bf16): within lowp_k1_bound, bitwise equal on a second
    call, and the plain version minus each row's last term rejected."""
    import torch
    from bnsgcn_tpu_torch.ops.bucket_sum import ell_apply, ell_apply_plain
    if pr.fns.spmm_kind != "ell":
        raise AssertionError(f"[papers] rank {pr.rank}: spmm "
                             f"{pr.fns.spmm_kind}, not ell")
    gen = torch.Generator(device=pr.device).manual_seed(777 + pr.rank)
    widths = (pr.cfg.n_hidden, pr.cfg.n_feat)
    err = 0.0
    for direction in ("fwd", "bwd"):
        rows = pr.fns.spmm.rows[direction]
        for hdim in widths:
            h = torch.randn((rows.n_src, hdim), generator=gen,
                            device=pr.device).to(torch.bfloat16)
            got = ell_apply(rows, h, phase="check")
            again = ell_apply(rows, h, phase="check")
            ref = ell_apply_plain(rows, h)
            if got.dtype != torch.bfloat16 or not torch.equal(got, again):
                raise AssertionError(f"[papers] K1 bf16 {direction} H={hdim}"
                                     f": {got.dtype}, or two calls differ")
            hf = h.float()
            bound = lowp_k1_bound(rows, h, None, ell_apply_plain(rows, hf),
                                  ref)
            e, _ = check(f"[papers] K1 bf16 {direction} H={hdim}",
                         got.float(), ref.float(), bound)
            try:
                check("control", ref.float() - last_terms(rows, hf),
                      ref.float(), bound)
            except AssertionError:
                pass
            else:
                raise AssertionError("[papers] K1 bf16: the bound admits "
                                     "dropping each row's last term")
            err = max(err, e)
            del got, again, ref, h, hf, bound
    torch.cuda.empty_cache()
    return {"K1": err, "widths": widths}


def papers_flags(extra):
    """scripts/ogbn-papers100m_torch.sh's training flags without its node
    flags (their values are the launch's: '$NODES', ...), then `extra`."""
    flags, out = script_flags(PAPERS_SCRIPT), []
    i = 0
    while i < len(flags):
        if i + 1 < len(flags) and flags[i + 1].startswith("$"):
            i += 2
            continue
        out.append(flags[i])
        i += 1
    return out + list(extra)


def free_port_pair():
    """A free local port p with p + 1 free too (the launchers' store and
    the ranks' rendezvous)."""
    import socket
    for _ in range(100):
        with socket.socket() as a:
            a.bind(("127.0.0.1", 0))
            p = a.getsockname()[1]
            with socket.socket() as b:
                try:
                    b.bind(("127.0.0.1", p + 1))
                except OSError:
                    continue
        return p
    raise AssertionError("no two adjacent free ports")


def ckpt_param_bytes(path):
    """{leaf path: bytes} of a checkpoint's parameters."""
    import numpy as np
    from bnsgcn_tpu_torch import checkpoint as ckpt
    out = {}

    def walk(prefix, x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(f"{prefix}/{k}", x[k])
        else:
            out[prefix] = np.asarray(getattr(x, "bits", x)).tobytes()
    walk("", ckpt.read_blob(path)["params"])
    return out


def papers_partition(work, n_nodes=PAPERS_NODES, extra=()):
    """[papers]' first step: its OGB directory (write_papers100m) and the
    script's partition step (PARTITION=1: partition_cli
    --streaming-artifacts always --feat-storage bfloat16) at --n-partitions
    4, in a wrapper that reads its peak RSS. Host work only: main() starts
    it beside [setup], in a thread of its own (the partition a child
    process). Returns its directories and numbers."""
    d = {k: os.path.join(work, "papers", k) for k in (
        "data", "parts", "cache", "ck1", "ck2", "res1", "res2")}
    t0 = time.perf_counter()
    n_edges = write_papers100m(d["data"], n_nodes)
    data_s = time.perf_counter() - t0
    wrap = ("import resource, subprocess, sys\n"
            "r = subprocess.run(sys.argv[1:])\n"
            "print('peak_rss_kib', resource.getrusage("
            "resource.RUSAGE_CHILDREN).ru_maxrss)\n"
            "sys.exit(r.returncode)\n")
    t0 = time.perf_counter()
    out = run_cli(["--data-path", d["data"], "--part-path", d["parts"],
                   *extra], cmd=[sys.executable, "-c", wrap, "bash",
                                 PAPERS_SCRIPT],
                  env={"PARTITION": "1", "P": str(PARTS)}, timeout_s=600)
    part_s = time.perf_counter() - t0
    rss_gib = int(out.split("peak_rss_kib")[-1].split()[0]) / 2 ** 20
    return {"dirs": d, "n_edges": n_edges, "data_s": data_s,
            "part_s": part_s, "rss_gib": rss_gib}


def papers_phase(work, n_nodes=PAPERS_NODES, extra=(), prep=None):
    """[papers]: scripts/ogbn-papers100m_torch.sh's two steps on an OGB
    directory at papers100M's widths (write_papers100m). The script's
    partition step (papers_partition; `prep` its future when it was
    started earlier, beside [setup]), its wall time and peak RSS; then its
    training flags with --n-partitions 4, PAPERS_EPOCHS
    epochs, --log-every PAPERS_LOG_EVERY, --fix-seed, --dist-backend gloo
    (one card) and one --cache-dir, twice: one launch of 4 ranks through
    run.run_training with a cold cache (each rank first holds K1 on bf16
    rows to its plain version on its own layout, papers_hook; then K1 must
    have launched once per aggregation of training and of each mesh eval,
    K2 never), and two concurrent launches of the script itself (--n-nodes
    2 --parts-per-node 2, node ranks 0 and 1: two coordinated launches)
    with the cache warm. The two
    runs' losses must agree to PAPERS_RTOL (relative) and their RESULT
    lines be equal, both nodes' too; every run ends with its ranks'
    parameters replicated bitwise (run_training checks). Returns the
    details."""
    from bnsgcn_tpu_torch.config import parse_config
    from bnsgcn_tpu_torch.data.artifacts import read_meta
    from bnsgcn_tpu_torch.parallel.halo import make_halo_spec, wire_bytes
    from bnsgcn_tpu_torch.run import artifacts_dir, run_training
    t_all = time.perf_counter()
    got = (prep.result() if prep is not None
           else papers_partition(work, n_nodes, extra))
    d, n_edges = got["dirs"], got["n_edges"]
    data_s, part_s, rss_gib = got["data_s"], got["part_s"], got["rss_gib"]
    common = ["--n-partitions", str(PARTS), "--n-epochs", str(PAPERS_EPOCHS),
              "--log-every", str(PAPERS_LOG_EVERY), "--fix-seed",
              "--dist-backend", "gloo", "--data-path", d["data"],
              "--part-path", d["parts"], "--cache-dir", d["cache"], *extra]
    c = parse_config(papers_flags(common + [
        "--n-nodes", "1", "--ckpt-path", d["ck1"], "--results-path",
        d["res1"]]))
    path = artifacts_dir(c)
    meta = read_meta(path)
    disk_mb = sum(os.path.getsize(os.path.join(path, f))
                  for f in os.listdir(path)) / 1e6
    if meta.feat_dtype != "bfloat16" or meta.n_feat != PAPERS_FEAT:
        raise AssertionError(f"[papers] the artifacts hold {meta.n_feat} "
                             f"{meta.feat_dtype} features")
    log(f"[papers] data: {n_nodes} nodes, {n_edges} edges, {PAPERS_FEAT} "
        f"f32 features, {PAPERS_CLASSES} classes (NaN outside the splits, "
        f"{PAPERS_SPLIT} of the nodes) written in {data_s:.1f} s; "
        f"PARTITION=1 bash {PAPERS_SCRIPT} --n-partitions {PARTS}: "
        f"{part_s:.1f} s wall, peak RSS {rss_gib:.2f} GiB; artifacts "
        f"{disk_mb:.0f} MB on disk (bf16 features), pad_inner "
        f"{meta.pad_inner}, pad_boundary {meta.pad_boundary}, edges/part "
        f"{meta.pad_edges}")

    # run 1: one launch of 4 ranks, the cache cold
    tee = Tee()
    t0 = time.perf_counter()
    res = run_training(c, log=tee, rank_hook=papers_hook)
    run1_s = time.perf_counter() - t0
    if not all(math.isfinite(x) for x in res.losses):
        raise AssertionError(f"[papers] non-finite loss {res.losses}")
    n_evals = PAPERS_EPOCHS // PAPERS_LOG_EVERY + 1
    passes = (c.n_layers - 1) * c.n_epochs
    want = {"fwd": passes, "bwd": passes, "pre": 1,
            "eval": c.n_layers * n_evals}
    for rep in res.ranks:
        if rep["launches"]["K1"] != want or rep["launches"]["K2"]:
            raise AssertionError(f"[papers] rank {rep['rank']}: launched "
                                 f"{rep['launches']}, not K1 {want}")
        if rep["layout_times"].get("ell", ("",))[0] != "built":
            raise AssertionError(f"[papers] rank {rep['rank']}: layouts "
                                 f"{rep['layout_times']} with a cold cache")
    evals = [ln for ln in tee.lines if ln.startswith("Epoch ")
             and "| Validation Accuracy " in ln]
    test = tee.having("Test Result | Accuracy")
    if len(evals) != n_evals - 1 or not test:
        raise AssertionError(f"[papers] eval lines {evals}, {test}")
    result1 = "RESULT final_loss=%.9e best_val=%.6f test=%.6f" % (
        res.losses[-1], res.best_val_acc, res.test_acc)

    # run 2: the script on two nodes of 2 ranks, the cache warm
    port = free_port_pair()
    argv = common + ["--ckpt-path", d["ck2"], "--results-path", d["res2"]]
    t0 = time.perf_counter()
    outs = finish_clis([(start_cli(argv, cmd=["bash", PAPERS_SCRIPT], env={
        "NODES": "2", "NODE_RANK": str(k), "MASTER": "127.0.0.1",
        "PORT": str(port), "PPN": "2", "P": str(PARTS)}), argv)
        for k in (0, 1)], timeout_s=600)
    run2_s = time.perf_counter() - t0
    losses2 = [cli_losses(o) for o in outs]
    results2 = [[ln for ln in o.splitlines() if ln.startswith("RESULT")][-1]
                for o in outs]
    if losses2[0] != losses2[1] or results2[0] != results2[1]:
        raise AssertionError(f"[papers] the nodes disagree: {losses2} "
                             f"{results2}")
    start2, l2 = losses2[0]
    rel = max(abs(a - b) / abs(b) for a, b in zip(l2, res.losses))
    if start2 != 0 or len(l2) != len(res.losses) or not rel <= PAPERS_RTOL:
        raise AssertionError(f"[papers] two nodes' losses {l2} against one "
                             f"launch's {res.losses}: {rel:.3e}")
    if results2[0] != result1:
        raise AssertionError(f"[papers] {results2[0]} != {result1}")
    bitwise = all("%.9e" % a == "%.9e" % b for a, b in zip(l2, res.losses))
    warm = [ln for ln in outs[0].splitlines() if "Part 0 of " in ln]
    if not warm or "ell loaded" not in warm[0] or "layout cache: wrote" in \
            outs[0]:
        raise AssertionError(f"[papers] the warm run did not load its "
                             f"layouts: {warm}")
    warm_s = float(warm[0].split("ell loaded ")[1].split("s")[0])
    last = f"{c.graph_name or c.derive_graph_name()}_p" \
           f"{c.sampling_rate:.2f}_{c.n_epochs - 1}.ckpt"
    p1, p2 = (ckpt_param_bytes(os.path.join(d[k], last))
              for k in ("ck1", "ck2"))
    same_params = p1 == p2

    spec, _ = make_halo_spec(meta.n_b, meta.pad_inner, meta.pad_boundary,
                             c.sampling_rate, wire=c.halo_wire)
    wire_mb = wire_bytes(spec, c.n_hidden) / 1e6
    ranks = []
    for rep in res.ranks:
        ep, ex = (mean_from_1(rep[k]) for k in ("epoch_times", "comm_times"))
        ranks.append({
            "rank": rep["rank"], "epoch_s": ep, "exchange_s": ex,
            "exchange_share": ex / max(ep, 1e-12),
            "reduce_s": mean_from_1(rep["reduce_times"]),
            "max_memory_gib": rep["max_memory_bytes"] / 2 ** 30,
            "layout_built_s": rep["layout_times"]["ell"][1],
            "launches": rep["launches"], "kinds": rep["kinds"],
            "n_edges": rep["n_edges"], "check": rep["hook"]})
    for x in ranks:
        log(f"[papers] rank {x['rank']} (4 ranks sharing one card over "
            f"gloo, not a 4-card number), {x['n_edges']} edges: mean of "
            f"epochs 1.. {x['epoch_s'] * 1e3:.1f} ms, exchange "
            f"{x['exchange_s'] * 1e3:.1f} ms ({x['exchange_share']:.1%} of "
            f"the epoch), all-reduce {x['reduce_s'] * 1e3:.1f} ms, peak "
            f"memory {x['max_memory_gib']:.2f} GiB; ELL layouts built "
            f"{x['layout_built_s']:.3f} s (cold cache); launches K1 "
            f"{x['launches']['K1']} {x['kinds']['K1']}; K1 bf16 max abs err "
            f"{x['check']['K1']:.3e} on its own layout at H="
            f"{tuple(x['check']['widths'])} (within its bound, the control "
            f"rejected)")
    log(f"[papers] {' '.join(papers_flags([])[:4])} ... GCN 3x128 bf16, "
        f"rate {c.sampling_rate}, fp8 wire {wire_mb:.3f} MB per exchange at "
        f"H={c.n_hidden}, --eval-device mesh: one launch of {PARTS} "
        f"({run1_s:.1f} s) and two launches of 2 (--n-nodes 2, "
        f"{run2_s:.1f} s): losses " + " ".join(f"{v:.6f}" for v in l2)
        + f", max relative difference {rel:.3e} <= {PAPERS_RTOL} ("
        f"{'bitwise equal' if bitwise else 'not bitwise'}); RESULT lines "
        f"equal ({result1}); the last checkpoints' parameters "
        f"{'bitwise equal' if same_params else 'differ'}; mesh evals: "
        + "; ".join(evals) + f"; {test[0]}; rank 0's ELL layouts built "
        f"{ranks[0]['layout_built_s']:.3f} s cold, loaded {warm_s:.3f} s "
        f"warm ({time.perf_counter() - t_all:.1f} s in all)")
    return {"n_nodes": n_nodes, "n_edges": n_edges, "data_s": data_s,
            "partition_s": part_s, "partition_rss_gib": rss_gib,
            "artifacts_mb": disk_mb, "losses": res.losses,
            "losses_two_nodes": l2, "max_rel": rel, "bitwise": bitwise,
            "same_params": same_params, "result": result1, "evals": evals,
            "test": test[0], "wire_mb": wire_mb, "warm_load_s": warm_s,
            "run1_s": run1_s, "run2_s": run2_s, "ranks": ranks,
            "launches": [rep["kinds"] for rep in res.ranks],
            "seconds": time.perf_counter() - t_all}


def small_agreement(base_cfg):
    """The same short hybrid run at dropout 0.5 on the card (kernels, D1
    among them) and on the CPU (plain versions): the losses must agree to
    1e-4 (f32 sums in another order, over 4 epochs of Adam; the dropout
    masks are jax's on both, bitwise)."""
    from bnsgcn_tpu_torch.run import run_training
    cfg = base_cfg.replace(dataset="sbm", n_layers=3, n_hidden=64,
                           dropout=0.5, block_tile=64, block_occupancy=8,
                           n_epochs=4, log_every=1000, eval=False)
    quiet = lambda m: None
    gpu = run_training(cfg.replace(device="cuda"), log=quiet).losses
    cpu = run_training(cfg.replace(device="cpu"), log=quiet).losses
    diff = max(abs(a - b) for a, b in zip(gpu, cpu))
    if not diff <= 1e-4:
        raise AssertionError(f"card and CPU losses differ by {diff:.3e}: "
                             f"{gpu} vs {cpu}")
    log(f"[agree] sbm 3x64 hybrid, dropout 0.5, 4 epochs: card "
        f"{gpu[-1]:.6f} vs CPU "
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
    from bnsgcn_tpu_torch.ops import bucket_sum, dropout, tile_matmul
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
    dropout.launches.reset()
    torch.cuda.reset_peak_memory_stats()
    res = run_training(c, log=log, prepared=pl)
    k1 = dict(bucket_sum.launches.by_kind)
    k2 = dict(tile_matmul.launches.by_kind)
    d1 = {"phases": dict(dropout.launches.by_phase),
          "kinds": dict(dropout.launches.by_kind)}
    if (k1, k2) != want:
        raise AssertionError(f"{name}: K1 launched {k1}, K2 {k2}; expected "
                             f"{want[0]} and {want[1]}")
    if not all(math.isfinite(x) for x in res.losses):
        raise AssertionError(f"{name}: non-finite loss {res.losses}")
    out = {"losses": res.losses, "epoch_times_s": res.epoch_times,
           "epoch_from_1_s": mean_from_1(res.epoch_times),
           "launches": {"K1": k1, "K2": k2}, "d1": d1, "setup_s": setup_s,
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


def compare_k1_ell(op, widths, gen, detail):
    """K1 against its plain version on an ELL operator's own row schedules
    (no base: the ELL SpMM's call), both directions, at each width, within
    k1_bound per element."""
    import torch
    from bnsgcn_tpu_torch.ops.bucket_sum import ell_apply, ell_apply_plain
    max_err = max_rel = 0.0
    for direction in ("fwd", "bwd"):
        rows = op.rows[direction]
        for hdim in widths:
            h = torch.randn((rows.n_src, hdim), generator=gen, device="cuda")
            got = ell_apply(rows, h, phase="check")
            e, rel = check(f"K1 {direction} H={hdim}", got,
                           ell_apply_plain(rows, h), k1_bound(rows, h))
            max_err, max_rel = max(max_err, e), max(max_rel, rel)
            detail.append({"kernel": "ell_bucket_sum", "dir": direction,
                           "rows": rows.n_rows,
                           "terms": int(rows.src.numel()), "H": hdim,
                           "max_abs_err": e, "max_rel_err": rel})
    return max_err, max_rel


def split_kernel_check(pr, gen, widths):
    """K1 and K2 against their plain versions on a --overlap split
    operator's interior and frontier layouts (their own tiles, residuals
    and row schedules), forward and backward, at `widths`, with the main
    path's bounds. Returns ({'K1': (err, rel), 'K2': ...}, detail)."""
    from types import SimpleNamespace
    detail, errs = [], {"K1": (0.0, 0.0), "K2": (0.0, 0.0)}
    for op in (pr.fns.spmm.interior, pr.fns.spmm.frontier):
        if hasattr(op, "residual"):
            ns = SimpleNamespace(spmm=op)
            k1 = compare_k1(ns, widths, gen, 0, detail)[0]
            k2 = compare_k2(ns, widths, gen, 0, detail)[0]
        else:
            k1, k2 = compare_k1_ell(op, widths, gen, detail), (0.0, 0.0)
        errs = {"K1": max(errs["K1"], k1), "K2": max(errs["K2"], k2)}
    return errs, detail


def once_ms(fn):
    """ms of one call of fn() between CUDA events, no warm-up (a plain
    version too slow to repeat at full size)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _bits(x):
    import torch
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def d1_check(x, g, key, control, tag):
    """D1 on x against its plain version: forward bitwise, the backward
    (the kernel on the incoming gradient g, through autograd) bitwise, and
    the control, the draw of another key, rejected. Raises on a
    mismatch."""
    import torch
    from bnsgcn_tpu_torch.ops import dropout as d1
    ref = d1.dropout_plain(x, *key, 0.5)
    if not torch.equal(_bits(d1.dropout_apply(x, *key, 0.5, "check")),
                       _bits(ref)):
        raise AssertionError(f"{tag}: D1's forward differs from its plain "
                             f"version")
    xr = x.clone().requires_grad_(True)
    d1.dropout(xr, key, 0.5).backward(g)
    if not torch.equal(_bits(xr.grad), _bits(d1.dropout_plain(g, *key,
                                                               0.5))):
        raise AssertionError(f"{tag}: D1's backward differs from its plain "
                             f"version")
    if torch.equal(_bits(d1.dropout_apply(x, *control, 0.5, "check")),
                   _bits(ref)):
        raise AssertionError(f"{tag}: the check did not reject the next "
                             f"epoch's key")


def compare_d1(n_rows, widths, reps, detail):
    """D1 at the P=1 main path's dropout shapes ([n_rows, w] for the use_pp
    input's and the hidden width), f32 and bf16, key (seed 0, epoch 3, rank
    0): d1_check with the control of epoch 4's key; then kernel, plain
    version (one call) and torch.nn.functional.dropout (Philox, not the
    same function: a yardstick) timed by events. Bound: the larger of the
    bytes (x read, out written) over HBM_BYTES_PER_S and threefry's
    D1_OPS_PER_ELEMENT int32 operations per element over INT32_OPS_PER_S.
    Returns {'f32'|'bf16': {width: times}}."""
    import torch
    import torch.nn.functional as F
    from bnsgcn_tpu_torch.ops import dropout as d1
    from bnsgcn_tpu_torch.trainer import dropout_key
    gen = torch.Generator(device="cuda").manual_seed(99)
    key = d1.key_words(dropout_key(0, 3, 0))
    control = d1.key_words(dropout_key(0, 4, 0))
    out = {}
    for dt, kind in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for w in widths:
            x = torch.randn((n_rows, w), generator=gen, device="cuda").to(dt)
            g = torch.randn((n_rows, w), generator=gen, device="cuda").to(dt)
            d1_check(x, g, key, control, f"[check] D1 {kind} [{n_rows}, {w}]")
            del g
            nbytes = 2 * x.numel() * x.element_size()
            by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            by_ops = D1_OPS_PER_ELEMENT * x.numel() / INT32_OPS_PER_S * 1e3
            t = {"shape": [n_rows, w], "dtype": kind,
                 "ms": cuda_ms(lambda: d1.dropout_apply(x, *key, 0.5,
                                                        "check"), reps),
                 "plain_ms": once_ms(lambda: d1.dropout_plain(x, *key, 0.5)),
                 "library_ms": cuda_ms(lambda: F.dropout(x, 0.5), reps),
                 "bound_ms": max(by_bytes, by_ops),
                 "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                 "bytes_ms": by_bytes, "ops_ms": by_ops}
            detail.append({"kernel": "D1", **t})
            out.setdefault(kind, {})[w] = t
            del x
            torch.cuda.empty_cache()
    return out


def d1_rank_check(cfg, art, me, dev):
    """[knobs]' D1 check on this rank's layer shapes ([pad_inner, 2F] for
    the use_pp input, [pad_inner, H]), f32 and bf16, epoch 0's key of this
    rank, the control epoch 1's; then the mask of (epoch 1, this rank) on
    the card against the CPU's plain draw, bitwise, on the first rows."""
    import torch
    from bnsgcn_tpu_torch.ops import dropout as d1
    from bnsgcn_tpu_torch.trainer import dropout_key
    gen = torch.Generator(device=dev).manual_seed(55 + me)
    key = d1.key_words(dropout_key(cfg.seed, 0, me))
    control = d1.key_words(dropout_key(cfg.seed, 1, me))
    shapes = [(art.pad_inner, 2 * art.n_feat), (art.pad_inner, cfg.n_hidden)]
    for dt in (torch.float32, torch.bfloat16):
        for shape in shapes:
            x = torch.randn(shape, generator=gen, device=dev).to(dt)
            g = torch.randn(shape, generator=gen, device=dev).to(dt)
            d1_check(x, g, key, control, f"[knobs] rank {me} D1 {dt} {shape}")
    rows = min(4096, art.pad_inner)
    ones = torch.ones((art.pad_inner, cfg.n_hidden), device=dev)
    k1 = d1.key_words(dropout_key(cfg.seed, 1, me))
    card = d1.dropout_apply(ones, *k1, 0.5, "check")[:rows].cpu()
    cpu = d1.dropout_plain(ones[:rows].cpu(), *k1, 0.5)
    if not torch.equal(card, cpu):
        raise AssertionError(f"[knobs] rank {me}: the card's mask of epoch "
                             f"1 differs from the CPU's")
    return {"shapes": [list(x) for x in shapes], "cpu_rows": rows}


class SideTimer:
    """CUDA events around one split side's training passes (its
    apply_dir, phases 'fwd' and 'bwd'; the precompute's 'pre' is left
    out), in call order, read after one synchronization."""

    def __init__(self, op):
        self.spans, inner = [], op.apply_dir

        def timed(direction, h, phase, *a, **k):
            if phase not in ("fwd", "bwd"):
                return inner(direction, h, phase, *a, **k)
            import torch
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = inner(direction, h, phase, *a, **k)
            ev[1].record()
            self.spans.append(tuple(ev))
            return out
        op.apply_dir = timed

    def ms(self):
        import torch
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.spans]


def halo_rank(ctx, cfg, path, reps):
    """[halo]'s rank body: this rank's part of the P=4 main path's
    artifacts, loaded once. (a) One exchange of random rows at H=n_hidden
    on epoch 0's plan under each strategy: forward bitwise padded's,
    backward within 1e-6 of it (of the largest value), timed over `reps`
    calls. (b) Each of HALO_VARIANTS for HALO_EPOCHS epochs through
    run.train_loop from the same initial parameters, layouts lent between
    variants of one SpMM; the split variants first hold K1 and K2 on their
    interior and frontier layouts to the plain versions, then time each
    side's passes by CUDA events. Launch counts are reset just before each
    loop and read just after. (c) [knobs]: d1_rank_check, then each of
    KNOB_VARIANTS the same way (a reorder variant first applies
    data/reorder.maybe_reorder to the part, the ranks agreeing on auto's
    verdict), with each run's final parameters and SyncBatchNorm
    statistics kept for the phase's comparisons."""
    import hashlib

    import torch
    from bnsgcn_tpu_torch.data.artifacts import load_artifacts
    from bnsgcn_tpu_torch.data.reorder import maybe_reorder
    from bnsgcn_tpu_torch.ops import bucket_sum, dropout, tile_matmul
    from bnsgcn_tpu_torch.parallel import halo
    from bnsgcn_tpu_torch.run import prepare_part, train_loop
    from bnsgcn_tpu_torch.utils import prng
    dev, me, comm = ctx.device, ctx.rank, ctx.comm
    lines = []

    def log(m):
        if me == 0:
            lines.append(str(m))
            ctx.log(m)

    t0 = time.perf_counter()
    art = load_artifacts(path, parts=[me])
    out = {"rank": me, "load_s": time.perf_counter() - t0, "exchange": {},
           "variants": {}}
    H = cfg.n_hidden
    bnd = torch.from_numpy(art.bnd[0]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(4321 + me)
    h = torch.randn((art.pad_inner, H), generator=gen, device=dev)
    cot = torch.randn((art.n_ext, H), generator=gen, device=dev)
    ref = None
    for strategy in ("padded", "shift", "ragged"):
        spec, tables = halo.make_halo_spec(art.n_b, art.pad_inner,
                                           art.pad_boundary,
                                           cfg.sampling_rate, strategy)
        plan = halo.make_halo_plan(spec, halo.tables_to(tables, dev), bnd,
                                   me, 0, prng.key(cfg.seed, dev))
        x = h.clone().requires_grad_(True)
        y = halo.halo_apply(spec, plan, x, comm)
        (y * cot).sum().backward()
        got = (y.detach(), x.grad)
        if ref is None:
            ref, err = got, 0.0
        else:
            if not torch.equal(got[0], ref[0]):
                raise AssertionError(f"[halo] rank {me}: the {strategy} "
                                     f"exchange's output differs from "
                                     f"padded's")
            err = float((got[1] - ref[1]).abs().max()
                        / ref[1].abs().max().clamp(min=1e-30))
            if not err <= 1e-6:
                raise AssertionError(f"[halo] rank {me}: the {strategy} "
                                     f"exchange's backward is {err:.3e} "
                                     f"(relative) from padded's")
        out["exchange"][strategy] = {
            "bwd_rel_err": err, "wire_mb": halo.wire_bytes(spec, H) / 1e6,
            "ms": cuda_ms(lambda: halo.halo_apply(spec, plan, h, comm),
                          reps)}
    lent, widths = {}, (H, art.n_feat)
    finals = {}

    def flat_params(model):
        return torch.cat([p.detach().reshape(-1).float()
                          for p in model.parameters()])

    for name, flags in HALO_VARIANTS:
        c = cfg.replace(**flags)
        t0 = time.perf_counter()
        pr = prepare_part(c, art, None, dev, log, me, comm,
                          reuse=lent.get((c.spmm, c.overlap, "off")))
        lent.setdefault((c.spmm, c.overlap, "off"), pr.fns)
        rec = {"setup_s": time.perf_counter() - t0,
               "overlap": pr.fns.overlap, "strategy": pr.fns.halo_strategy,
               "wire_mb": (0.0 if pr.fns.halo is None else
                           halo.wire_bytes(pr.fns.halo, H) / 1e6),
               "steady_mb": (0.0 if c.halo_mode == "grad-only" else
                             halo.wire_bytes(pr.fns.halo_refresh_spec or
                                             pr.fns.halo, H) / 1e6)}
        timers = None
        if pr.fns.overlap == "split":
            rec["check"], rec["detail"] = split_kernel_check(pr, gen, widths)
            # the part's real rows on the interior side (merge_perm below
            # the interior row space's size)
            op = pr.fns.spmm.interior
            n_int = op.fwd.n_rows if hasattr(op, "fwd") else op.rows[
                "fwd"].n_rows
            n_real = int(art.n_inner[me])
            rec["rows"] = (int((pr.fns.spmm.merge_perm[:n_real] < n_int)
                               .sum()), n_real)
            timers = {"interior": SideTimer(pr.fns.spmm.interior),
                      "frontier": SideTimer(pr.fns.spmm.frontier)}
        n = len(lines)
        bucket_sum.launches.reset()
        tile_matmul.launches.reset()
        dropout.launches.reset()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        res, model = train_loop(pr, None, log)
        rec.update(
            losses=res.losses, epoch_times=res.epoch_times,
            comm_times=res.comm_times, reduce_times=res.reduce_times,
            run_memory_gib=(torch.cuda.max_memory_allocated(dev) - held)
            / 2 ** 30,
            launches={"K1": dict(bucket_sum.launches.by_phase),
                      "K2": dict(tile_matmul.launches.by_phase)},
            kinds={"K1": dict(bucket_sum.launches.by_kind),
                   "K2": dict(tile_matmul.launches.by_kind)},
            d1={"phases": dict(dropout.launches.by_phase),
                "kinds": dict(dropout.launches.by_kind)},
            max_memory_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            lines=lines[n:])
        if timers is not None:
            rec["side_ms"] = {k: t.ms() for k, t in timers.items()}
        if name == "padded":
            finals[name] = flat_params(model)
        out["variants"][name] = rec
        del pr, res, model
        torch.cuda.empty_cache()

    # [knobs]
    t0 = time.perf_counter()
    out["d1"] = d1_rank_check(cfg, art, me, dev)
    out["d1"]["seconds"] = time.perf_counter() - t0
    out["knobs"] = {}
    for name, flags in KNOB_VARIANTS:
        c = cfg.replace(**flags)
        t0 = time.perf_counter()
        art_v, info = art, {}
        if c.reorder != "off":
            art_v, resolved, info = maybe_reorder(c, art, log, comm, me)
            c = c.replace(reorder=resolved)
        key = (c.spmm, c.overlap, c.reorder)
        pr = prepare_part(c, art_v, None, dev, log, me, comm,
                          reuse=lent.get(key))
        lent.setdefault(key, pr.fns)
        rec = {"setup_s": time.perf_counter() - t0, "reorder": info,
               "resolved": c.reorder,
               "layout_times": dict(pr.fns.layout_times)}
        bucket_sum.launches.reset()
        tile_matmul.launches.reset()
        dropout.launches.reset()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        res, model = train_loop(pr, None, log)
        flat = flat_params(model)
        rec.update(
            losses=res.losses, epoch_times=res.epoch_times,
            comm_times=res.comm_times,
            run_memory_gib=(torch.cuda.max_memory_allocated(dev) - held)
            / 2 ** 30,
            launches={"K1": dict(bucket_sum.launches.by_phase),
                      "K2": dict(tile_matmul.launches.by_phase)},
            d1={"phases": dict(dropout.launches.by_phase),
                "kinds": dict(dropout.launches.by_kind)},
            max_memory_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        if c.norm == "batch":
            stats = torch.cat([torch.cat([m.mean, m.var]) for k, m in
                               model.named_children()
                               if k.startswith("norm_")]).cpu()
            rec["bn_digest"] = hashlib.sha256(
                stats.numpy().tobytes()).hexdigest()
        twin = REMAT_TWINS.get(name)
        if twin is not None:
            ref = finals[twin]
            rec["params_vs_twin"] = {
                "bitwise": bool(torch.equal(flat, ref)),
                "max_rel": float((flat - ref).abs().max()
                                 / ref.abs().max().clamp(min=1e-30))}
        finals[name] = flat
        out["knobs"][name] = rec
        del pr, res, model
        torch.cuda.empty_cache()
    out["recipe"] = recipe_rank(ctx, cfg, art, lent, log)
    out["tune"] = tune_rank(ctx, cfg, art, lent, log, lines)
    lent.clear()
    return out


def recipe_rank(ctx, cfg, art, lent, log):
    """[recipe] at P=4, in [halo]'s group (its own group before [serve]):
    RECIPE_TPU appended to the flagship's command line on this rank's part,
    RECIPE_P4_EPOCHS epochs through run.train_loop, the hybrid layout lent
    by the padded variant (auto must pick the hybrid). The rank first holds
    K1 and K2 on bf16 to their plain versions on its layout
    (rank_kernel_check_bf16); its launch counts are reset just before the
    loop and read just after; the ranks must end with rank 0's parameters,
    bitwise."""
    import torch
    from bnsgcn_tpu_torch.ops import bucket_sum, tile_matmul
    from bnsgcn_tpu_torch.parallel.reducer import assert_replicated
    from bnsgcn_tpu_torch.run import prepare_part, train_loop
    dev, me, comm = ctx.device, ctx.rank, ctx.comm
    c = cfg.replace(**recipe_fields(), n_epochs=RECIPE_P4_EPOCHS)
    t0 = time.perf_counter()
    pr = prepare_part(c, art, None, dev, log, me, comm,
                      reuse=lent.get(("hybrid", "off", "off")))
    setup = time.perf_counter() - t0
    check = rank_kernel_check_bf16(pr)
    bucket_sum.launches.reset()
    tile_matmul.launches.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    res, model = train_loop(pr, None, log)
    rec = {"losses": res.losses, "epoch_times": res.epoch_times,
           "comm_times": res.comm_times, "reduce_times": res.reduce_times,
           "kinds": {"K1": dict(bucket_sum.launches.by_kind),
                     "K2": dict(tile_matmul.launches.by_kind)},
           "max_memory_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "check": check, "setup_s": setup}
    assert_replicated(model.parameters(), comm)
    del pr, res, model
    torch.cuda.empty_cache()
    return rec


def tune_rank(ctx, cfg, art, lent, log, lines):
    """[tune]'s rank body, after [knobs] in [halo]'s group: the flagship's
    command line on this rank's part with --tune schedule TUNE_SCHEDULE
    (K=4 folded in at launch, as run.tune_launch folds it), --strict-exec
    and the default comm-trace window, TUNE_EPOCHS epochs through
    run.train_loop, the layouts lent. The launch counts of K1, K2 and D1
    are read at every step boundary (the loop's beat), so each epoch's
    launches are known across both rebuilds."""
    import types

    import torch
    from bnsgcn_tpu_torch.ops import bucket_sum, dropout, tile_matmul
    from bnsgcn_tpu_torch.run import Control, prepare_part, train_loop
    dev, me, comm = ctx.device, ctx.rank, ctx.comm
    c = cfg.replace(tune="schedule", tune_schedule=TUNE_SCHEDULE,
                    strict_exec=True, comm_trace=True, halo_refresh=4,
                    n_epochs=TUNE_EPOCHS, log_every=2,
                    ckpt_path=os.path.join(cfg.ckpt_path, "tune"))
    t0 = time.perf_counter()
    pr = prepare_part(c, art, None, dev, log, me, comm,
                      reuse=lent.get((c.spmm, c.overlap, "off")))
    setup_s = time.perf_counter() - t0
    mods = (bucket_sum, tile_matmul, dropout)
    beats = []

    def beat(epoch):
        beats.append([epoch] + [m.launches.total for m in mods])

    for m in mods:
        m.launches.reset()
    n = len(lines)
    t0 = time.perf_counter()
    res, _ = train_loop(pr, None, log,
                        ctx=types.SimpleNamespace(beat=beat,
                                                  forwarded=lambda: None),
                        ctl=Control(tune_start=({"halo_refresh": 4},
                                                "schedule@0")))
    beat(TUNE_EPOCHS)
    out = {
        "setup_s": setup_s, "loop_s": time.perf_counter() - t0,
        "trail": [(d["epoch"], d["changes"], d["reason"])
                  for d in res.tune_decisions],
        "strict": res.strict, "comm_traced": res.comm_traced,
        "reduce_traced": res.reduce_traced,
        "retune_seconds": res.retune_seconds, "clean": res.clean,
        "epoch_times": res.epoch_times, "comm_times": res.comm_times,
        "losses": res.losses, "beats": beats, "lines": lines[n:],
        "kinds": {"K1": dict(bucket_sum.launches.by_kind),
                  "K2": dict(tile_matmul.launches.by_kind)},
        "d1": {"phases": dict(dropout.launches.by_phase),
               "kinds": dict(dropout.launches.by_kind)}}
    del pr, res
    torch.cuda.empty_cache()
    return out


def tune_report(cfg, ranks):
    """[tune]'s checks and lines over the ranks' reports (tune_rank): every
    rank applied TUNE_TRAIL; the K=4 -> K=2 retune logged one full refresh
    (reason retune) and the K=1 one none; the strict audit clean on every
    rank, its 2 re-arms, the host-staged copies counted as audited fetches
    (more than one a step); the window's `trace` numbers (comm_s > 0, from
    gloo's host ops) and the [traced] Comm column after it; K1, K2 and D1
    launched one step's worth in every epoch, before and after each
    rebuild. Prints the rebuilds' seconds, the first step after each
    beside a clean epoch, the traced epochs' mean beside the clean ones',
    and the traced Comm column beside the port's CUDA-event column."""
    recs = [r["tune"] for r in ranks]
    per = 2 * (cfg.n_layers - 1)            # K1 and K2: fwd and bwd
    d1 = 2 * cfg.n_layers - 1               # D1: every layer, bwd but the
    for me, r in enumerate(recs):           # first
        if [(e, ch, why) for e, ch, why in r["trail"]] != TUNE_TRAIL:
            raise AssertionError(f"[tune] rank {me} applied {r['trail']}, "
                                 f"not {TUNE_TRAIL}")
        s = r["strict"]
        if (s is None or s["violations"] != 0 or s["rearms"] != 2
                or sum(s["steps"].values()) != TUNE_EPOCHS
                or s["fetches"] <= 2 * TUNE_EPOCHS):
            raise AssertionError(f"[tune] rank {me}: strict audit {s}")
        steps = [[b - a for a, b in zip(x[1:], y[1:])]
                 for x, y in zip(r["beats"], r["beats"][1:])]
        if (len(steps) != TUNE_EPOCHS
                or any(st != [per, per, d1] for st in steps)):
            raise AssertionError(f"[tune] rank {me}: K1, K2, D1 launches "
                                 f"per epoch {steps}, not {[per, per, d1]}")
        if not all(math.isfinite(v) for v in r["losses"]):
            raise AssertionError(f"[tune] rank {me}: losses {r['losses']}")
    lines = recs[0]["lines"]
    full = [ln for ln in lines if "halo cache: full refresh" in ln]
    if full != ["  halo cache: full refresh at epoch 0 (start); next 3+ "
                "epochs reuse cached blocks",
                "  halo cache: full refresh at epoch 2 (retune); next 1+ "
                "epochs reuse cached blocks"]:
        raise AssertionError(f"[tune] full-refresh lines {full}")
    epochs = [ln for ln in lines if "Process 000 | Epoch" in ln]
    r0 = recs[0]
    if (r0["comm_traced"] is None or not r0["comm_traced"] > 0
            or "[traced]" not in epochs[-1] or "[events]" not in epochs[0]):
        raise AssertionError(f"[tune] no traced Comm column: "
                             f"{r0['comm_traced']} {epochs}")
    audit = [ln for ln in lines if ln.startswith("[strict] exec audit")]
    log(f"[tune] {TUNE_SCHEDULE} under --strict-exec on every rank: "
        f"decisions {[(e, ch) for e, ch, _ in TUNE_TRAIL]}, one full refresh "
        f"(retune) at epoch 2; {audit[0] if audit else ''}; fetches a rank "
        f"{_span([r['strict']['fetches'] for r in recs], '{:.0f}')} "
        f"({TUNE_EPOCHS} loss reads, the rest host-staged copies)")
    log(f"[tune] K1, K2, D1 each epoch on every rank, before and after both "
        f"rebuilds: {per}, {per}, {d1} (kinds K1 "
        f"{recs[0]['kinds']['K1']} K2 {recs[0]['kinds']['K2']} D1 "
        f"{recs[0]['d1']['kinds']})")
    clean = [[t for t, c in zip(r["epoch_times"], r["clean"]) if c]
             for r in recs]
    traced = [[t for e, t in enumerate(r["epoch_times"]) if 6 <= e <= 9]
              for r in recs]
    ms = lambda xs: sum(xs) / max(len(xs), 1) * 1e3
    rebuild = [[s for _, s in r["retune_seconds"]] for r in recs]
    first = [[r["epoch_times"][e] for e, _ in r["retune_seconds"]]
             for r in recs]
    ev_comm = [ms([c for c, k in zip(r["comm_times"], r["clean"]) if k])
               for r in recs]
    log(f"[tune] rebuild at epochs 2, 4: "
        f"{_span([x[0] for x in rebuild], '{:.3f}')}, "
        f"{_span([x[1] for x in rebuild], '{:.3f}')} s; the first step "
        f"after each {_span([x[0] * 1e3 for x in first])}, "
        f"{_span([x[1] * 1e3 for x in first])} ms against a clean epoch "
        f"(10, 11) {_span([ms(x) for x in clean])} ms; the traced epochs "
        f"(6..9) {_span([ms(x) for x in traced])} ms")
    log(f"[tune] Comm(s) per step at P={PARTS} over gloo: traced (min over "
        f"the ranks' gloo ops, rank 0's parse) {r0['comm_traced'] * 1e3:.3f}"
        f" ms, reduce {r0['reduce_traced'] * 1e3:.3f} ms; the port's "
        f"CUDA-event column on the clean epochs {_span(ev_comm)} ms")
    return {"ranks": [{k: v for k, v in r.items() if k != "lines"}
                      for r in recs], "clean_ms": [ms(x) for x in clean],
            "traced_ms": [ms(x) for x in traced], "rebuild_s": rebuild,
            "first_step_s": first, "events_comm_ms": ev_comm,
            "comm_traced_s": r0["comm_traced"],
            "reduce_traced_s": r0["reduce_traced"]}


def _span(xs, fmt="{:.1f}"):
    """min–max of per-rank values, as text."""
    lo, hi = min(xs), max(xs)
    return fmt.format(lo) if lo == hi else f"{fmt.format(lo)}–{fmt.format(hi)}"


def halo_phase(main4, args):
    """[halo]: the exchange's variants on the P=4 main path's artifacts
    (the flagship's command line: --inductive, rate 0.1, GraphSAGE 4x256
    with use_pp, f32, seed 0), in one spawned group of 4 ranks sharing the
    card over gloo (halo_rank). Checks: shift and ragged move padded's
    rows bitwise; their losses, and --overlap split's against off on the
    hybrid and on ELL, agree to HALO_RTOL (relative); K1 and K2 on the
    split layouts agree with their plain versions; each variant launches
    K1 and K2 once per aggregation (the split ones once per side), and the
    ELL ones no K2; --halo-refresh K logs one full-refresh epoch, at the
    start, and ships fewer bytes steady; grad-only opens no exchange span
    in its steps; rate 0.0 trains as grad-only does. Prints each
    variant's wire MB (peak and steady), Comm(s), epoch and peak memory,
    and for split the interior and frontier passes' ms beside the exchange
    span's and how much of the exchange they hid."""
    from bnsgcn_tpu_torch.data.artifacts import read_meta
    from bnsgcn_tpu_torch.parallel.mesh import launch
    from bnsgcn_tpu_torch.run import artifacts_dir
    from bnsgcn_tpu_torch.trainer import resolve_strategy
    t0 = time.perf_counter()
    cfg = main4.replace(n_epochs=HALO_EPOCHS, log_every=10 ** 6, eval=False)
    path = artifacts_dir(cfg)
    meta = read_meta(path)
    pick, why = resolve_strategy(cfg.replace(halo_exchange="auto"),
                                 meta.n_b, meta.pad_inner,
                                 meta.pad_boundary, cfg.sampling_rate)
    log(f"[halo] --halo-exchange auto at rate {cfg.sampling_rate} on the "
        f"main path's {PARTS} parts: {pick} ({why})")
    ranks = launch(halo_rank, PARTS, [(cfg, path, args.reps)] * PARTS,
                   cfg.dist_backend, cfg.device, log=log)
    for s in ("shift", "ragged"):
        x = [r["exchange"][s] for r in ranks]
        p = [r["exchange"]["padded"] for r in ranks]
        log(f"[halo] {s} on epoch 0's plan: every rank's output bitwise "
            f"padded's, backward within "
            f"{max(v['bwd_rel_err'] for v in x):.1e} (relative); one "
            f"exchange at H={cfg.n_hidden} {_span([v['ms'] for v in x], '{:.2f}')}"
            f" ms beside padded's {_span([v['ms'] for v in p], '{:.2f}')} "
            f"(events, reps {args.reps}); wire {x[0]['wire_mb']:.2f} MB "
            f"(padded {p[0]['wire_mb']:.2f})")
    var = {name: [r["variants"][name] for r in ranks]
           for name, _ in HALO_VARIANTS}
    passes = (cfg.n_layers - 1) * cfg.n_epochs
    for name, flags in HALO_VARIANTS:
        recs = var[name]
        losses = recs[0]["losses"]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"[halo] {name}: non-finite loss {losses}")
        sides = 2 if recs[0]["overlap"] == "split" else 1
        k1 = {"fwd": sides * passes, "bwd": sides * passes, "pre": sides}
        want = {"K1": k1, "K2": k1 if flags.get("spmm") != "ell" else {}}
        for r in recs:
            if r["launches"] != want:
                raise AssertionError(f"[halo] {name}: launches "
                                     f"{r['launches']}, not {want}")
        ep = [mean_from_1(r["epoch_times"]) * 1e3 for r in recs]
        ex = [mean_from_1(r["comm_times"]) * 1e3 for r in recs]
        mem = [r["max_memory_gib"] for r in recs]
        log(f"[halo] {name} ({recs[0]['strategy']}"
            f"{'+ovl' if recs[0]['overlap'] == 'split' else ''}): wire "
            f"{recs[0]['wire_mb']:.2f} MB per exchange at peak, "
            f"{recs[0]['steady_mb']:.2f} steady; Comm(s) {_span(ex)} ms, "
            f"epoch {_span(ep)} ms (means of epochs 1..), peak memory "
            f"{_span(mem, '{:.2f}')} GiB (with the layouts held for later "
            f"variants); losses "
            + " ".join(f"{v:.6f}" for v in losses)
            + f"; layout set-up {_span([r['setup_s'] for r in recs])} s")
    checks = []
    for name, base in (("shift", "padded"), ("ragged", "padded"),
                       ("split", "padded"), ("ell+split", "ell"),
                       ("rate0", "grad-only")):
        a, b = var[name][0]["losses"], var[base][0]["losses"]
        rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
        if not rel <= HALO_RTOL:
            raise AssertionError(f"[halo] {name}'s losses {a} differ from "
                                 f"{base}'s {b} by {rel:.3e} (relative)")
        checks.append((name, base, rel))
    log("[halo] losses agree (relative): " + ", ".join(
        f"{a} vs {b} {rel:.1e}" for a, b, rel in checks)
        + f" <= {HALO_RTOL}")
    for r in var["grad-only"]:
        if any(c != 0.0 for c in r["comm_times"]):
            raise AssertionError(f"[halo] grad-only opened an exchange "
                                 f"span: {r['comm_times']}")
    for K in (2, 4):
        lines = var[f"hr{K}"][0]["lines"]
        full = [ln for ln in lines if "halo cache: full refresh" in ln]
        if (full != [f"  halo cache: full refresh at epoch 0 (start); next "
                     f"{K - 1}+ epochs reuse cached blocks"]
                or not var[f"hr{K}"][0]["steady_mb"]
                < var[f"hr{K}"][0]["wire_mb"]):
            raise AssertionError(f"[halo] hr{K}: full-refresh lines {full}")
    log("[halo] --halo-refresh 2 and 4: one full-refresh epoch (0, "
        "'start'), the cached epochs after; grad-only: no exchange span in "
        "its steps (Comm(s) 0)")
    split = {}
    for name, base in (("split", "padded"), ("ell+split", "ell")):
        rows = []
        for r, b in zip(var[name], var[base]):
            ms = {k: v for k, v in r["side_ms"].items()}
            n_agg = 2 * (cfg.n_layers - 1)          # passes per epoch
            per = {k: sum(v[n_agg:]) / max(cfg.n_epochs - 1, 1)
                   for k, v in ms.items()}
            ex_s = mean_from_1(r["comm_times"]) * 1e3
            ex_o = mean_from_1(b["comm_times"]) * 1e3
            hidden = per["interior"] + ex_o - ex_s
            rows.append({"interior_ms": per["interior"],
                         "frontier_ms": per["frontier"],
                         "exchange_ms": ex_s, "exchange_off_ms": ex_o,
                         "hidden_ms": hidden, "check": r["check"],
                         "interior_rows": r["rows"][0],
                         "rows": r["rows"][1]})
        split[name] = rows
        share = [x["interior_rows"] / max(x["rows"], 1) for x in rows]
        log(f"[halo] {name}, per epoch (means of epochs 1.., events, "
            f"forward and backward): interior rows {_span(share, '{:.1%}')}"
            f" of each part's; interior {_span([x['interior_ms'] for x in rows])}"
            f" ms, frontier {_span([x['frontier_ms'] for x in rows])} ms, "
            f"the exchange span {_span([x['exchange_ms'] for x in rows])} ms "
            f"against {base}'s {_span([x['exchange_off_ms'] for x in rows])};"
            f" hidden (interior + {base}'s exchange - this exchange) "
            f"{_span([x['hidden_ms'] for x in rows])} ms; K1 and K2 on the "
            f"interior and frontier layouts within their bounds (max abs err "
            f"K1 {max(x['check']['K1'][0] for x in rows):.3e}, K2 "
            f"{max(x['check']['K2'][0] for x in rows):.3e})")
    log(f"[halo] done in {time.perf_counter() - t0:.1f} s (with [knobs], "
        f"[recipe] and [tune])")
    knobs = knobs_report(cfg, ranks, var)
    recipe = recipe_report(cfg, ranks)
    tuned = tune_report(cfg, ranks)
    return {"auto": [pick, why], "knobs": knobs, "tune": tuned,
            "recipe": recipe, "ranks": [
        {k: v for k, v in r.items() if k not in ("variants", "knobs",
                                                  "tune", "recipe")}
        for r in ranks],
        "variants": {name: [{k: v for k, v in x.items()
                             if k not in ("detail", "lines")} for x in recs]
                     for name, recs in var.items()},
        "split": split}


def recipe_report(cfg, ranks):
    """[recipe] at P=4 from the ranks' recipe_rank records: every rank's
    launches recipe_want's, the loss finite; it prints each rank's epoch,
    exchange share, peak memory and K1/K2 bf16 errors, and the int8 wire's
    MB per exchange beside the f32 path's. Returns the details."""
    from bnsgcn_tpu_torch.data.artifacts import read_meta
    from bnsgcn_tpu_torch.parallel.halo import make_halo_spec, wire_bytes
    from bnsgcn_tpu_torch.run import artifacts_dir
    c = cfg.replace(**recipe_fields(), n_epochs=RECIPE_P4_EPOCHS)
    recs = [r["recipe"] for r in ranks]
    want = dict(zip(("K1", "K2"), recipe_want(c)))
    for r, x in zip(ranks, recs):
        if x["kinds"] != want:
            raise AssertionError(f"[recipe] P={PARTS} rank {r['rank']}: "
                                 f"launched {x['kinds']}, not {want}")
    losses = recs[0]["losses"]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"[recipe] P={PARTS}: non-finite loss {losses}")
    meta = read_meta(artifacts_dir(c))
    wire = {}
    for name in ("native", c.halo_wire):
        spec, _ = make_halo_spec(meta.n_b, meta.pad_inner, meta.pad_boundary,
                                 c.sampling_rate, wire=name)
        wire[name] = wire_bytes(spec, c.n_hidden) / 1e6
    out = []
    for r, x in zip(ranks, recs):
        ep, ex = (mean_from_1(x[k]) for k in ("epoch_times", "comm_times"))
        out.append({"rank": r["rank"], "epoch_s": ep, "exchange_s": ex,
                    "exchange_share": ex / max(ep, 1e-12),
                    "reduce_s": mean_from_1(x["reduce_times"]),
                    "max_memory_gib": x["max_memory_gib"],
                    "launches": x["kinds"], "check": x["check"],
                    "setup_s": x["setup_s"]})
        log(f"[recipe] P={PARTS} rank {r['rank']} (4 ranks sharing one card "
            f"over gloo, not a 4-card number; in [halo]'s group), "
            f"{' '.join(RECIPE_TPU)}, inductive, rate {c.sampling_rate}: "
            f"mean of epochs 1.. {ep * 1e3:.1f} ms, exchange "
            f"{ex * 1e3:.1f} ms ({ex / max(ep, 1e-12):.1%} of the epoch), "
            f"peak memory {x['max_memory_gib']:.2f} GiB; launches K1 "
            f"{x['kinds']['K1']} K2 {x['kinds']['K2']}; K1 bf16 max abs err "
            f"{x['check']['K1']:.3e}, K2 bf16 {x['check']['K2']:.3e} on its "
            f"own layout at H={tuple(x['check']['widths'])} (within their "
            f"bounds, the controls rejected)")
    log(f"[recipe] P={PARTS}: {c.n_epochs} epochs, losses "
        + " ".join(f"{v:.4f}" for v in losses)
        + f"; int8 wire {wire[c.halo_wire]:.2f} MB per exchange at H="
        f"{c.n_hidden} (the f32 main path's: {wire['native']:.2f}); every "
        f"rank ends with rank 0's parameters; the layout lent by [halo]'s "
        f"padded run (set-up {_span([x['setup_s'] for x in recs])} s)")
    return {"losses": losses, "wire_mb": wire[c.halo_wire],
            "wire_mb_f32": wire["native"], "ranks": out}


def knobs_report(cfg, ranks, halo_var):
    """[knobs]' checks and lines over the ranks' reports (halo_rank (c)):
    D1 bitwise on every rank's layer shapes and against the CPU's mask; on
    the flagship at dropout 0.5 (the padded variant) D1 launched once per
    layer forward and once per layer backward but the first (whose input
    needs no gradient) every epoch; every variant's losses finite, its
    epoch, peak memory and set-up; SyncBatchNorm's statistics bitwise equal
    on every rank; --remat's losses and parameters equal to its twin's
    (bitwise, or within REMAT_RTOL, said which); the reorder variants'
    coverage before and after, order build ms, layout set-up, and losses
    against their twins (REORDER_TWINS), auto's against the variant its
    verdict names, bitwise. Returns the details for the report."""
    t0 = time.perf_counter()
    var = {name: [r["knobs"][name] for r in ranks] for name, _ in
           KNOB_VARIANTS}
    log(f"[knobs] D1 bitwise its plain version on every rank's layer "
        f"shapes {ranks[0]['d1']['shapes']} (and the others'), f32 and "
        f"bf16, forward and backward, the next epoch's key rejected; the "
        f"mask of (epoch 1, rank r) on the card bitwise the CPU's on "
        f"{ranks[0]['d1']['cpu_rows']} rows of every rank "
        f"({_span([r['d1']['seconds'] for r in ranks])} s)")
    n_l, n_e = cfg.n_layers, cfg.n_epochs
    want = {"fwd": n_l * n_e, "bwd": (n_l - 1) * n_e}
    for r in halo_var["padded"]:
        if r["d1"]["phases"] != want:
            raise AssertionError(f"[knobs] the flagship at dropout "
                                 f"{cfg.dropout}: D1 launched "
                                 f"{r['d1']['phases']}, not {want}")
    log(f"[knobs] the flagship at dropout {cfg.dropout} ([halo]'s padded "
        f"run): D1 launched {want} on every rank (each layer's forward, "
        f"each backward but layer 0's)")
    for name, _ in KNOB_VARIANTS:
        recs = var[name]
        losses = recs[0]["losses"]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"[knobs] {name}: non-finite loss {losses}")
        if not all(r["launches"]["K1"] for r in recs):
            raise AssertionError(f"[knobs] {name}: K1 never launched")
        ep = [mean_from_1(r["epoch_times"]) * 1e3 for r in recs]
        mem = [r["run_memory_gib"] for r in recs]
        log(f"[knobs] {name}: epoch {_span(ep)} ms (means of epochs 1..), "
            f"the run's own peak memory {_span(mem, '{:.2f}')} GiB (above "
            f"what the group held before it), D1 "
            f"{recs[0]['d1']['phases']}, set-up "
            f"{_span([r['setup_s'] for r in recs])} s; losses "
            + " ".join(f"{v:.6f}" for v in losses))
    for name in ("bn", "remat+bn"):
        digests = {r["bn_digest"] for r in var[name]}
        if len(digests) != 1:
            raise AssertionError(f"[knobs] {name}: the ranks' SyncBatchNorm "
                                 f"statistics differ")
    log("[knobs] --norm batch: the running mean and variance bitwise equal "
        "on every rank (bn, remat+bn)")
    remat = {}
    for name, twin in REMAT_TWINS.items():
        a = var[name][0]["losses"]
        b = (halo_var[twin] if twin in halo_var else var[twin])[0]["losses"]
        bitwise = a == b and all(r["params_vs_twin"]["bitwise"]
                                 for r in var[name])
        loss_rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
        p_rel = max(r["params_vs_twin"]["max_rel"] for r in var[name])
        if not (loss_rel <= REMAT_RTOL and p_rel <= REMAT_RTOL):
            raise AssertionError(f"[knobs] {name}: losses {a} vs {twin}'s "
                                 f"{b} ({loss_rel:.3e}), parameters "
                                 f"{p_rel:.3e} (relative)")
        m_a = [r["run_memory_gib"] for r in var[name]]
        m_b = [r["run_memory_gib"] for r in
               (halo_var[twin] if twin in halo_var else var[twin])]
        remat[name] = {"twin": twin, "bitwise": bitwise,
                       "loss_rel": loss_rel, "params_rel": p_rel,
                       "memory_gib": m_a, "twin_memory_gib": m_b}
        log(f"[knobs] {name} against {twin}: losses and final parameters "
            + ("bitwise equal" if bitwise else
               f"within {max(loss_rel, p_rel):.1e} (relative; the "
               f"recompute's kernels are not bitwise)")
            + f"; the run's own peak memory per rank "
            f"{_span(m_a, '{:.2f}')} GiB against {_span(m_b, '{:.2f}')}")
    ro = {}
    for name in ("ro-cluster", "ro-auto", "ell+ro-cluster", "ell+ro-auto"):
        recs = var[name]
        info = recs[0]["reorder"]
        ro[name] = {"resolved": recs[0]["resolved"], "info": [
            r["reorder"] for r in recs],
            "setup_s": [r["setup_s"] for r in recs]}
        log(f"[knobs] {name}: {info['mode']} -> {info['resolved']}, tile "
            f"coverage {info['coverage_before']:.1%} -> "
            f"{info['coverage_after']:.1%} (every rank's parts), the order "
            f"built in {_span([r['reorder']['build_ms'] for r in recs])} ms "
            f"per rank, layout set-up {_span(ro[name]['setup_s'])} s")
    for name, (twin, tol) in REORDER_TWINS.items():
        a, b = var[name][0]["losses"], var[twin][0]["losses"]
        worst = max(abs(x - y) / max(abs(y), 1.0) for x, y in zip(a, b))
        if not worst <= tol:
            raise AssertionError(f"[knobs] {name}: losses {a} vs {twin}'s "
                                 f"{b} differ by {worst:.3e}")
        ro[name]["loss_diff"] = worst
        log(f"[knobs] {name} against {twin}: losses within {worst:.1e} of "
            f"max(|loss|, 1) <= {tol}")
    for name, cl, base in (("ro-auto", "ro-cluster", "ro-base"),
                           ("ell+ro-auto", "ell+ro-cluster", "ell+ro-base")):
        twin = cl if var[name][0]["resolved"] == "cluster" else base
        if var[name][0]["losses"] != var[twin][0]["losses"]:
            raise AssertionError(f"[knobs] {name} resolved to "
                                 f"{var[name][0]['resolved']} but its losses "
                                 f"are not {twin}'s")
        log(f"[knobs] {name}: auto -> {var[name][0]['resolved']}, losses "
            f"bitwise {twin}'s")
    log(f"[knobs] report {time.perf_counter() - t0:.1f} s")
    return {"variants": {name: [{k: v for k, v in x.items()}
                                for x in recs] for name, recs in var.items()},
            "remat": remat, "reorder": ro,
            "d1": [r["d1"] for r in ranks]}


def axes_rank(ctx, cfgs):
    """[axes]' rank body: global rank g of AXES_RANKS, on both rank maps of
    the port (parallel/replicas.py): R=2 x P=4 (g = r P + p) and P=4 x T=2
    (g = p T + f), each map's groups made once, every rank in one order.
    Each of AXES_RUNS through run.train_loop from the seed's parameters (the
    P=4 law's), launch counts reset just before and read just after; the
    flagship's T=2 run first holds K1 and K2 to their plain versions on
    this feat rank's layout at H/T and the raw feature width; the
    flagship's R=2 run first builds its epoch-0 plan on the card and on
    the CPU for its replica's fold. Hands back each run's losses, epoch,
    exchange, feat and reduce seconds, wire MB, launches and a digest of
    its parameters."""
    import hashlib

    import torch
    from bnsgcn_tpu_torch.data.artifacts import load_artifacts
    from bnsgcn_tpu_torch.ops import bucket_sum, dropout, tile_matmul
    from bnsgcn_tpu_torch.parallel import halo
    from bnsgcn_tpu_torch.parallel.feat import shard_width
    from bnsgcn_tpu_torch.parallel.replicas import make_axes
    from bnsgcn_tpu_torch.run import artifacts_dir, prepare_part, train_loop
    from bnsgcn_tpu_torch.utils import prng
    dev, g = ctx.device, ctx.rank

    def log(m):
        if g == 0:
            ctx.log(m)

    t_rank = time.perf_counter()
    maps = {(AXES_R, 1): make_axes(ctx.comm, AXES_R, PARTS, 1),
            (1, AXES_T): make_axes(ctx.comm, 1, PARTS, AXES_T)}
    out = {"rank": g, "runs": {}, "groups_s": time.perf_counter() - t_rank,
           "load_s": 0.0}
    arts = {}

    def art(which, p):
        if (which, p) not in arts:
            t0 = time.perf_counter()
            arts[which, p] = load_artifacts(artifacts_dir(cfgs[which]),
                                            parts=[p])
            out["load_s"] += time.perf_counter() - t0
        return arts[which, p]

    for name, which, R, T, epochs in AXES_RUNS:
        ax = maps[R, T]
        cfg = cfgs[which].replace(replicas=R, feat=T, n_epochs=epochs,
                                  log_every=10 ** 6, eval=False)
        a = art(which, ax.p)
        t0 = time.perf_counter()
        pr = prepare_part(cfg, a, None, dev, log, ax.p, ax.parts, axes=ax)
        rec = {"coords": (ax.r, ax.p, ax.f), "setup_s":
               time.perf_counter() - t0}
        t0 = time.perf_counter()
        H = shard_width(cfg.n_hidden, T)
        if T > 1 and which == "main":
            gen = torch.Generator(device=dev).manual_seed(777 + g)
            widths, detail = (H, a.n_feat), []
            rec["check"] = {"K1": compare_k1(pr.fns, widths, gen, 0,
                                             detail)[0],
                            "K2": compare_k2(pr.fns, widths, gen, 0,
                                             detail)[0],
                            "widths": widths, "n": len(detail)}
        if R > 1 and which == "main":
            bnd = torch.from_numpy(a.bnd[0])
            spec, tables = halo.make_halo_spec(a.n_b, a.pad_inner,
                                               a.pad_boundary,
                                               cfg.sampling_rate)
            card = halo.make_halo_plan(spec, halo.tables_to(tables, dev),
                                       bnd.to(dev), ax.p, 0,
                                       prng.key(cfg.seed, dev), ax.r)
            cpu = halo.make_halo_plan(spec, tables, bnd, ax.p, 0,
                                      prng.key(cfg.seed), ax.r)
            same = all(torch.equal(getattr(card, k).cpu(), getattr(cpu, k))
                       for k in ("sel", "weight", "slots", "presence"))
            rec["plan"] = {"card_is_cpu": same, "digest": hashlib.sha256(
                torch.cat([cpu.sel.reshape(-1), cpu.slots.reshape(-1)])
                .numpy().tobytes()).hexdigest()}
        rec["check_s"] = time.perf_counter() - t0
        bucket_sum.launches.reset()
        tile_matmul.launches.reset()
        dropout.launches.reset()
        t0 = time.perf_counter()
        res, model = train_loop(pr, None, log)
        rec["loop_s"] = time.perf_counter() - t0
        flat = torch.cat([p.detach().reshape(-1).float()
                          for p in model.parameters()]).cpu()
        rec.update(
            losses=res.losses, epoch_times=res.epoch_times,
            comm_times=res.comm_times, feat_times=res.feat_times,
            reduce_times=res.reduce_times,
            wire_mb=halo.wire_bytes(pr.fns.halo, H) / 1e6,
            launches={"K1": dict(bucket_sum.launches.by_phase),
                      "K2": dict(tile_matmul.launches.by_phase)},
            kinds={"K1": dict(bucket_sum.launches.by_kind),
                   "K2": dict(tile_matmul.launches.by_kind)},
            d1={"phases": dict(dropout.launches.by_phase),
                "kinds": dict(dropout.launches.by_kind)},
            digest=hashlib.sha256(flat.numpy().tobytes()).hexdigest())
        out["runs"][name] = rec
        del pr, res, model
        torch.cuda.empty_cache()
    out["rank_s"] = time.perf_counter() - t_rank
    return out


def axes_phase(law, main4, law_losses, main_losses):
    """[axes]: --replicas 2 and --feat 2 in one spawned group of AXES_RANKS
    ranks sharing the card over gloo (axes_rank), on the P=4 law's and the
    P=4 main path's artifacts. Checks: (a) R=2 and (b) T=2 at rate 1.0
    without dropout, 2 epochs, give the P=4 law's first two; (c) T=2 on the
    flagship's command line gives the P=4 main path's first 2 epochs' (the
    keys fold no feat index, D1 draws at full width); (d) R=2 on it: every
    rank ends with the same parameters, bitwise, each rank's epoch-0 plan
    on the card is the CPU's for its replica's fold, and replica 1's
    differ from replica 0's; all to LAW_RTOL (relative). Every feat rank
    first holds K1 and K2 to their plain versions at H/T and the raw
    feature width; every run launches K1 and K2 once per aggregation and
    D1 once per layer forward and once per layer backward but layer 0's at
    dropout. Prints each run's epoch (mean of epochs 1..), Comm(s) split
    into exchange, feat and reduce, and the wire MB per exchange per
    replica beside the --replicas 1 --feat 1 run's at H."""
    from bnsgcn_tpu_torch.data.artifacts import read_meta
    from bnsgcn_tpu_torch.parallel.halo import make_halo_spec, wire_bytes
    from bnsgcn_tpu_torch.parallel.mesh import launch
    from bnsgcn_tpu_torch.run import artifacts_dir
    t0 = time.perf_counter()
    cfgs = {"law": law.replace(n_partitions=PARTS), "main": main4}
    wire = {}
    for which, c in cfgs.items():
        meta = read_meta(artifacts_dir(c))
        spec, _ = make_halo_spec(meta.n_b, meta.pad_inner, meta.pad_boundary,
                                 c.sampling_rate)
        wire[which] = wire_bytes(spec, c.n_hidden) / 1e6
    ranks = launch(axes_rank, AXES_RANKS, [(cfgs,)] * AXES_RANKS,
                   law.dist_backend, law.device, log=log)
    runs = {name: [r["runs"][name] for r in ranks] for name, *_ in AXES_RUNS}
    refs = {"law": law_losses, "main": main_losses}
    checks = []
    for name, which, R, T, epochs in AXES_RUNS:
        recs = runs[name]
        cfg = cfgs[which]
        want_k = {"fwd": (cfg.n_layers - 1) * epochs,
                  "bwd": (cfg.n_layers - 1) * epochs, "pre": 1}
        want_d1 = ({} if cfg.dropout == 0 else
                   {"fwd": cfg.n_layers * epochs,
                    "bwd": (cfg.n_layers - 1) * epochs})
        for r in recs:
            if not all(math.isfinite(v) for v in r["losses"]):
                raise AssertionError(f"[axes] {name}: non-finite loss "
                                     f"{r['losses']}")
            if r["launches"] != {"K1": want_k, "K2": want_k}:
                raise AssertionError(f"[axes] {name}: rank {r['coords']} "
                                     f"launched {r['launches']}, not "
                                     f"{want_k} each")
            if r["d1"]["phases"] != want_d1:
                raise AssertionError(f"[axes] {name}: D1 launched "
                                     f"{r['d1']['phases']}, not {want_d1}")
            if r["losses"] != recs[0]["losses"]:
                raise AssertionError(f"[axes] {name}: ranks report different "
                                     f"losses")
        got, ref = recs[0]["losses"], refs[which][:epochs]
        rel = max(abs(x - y) / abs(y) for x, y in zip(got, ref))
        held = not (which == "main" and R > 1)
        if held and not rel <= LAW_RTOL:
            raise AssertionError(f"[axes] {name}: losses {got} against "
                                 f"{ref} ({'the P=4 law' if which == 'law' else 'the P=4 main path'}) "
                                 f"differ by {rel:.3e} (relative)")
        if held:
            checks.append((name, rel))
        ep = [mean_from_1(r["epoch_times"]) * 1e3 for r in recs]
        ex = [mean_from_1(r["comm_times"]) * 1e3 for r in recs]
        ft = [mean_from_1(r["feat_times"]) * 1e3 for r in recs]
        rd = [mean_from_1(r["reduce_times"]) * 1e3 for r in recs]
        share = [f / max(e, 1e-9) for f, e in zip(ft, ep)]
        log(f"[axes] {name} ({'--replicas' if R > 1 else '--feat'} 2, "
            f"{AXES_RANKS} ranks sharing one card over gloo): losses "
            + " ".join(f"{v:.6f}" for v in got)
            + f", {rel:.1e} (relative) from "
            f"{'the P=4 law' if which == 'law' else 'the P=4 main path'}'s"
            f"{'' if held else ' (its own draws: not held to them)'}; "
            f"epoch {_span(ep)} ms (mean of epochs 1..); Comm(s): exchange "
            f"{_span(ex)}, feat {_span(ft)} ({_span(share, '{:.1%}')} of the"
            f" epoch), reduce {_span(rd)} ms; wire "
            f"{recs[0]['wire_mb']:.2f} MB per exchange per replica (--replicas 1"
            f" --feat 1: {wire[which]:.2f}); set-up "
            f"{_span([r['setup_s'] for r in recs])} s, checks "
            f"{_span([r['check_s'] for r in recs])} s, the loop (the "
            f"precompute, the epochs) {_span([r['loop_s'] for r in recs])}"
            f" s")
    d = runs["main R=2"]
    if len({r["digest"] for r in d}) != 1:
        raise AssertionError("[axes] main R=2: the ranks' parameters differ")
    plans = {}
    for r in d:
        rr, p, _ = r["coords"]
        if not r["plan"]["card_is_cpu"]:
            raise AssertionError(f"[axes] main R=2: rank {r['coords']}'s "
                                 f"epoch-0 plan on the card is not the "
                                 f"CPU's")
        plans[rr, p] = r["plan"]["digest"]
    same = [p for p in range(PARTS) if plans[0, p] == plans[1, p]]
    if same:
        raise AssertionError(f"[axes] main R=2: replicas 0 and 1 drew the "
                             f"same plans for parts {same}")
    for name in ("law T=2", "main T=2"):
        by_f = {}
        for r in runs[name]:
            by_f.setdefault(r["coords"][2], set()).add(r["digest"])
        if any(len(v) != 1 for v in by_f.values()):
            raise AssertionError(f"[axes] {name}: the shards' holders' "
                                 f"parameters differ")
    chk = [r["check"] for r in runs["main T=2"]]
    log(f"[axes] every feat rank's own layout at H={tuple(chk[0]['widths'])}"
        f": K1 max abs err {max(c['K1'][0] for c in chk):.3e}, K2 "
        f"{max(c['K2'][0] for c in chk):.3e} over {chk[0]['n']} checks each, "
        f"every element within its bound; main R=2: every rank's "
        f"parameters bitwise equal, each epoch-0 plan on the card the "
        f"CPU's for its fold, replica 1's plans differ from replica 0's on "
        f"every part; done in {time.perf_counter() - t0:.1f} s (a rank: "
        f"groups {_span([r['groups_s'] for r in ranks])} s, loads "
        f"{_span([r['load_s'] for r in ranks])} s, its whole body "
        f"{_span([r['rank_s'] for r in ranks])} s)")
    return {"checks": checks, "wire_mb_r1": wire, "ranks": [
        {"rank": r["rank"], "runs": {k: {x: y for x, y in v.items()
                                         if x != "plan"}
                                     for k, v in r["runs"].items()}}
        for r in ranks]}


def anchor_phase(work):
    """[anchor]: the JAX package's calibrated accuracy gate on the card
    (bnsgcn_tpu_torch/anchor.py; tests/test_accuracy_anchor.py's bands):
    exact (P=1, rate 1.0, f32, ELL) inside EXACT_BAND; at P=4 ranks sharing
    the card over gloo and rate 0.1, the stack of the recipe's finer knobs
    (hybrid, int8 dense tiles, int8 gathers, int8 halo wire) and the
    recipe's own knobs (RECIPE_TPU; what --spmm auto resolved to on the
    anchor's random partitions is printed) each within QUANT_TOL of exact;
    the finer stack in bf16 recorded beside them, not gated; the
    biased-sampler mutation (each rank draws the first k of every boundary
    list) below exact - 0.05. The P=4 runs train two at a time, and the
    phase runs beside [cli] (the seconds printed overlap)."""
    from bnsgcn_tpu_torch import anchor
    g = anchor.anchor_graph()
    quant = dict(spmm="hybrid", use_pallas=True, spmm_gather="int8",
                 spmm_dense="int8", halo_wire="int8")
    runs = (("exact", 1, 1.0, {}),
            ("quant", PARTS, BNS_RATE, quant),
            ("quant_bf16", PARTS, BNS_RATE, dict(quant, dtype="bfloat16")),
            ("recipe", PARTS, BNS_RATE, recipe_fields()),
            ("biased", PARTS, BNS_RATE, dict(biased_sampler=True)))

    def one(run):
        name, P, rate, kw = run
        t0 = time.perf_counter()
        lines = []
        acc = anchor.train_eval(g, P, rate, epochs=anchor.EPOCHS,
                                device="cuda",
                                work=os.path.join(work, "anchor", name),
                                log=lines.append, **kw)
        return name, {"val_acc": acc, "seconds": time.perf_counter() - t0,
                      "auto": [ln for ln in lines
                               if ln.startswith("spmm=auto:")]}

    # the P=4 runs two at a time, each its own spawned group on the card:
    # their epochs wait on gloo's host round trips more than on the card,
    # and the gate reads accuracies, not times
    out = dict([one(runs[0])])
    with ThreadPoolExecutor(2) as pool:
        out.update(pool.map(one, runs[1:]))
    e, q, b, r, m = (out[k]["val_acc"] for k in
                     ("exact", "quant", "quant_bf16", "recipe", "biased"))
    auto = out["recipe"]["auto"]
    if len(auto) != 1:
        raise AssertionError(f"[anchor] the recipe's run printed {auto}, "
                             f"not one spmm=auto line")
    lo, hi = anchor.EXACT_BAND
    log(f"[anchor] reddit_like_graph {g.n_nodes} nodes, {g.n_edges} edges, "
        f"GraphSAGE 3x32, {anchor.EPOCHS} epochs: exact (P=1, rate 1.0, f32, "
        f"ELL) val {e:.4f} (band ({lo}, {hi})); quant (P={PARTS} over gloo "
        f"on one card, rate {BNS_RATE}, hybrid, int8 dense, int8 gathers, "
        f"int8 wire) val {q:.4f}, |quant - exact| {abs(q - e):.4f} <= "
        f"{anchor.QUANT_TOL}; the same in bf16 (recorded) val {b:.4f}")
    log(f"[anchor] the recipe's own knobs ({' '.join(RECIPE_TPU)}; on the "
        f"anchor's random partitions {auto[0]}) val {r:.4f}, |recipe - "
        f"exact| {abs(r - e):.4f} <= {anchor.QUANT_TOL}; the biased-sampler "
        f"mutation (P={PARTS}, rate {BNS_RATE}, f32 ELL, a first-k sample) "
        f"val {m:.4f} < exact - 0.05 = {e - 0.05:.4f} ("
        + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in out.items())
        + ")")
    if not lo < e < hi:
        raise AssertionError(f"[anchor] exact accuracy {e:.4f} outside "
                             f"({lo}, {hi})")
    for name, acc in (("quantized stack", q), ("recipe", r)):
        if not abs(acc - e) <= anchor.QUANT_TOL:
            raise AssertionError(f"[anchor] {name} {acc:.4f} is "
                                 f"{abs(acc - e):.4f} from exact {e:.4f}, "
                                 f"over {anchor.QUANT_TOL}")
    if not m < e - 0.05:
        raise AssertionError(f"[anchor] the biased sampler's {m:.4f} did not "
                             f"fall below exact - 0.05 ({e - 0.05:.4f})")
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
    ap.add_argument("--papers-nodes", type=int, default=PAPERS_NODES,
                    help="[papers]' node count (papers100M's 111M cut)")
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
                                          copy_probe, dropout, tile_matmul)
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
    phases, t_phase = {}, [t_all]

    def phase_done(name):
        now = time.perf_counter()
        phases[name] = now - t_phase[0]
        t_phase[0] = now

    # 1. build
    t0 = time.perf_counter()
    kmods = (bucket_sum, tile_matmul, bucket_reduce, copy_probe, dropout)
    buildlib.build_many([(name, "cuda", [src]) for m in kmods
                         for name, src in m.BUILDS])
    for m in kmods:
        m.lib()
    log(f"[build] K1-K4 and D1 built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc, sm_90a)")
    phase_done("build")

    work = tempfile.mkdtemp(prefix="chip_smoke_")   # checkpoints, results
    cfg = Config(dataset=f"synth-reddit:{args.scale}", n_partitions=1,
                 model="graphsage", n_layers=4, n_hidden=256, use_pp=True,
                 norm="layer", dropout=0.5, lr=0.01, spmm="hybrid",
                 use_pallas=True, n_epochs=args.epochs,
                 log_every=args.epochs, eval=True, seed=0, device="cuda",
                 ckpt_path=os.path.join(work, "checkpoint"),
                 results_path=os.path.join(work, "results"),
                 comm_trace=False)    # [tune] alone traces its window
    # the P-rank phases' artifacts: host work, written by a child process
    # while the P=1 phases run
    part_path = os.path.join(os.getcwd(), "partition")
    writer = start_write_parts(cfg, args, part_path)
    # [papers]' data and partition step (host work) beside [setup] and the
    # P=1 phases, which leave the host's cores idle
    prep_pool = ThreadPoolExecutor(1)
    papers_prep = prep_pool.submit(papers_partition, work, args.papers_nodes)
    t0 = time.perf_counter()
    pr = prepare_run(cfg, log=log)
    log(f"[setup] graph + artifacts + layout {time.perf_counter() - t0:.1f} s")
    phase_done("setup")

    # 2. kernels against their plain versions at the main path's shapes
    gen = torch.Generator(device="cuda").manual_seed(1234)
    widths = (cfg.n_hidden, pr.cfg.n_feat)
    p1_nfeat = pr.cfg.n_feat
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

    d1t = compare_d1(pr.art.pad_inner, (2 * pr.cfg.n_feat, cfg.n_hidden),
                     args.reps, detail)
    for kind, by_w in d1t.items():
        for w, t in by_w.items():
            log(f"[check] D1 {kind} [{t['shape'][0]}, {w}]: bitwise equal to "
                f"its plain version forward and backward, the next epoch's "
                f"key rejected; kernel {t['ms']:.3f} ms, plain (one call) "
                f"{t['plain_ms']:.3f}, F.dropout (Philox, a yardstick) "
                f"{t['library_ms']:.3f}, bound {t['bound_ms']:.3f} "
                f"({t['bound_by']}: bytes {t['bytes_ms']:.3f}, "
                f"{D1_OPS_PER_ELEMENT} int32 operations per element "
                f"{t['ops_ms']:.3f})")

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

    phase_done("kernels")
    # 3. small-input agreement, card vs CPU
    small_agreement(cfg)
    phase_done("agree")

    # 4. the main path, through the user's entry point
    bucket_sum.launches.reset()
    tile_matmul.launches.reset()
    dropout.launches.reset()
    # under --strict-exec: no step may synchronise (strict.py)
    res = run_training(cfg.replace(strict_exec=True), log=log,
                       prepared=dataclasses.replace(
                           pr, cfg=pr.cfg.replace(strict_exec=True)))
    if res.strict is None or res.strict["violations"] != 0:
        raise AssertionError(f"[main] strict audit {res.strict}")
    k1 = dict(bucket_sum.launches.by_phase)
    k2 = dict(tile_matmul.launches.by_phase)
    d1_p1 = {"phases": dict(dropout.launches.by_phase),
             "kinds": dict(dropout.launches.by_kind)}
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
    # dropout before every layer; layer 0's input needs no gradient
    want_d1 = {"fwd": cfg.n_layers * args.epochs,
               "bwd": (cfg.n_layers - 1) * args.epochs}
    if d1_p1["phases"] != want_d1:
        raise AssertionError(f"D1 launched {d1_p1['phases']} on the main "
                             f"path, not {want_d1}")
    log(f"[launches] D1 {d1_p1['phases']}")
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
        f"{test:.3f}; --strict-exec clean ({res.strict['fetches']} audited "
        f"fetches, first-step compiles {res.strict['first_compiles']})")
    phase_done("main")
    p1 = {"scale": args.scale, "epochs": args.epochs, "losses": res.losses,
          "epoch_times_s": res.epoch_times, "epoch_time_s": res.epoch_time,
          "epoch_from_1_s": mean_from_1(res.epoch_times),
          "launches": {"K1": k1, "K2": k2}, "dense_edges": res.dense_edges,
          "strict": res.strict,
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
    phase_done("lowp+recipe")

    # 5. the P-rank path
    t0 = time.perf_counter()
    parts, res4 = parts_runs(cfg, args, part_path, writer)
    log(f"[parts] done in {time.perf_counter() - t0:.1f} s")
    phases.update({f"parts:{k}": v for k, v in parts.pop("phases").items()})
    t_phase[0] = time.perf_counter()

    # 6. the flagship's script: train, checkpoint, resume; then with the
    # evaluation on the ranks
    # 7. [anchor], the calibrated accuracy gate, the laws' P=1 sides and
    # 6b. [yelp], the multilabel path at Yelp's widths, beside [cli]'s
    # runs of the script and its --eval-device mesh run: none of them
    # reads a time it claims, each has its own directories and groups
    law_p1 = parts.pop("law_p1")
    serve_held = parts.pop("serve_held")
    with ThreadPoolExecutor(9) as pool:
        # [serve]'s delta and flush, and the CLI server over [cli]'s run
        serve_f = pool.submit(serve_checks, *serve_held)
        serve_cli_f = pool.submit(serve_cli_phase, work,
                                  os.path.join(work, "cli", CLI_TABLE))
        mesh = pool.submit(cli_mesh_phase, work)
        anc_f = pool.submit(anchor_phase, work)
        # after the --eval-device mesh run: fewer processes share the card
        hang_f = pool.submit(resil_hang_phase, work, mesh)
        law_f = pool.submit(gat_law_phase, cfg, work)
        # after the GAT law: fewer processes share the card and the host
        coord_f = pool.submit(coord_phase, work, law_f)
        law1_f = pool.submit(law_p1_phase, *law_p1)
        yelp_f = pool.submit(yelp_phase, work)
        cli = cli_phase(work)
        cli["mesh"] = mesh.result()
        cli["resil"]["hang"] = hang_f.result()
        cli["coord"] = coord_f.result()
        anc = anc_f.result()
        parts["gat"].update(law_f.result())
        parts.update(law1_f.result())
        yelp = yelp_f.result()
        parts["serve"]["checks"] = serve_f.result()
        parts["serve"]["cli"] = serve_cli_f.result()
    del law_p1, serve_held
    phase_done("cli+anchor+laws+yelp+serve")


    # 6c. scripts/ogbn-papers100m_torch.sh: streaming bf16 artifacts, one
    # launch against two nodes' launches, the layout cache
    papers = papers_phase(work, args.papers_nodes, prep=papers_prep)
    prep_pool.shutdown()
    phase_done("papers")

    shutil.rmtree(work, ignore_errors=True)
    # launches by variant on the main paths: the P=1 run, every rank of the
    # P=4 main path, [lowp]'s two runs, [recipe]'s at P=1 and P=4, and
    # every rank of [meval] (its evals included), of [yelp], of [papers],
    # of [halo]'s variants, of [axes]' runs and of [coord]'s pair A's
    # launch 0
    counts = {"K1": {}, "K2": {}, "D1": {}}
    for src in ([{"K1": p1_kinds["K1"], "K2": p1_kinds["K2"]}]
                + [rep["kinds"] for rep in res4.ranks]
                + [x["launches"] for x in lowp.values()]
                + [rec1["launches"]]
                + [x["launches"] for x in parts["recipe"]["ranks"]]
                + parts["meval"]["launches"] + yelp["launches"]
                + papers["launches"]
                + [x["kinds"] for recs in parts["halo"]["variants"].values()
                   for x in recs]
                + [x["kinds"] for r in parts["axes"]["ranks"]
                   for x in r["runs"].values()]
                + [x["kinds"] for x in cli["coord"]["a"]["ranks"]]
                + [x["kinds"] for x in parts["halo"]["tune"]["ranks"]]):
        for name in ("K1", "K2"):
            for kind, n in src[name].items():
                counts[name][kind] = counts[name].get(kind, 0) + n
    # D1 on the main paths at dropout > 0: the P=1 run, [lowp]'s and
    # [recipe]'s at P=1 (bf16), every rank of the P=4 main path, and of
    # [halo]'s and [knobs]' variants, [axes]' flagship runs and [coord]'s
    # pair A's launch 0
    for src in ([d1_p1] + [rep["d1"] for rep in res4.ranks]
                + [x["d1"] for x in lowp.values()] + [rec1["d1"]]
                + [x["d1"] for recs in parts["halo"]["variants"].values()
                   for x in recs]
                + [x["d1"] for recs in parts["halo"]["knobs"]["variants"]
                   .values() for x in recs]
                + [x["d1"] for r in parts["axes"]["ranks"]
                   for x in r["runs"].values()]
                + [x["d1"] for x in cli["coord"]["a"]["ranks"]]
                + [x["d1"] for x in parts["halo"]["tune"]["ranks"]]):
        for kind, n in src["kinds"].items():
            counts["D1"][kind] = counts["D1"].get(kind, 0) + n
    # the largest error of each kernel's checks, P=1's and every rank's
    hooks = ([rep["hook"] for rep in res4.ranks]
             + yelp["rank_checks"]
             + [x["check"] for rows in parts["halo"]["split"].values()
                for x in rows]
             + [r["runs"]["main T=2"]["check"]
                for r in parts["axes"]["ranks"]])
    errs = {"ell_bucket_sum": max([e1[0]] + [h["K1"][0] for h in hooks]),
            "tile_matmul": max([e2[0]] + [h["K2"][0] for h in hooks]),
            "bucket_reduce": e3, "copy_probe": 0.0}
    times = {"ell_bucket_sum": t1, "tile_matmul": t2, "bucket_reduce": t3,
             "copy_probe": t4,
             "dropout": d1t["f32"][2 * p1_nfeat],
             "dropout_bf16": d1t["bf16"][2 * p1_nfeat]}
    errs["dropout"] = errs["dropout_bf16"] = 0.0     # bitwise
    for prefix, res_k in (("ell_bucket_sum", lk1), ("tile_matmul", lk2)):
        for kind, (err, t) in res_k.items():
            name = f"{prefix}_{kind.replace('-', '_')}"
            errs[name], times[name] = err, t
    # and the bf16 variants' checks on every rank of [recipe] at P=4
    for name, k in (("ell_bucket_sum_bf16", "K1"), ("tile_matmul_bf16", "K2")):
        errs[name] = max([errs[name]] + [x["check"][k] for x in
                                          parts["recipe"]["ranks"]])
    # and K1 on bf16 rows on every rank's ELL layout of [papers]
    errs["ell_bucket_sum_bf16"] = max([errs["ell_bucket_sum_bf16"]]
                                      + [x["check"]["K1"]
                                         for x in papers["ranks"]])

    # 8. report
    out = {"card": smi, "p1": p1, "lowp": lowp, "recipe_p1": rec1,
           "d1": {k: {str(w): t for w, t in v.items()} for k, v in
                  d1t.items()}, "phases": phases,
           "parts": parts, "cli": cli, "yelp": yelp, "papers": papers,
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
    log("[phases] " + " | ".join(f"{k} {v:.1f} s" for k, v in
                                  phases.items())
        + f" | total {time.perf_counter() - t_all:.1f} s")
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
