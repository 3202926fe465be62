#!/bin/bash
# The P=1 epoch's device time of another tree of the port against this
# one, in turns (other, this, this, other), on the card, through
# epoch_profile.py: first the f32 main path, then the TPU recipe's own
# knobs, at synth-reddit:1.0 (GraphSAGE 4x256, use_pp, --spmm hybrid,
# dropout 0.5); last this tree at P=4 with the flagship's command line.
#
#   git archive <commit> bnsgcn_tpu_torch | tar -x -C OTHER
#   bash bnsgcn_tpu_torch/epoch_ab.sh OTHER [OUT]
#
# OTHER holds the other tree's bnsgcn_tpu_torch/; OUT (default
# chiprun_out/epoch_ab) receives one log per run, whose last line is
# epoch_profile's JSON. Both trees share one artifact directory and one
# --cache-dir, so only the first run builds them.
set -u
ROOT=$(pwd)
OTHER=$(cd "$1" && pwd)
OUT=${2:-$ROOT/chiprun_out/epoch_ab}
mkdir -p "$OUT"
W=$(mktemp -d)
trap 'rm -rf "$W"' EXIT
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
COMMON="--dataset synth-reddit:1.0 --n-partitions 1 --model graphsage --n-layers 4 --n-hidden 256 --use-pp --spmm hybrid --use-pallas --dropout 0.5 --fix-seed --part-path $W/parts --cache-dir $W/cache"
RECIPE="--dtype bfloat16 --spmm auto --use-pallas --halo-wire int8"
run() {  # tree label extra...
  local tree=$1 label=$2; shift 2
  local t0=$(date +%s)
  (cd "$tree" && python3 -m bnsgcn_tpu_torch.epoch_profile $COMMON "$@") \
    > "$OUT/$label.log" 2>&1
  echo "$label rc=$? $(( $(date +%s) - t0 ))s $(grep 'epoch wall' "$OUT/$label.log")"
}
run "$OTHER" f32_other_1
run "$ROOT" f32_this_1
run "$ROOT" f32_this_2
run "$OTHER" f32_other_2
run "$OTHER" recipe_other_1 $RECIPE
run "$ROOT" recipe_this_1 $RECIPE
run "$ROOT" recipe_this_2 $RECIPE
run "$OTHER" recipe_other_2 $RECIPE
python3 -m bnsgcn_tpu_torch.epoch_profile --dataset synth-reddit:0.5 \
  --n-partitions 4 --dist-backend gloo --inductive --sampling-rate 0.1 \
  --model graphsage --n-layers 4 --n-hidden 256 --use-pp --spmm hybrid \
  --use-pallas --dropout 0.5 --fix-seed --part-path "$W/parts4" \
  --cache-dir "$W/cache4" > "$OUT/p4.log" 2>&1
echo "p4 rc=$?"
grep -v '^{' "$OUT/p4.log" | tail -70
