#!/bin/bash
# Flagship Reddit recipe (scripts/reddit.sh) through the PyTorch/CUDA port:
# GraphSAGE 4x256, P-partition BNS at rate 0.1, precompute, inductive.
# The real Reddit is read from --data-path's reddit/ (DGL's npz; default
# ./dataset/); append
#   --dataset synth-reddit:1.0
# for its synthetic twin, --model gat --heads 2 for GAT on the same
# recipe, and --dist-backend gloo to run P ranks on fewer cards than P.
# Flags appended here override the recipe's.
"${PYTHON:-python3}" -m bnsgcn_tpu_torch.main \
  --dataset reddit \
  --dropout 0.5 \
  --lr 0.01 \
  --n-partitions ${P:-8} \
  --n-epochs 3000 \
  --model graphsage \
  --sampling-rate 0.1 \
  --n-layers 4 \
  --n-hidden 256 \
  --log-every 10 \
  --use-pp \
  --inductive \
  "$@"
