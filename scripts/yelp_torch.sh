#!/bin/bash
# Yelp recipe (scripts/yelp.sh, the reference's scripts/yelp.sh) through the
# PyTorch/CUDA port: GraphSAGE 4 layers h=512 with 2 linear tail layers,
# multilabel BCE, P-partition BNS at rate 0.1, precompute, inductive. Reads
# the GraphSAINT layout under --data-path (default ./dataset/):
# yelp/adj_full.npz, feats.npy, class_map.json, role.json. Append
# --dist-backend gloo to run P ranks on fewer cards than P. Flags appended
# here override the recipe's.
"${PYTHON:-python3}" -m bnsgcn_tpu_torch.main \
  --dataset yelp \
  --dropout 0.1 \
  --lr 0.001 \
  --n-partitions ${P:-10} \
  --n-epochs 3000 \
  --model graphsage \
  --sampling-rate 0.1 \
  --n-layers 4 \
  --n-linear 2 \
  --n-hidden 512 \
  --log-every 10 \
  --use-pp \
  --inductive \
  "$@"
