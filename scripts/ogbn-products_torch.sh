#!/bin/bash
# ogbn-products recipe (scripts/ogbn-products.sh, the reference's) through
# the PyTorch/CUDA port: GraphSAGE 3x128, P-partition BNS at rate 0.1,
# precompute, transductive. Reads the OGB layout under --data-path's
# ogbn_products/ (default ./dataset/). Append --dist-backend gloo to run P
# ranks on fewer cards than P. Flags appended here override the recipe's.
"${PYTHON:-python3}" -m bnsgcn_tpu_torch.main \
  --dataset ogbn-products \
  --dropout 0.3 \
  --lr 0.003 \
  --n-partitions ${P:-10} \
  --n-epochs 500 \
  --model graphsage \
  --sampling-rate 0.1 \
  --n-layers 3 \
  --n-hidden 128 \
  --log-every 10 \
  --use-pp \
  "$@"
