#!/bin/bash
# Offline smoke run of the PyTorch port (scripts/sbm_demo.sh's): 8 ranks
# over gloo on the CPU, no dataset download, no card needed.
"${PYTHON:-python3}" -m bnsgcn_tpu_torch.main \
  --dataset sbm --n-partitions 8 --model graphsage \
  --n-layers 3 --n-hidden 32 --n-epochs 50 --log-every 10 \
  --sampling-rate 0.5 --use-pp --fix-seed \
  --device cpu --dist-backend gloo "$@"
