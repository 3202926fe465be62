#!/bin/bash
# Sweep P x sampling_rate through the PyTorch port (scripts/ogbn-products_full.sh's
# grid, the reference's), teeing into results/.
mkdir -p results
for P in 5 8 10; do
  for RATE in 0.1 0.01 0.0; do
    P=$P bash scripts/ogbn-products_torch.sh --sampling-rate $RATE --no-eval \
      | tee results/ogbn-products_n${P}_p${RATE}.log
  done
done
