#!/bin/bash
# Sweep P x sampling_rate through the PyTorch port (scripts/reddit_full.sh's
# grid, the reference's), teeing into results/.
mkdir -p results
for P in 2 4 8; do
  for RATE in 0.1 0.01 0.0; do
    P=$P bash scripts/reddit_torch.sh --sampling-rate $RATE --no-eval \
      | tee results/reddit_n${P}_p${RATE}.log
  done
done
