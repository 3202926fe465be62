#!/bin/bash
# BASELINE config 5 (scripts/ogbn-papers100m.sh) through the PyTorch/CUDA
# port: ogbn-papers100M, GCN 3x128, P=64, rate 0.01, multi-host. The dataset
# is read from --data-path's ogbn_papers100M/ (OGB's binary layout; default
# ./dataset/).
#
# Step 1 - partition offline on a high-RAM host and share (or copy) the
# artifact directory before launching; the streaming builder keeps one part
# resident and stores the 111M x 128 features as bf16, half the bytes:
#   PARTITION=1 bash scripts/ogbn-papers100m_torch.sh
#
# Step 2 - one launcher per node, all nodes at once; node 0 serves the
# launchers' store at $MASTER:$PORT and the ranks meet at $MASTER:$PORT+1.
# Node k starts ranks [k*PPN, min((k+1)*PPN, P)):
#   node 0:  NODE_RANK=0 bash scripts/ogbn-papers100m_torch.sh
#   node k:  NODE_RANK=k MASTER=node0-addr bash scripts/ogbn-papers100m_torch.sh
# nccl (the default --dist-backend) runs one rank per card, so PPN may not
# exceed a node's cards; append --dist-backend gloo to run more ranks than
# cards (they share the cards, collectives staged through host memory).
# Append --cache-dir DIR to keep each rank's layouts across relaunches.
NODES=${NODES:-16}
NODE_RANK=${NODE_RANK:-0}
MASTER=${MASTER:-127.0.0.1}

if [ -n "$PARTITION" ]; then
  exec "${PYTHON:-python3}" -m bnsgcn_tpu_torch.partition_cli \
    --dataset ogbn-papers100m --n-partitions ${P:-64} \
    --streaming-artifacts always --feat-storage bfloat16 "$@"
fi

"${PYTHON:-python3}" -m bnsgcn_tpu_torch.main \
  --dataset ogbn-papers100m \
  --model gcn \
  --n-partitions ${P:-64} \
  --n-layers 3 \
  --n-hidden 128 \
  --sampling-rate 0.01 \
  --dropout 0.3 \
  --lr 0.003 \
  --n-epochs 200 \
  --log-every 10 \
  --use-pp \
  --dtype bfloat16 \
  --halo-wire fp8 \
  --eval-device mesh \
  --n-nodes $NODES --node-rank $NODE_RANK --master-addr $MASTER \
  --port ${PORT:-18118} --parts-per-node ${PPN:-4} \
  --skip-partition \
  "$@"
