#!/bin/bash
# Multi-node flow of the PyTorch port (scripts/reddit_multi_node.sh's):
# partition once on node 0, then one launcher per node, whose ranks meet at
# node 0 (MASTER, --port and --port + 1).
#   node 0:  NODE_RANK=0 bash scripts/reddit_multi_node_torch.sh
#   node i:  NODE_RANK=i MASTER=node0-addr bash scripts/reddit_multi_node_torch.sh
NODES=${NODES:-4}
NODE_RANK=${NODE_RANK:-0}
MASTER=${MASTER:-127.0.0.1}

if [ "$NODE_RANK" = "0" ]; then
  "${PYTHON:-python3}" -m bnsgcn_tpu_torch.partition_cli --dataset reddit \
    --n-partitions ${P:-40} --inductive
fi

P=${P:-40} bash scripts/reddit_torch.sh \
  --n-nodes $NODES --node-rank $NODE_RANK --master-addr $MASTER \
  --skip-partition "$@"
