"""bnsgcn_tpu_torch: the PyTorch/CUDA port of bnsgcn_tpu.

A package beside the JAX one, ported slice by slice; bnsgcn_tpu stays the
reference the port is tested against. It trains GraphSAGE/GCN on one GPU or
on P ranks, with boundary-node sampling at any rate in (0, 1] drawn from the
JAX package's own threefry stream, through the ELL and the hybrid SpMM,
whose aggregation runs hand-written CUDA kernels (csrc/).

    python -m bnsgcn_tpu_torch.main --dataset synth-reddit:0.25 \\
        --model graphsage --n-layers 4 --n-hidden 256 --use-pp \\
        --spmm hybrid --use-pallas --n-epochs 20 \\
        --n-partitions 4 --sampling-rate 0.1 --dist-backend gloo

The port imports torch and numpy only: never jax, and nothing of bnsgcn_tpu.
"""
