"""bnsgcn_tpu_torch: the PyTorch/CUDA port of bnsgcn_tpu.

A package beside the JAX one, ported slice by slice; bnsgcn_tpu stays the
reference the port is tested against. This slice trains GraphSAGE/GCN on one
GPU at P=1 and sampling rate 1.0 through the ELL and the hybrid SpMM, whose
aggregation runs two hand-written CUDA kernels (csrc/).

    python -m bnsgcn_tpu_torch.main --dataset synth-reddit:0.25 \\
        --model graphsage --n-layers 4 --n-hidden 256 --use-pp \\
        --spmm hybrid --use-pallas --n-epochs 20

The port imports torch and numpy only: never jax, and nothing of bnsgcn_tpu.
"""
