"""Partition parallelism for the PyTorch port: one process per part, the halo
exchange and the gradient reduce over torch.distributed (counterpart of
bnsgcn_tpu/parallel/)."""
