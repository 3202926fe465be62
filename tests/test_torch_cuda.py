"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips without a GPU. This file imports neither jax
nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerance: rtol 1e-5, atol 1e-4 -- f32 sums of up to a few hundred terms
of unit scale, taken in another order by the kernel and by PyTorch.
"""

import numpy as np
import pytest
import torch

from bnsgcn_tpu_torch.data.artifacts import build_artifacts
from bnsgcn_tpu_torch.data.graph import sbm_graph
from bnsgcn_tpu_torch.data.partitioner import partition_graph
from bnsgcn_tpu_torch.ops import block_spmm
from bnsgcn_tpu_torch.ops.bucket_sum import (bucket_sum, bucket_sum_plain,
                                             launches as k1_launches)
from bnsgcn_tpu_torch.ops.tile_matmul import (launches as k2_launches,
                                              row_offsets, tile_matmul,
                                              tile_matmul_plain)

TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _layout(tile):
    g = sbm_graph(n_nodes=600, n_class=5, n_feat=6, p_in=0.15, p_out=0.003,
                  seed=67)
    art = build_artifacts(g, partition_graph(g, 1))
    pi, pe = block_spmm.cluster_order(art.src[0], art.dst[0], art.pad_inner,
                                      art.n_ext, target=tile,
                                      log=lambda m: None)
    return art, block_spmm.build_block_layouts(
        art.src, art.dst, art.pad_inner, art.n_ext, pi[None], pe[None],
        occupancy_min=4, tile_r=tile, tile_c=tile)


@pytest.mark.cuda
@pytest.mark.parametrize("h_dim", [256, 602, 7])
def test_bucket_sum_kernel_matches_plain(cuda, h_dim):
    """All three vector widths (float4 / float2 / scalar rows); index 500
    is the pad and contributes nothing."""
    gen = torch.Generator(device=cuda).manual_seed(h_dim)
    h = torch.randn(500, h_dim, generator=gen, device=cuda)
    idx = torch.randint(0, 501, (64, 40), generator=gen, device=cuda,
                        dtype=torch.int32)
    idx[0] = 500
    before = k1_launches.total
    out = bucket_sum(h, idx)
    torch.cuda.synchronize()
    assert k1_launches.total == before + 1
    torch.testing.assert_close(out, bucket_sum_plain(h, idx), **TOL)
    assert bool((out[0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("h_dim", [256, 602])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_tile_matmul_kernel_matches_plain(cuda, h_dim, direction):
    art, (fwd, bwd, _, arrays) = _layout(64)
    spec = fwd if direction == "fwd" else bwd
    a = {k: torch.from_numpy(np.ascontiguousarray(v[0])).to(cuda)
         for k, v in arrays.items()}
    perm = a["blk_perm_ext" if direction == "fwd" else "blk_perm_inner"]
    gen = torch.Generator(device=cuda).manual_seed(h_dim)
    h = torch.randn(spec.n_src, h_dim, generator=gen, device=cuda)
    x = block_spmm.build_x_slabs(spec, perm, h)
    rowb = a[f"blk_rowb_{direction}"]
    tiles, colb = a[f"blk_tiles_{direction}"], a[f"blk_colb_{direction}"]
    before = k2_launches.total
    out = tile_matmul(tiles, rowb, colb, row_offsets(rowb, spec.n_row_blocks),
                      x, spec.n_row_blocks)
    torch.cuda.synchronize()
    assert k2_launches.total == before + 1
    torch.testing.assert_close(
        out, tile_matmul_plain(tiles, rowb, colb, x, spec.n_row_blocks), **TOL)


@pytest.mark.cuda
def test_tile_matmul_rejects_what_the_kernel_does_not_take(cuda):
    tiles = torch.zeros(1, 48, 64, dtype=torch.int8, device=cuda)
    ids = torch.zeros(1, dtype=torch.int32, device=cuda)
    off = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    x = torch.zeros(1, 64, 8, device=cuda)
    with pytest.raises(ValueError):
        tile_matmul(tiles, ids, ids, off, x, 1)     # TR % 64 != 0
    with pytest.raises(ValueError):
        tile_matmul(tiles[:, :, :32].contiguous(), ids, ids, off, x, 1)
    with pytest.raises(ValueError):
        bucket_sum(x[0].double(), ids[None])        # f64 rows
