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

from bnsgcn_tpu_torch.data.artifacts import (build_artifacts, load_artifacts,
                                             save_artifacts)
from bnsgcn_tpu_torch.data.graph import sbm_graph, synthetic_graph
from bnsgcn_tpu_torch.data.partitioner import partition_graph
from bnsgcn_tpu_torch.ops import block_spmm
from bnsgcn_tpu_torch.ops.bucket_reduce import (bucket_reduce,
                                                bucket_reduce_plain,
                                                launches as k3_launches)
from bnsgcn_tpu_torch.ops.bucket_sum import (bucket_sum, bucket_sum_plain,
                                             launches as k1_launches)
from bnsgcn_tpu_torch.ops.copy_probe import (PROBE_SHAPE, copy_probe,
                                             launches as k4_launches)
from bnsgcn_tpu_torch.ops.tile_matmul import (launches as k2_launches,
                                              row_offsets, tile_matmul,
                                              tile_matmul_plain)
from bnsgcn_tpu_torch.parallel.halo import (halo_apply, make_halo_plan,
                                            make_halo_spec)
from bnsgcn_tpu_torch.parallel.mesh import launch

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 16, 602), (40, 8, 256), (30, 3, 7)])
def test_bucket_reduce_kernel_matches_plain(cuda, shape, dtype):
    """All vector widths (16/8/4-byte and scalar rows). The kernel sums in
    f32 in the plain version's order and rounds once, so the results are
    bitwise equal."""
    gen = torch.Generator(device=cuda).manual_seed(shape[2])
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    before = k3_launches.total
    out = bucket_reduce(x)
    torch.cuda.synchronize()
    assert k3_launches.total == before + 1
    assert out.dtype == dtype
    assert torch.equal(out, bucket_reduce_plain(x))


@pytest.mark.cuda
def test_copy_probe_kernel_is_bitwise(cuda):
    x = torch.randn(PROBE_SHAPE, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    before = k4_launches.total
    out = copy_probe(x)
    torch.cuda.synchronize()
    assert k4_launches.total == before + 1
    assert torch.equal(out, x[0:1])
    with pytest.raises(ValueError):
        copy_probe(torch.zeros(2, 3, device=cuda))        # x[0] is 12 bytes
    with pytest.raises(ValueError):
        copy_probe(torch.zeros(2, 8192, device=cuda))     # over the buffer


def _halo_job(ctx, path, h, cot):
    art = load_artifacts(path, parts=[ctx.rank])
    spec, tables = make_halo_spec(art.n_b, art.pad_inner, art.pad_boundary,
                                  1.0)
    plan = make_halo_plan(spec, tables,
                          torch.from_numpy(art.bnd[0]).to(ctx.device),
                          ctx.rank)
    x = torch.from_numpy(h[ctx.rank]).to(ctx.device).requires_grad_(True)
    y = halo_apply(spec, plan, x, ctx.comm)
    (y * torch.from_numpy(cot[ctx.rank]).to(ctx.device)).sum().backward()
    return y.detach().cpu().numpy(), x.grad.cpu().numpy()


@pytest.mark.cuda
def test_halo_exchange_over_gloo_on_one_card(cuda, tmp_path):
    """Two ranks sharing the card over gloo, which takes the CUDA tensors
    itself, exchange what two CPU ranks exchange: the forward is copies
    (bitwise), the backward sums a few terms (1e-6)."""
    g = synthetic_graph(n_nodes=90, avg_degree=6, n_feat=6, n_class=4,
                        seed=31)
    art = build_artifacts(g, partition_graph(g, 2, method="random", seed=3))
    save_artifacts(art, str(tmp_path))
    rng = np.random.default_rng(0)
    h = rng.normal(size=(2, art.pad_inner, 5)).astype(np.float32)
    cot = rng.normal(size=(2, art.n_ext, 5)).astype(np.float32)
    args = [(str(tmp_path), h, cot)] * 2
    on_card = launch(_halo_job, 2, args, "gloo", "cuda")
    on_cpu = launch(_halo_job, 2, args, "gloo", "cpu")
    for (y, dx), (y_ref, dx_ref) in zip(on_card, on_cpu):
        np.testing.assert_array_equal(y, y_ref)
        np.testing.assert_allclose(dx, dx_ref, rtol=1e-6, atol=1e-6)
    assert np.abs(on_cpu[0][0][art.pad_inner:]).sum() > 0
