"""The port's CUDA kernels against their plain PyTorch versions, on the card
(and the BNS draw on the card against the CPU's).

Marked `cuda`; each test skips without a GPU. This file imports neither jax
nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerance: rtol 1e-5, atol 1e-4 -- f32 sums of up to a few hundred terms
of unit scale, taken in another order by the kernel and by PyTorch; K2 on
the skewed layout, whose rows sum hundreds of terms up to 127 |x|, and K1,
whose long rows sum over a thousand, are held to the per-element bound of
chip_smoke.py instead: 2 n u sum|x|, n the row's terms (+1 with a base),
u = 2^-24.
"""

import numpy as np
import pytest
import torch

from bnsgcn_tpu_torch.data.artifacts import (build_artifacts, load_artifacts,
                                             save_artifacts)
from bnsgcn_tpu_torch.data.graph import sbm_graph, synthetic_graph
from bnsgcn_tpu_torch.data.partitioner import partition_graph
from bnsgcn_tpu_torch import buildlib
from bnsgcn_tpu_torch.ops import block_spmm, bucket_reduce as k3_mod
from bnsgcn_tpu_torch.ops import copy_probe as k4_mod
from bnsgcn_tpu_torch.ops import ell as t_ell
from bnsgcn_tpu_torch.ops.bucket_reduce import (bucket_reduce,
                                                bucket_reduce_plain,
                                                launches as k3_launches)
from bnsgcn_tpu_torch.ops.bucket_sum import (CHUNKS, LONG_ROW, ORDERS,
                                             ell_apply, ell_apply_plain,
                                             launches as k1_launches,
                                             pack_rows)
from bnsgcn_tpu_torch.ops.copy_probe import (PROBE_SHAPE, copy_probe,
                                             copy_probe_plain,
                                             launches as k4_launches)
from bnsgcn_tpu_torch.ops.tile_matmul import (MAX_TC,
                                              launches as k2_launches,
                                              pack_tiles, row_offsets,
                                              tile_matmul, tile_matmul_plain)
from bnsgcn_tpu_torch.parallel.halo import (halo_apply, make_halo_plan,
                                            make_halo_spec)
from bnsgcn_tpu_torch.parallel.mesh import launch
from bnsgcn_tpu_torch.parallel.sampling import pair_key, pair_sample
from bnsgcn_tpu_torch.utils import prng

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


def _ell_rows(device, long_hub=True):
    """An ELL layout on the card with every kind of row: split rows (degree
    > 128, a power-law graph), a hub past the long-row threshold, degree-0
    rows (the padded ones) and multi-edges."""
    g = synthetic_graph(n_nodes=400, avg_degree=40, n_feat=6, seed=5,
                        power_law=True)
    art = build_artifacts(g, partition_graph(g, 1))
    src, dst = art.src[0], art.dst[0]
    keep = ~np.isin(src, (3, 50)) & ~np.isin(dst, (3, 50))   # degree 0
    src, dst = src[keep], dst[keep]
    if long_hub:
        hub = np.arange(LONG_ROW + 300) % art.pad_inner
        hub = hub[~np.isin(hub, (3, 50))]
        src = np.concatenate([src, hub])
        dst = np.concatenate([dst, np.full(len(hub), 9)])
    fs, bs, arrays = t_ell.build_layouts(
        src.astype(np.int32)[None], dst.astype(np.int32)[None],
        art.pad_inner, art.n_ext)
    return t_ell.EllSpmm(fs, bs, {k: torch.from_numpy(
        np.ascontiguousarray(v[0])).to(device) for k, v in arrays.items()})


def _k1_matches_plain(rows, h, base=None, base_row=None, **kw):
    """K1 against ell_apply_plain within 2 n u sum|x| per element, and
    bitwise equal to itself on a second call; one launch per call."""
    before = k1_launches.total
    out = ell_apply(rows, h, base, base_row, **kw)
    again = ell_apply(rows, h, base, base_row, **kw)
    torch.cuda.synchronize()
    assert k1_launches.total == before + (2 if rows.n_rows else 0)
    ref = ell_apply_plain(rows, h, base, base_row)
    n = (rows.row_ptr[1:] - rows.row_ptr[:-1]).long()[:, None]
    if base is not None:
        n = n + 1
    bound = 2 * n.clamp(min=1) * 2.0 ** -24 * ell_apply_plain(
        rows, h.abs(), None if base is None else base.abs(), base_row)
    assert bool(torch.isfinite(out).all())
    assert bool(((out - ref).abs() <= bound).all())
    assert torch.equal(out, again)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("h_dim", [1, 7, 33, 256, 602])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("with_base", [False, True])
def test_bucket_sum_kernel_matches_plain(cuda, h_dim, direction, with_base):
    """The one-launch ELL SpMM at every vector width (float4 at 256, float2
    at 602, scalars at 1, 7, 33; 33 and 602 leave a ragged last column
    chunk), both directions, with and without a base; split rows, a long
    row and degree-0 rows in the layout."""
    op = _ell_rows(cuda)
    rows = op.rows[direction]
    assert rows.spec.n_split > 0
    if direction == "fwd":
        assert rows.n_long >= 1
    gen = torch.Generator(device=cuda).manual_seed(h_dim)
    h = torch.randn(rows.n_src, h_dim, generator=gen, device=cuda)
    base = base_row = None
    if with_base:
        base = torch.randn(rows.n_rows + 7, h_dim, generator=gen, device=cuda)
        base_row = torch.randperm(rows.n_rows + 7, generator=gen,
                                  device=cuda)[:rows.n_rows].to(torch.int32)
    out = _k1_matches_plain(rows, h, base, base_row)
    empty = rows.row_ptr[1:] == rows.row_ptr[:-1]
    assert bool(empty.any())
    expect = 0.0 if base is None else base[base_row.long()][empty]
    assert bool((out[empty] == expect).all())


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("order", ORDERS)
def test_bucket_sum_kernel_each_chunk_and_order(cuda, chunk, order):
    """Every column chunk and work order gives the same bits: a row's terms
    are summed in the same order whichever CTA takes it. A long-row
    threshold of 64 sends many rows down the CTA path."""
    op = _ell_rows(cuda)
    rows = op.rows["fwd"]
    pos = torch.randperm(rows.n_rows, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(chunk)
    for h_dim in (256, 33):
        h = torch.randn(rows.n_src, h_dim, generator=gen, device=cuda)
        ref = ell_apply(rows, h)
        for long_row in (LONG_ROW, 64):
            r = rows.with_order(order, pos, long_row=long_row)
            out = _k1_matches_plain(r, h, chunk=chunk)
            if long_row == LONG_ROW:
                assert torch.equal(out, ref)
            else:
                assert r.n_long > 10


@pytest.mark.cuda
def test_bucket_sum_kernel_on_an_empty_layout(cuda):
    """A layout without edges: K1 still launches, writes zeros, or the base
    rows alone."""
    n_rows, n_src = 40, 30
    fs, bs, arrays = t_ell.build_layouts(
        np.zeros((1, 8), np.int32), np.full((1, 8), n_rows, np.int32),
        n_rows, n_src)
    op = t_ell.EllSpmm(fs, bs, {k: torch.from_numpy(v[0]).to(cuda)
                                for k, v in arrays.items()})
    rows = op.rows["fwd"]
    assert rows.src.numel() == 0
    h = torch.randn(n_src, 12, device=cuda)
    out = _k1_matches_plain(rows, h)
    assert bool((out == 0).all())
    base = torch.randn(n_rows, 12, device=cuda)
    br = torch.randperm(n_rows, device=cuda).to(torch.int32)
    assert torch.equal(_k1_matches_plain(rows, h, base, br), base[br.long()])


@pytest.mark.cuda
def test_bucket_sum_kernel_in_the_hybrid(cuda):
    """The hybrid SpMM on the card (K2's output as K1's base, gathered back
    to row order in K1) against the same operator on the CPU."""
    art, (fwd, bwd, pair, arrays) = _layout(64)
    a = {k: torch.from_numpy(np.ascontiguousarray(v[0])) for k, v in
         arrays.items()}
    on_cpu = block_spmm.BlockSpmm(fwd, bwd, pair, a)
    on_card = block_spmm.BlockSpmm(fwd, bwd, pair,
                                   {k: v.to(cuda) for k, v in a.items()})
    rng = np.random.default_rng(0)
    for d, spec in (("fwd", fwd), ("bwd", bwd)):
        h = torch.from_numpy(rng.normal(size=(spec.n_src, 48)).astype(
            np.float32))
        before = k1_launches.total
        got = on_card.apply_dir(d, h.to(cuda), "check")
        torch.cuda.synchronize()
        assert k1_launches.total == before + 1
        torch.testing.assert_close(got.cpu(), on_cpu.apply_dir(d, h, "check"),
                                   **TOL)


@pytest.mark.cuda
def test_bucket_sum_rejects_what_the_kernel_does_not_take(cuda):
    rows = _ell_rows(cuda, long_hub=False).rows["fwd"]
    h = torch.randn(rows.n_src, 8, device=cuda)
    base = torch.randn(rows.n_rows, 8, device=cuda)
    br = torch.arange(rows.n_rows, device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError):                     # f64 rows
        ell_apply(rows, h.double())
    with pytest.raises(ValueError):                     # not contiguous
        ell_apply(rows, torch.randn(8, rows.n_src, device=cuda).t())
    with pytest.raises(ValueError):                     # too few rows
        ell_apply(rows, h[:-1].contiguous())
    with pytest.raises(ValueError):                     # base without rows
        ell_apply(rows, h, base)
    with pytest.raises(ValueError):                     # int64 base rows
        ell_apply(rows, h, base, br.long())
    with pytest.raises(ValueError):                     # base on the CPU
        ell_apply(rows, h, base.cpu(), br)
    with pytest.raises(ValueError):                     # base of another H
        ell_apply(rows, h, base[:, :4].contiguous(), br)
    with pytest.raises(ValueError):                     # no such chunk
        ell_apply(rows, h, chunk=128)
    cpu_rows = pack_rows(rows.spec, [t.cpu() for t in rows.idx],
                         rows.perm.cpu(), rows.chunk_pos.cpu(),
                         rows.chunk_seg.cpu())
    with pytest.raises(ValueError):                     # schedule on the CPU
        ell_apply(cpu_rows, h)


def _k2_matches_plain(tiles, rowb, colb, x, n_row_blocks,
                      per_element=False):
    """K2 on the packed entries against the plain version on the dense
    tiles; row-blocks that no tile visits must come out zero. per_element:
    hold each element to 2 n u sum|a x| (n the row's nonzero terms, u =
    2^-24: two f32 sums of the same n products in different orders) instead
    of TOL, for rows of hundreds of terms up to 127 x |x|."""
    off = row_offsets(rowb, n_row_blocks)
    ent, ent_off = pack_tiles(tiles)
    before = k2_launches.total
    out = tile_matmul(tiles, rowb, colb, off, ent, ent_off, x, n_row_blocks)
    torch.cuda.synchronize()
    assert k2_launches.total == before + 1
    ref = tile_matmul_plain(tiles, rowb, colb, x, n_row_blocks)
    if per_element:
        n_row = torch.zeros((n_row_blocks + 1, tiles.shape[1]),
                            dtype=torch.int64, device=x.device).index_add_(
            0, rowb.long(), (tiles != 0).sum(-1))[:n_row_blocks, :, None]
        bound = 2 * n_row.clamp(min=1) * 2.0 ** -24 * tile_matmul_plain(
            tiles.abs(), rowb, colb, x.abs(), n_row_blocks)
        assert bool(torch.isfinite(out).all())
        assert bool(((out - ref).abs() <= bound).all())
    else:
        torch.testing.assert_close(out, ref, **TOL)
    unvisited = off[1:] == off[:-1]
    assert bool((out[unvisited] == 0).all())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("h_dim", [256, 602, 1, 33])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_tile_matmul_kernel_matches_plain(cuda, h_dim, direction):
    """float4, float2 (602) and scalar (1, 33) slab copies; 33 leaves a
    ragged last column chunk."""
    art, (fwd, bwd, _, arrays) = _layout(64)
    spec = fwd if direction == "fwd" else bwd
    a = {k: torch.from_numpy(np.ascontiguousarray(v[0])).to(cuda)
         for k, v in arrays.items()}
    perm = a["blk_perm_ext" if direction == "fwd" else "blk_perm_inner"]
    gen = torch.Generator(device=cuda).manual_seed(h_dim)
    h = torch.randn(spec.n_src, h_dim, generator=gen, device=cuda)
    x = block_spmm.build_x_slabs(spec, perm, h)
    _k2_matches_plain(a[f"blk_tiles_{direction}"], a[f"blk_rowb_{direction}"],
                      a[f"blk_colb_{direction}"], x, spec.n_row_blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("tr,tc,h_dim", [(512, 512, 256), (600, 96, 33),
                                         (48, MAX_TC, 602)])
def test_tile_matmul_kernel_on_a_skewed_layout(cuda, tr, tc, h_dim):
    """Row-block 0 owns many tiles, row-block 1 none, row-block 2 one tile
    with a dense row (every column, multiplicities up to 127) beside sparse
    ones; a pad tile follows. TR = 600 spans two 512-row slices, TC = 908
    fills both shared-memory stages."""
    gen = torch.Generator(device=cuda).manual_seed(tr + tc)
    n_many, n_cb = 40, 41
    b = n_many + 2
    tiles = (torch.rand(b, tr, tc, generator=gen, device=cuda) < 0.03).to(
        torch.int8)
    tiles *= torch.randint(1, 128, (b, tr, tc), generator=gen, device=cuda,
                           dtype=torch.int8)
    tiles[n_many, tr // 3, :] = torch.randint(
        1, 128, (tc,), generator=gen, device=cuda, dtype=torch.int8)
    tiles[-1] = 0                                       # the pad
    rowb = torch.tensor([0] * n_many + [2, 3], dtype=torch.int32,
                        device=cuda)
    colb = torch.cat([torch.randperm(n_cb, generator=gen, device=cuda)[
        :n_many], torch.tensor([5, 0], device=cuda)]).to(torch.int32)
    x = torch.randn(n_cb, tc, h_dim, generator=gen, device=cuda)
    out = _k2_matches_plain(tiles, rowb, colb, x, 3, per_element=True)
    assert bool((out[1] == 0).all())


@pytest.mark.cuda
def test_tile_matmul_rejects_what_the_kernel_does_not_take(cuda):
    tiles = torch.zeros(1, 48, MAX_TC + 1, dtype=torch.int8, device=cuda)
    ids = torch.zeros(1, dtype=torch.int32, device=cuda)
    off = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    ent, ent_off = pack_tiles(tiles)
    x = torch.zeros(1, MAX_TC + 1, 8, device=cuda)
    with pytest.raises(ValueError):                 # TC > MAX_TC
        tile_matmul(tiles, ids, ids, off, ent, ent_off, x, 1)
    t64, x64 = tiles[:, :, :64].contiguous(), x[:, :64].contiguous()
    e64, o64 = pack_tiles(t64)
    tile_matmul(t64, ids, ids, off, e64, o64, x64, 1)   # takes any TR
    with pytest.raises(ValueError):                 # ent_off for TR + 2
        tile_matmul(t64, ids, ids, off, e64,
                    torch.zeros(1, 50, dtype=torch.int32, device=cuda), x64,
                    1)
    with pytest.raises(ValueError):                 # int64 entries
        tile_matmul(t64, ids, ids, off, e64.long(), o64, x64, 1)
    with pytest.raises(ValueError):                 # slabs of another TC
        tile_matmul(t64, ids, ids, off, e64, o64, x[:, :32].contiguous(), 1)


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
    with pytest.raises(ValueError):
        copy_probe(x.double())
    with pytest.raises(ValueError):
        copy_probe(x.transpose(1, 2))                     # not contiguous


@pytest.mark.cuda
def test_small_kernels_through_the_lean_launch_path(cuda):
    """K3 and K4 resolve their C entry points once; on a side stream they
    launch there, and stay within bound (K3, bitwise) and bitwise (K4) over
    many calls."""
    x = torch.randn(PROBE_SHAPE, device=cuda)
    g = torch.randn(64, 16, 602, device=cuda)
    copy_probe(x)
    bucket_reduce(g)
    calls = (k3_mod._kernel._call, k4_mod._kernel._call)
    assert all(c is not None for c in calls)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert buildlib.raw_stream(x.get_device()) == side.cuda_stream
        outs = [copy_probe(x) for _ in range(50)]
        sums = [bucket_reduce(g) for _ in range(5)]
    torch.cuda.synchronize()
    assert (k3_mod._kernel._call, k4_mod._kernel._call) == calls
    assert all(torch.equal(o, copy_probe_plain(x)) for o in outs)
    assert all(torch.equal(s, bucket_reduce_plain(g)) for s in sums)


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


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_bns_plan_on_the_card_is_the_cpu_plan(cuda, rate):
    """The BNS draw is integer ops, a stable sort and indexing: every
    rank's plan built on the card is the CPU's, array for array, for three
    epochs; so is a draw over a 29,711-node boundary list, which holds tied
    scores."""
    g = synthetic_graph(n_nodes=400, avg_degree=8, n_feat=6, n_class=4,
                        seed=31)
    art = build_artifacts(g, partition_graph(g, 4, method="random", seed=3))
    spec, tables = make_halo_spec(art.n_b, art.pad_inner, art.pad_boundary,
                                  rate)
    for r in range(4):
        bnd = torch.from_numpy(art.bnd[r])
        for e in range(3):
            on_cpu = make_halo_plan(spec, tables, bnd, r, e, prng.key(7))
            on_card = make_halo_plan(spec, tables, bnd.to(cuda), r, e,
                                     prng.key(7, cuda))
            for name in ("sel", "weight", "slots"):
                got = getattr(on_card, name)
                assert got.device.type == "cuda"
                assert torch.equal(got.cpu(), getattr(on_cpu, name)), name
    keys = pair_key(prng.key(5), 2, torch.arange(4), 1)
    n = torch.tensor([29711, 29000, 100, 0])
    s = (n.double() * rate).long()
    want = pair_sample(keys, n, s, 29711, 29711)
    got = pair_sample(keys.to(cuda), n.to(cuda), s.to(cuda), 29711, 29711)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
