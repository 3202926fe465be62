"""The port's CUDA kernels against their plain PyTorch versions, on the card
(and the BNS draw on the card against the CPU's; checkpoints of card
tensors, and a P=1 resume on the card against the uninterrupted run).

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
from bnsgcn_tpu_torch.ops.bucket_sum import (LONG_ROW, ell_apply,
                                             ell_apply_plain,
                                             launches as k1_launches,
                                             pack_rows)
from bnsgcn_tpu_torch.ops.copy_probe import (PROBE_SHAPE, copy_probe,
                                             copy_probe_plain,
                                             launches as k4_launches)
from bnsgcn_tpu_torch.ops.tile_matmul import (MAX_TC, k_major,
                                              launches as k2_launches,
                                              pack_tiles, row_offsets,
                                              tile_matmul, tile_matmul_plain)
from bnsgcn_tpu_torch.parallel.halo import (halo_apply, make_halo_plan,
                                            make_halo_spec)
from bnsgcn_tpu_torch.parallel.mesh import launch
from bnsgcn_tpu_torch.parallel.sampling import pair_key, pair_sample
from bnsgcn_tpu_torch.utils import prng
from bnsgcn_tpu_torch.utils.quant import f8_quant, i8_quant

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
def test_bucket_sum_kernel_at_any_long_row_threshold(cuda):
    """A threshold of 64 sends many rows down the long-row path, which
    sums a row in its warps' slices: within the bound, repeatable, and a
    row short under both thresholds keeps its bits (the same CTA path, the
    same order, wherever the work order puts it)."""
    op = _ell_rows(cuda)
    rows = op.rows["fwd"]
    gen = torch.Generator(device=cuda).manual_seed(3)
    short = (rows.row_ptr[1:] - rows.row_ptr[:-1]) <= 64
    for h_dim in (256, 33):
        h = torch.randn(rows.n_src, h_dim, generator=gen, device=cuda)
        ref = ell_apply(rows, h)
        r = rows.with_long_row(64)
        assert r.n_long > 10
        assert torch.equal(_k1_matches_plain(r, h)[short], ref[short])


def _k1_lowp(rows, h, base, base_row, scale, out_dtype):
    """(kernel, plain, per-element bound) for rows of a narrow dtype: the
    f32 accumulators of the two versions differ by at most 2 n u sum|x|
    (times the scale); a bf16 out rounds twice (the residual, then base +
    residual), each a half ulp of either side: 2^-7 (|a| + |out|). int8
    rows sum exactly, so their bound is 0."""
    out = ell_apply(rows, h, base, base_row, scale=scale, out_dtype=out_dtype)
    ref = ell_apply_plain(rows, h, base, base_row, scale, out_dtype)
    torch.cuda.synchronize()
    if h.dtype == torch.int8:
        return out, ref, torch.zeros_like(ref, dtype=torch.float32)
    n = (rows.row_ptr[1:] - rows.row_ptr[:-1]).long()[:, None]
    s = 1.0 if scale is None else scale
    mag = ell_apply_plain(rows, h.float().abs(), None, None) * s
    acc = ell_apply_plain(rows, h.float(), None, None) * s
    e = 2 * n.clamp(min=1) * 2.0 ** -24 * mag
    u = 2.0 ** -7 if out_dtype == torch.bfloat16 else 2.0 ** -23
    return out, ref, (1 + 2.0 ** -6) * (
        e + u * (acc.abs() + ref.float().abs()))


_LOWP_K1 = [(r, o, b) for r, o in [
    (torch.int8, torch.int32), (torch.int8, torch.float32),
    (torch.int8, torch.bfloat16), (torch.float8_e4m3fn, torch.float32),
    (torch.float8_e4m3fn, torch.bfloat16), (torch.bfloat16, torch.bfloat16)]
    for b in (False, True) if not (o == torch.int32 and b)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows_dtype,out_dtype,with_base", _LOWP_K1)
@pytest.mark.parametrize("h_dim", [256, 602, 33])
def test_bucket_sum_kernel_low_precision(cuda, rows_dtype, out_dtype,
                                         with_base, h_dim):
    """int8 rows (exact int32 sums: bitwise equal to the plain version in
    every out dtype, the scale and the base applied alike), e4m3 and bf16
    rows (f32 sums) within _k1_lowp's bound, at 16-byte, narrower and
    scalar loads; split rows, a long row and degree-0 rows."""
    op = _ell_rows(cuda)
    rows = op.rows["fwd"]
    gen = torch.Generator(device=cuda).manual_seed(h_dim)
    x = torch.randn(rows.n_src, h_dim, generator=gen, device=cuda)
    if rows_dtype == torch.int8:
        h, scale = i8_quant(x)
    elif rows_dtype == torch.float8_e4m3fn:
        h, scale = f8_quant(x)
    else:
        h, scale = x.to(torch.bfloat16), None
    if out_dtype == torch.int32:
        scale = None
    base = base_row = None
    if with_base:
        base = torch.randn(rows.n_rows + 7, h_dim, generator=gen, device=cuda)
        base_row = torch.randperm(rows.n_rows + 7, generator=gen,
                                  device=cuda)[:rows.n_rows].to(torch.int32)
    before = k1_launches.total
    out, ref, bound = _k1_lowp(rows, h, base, base_row, scale, out_dtype)
    assert k1_launches.total == before + 1
    assert out.dtype == ref.dtype == out_dtype
    if rows_dtype == torch.int8:
        assert torch.equal(out, ref)
    else:
        assert bool(torch.isfinite(out.float()).all())
        assert bool(((out.float() - ref.float()).abs() <= bound).all())
        wrong = ref.float().clone()
        wrong[rows.row_ptr[1:] > rows.row_ptr[:-1]] *= 1.05
        assert not bool(((out.float() - wrong).abs() <= bound).all())
    assert torch.equal(out, ell_apply(rows, h, base, base_row, scale=scale,
                                      out_dtype=out_dtype))


# the row lengths that wrap a 16-bit lane of 255 * 257, and one past 4096
_EDGE_LENS = (1, 255, 256, 257, 258, 513, 4100)
_F8_CODES = [c for c in range(256) if c & 0x7F != 0x7F]    # finite e4m3


def _one_bucket(idx, n_src, device):
    """K1's row schedule of one ELL bucket [r, w] (entries n_src: pads)."""
    r, w = idx.shape
    spec = t_ell.EllSpec(widths=(w,), rows=(r,), n_rows=r, n_src=n_src)
    return pack_rows(spec, [torch.from_numpy(idx).to(device)],
                     torch.arange(r, dtype=torch.int32, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("h_dim", [256, 602, 33])
def test_bucket_sum_kernel_int8_edges(cuda, h_dim):
    """int8 rows where a packed or narrow accumulator would wrap: every
    term 127, every term -128, and mixed signs, at each of _EDGE_LENS terms
    (4100: past the long-row threshold), through the short-row path and,
    at a threshold of 64, the long-row CTAs' slices; bitwise the plain
    version in every out kind, the constant rows at their exact sums."""
    n_src = 64
    rng = np.random.default_rng(h_dim)
    idx = np.full((3 * len(_EDGE_LENS), max(_EDGE_LENS)), n_src, np.int32)
    for i, (lo, hi) in enumerate(((0, 16), (16, 32), (32, 64))):
        for j, n in enumerate(_EDGE_LENS):
            idx[i * len(_EDGE_LENS) + j, :n] = rng.integers(lo, hi, n)
    h = torch.empty((n_src, h_dim), dtype=torch.int8)
    h[:16], h[16:32] = 127, -128
    h[32:] = torch.from_numpy(rng.integers(-128, 128, (32, h_dim)))
    h = h.to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(h_dim)
    scale = torch.tensor(0.0123, device=cuda)
    lens = torch.tensor(_EDGE_LENS, device=cuda)[:, None]
    for long_row in (LONG_ROW, 64):
        rows = _one_bucket(idx, n_src, cuda).with_long_row(long_row)
        assert rows.n_long == (3 if long_row == LONG_ROW else 18)
        base = torch.randn(rows.n_rows, h_dim, generator=gen, device=cuda)
        base_row = torch.randperm(rows.n_rows, generator=gen,
                                  device=cuda).to(torch.int32)
        raw = ell_apply(rows, h)
        torch.cuda.synchronize()
        assert torch.equal(raw, ell_apply_plain(rows, h))
        k = len(_EDGE_LENS)
        assert bool((raw[:k] == 127 * lens).all())
        assert bool((raw[k:2 * k] == -128 * lens).all())
        # a base 4 bytes off 16-byte alignment takes the element-wise
        # epilogue, an aligned one the 16-byte one: the same bits
        odd = torch.empty(base.numel() + 1, device=cuda)[1:].view_as(base)
        odd.copy_(base)
        for out_dtype in (torch.float32, torch.bfloat16):
            for b, br in ((None, None), (base, base_row), (odd, base_row)):
                got = ell_apply(rows, h, b, br, scale=scale,
                                out_dtype=out_dtype)
                assert torch.equal(got, ell_apply_plain(
                    rows, h, b, br, scale, out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("h_dim", [256, 602, 33])
def test_bucket_sum_kernel_every_e4m3_code(cuda, h_dim):
    """e4m3 rows of every finite code (both zeros, the subnormals, +-448):
    one-term rows decode each code to its float32 value exactly; rows of
    every code once (in order, reversed, the positive ones) and a long row
    of each code 17 times sum within _k1_lowp's bound at both long-row
    thresholds, and the control (every non-empty row 5% off) is
    rejected."""
    codes = np.array(_F8_CODES, np.uint8)
    n_src = len(codes)
    bits = codes[(np.arange(n_src)[:, None] + np.arange(h_dim)) % n_src]
    h = torch.from_numpy(bits).view(torch.float8_e4m3fn).to(cuda)
    pos = np.flatnonzero((codes > 0) & (codes < 0x80))
    w = 17 * n_src
    idx = np.full((n_src + 4, w), n_src, np.int32)
    idx[:n_src, 0] = np.arange(n_src)
    idx[n_src, :n_src] = np.arange(n_src)
    idx[n_src + 1, :n_src] = np.arange(n_src)[::-1]
    idx[n_src + 2, :len(pos)] = pos
    idx[n_src + 3] = np.tile(np.arange(n_src), 17)
    gen = torch.Generator(device=cuda).manual_seed(h_dim)
    scale = torch.tensor(0.0123, device=cuda)
    for long_row in (LONG_ROW, 64):
        rows = _one_bucket(idx, n_src, cuda).with_long_row(long_row)
        one = ell_apply(rows, h)                 # f32 sums, no scale
        torch.cuda.synchronize()
        assert torch.equal(one[:n_src], h.float())
        base = torch.randn(rows.n_rows, h_dim, generator=gen, device=cuda)
        base_row = torch.randperm(rows.n_rows, generator=gen,
                                  device=cuda).to(torch.int32)
        for out_dtype in (torch.float32, torch.bfloat16):
            out, ref, bound = _k1_lowp(rows, h, base, base_row, scale,
                                       out_dtype)
            assert bool(torch.isfinite(out.float()).all())
            assert bool(((out.float() - ref.float()).abs() <= bound).all())
            wrong = ref.float().clone()
            wrong[rows.row_ptr[1:] > rows.row_ptr[:-1]] *= 1.05
            assert not bool(((out.float() - wrong).abs() <= bound).all())


# bf16 rows of every remainder of a 4-term batch, and more than 8 terms
_BF16_LENS = (0, 1, 3, 4, 5, 9)


def _k1_into(rows, h, base, base_row, out):
    """K1 on bf16 rows into a caller's `out` [n_rows, H] (bf16, contiguous,
    at any address): the launch ell_apply makes, without its allocation,
    so that a test can hand the kernel an output off 16-byte alignment."""
    from bnsgcn_tpu_torch.ops import bucket_sum as k1
    k1._kernel(h.data_ptr(), k1.ROW_KINDS[h.dtype], rows.row_ptr.data_ptr(),
               rows.src.data_ptr(), rows.work.data_ptr(), rows.n_rows,
               rows.n_long, None,
               None if base is None else base.data_ptr(),
               None if base is None else base_row.data_ptr(), out.data_ptr(),
               k1.OUT_KINDS[torch.bfloat16], h.shape[1],
               buildlib.raw_stream(h.get_device()))
    return out


def _misaligned(x):
    """A copy of x whose storage starts one element past x's alignment."""
    odd = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    return odd.view_as(x).copy_(x)


@pytest.mark.cuda
@pytest.mark.parametrize("h_dim", [256, 64, 72])
def test_bucket_sum_kernel_bf16_batches(cuda, h_dim):
    """bf16 rows at 16-byte loads (the batched gather, 4 terms per batch,
    and the 16-byte epilogue): rows of each of _BF16_LENS terms and a row
    past the long-row threshold, at that threshold and at 8 (every row of
    9 terms a long row too); within _k1_lowp's bound of the plain version,
    with and without a base, bitwise equal on a second call; the plain
    version without each row's last term is rejected; an output or a base
    off 16-byte alignment takes the element-wise epilogue with the same
    bits."""
    n_src = 300
    rng = np.random.default_rng(h_dim)
    lens = np.array([_BF16_LENS[i % len(_BF16_LENS)] for i in range(95)]
                    + [LONG_ROW + 77])
    idx = np.full((len(lens), lens.max()), n_src, np.int32)
    for i, n in enumerate(lens):
        idx[i, :n] = rng.integers(0, n_src, n)
    gen = torch.Generator(device=cuda).manual_seed(h_dim)
    h = torch.randn(n_src, h_dim, generator=gen,
                    device=cuda).to(torch.bfloat16)
    hf = h.float()
    for long_row in (LONG_ROW, 8):
        rows = _one_bucket(idx, n_src, cuda).with_long_row(long_row)
        assert rows.n_long == (1 if long_row == LONG_ROW else
                               int((lens > 8).sum()))
        base = torch.randn(rows.n_rows + 3, h_dim, generator=gen,
                           device=cuda)
        base_row = torch.randperm(rows.n_rows + 3, generator=gen,
                                  device=cuda)[:rows.n_rows].to(torch.int32)
        deg = rows.row_ptr[1:] - rows.row_ptr[:-1]
        last = torch.zeros((rows.n_rows, h_dim), device=cuda)
        has = deg > 0
        last[has] = hf[rows.src[(rows.row_ptr[1:][has] - 1).long()].long()]
        for b, br in ((None, None), (base, base_row)):
            before = k1_launches.total
            out, ref, bound = _k1_lowp(rows, h, b, br, None, torch.bfloat16)
            assert k1_launches.total == before + 1
            assert out.dtype == torch.bfloat16
            assert bool(torch.isfinite(out.float()).all())
            assert bool(((out.float() - ref.float()).abs() <= bound).all())
            assert not bool(((out.float() - (ref.float() - last)).abs()
                             <= bound).all())
            assert torch.equal(out, ell_apply(rows, h, b, br))
            odd_out = _misaligned(torch.empty_like(out))
            assert odd_out.data_ptr() % 16 != 0
            _k1_into(rows, h, b, br, odd_out)
            torch.cuda.synchronize()
            assert torch.equal(odd_out, out)
            if b is not None:
                odd_base = _misaligned(b)
                assert odd_base.data_ptr() % 16 != 0
                assert torch.equal(ell_apply(rows, h, odd_base, br), out)


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
    with pytest.raises(ValueError):                     # f16 rows
        ell_apply(rows, h.half())
    q, sc = i8_quant(h)
    with pytest.raises(ValueError):                     # raw sums + base
        ell_apply(rows, q, base, br)
    with pytest.raises(ValueError):                     # scale of f32 rows
        ell_apply(rows, h, scale=sc)
    with pytest.raises(ValueError):                     # f32 rows to bf16
        ell_apply(rows, h, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError):                     # scale on the CPU
        ell_apply(rows, q, scale=sc.cpu(), out_dtype=torch.float32)
    cpu_rows = pack_rows(rows.spec, [t.cpu() for t in rows.idx],
                         rows.perm.cpu(), rows.chunk_pos.cpu(),
                         rows.chunk_seg.cpu())
    with pytest.raises(ValueError):                     # schedule on the CPU
        ell_apply(cpu_rows, h)


def _k2_matches_plain(tiles, rowb, colb, x, n_row_blocks,
                      per_element=False, scale=None):
    """One launch of K2 on the tiles against the plain version on the dense
    tiles; row-blocks that no tile visits must come out zero. int8 slabs
    (raw int32 sums, or per-slab scaled f32) bitwise; float slabs within
    TOL, or, per_element, each element within 2 n u sum|a x| (n the row's
    nonzero terms, u = 2^-24: two f32 sums of the same products, exact in
    f32, in different orders) for rows of hundreds of terms up to 127 x
    |x|."""
    off = row_offsets(rowb, n_row_blocks)
    ent, ent_off = pack_tiles(tiles)
    before = k2_launches.total
    out = tile_matmul(tiles, rowb, colb, off, ent, ent_off, x, n_row_blocks,
                      slab_scale=scale)
    torch.cuda.synchronize()
    assert k2_launches.total == before + 1
    ref = tile_matmul_plain(tiles, rowb, colb, x, n_row_blocks, scale)
    assert out.dtype == ref.dtype
    if x.dtype == torch.int8:
        assert torch.equal(out, ref)
    elif per_element:
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


def _narrow_slabs(x, mode):
    """(slabs, per-slab scale or None) of f32 slabs x for a K2 mode."""
    if mode == "f32":
        return x, None
    if mode == "bf16":
        return k_major(x.to(torch.bfloat16)), None
    q, sc = block_spmm.quantize_slabs(x, per_slab=mode == "int8-slab")
    return q, (sc if mode == "int8-slab" else None)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8", "int8-slab"])
@pytest.mark.parametrize("tr,tc,h_dim", [(512, 512, 256), (600, 96, 33),
                                         (48, MAX_TC, 602)])
def test_tile_matmul_kernel_on_a_skewed_layout(cuda, tr, tc, h_dim, mode):
    """Row-block 0 owns many tiles, row-block 1 none, row-block 2 one tile
    with a dense row (every column, multiplicities up to 127) beside sparse
    ones; a pad tile follows. f32 slabs on the zero-skipping kernel: TR =
    600 spans two 512-row slices, TC = 908 fills both shared-memory stages.
    int8 and bf16 slabs on the tensor cores: TR = 600 and 48 leave ragged
    128-row slices, TC = 96 and 908 a ragged last piece (908: cp.async in
    4-byte copies in place of TMA), H = 33 and 602 ragged 128-column
    chunks."""
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
    x, scale = _narrow_slabs(
        torch.randn(n_cb, tc, h_dim, generator=gen, device=cuda), mode)
    out = _k2_matches_plain(tiles, rowb, colb, x, 3, per_element=True,
                            scale=scale)
    assert bool((out[1] == 0).all())


@pytest.mark.cuda
def test_tile_matmul_routes_narrow_slabs_to_the_tensor_cores(cuda):
    """int8 and bf16 slabs launch the tensor-core kernel, f32 slabs the
    zero-skipping one: the launch count names the route. Tile entries of
    either sign (no layout holds negative ones) convert to bf16 exactly."""
    art, (fwd, _, _, arrays) = _layout(64)
    a = {k: torch.from_numpy(np.ascontiguousarray(v[0])).to(cuda)
         for k, v in arrays.items()}
    tiles = a["blk_tiles_fwd"].clone()
    tiles[:, ::3] *= -1
    tiles[0, 0, :8] = torch.tensor([-128, 127, -1, 1, -127, 64, -64, 0],
                                   dtype=torch.int8)
    gen = torch.Generator(device=cuda).manual_seed(3)
    h = torch.randn(fwd.n_src, 64, generator=gen, device=cuda)
    x = block_spmm.build_x_slabs(fwd, a["blk_perm_ext"], h)
    k2_launches.reset()
    for mode in ("f32", "bf16", "int8", "int8-slab"):
        xs, scale = _narrow_slabs(x, mode)
        _k2_matches_plain(tiles, a["blk_rowb_fwd"], a["blk_colb_fwd"], xs,
                          fwd.n_row_blocks, per_element=True, scale=scale)
    assert k2_launches.by_kind == {"f32": 1, "tc-bf16": 1, "tc-int8": 1,
                                   "tc-int8-slab": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8", "int8-slab"])
@pytest.mark.parametrize("h_dim", [256, 602, 36])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_tile_matmul_kernel_low_precision(cuda, mode, h_dim, direction):
    """bf16 slabs within 2 n u sum|a x| (the products are exact in f32);
    int8 slabs bitwise: the per-call mode's raw int32 sums, and the
    per-slab mode's tile sums scaled and added in tile order. A plain run
    that skips each row-block's last tile must differ."""
    art, (fwd, bwd, _, arrays) = _layout(64)
    spec = fwd if direction == "fwd" else bwd
    a = {k: torch.from_numpy(np.ascontiguousarray(v[0])).to(cuda)
         for k, v in arrays.items()}
    perm = a["blk_perm_ext" if direction == "fwd" else "blk_perm_inner"]
    gen = torch.Generator(device=cuda).manual_seed(h_dim)
    h = torch.randn(spec.n_src, h_dim, generator=gen, device=cuda)
    x = block_spmm.build_x_slabs(spec, perm, h)
    scale = None
    if mode == "bf16":
        x = k_major(x.to(torch.bfloat16))
    else:
        x, sc = block_spmm.quantize_slabs(x, per_slab=mode == "int8-slab")
        scale = sc if mode == "int8-slab" else None
    tiles, rowb, colb = (a[f"blk_{k}_{direction}"]
                         for k in ("tiles", "rowb", "colb"))
    nrb = spec.n_row_blocks
    off = row_offsets(rowb, nrb)
    ent, ent_off = pack_tiles(tiles)
    before = k2_launches.total
    out = tile_matmul(tiles, rowb, colb, off, ent, ent_off, x, nrb,
                      slab_scale=scale)
    torch.cuda.synchronize()
    assert k2_launches.total == before + 1
    ref = tile_matmul_plain(tiles, rowb, colb, x, nrb, scale)
    assert out.dtype == ref.dtype == (torch.int32 if mode == "int8"
                                      else torch.float32)
    if mode == "bf16":
        n_row = torch.zeros((nrb + 1, tiles.shape[1]), dtype=torch.int64,
                            device=cuda).index_add_(
            0, rowb.long(), (tiles != 0).sum(-1))[:nrb, :, None]
        bound = 2 * n_row.clamp(min=1) * 2.0 ** -24 * tile_matmul_plain(
            tiles, rowb, colb, x.abs(), nrb)
        assert bool(((out - ref).abs() <= bound).all())
    else:
        assert torch.equal(out, ref)
    last = off[1:][off[1:] > off[:-1]].long() - 1   # each row-block's last
    keep = torch.ones(len(rowb), dtype=torch.bool, device=cuda)
    keep[last] = False
    skipped = tile_matmul_plain(tiles * keep[:, None, None].to(torch.int8),
                                rowb, colb, x, nrb, scale)
    assert not torch.equal(out, skipped)


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
    # the tensor-core kernel (int8 and bf16 slabs, K-major [n_cb, H, TC])
    # stages pieces of a tile: it takes TC > MAX_TC; it refuses tiles other
    # than int8 and a work order of another length
    xq = torch.zeros(1, 8, MAX_TC + 1, dtype=torch.int8, device=cuda)
    out = tile_matmul(tiles, ids, ids, off, ent, ent_off, xq, 1)
    torch.cuda.synchronize()
    assert out.dtype == torch.int32 and not bool(out.any())
    with pytest.raises(ValueError):                 # f32 tiles
        tile_matmul(tiles.float(), ids, ids, off, ent, ent_off, xq, 1)
    with pytest.raises(ValueError):                 # order for 2 row-blocks
        tile_matmul(tiles, ids, ids, off, ent, ent_off, xq, 1,
                    order=torch.zeros(2, dtype=torch.int32, device=cuda))


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


@pytest.mark.cuda
def test_checkpoint_from_card_tensors_reloads_bitwise(cuda, tmp_path):
    """Parameters and Adam state on the card go through the JAX-format file
    (trainer.params_to_jax / opt_state_to_jax, checkpoint.py) and come back
    onto the card bitwise."""
    from bnsgcn_tpu_torch import checkpoint as ckpt
    from bnsgcn_tpu_torch.config import Config
    from bnsgcn_tpu_torch.models.gnn import GNN, spec_from_config
    from bnsgcn_tpu_torch.trainer import (make_tx, opt_state_from_jax,
                                          opt_state_to_jax, params_from_jax,
                                          params_to_jax)
    cfg = Config(model="graphsage", n_layers=3, n_hidden=32, use_pp=True,
                 n_feat=7, n_class=5, weight_decay=5e-4)
    spec = spec_from_config(cfg)
    net = GNN(spec, 1).to(cuda)
    opt = make_tx(cfg, net.parameters())
    gen = torch.Generator(device=cuda).manual_seed(2)
    for _ in range(3):
        for p in net.parameters():
            p.grad = torch.randn(p.shape, generator=gen, device=cuda)
        opt.step()
    path = str(tmp_path / "card.ckpt")
    ckpt.save_checkpoint(path, params=params_to_jax(net.state_dict(), spec),
                         opt_state=opt_state_to_jax(opt, net), epoch=2,
                         best_acc=0.5, seed=3)
    payload = ckpt.read_blob(path)
    back = GNN(spec).to(cuda)
    back.load_state_dict(params_from_jax(payload["params"], spec))
    opt2 = make_tx(cfg, back.parameters())
    opt_state_from_jax(payload["opt_state"], opt2, back)
    for (name, p), q in zip(net.named_parameters(), back.parameters()):
        assert q.device.type == "cuda" and torch.equal(p, q), name
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][k], opt2.state[q][k]), (name, k)
        assert float(opt.state[p]["step"]) == float(opt2.state[q]["step"])


@pytest.mark.cuda
def test_p1_resume_on_the_card_matches_the_uninterrupted_run(cuda, tmp_path):
    """A P=1 run on the card (K1 through the ELL SpMM, dropout 0.5 keyed by
    epoch) stopped after 4 epochs and resumed to 6 gives the uninterrupted
    run's losses for epochs 4 and 5 to 1e-5 (relative): chip_smoke's [cli]
    tolerance, for plain-torch ops around the kernels that are not bitwise
    on CUDA."""
    from bnsgcn_tpu_torch.config import Config
    from bnsgcn_tpu_torch.run import run_training

    def run(name, n_epochs, resume=False):
        cfg = Config(dataset="sbm", n_partitions=1, model="graphsage",
                     n_layers=3, n_hidden=64, use_pp=True, dropout=0.5,
                     n_epochs=n_epochs, log_every=2, device="cuda", seed=4,
                     resume=resume, ckpt_path=str(tmp_path / name),
                     results_path=str(tmp_path / "res"))
        return run_training(cfg, log=lambda m: None)

    whole = run("whole", 6)
    run("cut", 4)
    resumed = run("cut", 6, resume=True)
    assert resumed.start_epoch == 4 and len(resumed.losses) == 2
    np.testing.assert_allclose(resumed.losses, whole.losses[4:], rtol=1e-5,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("h_dim", [512, 300])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_kernels_at_yelp_widths(cuda, h_dim, direction):
    """K1 (with a base) and K2 at the Yelp recipe's widths, H=512 (its
    hidden layers) and F=300 (its features, the use_pp precompute and the
    mesh eval's layer 0), against their plain versions."""
    op = _ell_rows(cuda)
    rows = op.rows[direction]
    gen = torch.Generator(device=cuda).manual_seed(h_dim)
    h = torch.randn(rows.n_src, h_dim, generator=gen, device=cuda)
    base = torch.randn(rows.n_rows + 3, h_dim, generator=gen, device=cuda)
    base_row = torch.randperm(rows.n_rows + 3, generator=gen,
                              device=cuda)[:rows.n_rows].to(torch.int32)
    _k1_matches_plain(rows, h, base, base_row)
    art, (fwd, bwd, _, arrays) = _layout(64)
    spec = fwd if direction == "fwd" else bwd
    a = {k: torch.from_numpy(np.ascontiguousarray(v[0])).to(cuda)
         for k, v in arrays.items()}
    perm = a["blk_perm_ext" if direction == "fwd" else "blk_perm_inner"]
    x = block_spmm.build_x_slabs(spec, perm, torch.randn(
        spec.n_src, h_dim, generator=gen, device=cuda))
    _k2_matches_plain(a[f"blk_tiles_{direction}"], a[f"blk_rowb_{direction}"],
                      a[f"blk_colb_{direction}"], x, spec.n_row_blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("model,use_pp", [("graphsage", True),
                                          ("gcn", False)])
def test_mesh_eval_on_the_card_matches_the_host_eval(cuda, model, use_pp):
    """--eval-device mesh's forward at P=1 on the card (K1 and K2, counted
    under 'eval': one launch of each per graph layer) against the host
    eval (COO index_add_) on the card, for the same parameters: logits to
    1e-5 of the largest, the same predictions, the same accuracies."""
    from bnsgcn_tpu_torch.config import Config
    from bnsgcn_tpu_torch.evaluate import evaluate_mesh, full_graph_logits
    from bnsgcn_tpu_torch.models.gnn import GNN
    from bnsgcn_tpu_torch.run import prepare_run
    from bnsgcn_tpu_torch.utils.metrics import calc_acc
    g = sbm_graph(n_nodes=600, n_class=5, n_feat=6, p_in=0.15, p_out=0.003,
                  seed=67)
    cfg = Config(model=model, n_layers=3, n_hidden=64, use_pp=use_pp,
                 dropout=0.0, spmm="hybrid", block_tile=64, n_partitions=1,
                 device="cuda", eval_device="mesh", seed=2)
    pr = prepare_run(cfg, g=g, log=lambda m: None)
    net = GNN(pr.spec, 2).to(cuda)
    k1, k2 = (dict(c.by_phase) for c in (k1_launches, k2_launches))
    got = pr.fns.eval_forward(net, pr.blk)
    for before, c in ((k1, k1_launches), (k2, k2_launches)):
        assert c.by_phase.get("eval", 0) == before.get("eval", 0) + 3
    want = torch.from_numpy(full_graph_logits(net, g, cuda))
    inner = torch.from_numpy(pr.art.inner_mask[0])
    got = got.cpu()[inner]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    assert torch.equal(got.argmax(1), want.argmax(1))
    accs = evaluate_mesh("x", pr.fns.eval_forward, net, pr.blk, pr.art,
                         ("val", "test"), log=lambda m: None)
    for mode, mask in (("val", g.val_mask), ("test", g.test_mask)):
        assert accs[mode] == calc_acc(want.numpy()[mask], g.label[mask])


@pytest.mark.cuda
@pytest.mark.parametrize("inductive", [False, True])
def test_eval_devices_agree_on_the_card_at_p2(cuda, tmp_path, inductive):
    """Two ranks sharing the card over gloo, dropout 0: the run whose ranks
    evaluate (--eval-device mesh, the eval graphs' own partitions under
    --inductive) and the run whose rank 0 evaluates in its thread on its
    own stream (host) print the same eval lines and end on the same test
    accuracy and losses."""
    from bnsgcn_tpu_torch.config import Config
    from bnsgcn_tpu_torch.run import run_training
    g = sbm_graph(n_nodes=600, n_class=5, n_feat=6, p_in=0.15, p_out=0.003,
                  seed=67)
    out = {}
    for dev in ("mesh", "host"):
        cfg = Config(dataset="sbm", model="graphsage", n_layers=3,
                     n_hidden=64, use_pp=True, dropout=0.0, spmm="hybrid",
                     block_tile=64, n_partitions=2, dist_backend="gloo",
                     partition_method="random", device="cuda", seed=2,
                     n_epochs=6, log_every=2, eval_device=dev,
                     inductive=inductive, part_path=str(tmp_path / "parts"),
                     ckpt_path=str(tmp_path / dev),
                     results_path=str(tmp_path / f"res_{dev}"))
        lines = []
        res = run_training(cfg, g=g, log=lines.append)
        out[dev] = ([ln for ln in lines if ln.startswith(
            ("Epoch ", "Test Result", "Max Validation"))],
            res.test_acc, res.losses)
    assert out["mesh"][0] == out["host"][0] and len(out["mesh"][0]) == 5
    assert out["mesh"][1] == out["host"][1]
    np.testing.assert_allclose(out["mesh"][2], out["host"][2], rtol=1e-6)


SKEW = dict(n_nodes=120, avg_degree=7, n_feat=6, seed=41, power_law=True)
SKEW_SIZES = (60, 30, 20, 10)


def _skew_art():
    g = synthetic_graph(**SKEW)
    return build_artifacts(g, np.repeat(np.arange(4), SKEW_SIZES)
                           .astype(np.int32))


def _split_op(art, p, kind, device):
    """The --overlap split operator of part p (ELL, or hybrid with 16-wide
    tiles) on `device`."""
    from bnsgcn_tpu_torch.ops.spmm import SplitSpmm
    from bnsgcn_tpu_torch.trainer import _sub, to_device
    src, dst = art.src[p:p + 1], art.dst[p:p + 1]
    ni, n_ext = art.pad_inner, art.n_ext
    if kind == "ell":
        (i_f, i_b), (r_f, r_b), arrays, _, _ = t_ell.build_split_layouts(
            src, dst, ni, n_ext)
        ops = (t_ell.EllSpmm(i_f, i_b, to_device(_sub(arrays, "int_"),
                                                 device)),
               t_ell.EllSpmm(r_f, r_b, to_device(_sub(arrays, "fro_"),
                                                 device)))
    else:
        pi, pe = block_spmm.cluster_order(src[0], dst[0], ni, n_ext,
                                          target=16, log=lambda m: None)
        ints, fros, arrays, _, _ = block_spmm.build_split_block_layouts(
            src, dst, ni, n_ext, pi[None], pe[None], occupancy_min=2,
            tile_r=16, tile_c=16)
        ops = (block_spmm.BlockSpmm(*ints, to_device(_sub(arrays, "int_"),
                                                     device)),
               block_spmm.BlockSpmm(*fros, to_device(_sub(arrays, "fro_"),
                                                     device)))
    return SplitSpmm(*ops, torch.from_numpy(arrays["merge_perm"][0]).to(
        device), ni)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ell", "hybrid"])
def test_split_layouts_through_the_kernels(cuda, kind):
    """K1 (and K2 on the hybrid) on the interior and frontier layouts of
    every part of a skewed partition, forward and backward through the
    split operator, against the same operator's plain versions on the
    CPU; each side launches its kernels once per pass."""
    art = _skew_art()
    rng = np.random.default_rng(3)
    for p in range(4):
        h = rng.normal(size=(art.n_ext, 64)).astype(np.float32)
        cot = rng.normal(size=(art.pad_inner, 64)).astype(np.float32)
        outs = []
        for dev in (cuda, torch.device("cpu")):
            op = _split_op(art, p, kind, dev)
            k1_launches.reset()
            k2_launches.reset()
            x = torch.from_numpy(h).to(dev).requires_grad_(True)
            y = op(x)
            (y * torch.from_numpy(cot).to(dev)).sum().backward()
            outs.append((y.detach().cpu().numpy(), x.grad.cpu().numpy()))
            if dev.type == "cuda":
                assert k1_launches.by_phase == {"fwd": 2, "bwd": 2}
                assert k2_launches.by_phase == (
                    {} if kind == "ell" else {"fwd": 2, "bwd": 2})
        np.testing.assert_allclose(outs[0][0], outs[1][0], **TOL)
        np.testing.assert_allclose(outs[0][1], outs[1][1], **TOL)


def _variants_job(ctx, path, h, cot):
    """Every strategy x wire's exchange and VJP, synchronous (halo_apply)
    and cut at the seam (HaloFlight), on this rank's part at rate 0.5."""
    from bnsgcn_tpu_torch.parallel.halo import HaloFlight
    art = load_artifacts(path, parts=[ctx.rank])
    bnd = torch.from_numpy(art.bnd[0]).to(ctx.device)
    out = {}
    for strategy in ("padded", "shift", "ragged"):
        for wire in ("native", "bf16", "int8", "fp8"):
            spec, tables = make_halo_spec(art.n_b, art.pad_inner,
                                          art.pad_boundary, 0.5, strategy,
                                          wire)
            plan = make_halo_plan(spec, tables, bnd, ctx.rank, 1,
                                  prng.key(0, ctx.device))
            x = torch.from_numpy(h[ctx.rank]).to(ctx.device)
            c = torch.from_numpy(cot[ctx.rank]).to(ctx.device)
            for seam in (False, True):
                xg = x.clone().requires_grad_(True)
                if seam:
                    flight = HaloFlight(spec, plan, ctx.comm)
                    flight.start(xg)
                    y = torch.cat([xg, flight.finish()])
                else:
                    y = halo_apply(spec, plan, xg, ctx.comm)
                (y * c).sum().backward()
                out[strategy, wire, seam] = (y.detach().cpu().numpy(),
                                             xg.grad.cpu().numpy())
    return out


def _within_code_step(got, want, wire, what):
    """A quantized wire's exchange on the card against the CPU's: the
    card's division by a scalar multiplies by its reciprocal, so a block's
    scale may sit one f32 ulp off the CPU's and a value on a rounding tie
    may take the neighbouring code: within one int8 step of the largest
    value, or one e4m3 step (2^-3) of the value."""
    amax = float(np.abs(want).max())
    tol = (amax / 127 * 1.001 if wire == "int8" else
           2.0 ** -3 * np.abs(want) + 1e-5 * amax)
    assert (np.abs(got - want) <= tol).all(), what


@pytest.mark.cuda
def test_shift_and_ragged_exchanges_on_the_card(cuda, tmp_path):
    """Four ranks sharing the card over gloo (shift's sends and receives
    staged through host buffers, ragged's split-size all-to-all taken by
    gloo itself), under every wire, synchronously and through the async
    seam: on the card every strategy's forward is bitwise padded's and its
    backward within 1e-6; against four CPU ranks the native and bf16
    wires' forward is bitwise and their backward within 1e-6, the int8 and
    fp8 wires' forward within one code step (_within_code_step)."""
    art = _skew_art()
    save_artifacts(art, str(tmp_path))
    rng = np.random.default_rng(0)
    h = rng.normal(size=(4, art.pad_inner, 8)).astype(np.float32)
    cot = rng.normal(size=(4, art.n_ext, 8)).astype(np.float32)
    args = [(str(tmp_path), h, cot)] * 4
    on_card = launch(_variants_job, 4, args, "gloo", "cuda")
    on_cpu = launch(_variants_job, 4, args, "gloo", "cpu")
    for got, want in zip(on_card, on_cpu):
        assert sorted(got) == sorted(want)
        for k in got:
            strategy, wire, seam = k
            pad = got["padded", wire, seam]
            np.testing.assert_array_equal(got[k][0], pad[0], err_msg=str(k))
            np.testing.assert_allclose(got[k][1], pad[1], rtol=1e-6,
                                       atol=1e-6, err_msg=str(k))
            if wire in ("native", "bf16"):
                np.testing.assert_array_equal(got[k][0], want[k][0],
                                              err_msg=str(k))
                np.testing.assert_allclose(got[k][1], want[k][1], rtol=1e-6,
                                           atol=1e-6, err_msg=str(k))
            else:
                _within_code_step(got[k][0], want[k][0], wire, k)
    assert np.abs(on_cpu[0]["shift", "native", True][0][
        art.pad_inner:]).sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("edge_chunk", [0, 512])
def test_segment_spmm_on_the_card_within_tolerance(cuda, edge_chunk):
    """--spmm segment (CooSpmm, plain index_add_, no kernel) on the card
    against the CPU, forward and backward: the card adds with atomics, in
    no fixed order, so the two agree within TOL, not bitwise."""
    from bnsgcn_tpu_torch.ops.spmm import CooSpmm
    art = _skew_art()
    rng = np.random.default_rng(4)
    h = rng.normal(size=(art.n_ext, 32)).astype(np.float32)
    cot = rng.normal(size=(art.pad_inner, 32)).astype(np.float32)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        op = CooSpmm(torch.from_numpy(art.src[1]).to(dev),
                     torch.from_numpy(art.dst[1]).to(dev), art.pad_inner,
                     edge_chunk)
        x = torch.from_numpy(h).to(dev).requires_grad_(True)
        y = op(x)
        (y * torch.from_numpy(cot).to(dev)).sum().backward()
        outs.append((y.detach().cpu().numpy(), x.grad.cpu().numpy()))
    np.testing.assert_allclose(outs[0][0], outs[1][0], **TOL)
    np.testing.assert_allclose(outs[0][1], outs[1][1], **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 1), (1000, 37), (4099, 256),
                                   (3, 1 << 20)])
def test_dropout_kernel_is_its_plain_version(cuda, shape, dtype):
    """D1 (csrc/dropout.cu) bitwise its plain version, forward and backward
    (the kernel on the gradient), on odd sizes and a flat index past a
    grid's worth of threads; another key's draw differs; the launches are
    counted by phase."""
    from bnsgcn_tpu_torch.ops import dropout as d1
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(shape, generator=gen, device=cuda).to(dt)
    g = torch.randn(shape, generator=gen, device=cuda).to(dt)
    key = d1.key_words(prng.fold_in(prng.key(3), 2))
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    d1.launches.reset()
    for rate in (0.5, 0.1):
        ref = d1.dropout_plain(x, *key, 1.0 - rate)
        got = d1.dropout_apply(x, *key, 1.0 - rate)
        assert torch.equal(got.view(bits), ref.view(bits))
        xr = x.clone().requires_grad_(True)
        d1.dropout(xr, key, rate).backward(g)
        assert torch.equal(xr.grad.view(bits),
                           d1.dropout_plain(g, *key, 1.0 - rate).view(bits))
        if x.numel() > 64:
            other = d1.dropout_apply(x, key[0], key[1] ^ 1, 1.0 - rate)
            assert not torch.equal(other.view(bits), ref.view(bits))
    torch.cuda.synchronize()
    assert d1.launches.by_phase["fwd"] >= 4 and d1.launches.by_phase[
        "bwd"] == 2
    with pytest.raises(ValueError):
        d1.dropout_apply(x.to(torch.float16), *key, 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_kernels_at_a_feat_shard_width(cuda, direction):
    """K1 (with a base) and K2 at H = 128 f32, the width a feat shard's
    exchange and SpMM carry at --feat 2 on the flagship's 256-wide hidden
    layers, against their plain versions."""
    op = _ell_rows(cuda)
    rows = op.rows[direction]
    gen = torch.Generator(device=cuda).manual_seed(128)
    h = torch.randn(rows.n_src, 128, generator=gen, device=cuda)
    base = torch.randn(rows.n_rows + 3, 128, generator=gen, device=cuda)
    base_row = torch.randperm(rows.n_rows + 3, generator=gen,
                              device=cuda)[:rows.n_rows].to(torch.int32)
    _k1_matches_plain(rows, h, base, base_row)
    _k1_matches_plain(rows, h, None, None)
    art, (fwd, bwd, _, arrays) = _layout(64)
    spec = fwd if direction == "fwd" else bwd
    a = {k: torch.from_numpy(np.ascontiguousarray(v[0])).to(cuda)
         for k, v in arrays.items()}
    perm = a["blk_perm_ext" if direction == "fwd" else "blk_perm_inner"]
    x = block_spmm.build_x_slabs(spec, perm, torch.randn(
        spec.n_src, 128, generator=gen, device=cuda))
    _k2_matches_plain(a[f"blk_tiles_{direction}"], a[f"blk_rowb_{direction}"],
                      a[f"blk_colb_{direction}"], x, spec.n_row_blocks)


@pytest.mark.cuda
def test_dropout_kernel_on_a_feat_rank_s_full_width(cuda):
    """D1 draws a feat shard's masks at the full width, before the slice:
    on a rank's [rows, 256] hidden block each shard's columns are the
    plain version's columns (the feat=1 masks), and GAT's head dropout,
    drawn at the full head count and sliced at the shard's offset, is the
    CPU's draw."""
    from bnsgcn_tpu_torch.models.gnn import _dropout_heads
    from bnsgcn_tpu_torch.ops import dropout as d1
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(4099, 256, generator=gen, device=cuda)
    key = prng.fold_in(prng.fold_in(prng.key(1), 0), 3)
    words = d1.key_words(key)
    full = d1.dropout_apply(x, *words, 0.5)
    ref = d1.dropout_plain(x, *words, 0.5)
    for f in range(2):
        cols = slice(128 * f, 128 * (f + 1))
        assert torch.equal(full[:, cols].view(torch.int32),
                           ref[:, cols].view(torch.int32))
    a = torch.rand(5000, 2, generator=gen, device=cuda)
    d1.launches.reset()
    for off in (0, 2):
        got = _dropout_heads(a, 0.5, key, True, 4, off)
        want = _dropout_heads(a.cpu(), 0.5, key, True, 4, off)
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))
    torch.cuda.synchronize()
    assert d1.launches.by_phase["fwd"] == 2


def _strict_cfg(tmp_path, **kw):
    from bnsgcn_tpu_torch.config import Config
    d = dict(dataset="sbm", n_partitions=1, model="graphsage", n_layers=3,
             n_hidden=64, use_pp=True, dropout=0.5, spmm="hybrid",
             block_tile=64, n_epochs=4, log_every=2, device="cuda", seed=4,
             strict_exec=True, ckpt_path=str(tmp_path / "ck"),
             results_path=str(tmp_path / "res"))
    d.update(kw)
    return Config(**d)


@pytest.mark.cuda
def test_strict_exec_is_clean_at_p1_on_the_card(cuda, tmp_path):
    """--strict-exec on the card: K1, K2 and D1 run inside the guard
    (torch's sync debug mode 'error'), no step synchronises, and the audit
    reads 0 violations with one audited loss read per step."""
    from bnsgcn_tpu_torch.ops import bucket_sum, dropout, tile_matmul
    from bnsgcn_tpu_torch.run import run_training
    for m in (bucket_sum, tile_matmul, dropout):
        m.launches.reset()
    res = run_training(_strict_cfg(tmp_path), log=lambda m: None)
    assert res.strict["violations"] == 0, res.strict
    assert res.strict["steps"] == {"step": 4}
    assert res.strict["fetches"] == 4
    for m in (bucket_sum, tile_matmul, dropout):
        assert m.launches.by_phase.get("fwd", 0) >= 4, m


@pytest.mark.cuda
def test_strict_exec_raises_on_an_item_inside_a_step(cuda, tmp_path,
                                                     monkeypatch):
    """A deliberate .item() of a CUDA tensor inside the guarded step is an
    implicit transfer: StrictExecError, the JAX package's wording."""
    from bnsgcn_tpu_torch import trainer
    from bnsgcn_tpu_torch.run import run_training
    from bnsgcn_tpu_torch.strict import StrictExecError
    real = trainer.ce_sum

    def leaky(logits, labels, mask):
        out = real(logits, labels, mask)
        out.detach().sum().item()
        return out

    monkeypatch.setattr(trainer, "ce_sum", leaky)
    with pytest.raises(StrictExecError,
                       match="implicit host transfer inside the guarded "
                             "'step' step"):
        run_training(_strict_cfg(tmp_path, resilience="off"),
                     log=lambda m: None)
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_a_card_trace_names_the_kernels(cuda, tmp_path):
    """--profile-dir at P=1 on the card: the trace holds the train_step
    spans and K1's, K2's and D1's kernels by name on the CUDA lanes."""
    import json
    from bnsgcn_tpu_torch.run import run_training
    prof = tmp_path / "prof"
    run_training(_strict_cfg(tmp_path, n_epochs=8, profile_dir=str(prof),
                             strict_exec=False), log=lambda m: None)
    with open(prof / "rank_0.json") as f:
        evs = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in evs if e.get("cat") == "kernel"}
    for name in ("ell_rows_kernel", "tile_spmm_kernel", "dropout_kernel"):
        assert any(name in k for k in kernels), (name, sorted(kernels)[:20])
    steps = [e for e in evs if e.get("name") == "train_step"
             and e.get("cat") == "user_annotation"]
    assert len(steps) == 2


def _serving(cuda, model):
    """A ServeCore on the card over a 600-node graph, 3 layers x 64."""
    from bnsgcn_tpu_torch import serve
    from bnsgcn_tpu_torch.config import Config
    from bnsgcn_tpu_torch.models.gnn import GNN, spec_from_config
    g = sbm_graph(n_nodes=600, n_class=5, n_feat=48, p_in=0.02,
                  p_out=0.001, seed=9)
    cfg = Config(dataset="sbm", model=model, n_layers=3, n_hidden=64,
                 heads=2 if model == "gat" else 1,
                 use_pp=model == "graphsage", n_feat=g.n_feat,
                 n_class=g.n_class, n_train=g.n_train, serve_max_batch=64)
    net = GNN(spec_from_config(cfg), 3).to(cuda).eval()
    return g, net, serve.build_core(cfg, g, net, log=lambda *a: None)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["graphsage", "gcn", "gat"])
def test_serving_forward_is_bitwise_repeatable_and_batch_invariant(cuda,
                                                                   model):
    """The serving forward on the card (fixed-order sums, row tiles): two
    precomputes bitwise equal; a node scored alone bitwise the same node in
    a full bucket; both within TOL of the CPU's forward."""
    from bnsgcn_tpu_torch.evaluate import full_graph_embeddings
    g, net, core = _serving(cuda, model)
    try:
        again = full_graph_embeddings(net, g, cuda)
        assert np.array_equal(again[0], core.hidden)
        assert np.array_equal(again[1], core.logits)
        cpu_net = net.to("cpu")
        try:
            ref = full_graph_embeddings(cpu_net, g, torch.device("cpu"))
        finally:
            net.to(cuda)
        np.testing.assert_allclose(core.logits, ref[1], **TOL)
        np.testing.assert_allclose(core.hidden, ref[0], **TOL)
        v = int(np.argmin(core.graph.in_deg))
        alone = core.scorer.score(core.graph, net, [v])
        n_alone = core.scorer.last["nodes"]
        full = core.scorer.score(core.graph, net,
                                 sorted({v} | set(range(63))))
        # another subgraph: the node's row sits elsewhere among others
        assert core.scorer.last["nodes"] > n_alone
        assert np.array_equal(alone[v][0], full[v][0])
        assert np.array_equal(alone[v][1], full[v][1])
        np.testing.assert_allclose(alone[v][1], core.logits[v], **TOL)
    finally:
        core.close()


@pytest.mark.cuda
def test_serving_delta_refresh_on_the_card(cuda):
    """A delta's flush on the card: clean rows bitwise untouched, the
    dirty rows within TOL of a scratch eval of the mutated graph."""
    from bnsgcn_tpu_torch.data.graph import Graph
    from bnsgcn_tpu_torch.evaluate import full_graph_logits
    g, net, core = _serving(cuda, "graphsage")
    try:
        before = core.logits.copy()
        core.add_edges([(3, 17)])
        dirty = sorted(core.dirty)
        core.flush()
        clean = np.setdiff1d(np.arange(g.n_nodes), dirty)
        assert np.array_equal(core.logits[clean], before[clean])
        g2 = Graph(g.n_nodes, np.concatenate([g.src, [3]]),
                   np.concatenate([g.dst, [17]]), g.feat, g.label,
                   g.train_mask, g.val_mask, g.test_mask)
        ref = full_graph_logits(net, g2, cuda)
        np.testing.assert_allclose(core.logits[dirty], ref[dirty], **TOL)
    finally:
        core.close()


class _CardFleet:
    """A 2-backend serving fleet in this process on the card (the port's
    router and backends over TCP), its tables sliced from the single-host
    core's, over a random 2-way owner map."""

    def __init__(self, core, net, g):
        from bnsgcn_tpu_torch import serve_backend as sb
        from bnsgcn_tpu_torch import serve_router as sr
        quiet = lambda *a: None  # noqa: E731
        self.owner = np.random.default_rng(5).integers(
            0, 2, g.n_nodes).astype(np.int32)
        self.owner[:2] = [0, 1]
        self.rcore = sr.RouterCore(self.owner, 2, hops=core.hops, log=quiet)
        self.router = sr.RouterServer(self.rcore, 0, log=quiet)
        self.cores, self.servers = [], []
        for part in (0, 1):
            c = sb.build_backend_core(core.cfg.replace(serve_part=part), g,
                                      self.owner, net, log=quiet,
                                      hidden=core.hidden, logits=core.logits)
            c.graph.resolver = sb.PeerResolver("127.0.0.1", self.router.port)
            srv = sb.BackendServer(c, 0, log=quiet)
            self.rcore.fleet.register(part, 0, "127.0.0.1", srv.port)
            self.cores.append(c)
            self.servers.append(srv)

    def close(self):
        for srv, c in zip(self.servers, self.cores):
            srv.drain(timeout_s=2.0)
            c.close()
            c.graph.resolver.close()
        self.router.drain(timeout_s=2.0)
        self.rcore.close()


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["graphsage", "gcn"])
def test_fleet_tier_b_across_the_cut_bitwise_on_the_card(cuda, model):
    """Tier A and forced tier B through a 2-backend fleet on the card,
    bitwise the single-host core on the card: each backend builds the
    closure from its CSR slice and the halo rows its peer resolves."""
    g, net, core = _serving(cuda, model)
    fleet = _CardFleet(core, net, g)
    try:
        for part in (0, 1):
            for v in np.flatnonzero(fleet.owner == part)[:3].tolist():
                a = fleet.rcore.predict(v)
                assert a["tier"] == "A" and a["part"] == part
                assert a["scores"] == core.predict(v)["scores"]
                b = fleet.rcore.predict(v, tier="B")
                assert b["scores"] == core.predict(v, tier="B")["scores"]
        assert all(c.graph.halo_stats()["halo_fetches"] > 0
                   for c in fleet.cores)
    finally:
        fleet.close()
        core.close()


@pytest.mark.cuda
def test_fleet_delta_and_flush_bitwise_on_the_card(cuda):
    """A cross-part delta through the fleet's router on the card: the
    single-host core's dirty set, tier B on dirty nodes bitwise, and after
    both flushes tier A bitwise."""
    g, net, core = _serving(cuda, "graphsage")
    fleet = _CardFleet(core, net, g)
    try:
        u = int(np.flatnonzero(fleet.owner == 0)[3])
        v = int(np.flatnonzero(fleet.owner == 1)[3])
        r = fleet.rcore.add_edges([[u, v], [v, u]])
        assert r["dirty_total"] == core.add_edges([[u, v], [v, u]])[
            "dirty_total"]
        assert set().union(*(c.dirty for c in fleet.cores)) == core.dirty
        probe = list(dict.fromkeys([u, v] + sorted(core.dirty)[:4]))
        for w in probe:
            a, b = fleet.rcore.predict(w), core.predict(w)
            assert a["tier"] == b["tier"] == "B"
            assert a["scores"] == b["scores"]
        assert fleet.rcore.flush() == core.flush()
        for w in probe:
            a, b = fleet.rcore.predict(w), core.predict(w)
            assert a["tier"] == b["tier"] == "A"
            assert a["scores"] == b["scores"]
    finally:
        fleet.close()
        core.close()
