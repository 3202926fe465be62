"""The port's reduced-precision stack against the JAX package, on the CPU:
the quantizers, the kernels' plain versions at their narrow dtypes, the
quantized ELL and hybrid SpMMs, --spmm auto, and bf16 training at P=1.

Inputs come from numpy with a seed and go through both packages; Pallas
kernels run as the JAX package's own tests run them here (interpret=True).
Tolerances, each with its reason:

  * quantizer payloads and scales, int8 accumulators, the per-call int8
    dense path: array-equal (the same f32 arithmetic; integer sums);
  * f32 sums of e4m3 values or of bf16 x int8 products: rtol 1e-6 on the
    sums of a few dozen terms in another order;
  * bf16 outputs: 2^-8 relative (one bf16 rounding of sums that agree in
    f32) plus 1e-6 of the largest value;
  * quantized SpMMs forward and backward: 1e-5 of max |ref| (both packages
    quantize to the same payload with the same scale, then sum in another
    order; the JAX test's own bound is 0.05 max |ref|);
  * the per-slab int8 dense path: rtol 1e-5 (its f32 sums over tiles in
    another order);
  * bf16 training: 2e-2 relative on each of 3 epochs' losses (see the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnsgcn_tpu.ops import block_spmm as j_blk
from bnsgcn_tpu.ops import ell as j_ell
from bnsgcn_tpu.ops.pallas_block import dense_apply_pallas, pallas_tile_matmul
from bnsgcn_tpu.utils import quant as j_quant
from bnsgcn_tpu_torch.config import Config
from bnsgcn_tpu_torch.data.artifacts import build_artifacts
from bnsgcn_tpu_torch.data.graph import sbm_graph, synthetic_graph
from bnsgcn_tpu_torch.data.partitioner import partition_graph
from bnsgcn_tpu_torch.ops import block_spmm as t_blk
from bnsgcn_tpu_torch.ops import ell as t_ell
from bnsgcn_tpu_torch.ops.bucket_sum import bucket_sum_plain, ell_apply
from bnsgcn_tpu_torch.ops.tile_matmul import (pack_tiles, row_offsets,
                                              tile_matmul_plain)
from bnsgcn_tpu_torch.utils import quant as t_quant


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _f8_bits(x):
    """e4m3 payload bits as uint8, from either package."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _quant_inputs():
    rng = np.random.default_rng(17)
    x = rng.normal(size=(4, 6, 9)).astype(np.float32)
    x[0, 0, :4] = [0.5, 1.5, -2.5, 3.5]          # ties once scaled to 1
    x[1] = 0.0                                   # an all-zero block
    x[2, 3, 1] = 3.0e38                          # a huge value
    x[3] *= 1e-3
    ties = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, 127.0, -127.0, 63.5]],
                    np.float32)
    return x, ties


# ---------------------------------------------------------------------------
# the quantizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes", [None, (-2, -1)])
def test_quantizers_are_array_equal_to_jax(axes):
    """i8_quant, f8_quant and f8_dequant: payloads and scales array-equal
    to bnsgcn_tpu/utils/quant.py on the same f32 inputs (one scale, and
    one per block over the last two axes as the halo wire takes them),
    ties at .5, a zero block and a huge value included."""
    x, ties = _quant_inputs()
    for arr in (x, ties * 127.0 / 127.0):
        if axes is not None and arr.ndim < 3:
            arr = arr[None]
        q, s = t_quant.i8_quant(_t(arr), axes=axes)
        jq, js = j_quant.i8_quant(jnp.asarray(arr), axes=axes)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        f, fs = t_quant.f8_quant(_t(arr), axes=axes)
        jf, jfs = j_quant.f8_quant(jnp.asarray(arr), axes=axes)
        assert f.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(_f8_bits(f), _f8_bits(jf))
        np.testing.assert_array_equal(fs.numpy(), np.asarray(jfs))
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            d = t_quant.f8_dequant(f, fs, dt)
            jd = np.asarray(j_quant.f8_dequant(jf, jfs, jdt))
            np.testing.assert_array_equal(d.float().numpy(),
                                          jd.astype(np.float32))
    # the ties: round half to even, as jnp.round
    q, s = t_quant.i8_quant(_t(ties))
    assert float(s) == 1.0
    assert q.tolist() == [[0, 2, 2, 0, -2, 127, -127, 64]]


# ---------------------------------------------------------------------------
# K1's plain version at the narrow row dtypes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", ["int8", "fp8", "bf16"])
@pytest.mark.parametrize("n,h_dim,r,w", [(50, 8, 16, 4), (40, 7, 24, 16)])
def test_bucket_sum_plain_narrow_rows_match_jax(rows, n, h_dim, r, w):
    """One bucket's sums against bnsgcn_tpu/ops/ell.py `_bucket_sum`
    (accum='reduce'): int8 rows give int32 sums, array-equal; e4m3 rows
    f32 sums (rtol 1e-6); bf16 rows f32 sums, which the JAX package keeps
    in bf16 (2^-8 relative)."""
    rng = np.random.default_rng(n + w)
    x = rng.normal(size=(n, h_dim)).astype(np.float32)
    idx = rng.integers(0, n + 1, size=(r, w)).astype(np.int32)   # n = pad
    if rows == "int8":
        h, _ = t_quant.i8_quant(_t(x))
        jh, _ = j_quant.i8_quant(jnp.asarray(x))
    elif rows == "fp8":
        h, _ = t_quant.f8_quant(_t(x))
        jh, _ = j_quant.f8_quant(jnp.asarray(x))
    else:
        h, jh = _t(x).to(torch.bfloat16), jnp.asarray(x, jnp.bfloat16)
    hp = jnp.concatenate([jh, jnp.zeros((1, h_dim), jh.dtype)])
    ref = np.asarray(j_ell._bucket_sum(hp, jnp.asarray(idx), w,
                                       accum="reduce"))
    got = bucket_sum_plain(h, _t(idx))
    if rows == "int8":
        assert got.dtype == torch.int32 and ref.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), ref)
    elif rows == "fp8":
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    else:
        assert got.dtype == torch.float32
        ref = ref.astype(np.float32)
        np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(),
                                   ref, rtol=2.0 ** -8,
                                   atol=1e-6 * np.abs(ref).max())


def _ell_case():
    g = synthetic_graph(n_nodes=400, avg_degree=40, n_feat=6, seed=5,
                        power_law=True)        # split rows: the combine
    art = build_artifacts(g, partition_graph(g, 1))
    fs, bs, arrays = t_ell.build_layouts(art.src, art.dst, art.pad_inner,
                                         art.n_ext, geometry=art.ell_geometry)
    return art, fs, bs, {k: v[0] for k, v in arrays.items()}


def _jax_fwd_grad(spmm, arrays, h, cot):
    a = {k: jnp.asarray(v) for k, v in arrays.items()}
    out = np.asarray(spmm(a, jnp.asarray(h)))
    d_h = np.asarray(jax.grad(lambda x: jnp.sum(spmm(a, x) * cot))(
        jnp.asarray(h)))
    return out, d_h


def _torch_fwd_grad(op, h, cot):
    x = _t(h).requires_grad_(True)
    out = op(x)
    (out * _t(cot)).sum().backward()
    return out.detach().numpy(), x.grad.numpy()


def _close(got, ref, frac=1e-5):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=frac * np.abs(ref).max())


@pytest.mark.parametrize("gather", ["int8", "fp8"])
def test_quantized_ell_spmm_matches_jax(gather):
    """EllSpmm(gather_dtype) against make_ell_spmm(gather_dtype): one
    per-call scale on h forward, the cotangent's own scale backward, the
    scaled sums in h's dtype; split rows combined in the accumulator."""
    art, fs, bs, a0 = _ell_case()
    rng = np.random.default_rng(4)
    h = rng.normal(size=(art.n_ext, 6)).astype(np.float32)
    cot = (100.0 * rng.normal(size=(art.pad_inner, 6))).astype(np.float32)
    ref, d_ref = _jax_fwd_grad(j_ell.make_ell_spmm(
        fs, bs, len(fs.widths), len(bs.widths), gather_dtype=gather),
        a0, h, cot)
    op = t_ell.EllSpmm(fs, bs, {k: _t(v) for k, v in a0.items()},
                       gather_dtype=gather)
    got, d_got = _torch_fwd_grad(op, h, cot)
    _close(got, ref)
    _close(d_got, d_ref)
    # the quantization shows: native differs by far more than the bound
    native, _ = _torch_fwd_grad(
        t_ell.EllSpmm(fs, bs, {k: _t(v) for k, v in a0.items()}), h, cot)
    assert np.abs(native - ref).max() > 1e-3 * np.abs(ref).max()


def test_ell_apply_int8_raw_sums_and_scaled_bf16():
    """ell_apply on int8 rows: without a scale the raw int32 sums (the
    JAX combine's int32 out before its scale), with one the sums times the
    scale rounded to bf16 plus a base rounded to bf16, as JAX computes
    `dense + ell(h)` in bf16."""
    art, fs, bs, a0 = _ell_case()
    op = t_ell.EllSpmm(fs, bs, {k: _t(v) for k, v in a0.items()})
    rows = op.rows["fwd"]
    rng = np.random.default_rng(8)
    x = rng.normal(size=(art.n_ext, 5)).astype(np.float32)
    q, s = t_quant.i8_quant(_t(x))
    idx = [jnp.asarray(a0[f"fwd_idx_{k}"]) for k in range(len(fs.widths))]
    jq, js = j_quant.i8_quant(jnp.asarray(x))
    hp = jnp.concatenate([jq, jnp.zeros((1, 5), jnp.int8)])
    outs = [j_ell._bucket_sum(hp, i, int(i.shape[1]), accum="reduce")
            for i in idx]
    raw = np.asarray(j_ell.ell_combine(
        fs, outs, jnp.asarray(a0["fwd_perm"]),
        jnp.asarray(a0["fwd_chunk_pos"]), jnp.asarray(a0["fwd_chunk_seg"])))
    got = ell_apply(rows, q)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), raw)
    base = rng.normal(size=(fs.n_rows + 3, 5)).astype(np.float32)
    br = rng.permutation(fs.n_rows + 3)[:fs.n_rows].astype(np.int32)
    want = (jnp.asarray(base[br], jnp.bfloat16)
            + (jnp.asarray(raw).astype(jnp.float32) * js).astype(jnp.bfloat16))
    got = ell_apply(rows, q, _t(base), _t(br), scale=s,
                    out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))


# ---------------------------------------------------------------------------
# K2's plain version at bf16 and int8 slabs; the hybrid's int8 modes
# ---------------------------------------------------------------------------

def _hybrid(tile=32, occ=4, seed=67):
    g = sbm_graph(n_nodes=300, n_class=5, n_feat=6, p_in=0.15, p_out=0.003,
                  seed=seed)
    art = build_artifacts(g, partition_graph(g, 1))
    pi, pe = t_blk.cluster_order(art.src[0], art.dst[0], art.pad_inner,
                                 art.n_ext, target=tile, log=lambda m: None)
    fwd, bwd, pair, arrays = t_blk.build_block_layouts(
        art.src, art.dst, art.pad_inner, art.n_ext, pi[None], pe[None],
        occupancy_min=occ, tile_r=tile, tile_c=tile)
    assert t_blk.dense_edge_count(arrays) > 0
    return art, fwd, bwd, pair, {k: v[0] for k, v in arrays.items()}


_DIRS = (("fwd", "blk_perm_ext", "blk_perm_inner"),
         ("bwd", "blk_perm_inner", "blk_perm_ext"))


@pytest.mark.parametrize("slabs", ["int8", "bf16"])
def test_tile_matmul_plain_narrow_slabs_match_pallas(slabs):
    """K2's plain version against pallas_tile_matmul (interpret) on the
    same slabs, forward and transposed stacks: int8 slabs give the raw
    int32 sums, array-equal; bf16 slabs f32 sums of products exact in f32
    (rtol 1e-6). Unvisited row-blocks are zero."""
    art, fwd, bwd, _, a = _hybrid()
    rng = np.random.default_rng(5)
    for (d, psrc, _), spec in zip(_DIRS, (fwd, bwd)):
        tiles, rowb, colb = (a[f"blk_{k}_{d}"] for k in
                             ("tiles", "rowb", "colb"))
        h = rng.normal(size=(spec.n_src, 9)).astype(np.float32)
        x = t_blk.build_x_slabs(spec, _t(a[psrc]), _t(h))
        if slabs == "int8":
            x, _ = t_blk.quantize_slabs(x, per_slab=False)
            jx = jnp.asarray(x.numpy())
        else:
            x = x.to(torch.bfloat16)
            jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
        ours = tile_matmul_plain(_t(tiles), _t(rowb), _t(colb), x,
                                 spec.n_row_blocks).numpy()
        pal = np.asarray(pallas_tile_matmul(
            jnp.asarray(tiles), jnp.asarray(rowb), jnp.asarray(colb), jx,
            spec.n_row_blocks, interpret=True))
        visited = np.zeros(spec.n_row_blocks, bool)
        visited[rowb[rowb < spec.n_row_blocks]] = True
        if slabs == "int8":
            assert ours.dtype == np.int32 and pal.dtype == np.int32
            np.testing.assert_array_equal(ours[visited], pal[:-1][visited])
        else:
            np.testing.assert_allclose(ours[visited], pal[:-1][visited],
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(ours[~visited], 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_dense_per_call_matches_dense_apply_pallas(dtype):
    """The per-call int8 mode (one amax/127 scale, int32 sums, x scale)
    against dense_apply_pallas(dense_dtype='int8', interpret=True), in row
    order, for f32 and bf16 activations: array-equal (the same
    quantization, exact sums, one f32 multiply; JAX's cast to bf16 is the
    one K1 makes of its base)."""
    art, fwd, bwd, _, a = _hybrid()
    rng = np.random.default_rng(6)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    for (d, psrc, pout), spec in zip(_DIRS, (fwd, bwd)):
        h = rng.normal(size=(spec.n_src, 8)).astype(np.float32)
        th = _t(h).to(getattr(torch, dtype))
        assert t_blk.dense_mode(spec, "int8") == "int8"
        port = t_blk.dense_tiles(
            spec, _t(a[f"blk_tiles_{d}"]), _t(a[f"blk_rowb_{d}"]),
            _t(a[f"blk_colb_{d}"]),
            row_offsets(_t(a[f"blk_rowb_{d}"]), spec.n_row_blocks),
            *pack_tiles(_t(a[f"blk_tiles_{d}"])), _t(a[psrc]), th,
            mode="int8")[_t(a[pout]).long()]
        jargs = [jnp.asarray(a[k]) for k in (f"blk_tiles_{d}",
                                             f"blk_rowb_{d}",
                                             f"blk_colb_{d}", psrc, pout)]
        ref = dense_apply_pallas(spec, *jargs, jnp.asarray(h, jdt),
                                 dense_dtype="int8", interpret=True)
        np.testing.assert_array_equal(
            port.to(getattr(torch, dtype)).float().numpy(),
            np.asarray(ref).astype(np.float32))


def test_int8_dense_per_slab_matches_dense_apply():
    """The per-slab int8 mode (one scale per slab, each tile's int32 sums
    scaled into f32) against bnsgcn_tpu/ops/block_spmm.py `_dense_apply`
    (dense_dtype='int8'): rtol 1e-5, its f32 sums over tiles in another
    order."""
    art, fwd, bwd, _, a = _hybrid()
    rng = np.random.default_rng(7)
    for (d, psrc, pout), spec in zip(_DIRS, (fwd, bwd)):
        h = rng.normal(size=(spec.n_src, 8)).astype(np.float32)
        port = t_blk.dense_tiles(
            spec, _t(a[f"blk_tiles_{d}"]), _t(a[f"blk_rowb_{d}"]),
            _t(a[f"blk_colb_{d}"]),
            row_offsets(_t(a[f"blk_rowb_{d}"]), spec.n_row_blocks),
            *pack_tiles(_t(a[f"blk_tiles_{d}"])), _t(a[psrc]), _t(h),
            mode="int8-slab")[_t(a[pout]).long()].numpy()
        jargs = [jnp.asarray(a[k]) for k in (f"blk_tiles_{d}",
                                             f"blk_rowb_{d}",
                                             f"blk_colb_{d}", psrc, pout)]
        ref = np.asarray(j_blk._dense_apply(spec, *jargs, jnp.asarray(h),
                                            dense_dtype="int8"))
        np.testing.assert_allclose(port, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("row_cap", [t_blk.I8_ROW_CAP, 2])
def test_quantized_hybrid_spmm_and_the_overflow_guard(row_cap):
    """The hybrid with int8 dense tiles and int8 gathers, forward and d/dh.
    At the real cap both directions take the per-call mode; a cap below the
    layout's max_row_dense (as a row of more than (2^31 - 1) / 127^2 dense
    edges would) sends them to the per-slab mode, which the JAX package's
    make_block_spmm also takes here (its XLA route): held to it at 1e-5 of
    max |ref|. The per-call mode quantizes all slabs with one scale, so it
    is held to the JAX test's own bound, 0.05 max |ref|."""
    art, fwd, bwd, pair, a = _hybrid()
    op = t_blk.BlockSpmm(fwd, bwd, pair, {k: _t(v) for k, v in a.items()},
                         gather_dtype="int8", dense_dtype="int8",
                         row_cap=row_cap)
    assert fwd.max_row_dense > 2 and bwd.max_row_dense > 2
    mode = "int8" if row_cap == t_blk.I8_ROW_CAP else "int8-slab"
    assert op.mode == {"fwd": mode, "bwd": mode}
    rng = np.random.default_rng(9)
    h = rng.normal(size=(art.n_ext, 7)).astype(np.float32)
    cot = rng.normal(size=(art.pad_inner, 7)).astype(np.float32)
    ref, d_ref = _jax_fwd_grad(j_blk.make_block_spmm(
        fwd, bwd, pair, use_pallas=True, gather_dtype="int8",
        dense_dtype="int8"), a, h, cot)
    got, d_got = _torch_fwd_grad(op, h, cot)
    frac = 1e-5 if mode == "int8-slab" else 0.05
    _close(got, ref, frac)
    _close(d_got, d_ref, frac)


# ---------------------------------------------------------------------------
# --spmm auto
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clustered", [True, False])
def test_estimate_coverage_and_auto_resolution_match_jax(clustered):
    """estimate_coverage equals the JAX package's on the same perms, on a
    clustered graph (an SBM) and an unclustered one (a random graph), at
    occupancies on both sides of the decision; resolve_spmm picks what the
    JAX rule AUTO_HYBRID_MIN_COVERAGE picks and reuses the perms; the
    occupancies sweep across the decision on both graphs."""
    from bnsgcn_tpu.trainer import AUTO_HYBRID_MIN_COVERAGE as J_MIN
    from bnsgcn_tpu_torch.trainer import (AUTO_HYBRID_MIN_COVERAGE,
                                          resolve_spmm)
    assert AUTO_HYBRID_MIN_COVERAGE == J_MIN
    g = (sbm_graph(n_nodes=300, n_class=5, n_feat=6, p_in=0.15, p_out=0.003,
                   seed=61) if clustered else
         synthetic_graph(n_nodes=300, avg_degree=12, n_feat=6, seed=61))
    art = build_artifacts(g, partition_graph(g, 1))
    pi, pe = t_blk.cluster_order(art.src[0], art.dst[0], art.pad_inner,
                                 art.n_ext, target=64, log=lambda m: None)
    real = art.dst[0] < art.pad_inner
    d, s = art.dst[0][real], art.src[0][real]
    picks = set()
    for occ in (4, 16, 64, 10**9):
        est = t_blk.estimate_coverage(pi, pe, art.pad_inner, art.n_ext, d, s,
                                      occupancy_min=occ, tile_r=64,
                                      tile_c=64)
        ref = j_blk.estimate_coverage(pi, pe, art.pad_inner, art.n_ext, d, s,
                                      occupancy_min=occ, tile_r=64,
                                      tile_c=64)
        assert est == ref
        cfg = Config(spmm="auto", block_tile=64, block_occupancy=occ)
        kind, perms = resolve_spmm(cfg, art, log=lambda m: None)
        assert kind == ("hybrid" if ref >= J_MIN else "ell")
        assert (perms is not None) == (kind == "hybrid")
        picks.add(kind)
    assert picks == {"hybrid", "ell"}      # the sweep crosses the decision


# ---------------------------------------------------------------------------
# bf16 training at P=1
# ---------------------------------------------------------------------------

BF16_EPOCHS = 3
BF16_LOSS_RTOL = 2e-2


def _jax_bf16_run(art_j, cfg_kw, init_np, spmm):
    """The JAX package at P=1 with dtype=bfloat16 from `init_np` (f32
    numpy parameters, cast to bf16 as init_params(dtype) would hold them):
    the losses, and the final parameters and Adam moments as f32 numpy."""
    from bnsgcn_tpu.config import Config as JConfig
    from bnsgcn_tpu.models.gnn import ModelSpec
    from bnsgcn_tpu.parallel.mesh import make_parts_mesh
    from bnsgcn_tpu.trainer import (build_block_arrays, build_step_fns,
                                    make_tx, place_blocks, place_replicated)
    spec = ModelSpec(cfg_kw["model"], (art_j.n_feat, 16, 16, art_j.n_class),
                     norm="layer", dropout=0.0, use_pp=True,
                     train_size=art_j.n_train)
    cfg = JConfig(model=cfg_kw["model"], dropout=0.0, use_pp=True,
                  norm="layer", n_train=art_j.n_train, lr=0.01,
                  weight_decay=5e-4, spmm=spmm, block_tile=32,
                  block_occupancy=4, dtype="bfloat16", n_partitions=1)
    mesh = make_parts_mesh(1)
    fns, _, tb, tbf = build_step_fns(cfg, spec, art_j, mesh)
    blk_np = build_block_arrays(art_j, spec.model)
    blk_np.update(fns.extra_blk)
    for k in fns.drop_blk_keys:
        blk_np.pop(k, None)
    blk = place_blocks(blk_np, mesh)
    blk["feat"] = blk["feat"].astype(jnp.bfloat16)
    blk["feat"] = fns.precompute(blk, place_replicated(tbf, mesh)).astype(
        jnp.bfloat16)
    params = jax.tree.map(lambda v: jnp.asarray(v, jnp.bfloat16), init_np)
    opt = make_tx(cfg).init(params)
    pp, ss, opt = (place_replicated(x, mesh) for x in (params, {}, opt))
    tb = place_replicated(tb, mesh)
    losses = []
    for e in range(BF16_EPOCHS):
        pp, ss, opt, loss = fns.train_step(pp, ss, opt, jnp.uint32(e), blk,
                                           tb, jax.random.key(0),
                                           jax.random.key(1))
        losses.append(float(loss))
    return losses, jax.tree.map(lambda v: np.asarray(v, np.float32), pp)


@pytest.mark.parametrize("spmm", ["ell", "hybrid"])
def test_bf16_training_p1_matches_jax(spmm):
    """--dtype bfloat16 at P=1 (GraphSAGE with use_pp and LayerNorm,
    dropout 0) from the same parameters as the JAX package's bf16 run:
    parameters and Adam moments are bf16, the features and the precompute
    bf16, the loss f32. Bound: 2e-2 relative on each epoch's loss. Both
    round activations to bf16 at every layer (8 significant bits, 2^-8
    relative per rounding) but at different points (torch's bf16 matmul
    and Adam round once per fused op, XLA per primitive), and 3 steps of
    Adam at lr 0.01 in bf16 compound that; the bound is a few hundred such
    roundings and still fails a run whose loss does not fall alike. The
    port's bf16 losses also differ from its f32 run of the same
    parameters: the bf16 arithmetic really ran."""
    from bnsgcn_tpu.data.artifacts import build_artifacts as j_build
    from bnsgcn_tpu.data.graph import sbm_graph as j_sbm
    from bnsgcn_tpu_torch.models.gnn import spec_from_config
    from bnsgcn_tpu_torch.run import init_training, prepare_run
    from bnsgcn_tpu_torch.trainer import params_from_jax
    gkw = dict(n_nodes=200, n_class=4, n_feat=12, p_in=0.15, p_out=0.01,
               seed=29)
    g = sbm_graph(**gkw)
    cfg = Config(model="graphsage", n_layers=3, n_hidden=16, dropout=0.0,
                 use_pp=True, norm="layer", lr=0.01, weight_decay=5e-4,
                 spmm=spmm, block_tile=32, block_occupancy=4,
                 dtype="bfloat16", n_partitions=1, n_epochs=BF16_EPOCHS,
                 eval=False, device="cpu", seed=0)
    pr = prepare_run(cfg, g=g, log=lambda m: None)
    from bnsgcn_tpu.models.gnn import ModelSpec, init_params
    jspec = ModelSpec("graphsage", (pr.cfg.n_feat, 16, 16, pr.cfg.n_class),
                      norm="layer", dropout=0.0, use_pp=True,
                      train_size=pr.cfg.n_train)
    params, _ = init_params(jax.random.key(3), jspec)
    init_np = jax.tree.map(
        lambda v: np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32),
        params)
    ref_losses, ref_params = _jax_bf16_run(
        j_build(j_sbm(**gkw), partition_graph(g, 1)),
        {"model": "graphsage"}, init_np, spmm)
    spec = spec_from_config(pr.cfg)
    blk, model, opt = init_training(pr, params_from_jax(init_np, spec))
    assert blk["feat"].dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    losses = [float(pr.fns.train_step(model, opt, blk, e))
              for e in range(BF16_EPOCHS)]
    for st in opt.state.values():
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.bfloat16
    np.testing.assert_allclose(losses, ref_losses, rtol=BF16_LOSS_RTOL)
    pr32 = prepare_run(cfg.replace(dtype="float32"), g=g, log=lambda m: None)
    blk32, m32, o32 = init_training(pr32, params_from_jax(init_np, spec))
    f32 = [float(pr32.fns.train_step(m32, o32, blk32, e))
           for e in range(BF16_EPOCHS)]
    assert losses != f32
    assert losses[-1] < losses[0] and ref_losses[-1] < ref_losses[0]
    assert set(ref_params) == {"layer_0", "layer_1", "layer_2", "norm_0",
                               "norm_1"}
