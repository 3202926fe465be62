"""The port's SpMM operators and their kernels' plain versions against the
JAX package, on the CPU (the kernels themselves: test_torch_cuda.py).

Inputs come from numpy with a seed and go through both packages. Pallas
kernels run as the JAX package's own tests run them here (interpret=True).
Tolerance rtol = atol = 1e-5 for every float comparison: f32 sums of a few
dozen terms, taken in a different order by XLA:CPU and by PyTorch.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnsgcn_tpu.ops import block_spmm as j_blk
from bnsgcn_tpu.ops import ell as j_ell
from bnsgcn_tpu.ops.pallas_block import dense_apply_pallas, pallas_tile_matmul
from bnsgcn_tpu_torch.data.artifacts import build_artifacts
from bnsgcn_tpu_torch.data.graph import sbm_graph, synthetic_graph
from bnsgcn_tpu_torch.data.partitioner import partition_graph
from bnsgcn_tpu_torch.ops import block_spmm as t_blk
from bnsgcn_tpu_torch.ops import ell as t_ell
from bnsgcn_tpu_torch.ops.bucket_reduce import (bucket_reduce,
                                                bucket_reduce_plain,
                                                launches as k3_launches)
from bnsgcn_tpu_torch.ops.bucket_sum import (bucket_sum_plain, ell_apply,
                                             launches as k1_launches)
from bnsgcn_tpu_torch.ops.copy_probe import (PROBE_SHAPE, copy_probe,
                                             copy_probe_plain,
                                             launches as k4_launches)
from bnsgcn_tpu_torch.ops.tile_matmul import (launches as k2_launches,
                                              pack_tiles, row_offsets,
                                              tile_matmul, tile_matmul_plain)
from tools.pallas_spmm import pallas_bucket_reduce, pallas_bucket_sum

TOL = dict(rtol=1e-5, atol=1e-5)   # f32, summation order differs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in parallel workers; torch would otherwise spread each
    # tiny op over every core and crowd the timing-sensitive tests beside it
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# (b) K1: the ELL bucket gather-sum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,h_dim,r,w", [(50, 8, 16, 4), (40, 7, 24, 16)])
def test_bucket_sum_plain_matches_jax(n, h_dim, r, w):
    """Plain K1 == the XLA bucket sum (both accumulations) == the Pallas
    bucket kernel in interpret mode; pad index n contributes nothing."""
    rng = np.random.default_rng(n + w)
    h = rng.normal(size=(n, h_dim)).astype(np.float32)
    idx = rng.integers(0, n + 1, size=(r, w)).astype(np.int32)
    idx[0] = n                                     # an all-pad row
    hp = jnp.asarray(np.concatenate([h, np.zeros((1, h_dim), np.float32)]))
    ours = bucket_sum_plain(_t(h), _t(idx)).numpy()
    for accum in ("reduce", "unroll"):
        ref = np.asarray(j_ell._bucket_sum(hp, jnp.asarray(idx), w,
                                           accum=accum))
        np.testing.assert_allclose(ours, ref, **TOL)
    pal = np.asarray(pallas_bucket_sum(hp, jnp.asarray(idx), interpret=True))
    np.testing.assert_allclose(ours, pal, **TOL)
    np.testing.assert_array_equal(ours[0], 0.0)


def test_bucket_sum_wrapper_takes_plain_on_cpu():
    """A CPU tensor takes the plain version and counts no kernel launch: the
    plain bucket sum gives the same sums row-chunked or not, and K1's
    wrapper on a CPU layout (with and without a base) gives the layout's
    row sums, computed here from its CSR."""
    rng = np.random.default_rng(3)
    h = _t(rng.normal(size=(30, 5)).astype(np.float32))
    idx = _t(rng.integers(0, 31, size=(40, 8)).astype(np.int32))
    before = k1_launches.total
    np.testing.assert_allclose(bucket_sum_plain(h, idx).numpy(),
                               bucket_sum_plain(h, idx, chunk_gathers=16)
                               .numpy(), **TOL)

    g = synthetic_graph(n_nodes=120, avg_degree=9, n_feat=6, seed=2,
                        power_law=True)
    art = build_artifacts(g, partition_graph(g, 1))
    fs, bs, arrays = t_ell.build_layouts(art.src, art.dst, art.pad_inner,
                                         art.n_ext, geometry=art.ell_geometry)
    op = t_ell.EllSpmm(fs, bs, {k: _t(v[0]) for k, v in arrays.items()})
    h = _t(rng.normal(size=(art.n_ext, 5)).astype(np.float32))
    base = _t(rng.normal(size=(art.pad_inner + 3, 5)).astype(np.float32))
    base_row = _t(rng.permutation(art.pad_inner + 3)[:art.pad_inner]
                  .astype(np.int32))
    rows = op.rows["fwd"]
    deg = (rows.row_ptr[1:] - rows.row_ptr[:-1]).long()
    seg = torch.repeat_interleave(torch.arange(rows.n_rows), deg)
    sums = torch.zeros((rows.n_rows, 5)).index_add_(0, seg,
                                                    h[rows.src.long()])
    for b, br, want in ((None, None, sums),
                        (base, base_row, base[base_row.long()] + sums)):
        np.testing.assert_allclose(ell_apply(rows, h, b, br).numpy(),
                                   want.numpy(), **TOL)
    assert k1_launches.total == before


# ---------------------------------------------------------------------------
# (c) K2: the dense-tile grouped matmul
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
    return art, fwd, bwd, pair, arrays


def test_tile_matmul_plain_matches_pallas_and_xla():
    """Plain K2 == pallas_tile_matmul (interpret) on its visited blocks, and
    the port's dense_tiles, permuted back to row order, ==
    dense_apply_pallas (interpret) == the XLA _dense_apply, forward and on
    the transposed (backward) stack."""
    art, fwd, bwd, _, arrays = _hybrid()
    a = {k: v[0] for k, v in arrays.items()}
    rng = np.random.default_rng(3)
    for spec, d, psrc, pout in ((fwd, "fwd", "blk_perm_ext", "blk_perm_inner"),
                                (bwd, "bwd", "blk_perm_inner", "blk_perm_ext")):
        tiles, rowb, colb = (a[f"blk_tiles_{d}"], a[f"blk_rowb_{d}"],
                             a[f"blk_colb_{d}"])
        h = rng.normal(size=(spec.n_src, 7)).astype(np.float32)
        x = t_blk.build_x_slabs(spec, _t(a[psrc]), _t(h))
        ours = tile_matmul_plain(_t(tiles), _t(rowb), _t(colb), x,
                                 spec.n_row_blocks).numpy()
        pal = np.asarray(pallas_tile_matmul(
            jnp.asarray(tiles), jnp.asarray(rowb), jnp.asarray(colb),
            jnp.asarray(x.numpy()), spec.n_row_blocks, interpret=True))
        visited = np.zeros(spec.n_row_blocks, bool)
        visited[rowb[rowb < spec.n_row_blocks]] = True
        np.testing.assert_allclose(ours[visited], pal[:-1][visited], **TOL)
        np.testing.assert_array_equal(ours[~visited], 0.0)

        port = t_blk.dense_tiles(spec, _t(tiles), _t(rowb), _t(colb),
                                 row_offsets(_t(rowb), spec.n_row_blocks),
                                 *pack_tiles(_t(tiles)), _t(a[psrc]),
                                 _t(h))[_t(a[pout]).long()].numpy()
        jargs = [jnp.asarray(a[k]) for k in (f"blk_tiles_{d}",
                                             f"blk_rowb_{d}",
                                             f"blk_colb_{d}", psrc, pout)]
        np.testing.assert_allclose(
            port, np.asarray(dense_apply_pallas(spec, *jargs, jnp.asarray(h),
                                                interpret=True)), **TOL)
        np.testing.assert_allclose(
            port, np.asarray(j_blk._dense_apply(spec, *jargs,
                                                jnp.asarray(h))), **TOL)


def test_row_offsets_is_csr_over_sorted_rowb():
    rowb = torch.tensor([0, 0, 2, 2, 2, 5, 6, 6], dtype=torch.int32)  # 6 = pad
    assert row_offsets(rowb, 6).tolist() == [0, 2, 2, 5, 5, 5, 6]


def test_tile_matmul_wrapper_takes_plain_on_cpu():
    _, fwd, _, _, arrays = _hybrid()
    a = {k: _t(v[0]) for k, v in arrays.items()}
    x = torch.randn((fwd.n_src + fwd.col_tile) // fwd.col_tile, fwd.col_tile,
                    3, generator=torch.Generator().manual_seed(0))
    before = k2_launches.total
    out = tile_matmul(a["blk_tiles_fwd"], a["blk_rowb_fwd"],
                      a["blk_colb_fwd"],
                      row_offsets(a["blk_rowb_fwd"], fwd.n_row_blocks),
                      *pack_tiles(a["blk_tiles_fwd"]), x, fwd.n_row_blocks)
    assert out.shape == (fwd.n_row_blocks, fwd.row_tile, 3)
    assert k2_launches.total == before


# ---------------------------------------------------------------------------
# (d) the ELL and hybrid SpMM: forward and d/dh against the JAX custom_vjps
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("graph", ["sbm", "powerlaw"])
def test_ell_spmm_matches_jax(graph):
    if graph == "sbm":
        g = sbm_graph(n_nodes=240, n_class=4, n_feat=6, p_in=0.12,
                      p_out=0.004, seed=63)
    else:   # rows above the split cap exercise the chunk combine
        g = synthetic_graph(n_nodes=400, avg_degree=40, n_feat=6, seed=5,
                            power_law=True)
    art = build_artifacts(g, partition_graph(g, 1))
    fs, bs, arrays = t_ell.build_layouts(art.src, art.dst, art.pad_inner,
                                         art.n_ext, geometry=art.ell_geometry)
    a0 = {k: v[0] for k, v in arrays.items()}
    rng = np.random.default_rng(1)
    h = rng.normal(size=(art.n_ext, 5)).astype(np.float32)
    cot = rng.normal(size=(art.pad_inner, 5)).astype(np.float32)
    jspmm = j_ell.make_ell_spmm(fs, bs, len(fs.widths), len(bs.widths))
    ref, d_ref = _jax_fwd_grad(jspmm, a0, h, cot)
    got, d_got = _torch_fwd_grad(
        t_ell.EllSpmm(fs, bs, {k: _t(v) for k, v in a0.items()}), h, cot)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(d_got, d_ref, **TOL)


@pytest.mark.parametrize("tile,occ", [(32, 4), (64, 4), (32, 10**9)])
def test_hybrid_spmm_matches_jax(tile, occ):
    """Hybrid forward and d/dh == the JAX make_block_spmm (XLA dense path
    and its custom VJP on the transposed tiles); occ=huge = no dense tile."""
    g = sbm_graph(n_nodes=300, n_class=5, n_feat=6, p_in=0.15, p_out=0.003,
                  seed=61)
    art = build_artifacts(g, partition_graph(g, 1))
    pi, pe = t_blk.cluster_order(art.src[0], art.dst[0], art.pad_inner,
                                 art.n_ext, target=tile, log=lambda m: None)
    fwd, bwd, pair, arrays = t_blk.build_block_layouts(
        art.src, art.dst, art.pad_inner, art.n_ext, pi[None], pe[None],
        occupancy_min=occ, tile_r=tile, tile_c=tile)
    a0 = {k: v[0] for k, v in arrays.items()}
    rng = np.random.default_rng(2)
    h = rng.normal(size=(art.n_ext, 7)).astype(np.float32)
    cot = rng.normal(size=(art.pad_inner, 7)).astype(np.float32)
    ref, d_ref = _jax_fwd_grad(j_blk.make_block_spmm(fwd, bwd, pair), a0, h,
                               cot)
    got, d_got = _torch_fwd_grad(
        t_blk.BlockSpmm(fwd, bwd, pair, {k: _t(v) for k, v in a0.items()}),
        h, cot)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(d_got, d_ref, **TOL)


# ---------------------------------------------------------------------------
# (e) K3: the width-axis bucket reduce; K4: the manual-copy probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(24, 8, 602), (16, 5, 7)])
def test_bucket_reduce_plain_matches_pallas(shape, dtype):
    """Plain K3 == pallas_bucket_reduce in interpret mode (as
    tests/test_pallas_spmm.py runs it), f32 and bf16 inputs made from the
    same f32 numbers. f32: TOL. bf16: both sum in f32 and round once, but
    XLA may sum in another order, so a sum on a rounding boundary may land
    one bf16 ulp away: rtol 2^-7, atol 1e-5."""
    rng = np.random.default_rng(shape[1])
    x = rng.normal(size=shape).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    pal = pallas_bucket_reduce(jnp.asarray(x, jdt), interpret=True)
    ours = bucket_reduce_plain(_t(x).to(tdt))
    assert ours.dtype == tdt and ours.shape == (shape[0], shape[2])
    tol = TOL if dtype == "float32" else dict(rtol=2.0 ** -7, atol=1e-5)
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(pal, np.float32), **tol)


def test_bucket_reduce_wrapper_takes_plain_on_cpu():
    x = torch.randn(8, 3, 10, generator=torch.Generator().manual_seed(1))
    before = k3_launches.total
    assert torch.equal(bucket_reduce(x), bucket_reduce_plain(x))
    torch.testing.assert_close(bucket_reduce(x), x.sum(1), **TOL)
    assert k3_launches.total == before


def test_copy_probe_plain_matches_pallas_probe():
    """Plain K4 == the probe's manual-DMA kernel (tools/hw_session.py
    `dma_kernel`, whose body is copied here because it lives in a script
    string) run in Pallas interpret mode. The probe names its memory spaces
    pltpu.TPUMemorySpace.ANY / .VMEM, which the installed jax calls pl.ANY
    and pltpu.VMEM. Bitwise: both are copies."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    def dma_kernel(x_ref, o_ref, scratch, sem):
        c = pltpu.make_async_copy(x_ref.at[0], scratch.at[0], sem)
        c.start(); c.wait()
        o_ref[...] = scratch[...]

    x = np.random.default_rng(4).normal(size=PROBE_SHAPE).astype(np.float32)
    y = pl.pallas_call(
        dma_kernel,
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1,) + PROBE_SHAPE[1:], jnp.float32),
        scratch_shapes=[pltpu.VMEM((1,) + PROBE_SHAPE[1:], jnp.float32),
                        pltpu.SemaphoreType.DMA],
        interpret=True)(jnp.asarray(x))
    before = k4_launches.total
    ours = copy_probe(_t(x))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(y))
    np.testing.assert_array_equal(copy_probe_plain(_t(x)).numpy(), x[0:1])
    assert k4_launches.total == before


# ---------------------------------------------------------------------------
# (f) the kernels' launcher
# ---------------------------------------------------------------------------

def test_kernel_declares_its_entry_point_on_a_library_loaded_elsewhere(
        monkeypatch):
    """A Kernel sets its C function's argtypes/restype itself, so it holds
    when another caller loaded the library first (with no declare); a
    non-zero return raises with the library's own error text. libc stands
    in for a kernel library: abs as the entry point, strerror as the
    error-text function."""
    from bnsgcn_tpu_torch import buildlib

    libc = ctypes.CDLL(None)
    loads = []

    def load(name, kind, sources, declare=None):
        loads.append((name, kind, declare))
        return libc

    monkeypatch.setattr(buildlib, "load", load)
    k = buildlib.Kernel("stand_in", "stand_in.cu", "abs", [ctypes.c_int],
                        "strerror")
    k(0)
    assert loads == [("stand_in", "cuda", None)]
    assert libc.abs.argtypes == [ctypes.c_int]
    assert libc.abs.restype is ctypes.c_int
    assert libc.strerror.restype is ctypes.c_char_p
    k(0)
    assert len(loads) == 1                  # resolved once per process
    with pytest.raises(RuntimeError, match="abs launch failed"):
        k(2)                                # abs(2) == 2: a CUDA-style code
