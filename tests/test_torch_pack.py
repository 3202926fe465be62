"""`pack_tiles`: the dense-tile stacks' nonzero entries as kernel K2 reads
them, on the CPU.

The packed form must hold exactly what the dense int8 tiles hold: rebuilt to
dense tiles it is array-equal to the stack (P=1 and every part of a P=4
layout, forward and transposed), and a plain index_add_ over its entries
gives K2's function, tile_matmul_plain and the JAX package's
pallas_tile_matmul (interpret mode) to rtol = atol = 1e-5 (f32 sums of a few
dozen terms in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnsgcn_tpu.ops.pallas_block import pallas_tile_matmul
from bnsgcn_tpu_torch.data.artifacts import build_artifacts
from bnsgcn_tpu_torch.data.graph import sbm_graph
from bnsgcn_tpu_torch.data.partitioner import partition_graph
from bnsgcn_tpu_torch.ops import block_spmm as t_blk
from bnsgcn_tpu_torch.ops.tile_matmul import (pack_tiles, row_offsets,
                                              tile_matmul_plain)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _layouts(n_parts, tile=32):
    """One hybrid layout per part, each built from the part alone (as every
    rank builds its own)."""
    g = sbm_graph(n_nodes=300, n_class=5, n_feat=6, p_in=0.15, p_out=0.003,
                  seed=67)
    art = build_artifacts(g, partition_graph(g, n_parts))
    out = []
    for p in range(n_parts):
        pi, pe = t_blk.cluster_order(art.src[p], art.dst[p], art.pad_inner,
                                     art.n_ext, target=tile,
                                     log=lambda m: None)
        fwd, bwd, _, arrays = t_blk.build_block_layouts(
            art.src[p:p + 1], art.dst[p:p + 1], art.pad_inner, art.n_ext,
            pi[None], pe[None], occupancy_min=4, tile_r=tile, tile_c=tile)
        out.append((fwd, bwd, {k: v[0] for k, v in arrays.items()}))
    return out


def _unpack(ent, ent_off, tc):
    """The dense int8 stack [B, TR, TC] the packed entries describe."""
    b, tr1 = ent_off.shape
    tr = tr1 - 1
    counts = (ent_off[:, 1:] - ent_off[:, :-1]).reshape(-1).long()
    row = torch.repeat_interleave(torch.arange(b * tr), counts)
    col = (ent >> 8).long()
    val = (ent & 0xFF).to(torch.uint8).view(torch.int8)
    dense = torch.zeros(b * tr * tc, dtype=torch.int8)
    dense[row * tc + col] = val
    return dense.view(b, tr, tc)


def _check_structure(ent, ent_off, tiles):
    b, tr, tc = tiles.shape
    assert ent.dtype == ent_off.dtype == torch.int32
    assert ent_off.shape == (b, tr + 1)
    assert int(ent_off[0, 0]) == 0 and int(ent_off[-1, -1]) == ent.numel()
    # each tile's last offset is the next tile's first; rows never shrink
    assert torch.equal(ent_off[1:, 0], ent_off[:-1, -1])
    assert bool((ent_off[:, 1:] >= ent_off[:, :-1]).all())
    assert ent.numel() == int((tiles != 0).sum())
    # sorted by (tile, row, column): the columns rise strictly within a row
    col = ent >> 8
    starts = torch.zeros(ent.numel(), dtype=torch.bool)
    starts[ent_off[:, :-1].reshape(-1)[
        ent_off[:, :-1].reshape(-1) < ent.numel()].long()] = True
    assert bool(((col[1:] > col[:-1]) | starts[1:]).all())


def _index_add(ent, ent_off, rowb, colb, x, n_row_blocks):
    """K2's function from the packed entries alone, in plain torch: every
    entry adds mult * x_slabs[colb[tile], col] to out[rowb[tile], row]."""
    b, tr1 = ent_off.shape
    tr = tr1 - 1
    counts = (ent_off[:, 1:] - ent_off[:, :-1]).reshape(-1).long()
    tile_row = torch.repeat_interleave(torch.arange(b * tr), counts)
    tile, row = tile_row // tr, tile_row % tr
    col = (ent >> 8).long()
    mult = (ent & 0xFF).to(torch.uint8).view(torch.int8).float()
    out = torch.zeros(((n_row_blocks + 1) * tr, x.shape[-1]))
    src = x[colb.long()[tile], col] * mult[:, None]
    out.index_add_(0, rowb.long()[tile] * tr + row, src)
    return out.view(n_row_blocks + 1, tr, -1)[:n_row_blocks]


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("n_parts", [1, 4])
def test_pack_tiles_round_trips_the_layouts(n_parts, direction):
    for fwd, bwd, a in _layouts(n_parts):
        spec = fwd if direction == "fwd" else bwd
        tiles = _t(a[f"blk_tiles_{direction}"])
        assert tiles.shape[1:] == (spec.row_tile, spec.col_tile)
        ent, ent_off = pack_tiles(tiles)
        _check_structure(ent, ent_off, tiles)
        assert torch.equal(_unpack(ent, ent_off, spec.col_tile), tiles)
        # pad tiles (rowb == n_row_blocks) own no entries
        pad = _t(a[f"blk_rowb_{direction}"]) == spec.n_row_blocks
        assert bool((ent_off[pad, -1] == ent_off[pad, 0]).all())


def test_pack_tiles_edge_cases():
    """A pad tile, a row-block with no tiles, multiplicities above 1 (and a
    negative int8, which the packing keeps as its low byte), a full tile
    row, an all-zero tile, packed the same in chunks of any size."""
    tr, tc = 8, 16
    tiles = torch.zeros(5, tr, tc, dtype=torch.int8)
    tiles[0, 2, 3] = 1
    tiles[0, 2, 15] = 127                  # multiplicity > 1, last column
    tiles[0, 7, 0] = 5
    tiles[1, 4, :] = torch.arange(1, tc + 1, dtype=torch.int8)  # full row
    tiles[1, 0, 9] = -3
    # tile 2 is all zero; tile 3 is real; tile 4 is the pad
    tiles[3, 1, 1] = 2
    rowb = torch.tensor([0, 0, 2, 3, 4], dtype=torch.int32)  # 1: no tiles
    colb = torch.tensor([0, 1, 1, 0, 0], dtype=torch.int32)
    n_rb = 4
    ent, ent_off = pack_tiles(tiles)
    _check_structure(ent, ent_off, tiles)
    assert torch.equal(_unpack(ent, ent_off, tc), tiles)
    assert ent.numel() == 3 + tc + 1 + 1
    assert int(ent_off[1, 5] - ent_off[1, 4]) == tc          # the full row
    assert int(ent_off[2, -1] - ent_off[2, 0]) == 0          # all-zero tile
    assert int(ent_off[4, -1] - ent_off[4, 0]) == 0          # the pad
    for chunk in (1, tr * tc, 2 * tr * tc + 1, 1 << 30):
        e2, o2 = pack_tiles(tiles, chunk_bytes=chunk)
        assert torch.equal(e2, ent) and torch.equal(o2, ent_off)
    x = torch.randn(2, tc, 3, generator=torch.Generator().manual_seed(0))
    got = _index_add(ent, ent_off, rowb, colb, x, n_rb)
    ref = tile_matmul_plain(tiles, rowb, colb, x, n_rb)
    torch.testing.assert_close(got, ref, **TOL)
    assert bool((got[1] == 0).all())                      # no tiles: zero
    # an empty stack packs to nothing
    e0, o0 = pack_tiles(torch.zeros(0, tr, tc, dtype=torch.int8))
    assert e0.numel() == 0 and o0.shape == (0, tr + 1)


def test_pack_tiles_rejects_what_it_cannot_pack():
    with pytest.raises(ValueError):
        pack_tiles(torch.zeros(1, 4, 4, dtype=torch.int32))
    with pytest.raises(ValueError):
        pack_tiles(torch.zeros(1, 1, 1 << 24, dtype=torch.int8))


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_index_add_over_packed_entries_is_k2(direction):
    """The packed entries carry K2's whole function: an index_add_ over them
    equals tile_matmul_plain and pallas_tile_matmul (interpret) on the
    visited row-blocks, and is zero on the others."""
    (fwd, bwd, a), = _layouts(1, tile=64)
    spec = fwd if direction == "fwd" else bwd
    psrc = "blk_perm_ext" if direction == "fwd" else "blk_perm_inner"
    tiles, rowb, colb = (a[f"blk_tiles_{direction}"],
                         a[f"blk_rowb_{direction}"],
                         a[f"blk_colb_{direction}"])
    rng = np.random.default_rng(5)
    h = rng.normal(size=(spec.n_src, 7)).astype(np.float32)
    x = t_blk.build_x_slabs(spec, _t(a[psrc]), _t(h))
    ent, ent_off = pack_tiles(_t(tiles))
    got = _index_add(ent, ent_off, _t(rowb), _t(colb), x, spec.n_row_blocks)
    ref = tile_matmul_plain(_t(tiles), _t(rowb), _t(colb), x,
                            spec.n_row_blocks)
    torch.testing.assert_close(got, ref, **TOL)
    pal = np.asarray(pallas_tile_matmul(
        jnp.asarray(tiles), jnp.asarray(rowb), jnp.asarray(colb),
        jnp.asarray(x.numpy()), spec.n_row_blocks, interpret=True))
    off = row_offsets(_t(rowb), spec.n_row_blocks)
    visited = (off[1:] > off[:-1]).numpy()
    np.testing.assert_allclose(got.numpy()[visited], pal[:-1][visited], **TOL)
    np.testing.assert_array_equal(got.numpy()[~visited], 0.0)
