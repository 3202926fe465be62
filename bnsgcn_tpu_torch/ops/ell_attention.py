"""GAT attention over the ELL layout (counterpart of
bnsgcn_tpu/ops/ell_attention.py, XLA there: no TPU kernel; plain PyTorch
here until a CUDA kernel per bucket, ROADMAP X2).

With destination rows in ELL form, built WITHOUT the split cap so that
every dst row is one table row, the edge softmax is a dense masked softmax
over the row width and the weighted sum a batched product:

  out[v] = sum_u softmax_u(leaky(el[u] + er[v])) * z[u]   over v's row,

unsampled halo slots and padding masked out (the presence mask). Rows go in
chunks of about `chunk_gathers` (row, slot) gathers, which is what keeps the
widest bucket's [rows, W, H, F] gather in memory on the card; each chunk
gathers z head-major ([H, rows, W, F]) so that the products are batched
matrix products of contiguous blocks.

Backward (`_GatFn`, the JAX custom VJP's two passes):
  * pass A on the FORWARD layout (rows = dst v): alpha recomputed from the
    saved per-row softmax statistics (max, denominator), q = <g[v], z[u]>
    per edge, d_er and the per-row sum s_v = sum_u alpha q;
  * pass B on the TRANSPOSED layout (rows = src u, capped with split-row
    chunks like the SpMM backward): d_z[u] = sum_v alpha g[v] and
    d_el[u] = sum_v alpha (q - s_v) leaky', gathers only, the split rows'
    partial sums combined as ell_combine combines the SpMM's.
No scatter over [n_ext, H, F] anywhere.

Attention dropout is edge-deterministic: the keep decision is an integer
hash of (src id, dst id, head, two seeds), so the forward and the
transposed backward reproduce the same mask without storing it. The hash
runs in int64 torch ops masked to 32 bits (as utils/prng.py runs threefry),
bitwise the JAX package's on the CPU and on the card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from bnsgcn_tpu_torch.ops.bucket_sum import ell_combine
from bnsgcn_tpu_torch.ops.ell import (ELL_SPLIT_CAP, EllSpec, build_ell_numpy,
                                      compute_geometry)

MASK = 0xFFFFFFFF
CHUNK_GATHERS = 2_000_000       # (row, slot) gathers per chunk


@dataclass(frozen=True)
class GatEllSpec:
    widths: tuple[int, ...]
    rows: tuple[int, ...]
    n_rows: int                        # dst rows (pad_inner)
    n_src: int                         # extended rows
    bwd: EllSpec = None                # transposed (src-major, capped) layout


def gat_geometry(src_all: np.ndarray, dst_all: np.ndarray, n_dst: int,
                 n_src_ext: int) -> dict:
    """The uncapped forward geometry (whole rows: a softmax cannot span
    split chunks), compute_geometry's schema."""
    return compute_geometry(src_all, dst_all, n_dst, n_src_ext, cap=None,
                            directions=("fwd",))["fwd"]


def build_gat_layouts(src_all: np.ndarray, dst_all: np.ndarray, n_dst: int,
                      n_src_ext: int, geometry: Optional[dict] = None,
                      geometry_bwd: Optional[dict] = None
                      ) -> tuple[GatEllSpec, dict]:
    """The dst-major uncapped forward layout and the src-major capped
    backward layout, with each table row's row id, stacked on parts
    (the JAX package's build_gat_layouts, array for array). `geometry` and
    `geometry_bwd` may come from meta.json ('gat_fwd' and 'bwd'); else
    they are computed from the parts given. Returns (spec, arrays):
    {'gat_idx_k', 'gat_rows', 'gat_perm', 'gat_bwd_idx_k', 'gat_bwd_rows',
    'gat_bwd_perm'[, 'gat_bwd_chunk_pos', 'gat_bwd_chunk_seg']}."""
    P = src_all.shape[0]
    if geometry is None:
        geometry = gat_geometry(src_all, dst_all, n_dst, n_src_ext)
    if geometry_bwd is None:
        geometry_bwd = compute_geometry(src_all, dst_all, n_dst, n_src_ext,
                                        cap=ELL_SPLIT_CAP,
                                        directions=("bwd",))["bwd"]
    widths, rows_max = tuple(geometry["widths"]), tuple(geometry["rows"])
    arrays = {}
    idx_stacked = [[] for _ in widths]
    perms, rows_ids = [], []
    for p in range(P):
        _, _, idx, perm, _, _, row_of = build_ell_numpy(
            src_all[p], dst_all[p], n_dst, n_src_ext, widths=widths,
            row_pad=rows_max, cap=None)
        for k in range(len(widths)):
            idx_stacked[k].append(idx[k])
        perms.append(perm)
        rows_ids.append(row_of)
    arrays["gat_perm"] = np.stack(perms)
    arrays["gat_rows"] = np.stack(rows_ids)
    for k in range(len(widths)):
        arrays[f"gat_idx_{k}"] = np.stack(idx_stacked[k])

    bw, br = tuple(geometry_bwd["widths"]), tuple(geometry_bwd["rows"])
    b_split, b_chunks = geometry_bwd["split"], geometry_bwd["chunks"]
    bidx_stacked = [[] for _ in bw]
    bperms, brows, bcp, bcs = [], [], [], []
    for p in range(P):
        real = dst_all[p] < n_dst
        _, _, idx, perm, cp, cs, row_of = build_ell_numpy(
            dst_all[p][real], src_all[p][real], n_src_ext, n_dst, widths=bw,
            row_pad=br, cap=geometry_bwd["cap"], split_pad=b_split,
            chunk_pad=b_chunks)
        for k in range(len(bw)):
            bidx_stacked[k].append(idx[k])
        bperms.append(perm)
        brows.append(row_of)
        bcp.append(cp)
        bcs.append(cs)
    arrays["gat_bwd_perm"] = np.stack(bperms)
    arrays["gat_bwd_rows"] = np.stack(brows)
    if b_split:
        arrays["gat_bwd_chunk_pos"] = np.stack(bcp)
        arrays["gat_bwd_chunk_seg"] = np.stack(bcs)
    for k in range(len(bw)):
        arrays[f"gat_bwd_idx_{k}"] = np.stack(bidx_stacked[k])
    bwd_spec = EllSpec(widths=bw, rows=br, n_rows=n_src_ext, n_src=n_dst,
                       n_split=b_split, n_chunks=b_chunks)
    return GatEllSpec(widths=widths, rows=rows_max, n_rows=n_dst,
                      n_src=n_src_ext, bwd=bwd_spec), arrays


# ---------------------------------------------------------------------------
# edge-deterministic dropout
# ---------------------------------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), in two 16-bit halves of c
    so that no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def _hash_keep(u, v, h_idx, seed0, seed1, keep_prob: float) -> torch.Tensor:
    """u, v: broadcast-compatible int64 tensors of src and dst ids; h_idx
    [H] int64 head ids; seeds: uint32 words (ints or int64 tensors).
    Returns bool [..., H]: keep where the murmur3-finalized hash of (u, v,
    h, seeds), as a float32 in [0, 1), is below keep_prob."""
    x = _mul32(u & MASK, 2654435761) ^ _mul32(v & MASK, 2246822519) ^ seed0
    x = x[..., None] ^ _mul32(h_idx & MASK, 3266489917) ^ seed1
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    unit = x.to(torch.float32) * (1.0 / 4294967296.0)
    return unit < torch.tensor(keep_prob, dtype=torch.float32)


def _leaky(x, slope):
    return torch.where(x > 0, x, x * slope)


def _pad_rows(x, value=0.0):
    return torch.cat([x, x.new_full((1,) + tuple(x.shape[1:]), value)])


def _chunks(r: int, w: int, chunk_gathers: int):
    step = max(1, chunk_gathers // max(w, 1))
    return [(r0, min(r0 + step, r)) for r0 in range(0, r, step)]


# ---------------------------------------------------------------------------
# forward and the two-pass backward
# ---------------------------------------------------------------------------

def _fwd(spec: GatEllSpec, arrays: dict, z, el, er, pres, seeds, hidx,
         drop: float, slope: float, chunk_gathers: int):
    """The forward over the dst-major layout: (out [n_dst, H, F] in z's
    dtype, per-row max and denominator [n_dst, H] f32)."""
    heads, fdim = z.shape[1], z.shape[2]
    zp_hm = _pad_rows(z).permute(1, 0, 2).contiguous()        # [H, n+1, F]
    elp, erp = _pad_rows(el), _pad_rows(er)
    outs, ms, ds = [], [], []
    offset = 0
    for k, w in enumerate(spec.widths):
        idx = arrays[f"gat_idx_{k}"]
        r = idx.shape[0]
        rows = arrays["gat_rows"][offset:offset + r]
        offset += r
        o_k = z.new_empty((r, heads, fdim))
        m_k = torch.empty((r, heads), dtype=torch.float32, device=z.device)
        d_k = torch.empty_like(m_k)
        for a, b in _chunks(r, w, chunk_gathers):
            idx_t, rows_t = idx[a:b], rows[a:b]
            mask = (idx_t != spec.n_src) & (rows_t != spec.n_rows)[:, None]
            if pres is not None:
                mask = mask & pres[idx_t]
            e = _leaky((elp[idx_t] + erp[rows_t][:, None, :]).float(), slope)
            e = torch.where(mask[:, :, None], e, -1e30)
            m = e.amax(1).clamp(min=-1e29)                      # [r, H]
            ex = torch.where(mask[:, :, None], torch.exp(e - m[:, None, :]),
                             0.0)
            denom = ex.sum(1).clamp(min=1e-16)
            alpha = ex / denom[:, None, :]
            if drop > 0.0:
                keep = _hash_keep(idx_t, rows_t[:, None], hidx, seeds[0],
                                  seeds[1], 1.0 - drop)
                alpha = torch.where(keep, alpha / (1.0 - drop), 0.0)
            a_hm = alpha.to(z.dtype).permute(2, 0, 1).unsqueeze(-2)
            o = torch.matmul(a_hm, zp_hm[:, idx_t]).squeeze(-2)
            o_k[a:b] = o.permute(1, 0, 2)
            m_k[a:b], d_k[a:b] = m, denom
        outs.append(o_k)
        ms.append(m_k)
        ds.append(d_k)
    perm = arrays["gat_perm"]
    out = torch.cat(outs + [z.new_zeros((1, heads, fdim))])[perm]
    # degree-0 rows take the appended neutral row: max -1e29, denominator 1
    m_v = torch.cat(ms + [m_k.new_full((1, heads), -1e29)])[perm]
    d_v = torch.cat(ds + [m_k.new_ones((1, heads))])[perm]
    return out, m_v, d_v


def _bwd(spec: GatEllSpec, arrays: dict, z, el, er, pres, seeds, hidx,
         drop: float, slope: float, m_v, d_v, g, chunk_gathers: int):
    """(d_z, d_el, d_er) in f32 for the cotangent g [n_dst, H, F]."""
    heads = z.shape[1]
    keep_p = 1.0 - drop
    zf = z.float()
    zp_hm = _pad_rows(zf).permute(1, 0, 2).contiguous()       # [H, n+1, F]
    gp_hm = _pad_rows(g.float()).permute(1, 0, 2).contiguous()
    elp, erp = _pad_rows(el), _pad_rows(er)
    m_p, den_p = _pad_rows(m_v, -1e29), _pad_rows(d_v, 1.0)

    # pass A: the forward layout; d_er and s_v = sum_u alpha q
    der_list, s_list = [], []
    offset = 0
    for k, w in enumerate(spec.widths):
        idx = arrays[f"gat_idx_{k}"]
        r = idx.shape[0]
        rows = arrays["gat_rows"][offset:offset + r]
        offset += r
        der_k = torch.empty((r, heads), dtype=torch.float32, device=z.device)
        s_k = torch.empty_like(der_k)
        for a, b in _chunks(r, w, chunk_gathers):
            idx_t, rows_t = idx[a:b], rows[a:b]
            mask = (idx_t != spec.n_src) & (rows_t != spec.n_rows)[:, None]
            if pres is not None:
                mask = mask & pres[idx_t]
            e_pre = (elp[idx_t] + erp[rows_t][:, None, :]).float()
            alpha = torch.where(
                mask[:, :, None],
                torch.exp(_leaky(e_pre, slope) - m_p[rows_t][:, None, :])
                / den_p[rows_t][:, None, :], 0.0)               # [r, W, H]
            g_hm = gp_hm[:, rows_t].unsqueeze(-1)               # [H, r, F, 1]
            q = torch.matmul(zp_hm[:, idx_t], g_hm)             # [H, r, W, 1]
            q = q.squeeze(-1).permute(1, 2, 0)                  # [r, W, H]
            if drop > 0.0:
                keep = _hash_keep(idx_t, rows_t[:, None], hidx, seeds[0],
                                  seeds[1], keep_p)
                q = torch.where(keep, q / keep_p, 0.0)
            s_row = (alpha * q).sum(1)                          # [r, H]
            d_pre = (alpha * (q - s_row[:, None, :])
                     * torch.where(e_pre > 0, 1.0, slope))
            der_k[a:b], s_k[a:b] = d_pre.sum(1), s_row
        der_list.append(der_k)
        s_list.append(s_k)
    zero_h = torch.zeros((1, heads), dtype=torch.float32, device=z.device)
    perm = arrays["gat_perm"]
    d_er = torch.cat(der_list + [zero_h])[perm]
    s_p = _pad_rows(torch.cat(s_list + [zero_h])[perm])

    # pass B: the transposed layout; d_z and d_el, gathers only
    bspec = spec.bwd
    dz_outs, del_outs = [], []
    offset = 0
    for k, w in enumerate(bspec.widths):
        idx = arrays[f"gat_bwd_idx_{k}"]                         # dst ids
        r = idx.shape[0]
        rows = arrays["gat_bwd_rows"][offset:offset + r]        # src ids
        offset += r
        dz_k = torch.empty((r, heads, z.shape[2]), dtype=torch.float32,
                           device=z.device)
        del_k = torch.empty((r, heads), dtype=torch.float32, device=z.device)
        for a, b in _chunks(r, w, chunk_gathers):
            idx_t, rows_t = idx[a:b], rows[a:b]
            mask = idx_t != bspec.n_src
            if pres is not None:
                mask = mask & pres[rows_t][:, None]
            e_pre = (elp[rows_t][:, None, :] + erp[idx_t]).float()
            alpha = torch.where(
                mask[:, :, None],
                torch.exp(_leaky(e_pre, slope) - m_p[idx_t]) / den_p[idx_t],
                0.0)
            g_t = gp_hm[:, idx_t]                               # [H, r, W, F]
            q = torch.matmul(g_t, zp_hm[:, rows_t].unsqueeze(-1))
            q = q.squeeze(-1).permute(1, 2, 0)                  # [r, W, H]
            alpha_d = alpha
            if drop > 0.0:
                # the hash's arguments as in pass A: u = src id, v = dst id
                keep = _hash_keep(rows_t[:, None], idx_t, hidx, seeds[0],
                                  seeds[1], keep_p)
                alpha_d = torch.where(keep, alpha / keep_p, 0.0)
                q = torch.where(keep, q / keep_p, 0.0)
            a_hm = alpha_d.permute(2, 0, 1).unsqueeze(-2)       # [H, r, 1, W]
            dz_k[a:b] = torch.matmul(a_hm, g_t).squeeze(-2).permute(1, 0, 2)
            d_pre = (alpha * (q - s_p[idx_t])
                     * torch.where(e_pre > 0, 1.0, slope))
            del_k[a:b] = d_pre.sum(1)
        dz_outs.append(dz_k)
        del_outs.append(del_k)
    cp = arrays.get("gat_bwd_chunk_pos")
    cs = arrays.get("gat_bwd_chunk_seg")
    bperm = arrays["gat_bwd_perm"]
    hf = heads * z.shape[2]
    d_z = ell_combine(bspec, [o.reshape(o.shape[0], hf) for o in dz_outs],
                      bperm, cp, cs).reshape(z.shape)
    d_el = ell_combine(bspec, del_outs, bperm, cp, cs)
    return d_z, d_el, d_er


class _GatFn(torch.autograd.Function):
    # saves z, el, er and the per-row statistics; never the [E, H] weights

    @staticmethod
    def forward(ctx, z, el, er, op: "GatAttention", pres, seeds, hidx,
                drop: float, slope: float):
        out, m_v, d_v = _fwd(op.spec, op.arrays, z, el, er, pres, seeds,
                             hidx, drop, slope, op.chunk_gathers)
        ctx.save_for_backward(z, el, er, m_v, d_v)
        ctx.op, ctx.pres, ctx.seeds, ctx.hidx = op, pres, seeds, hidx
        ctx.drop, ctx.slope = drop, slope
        return out

    @staticmethod
    def backward(ctx, g):
        z, el, er, m_v, d_v = ctx.saved_tensors
        op = ctx.op
        if op.timer is not None:
            op.timer.start("bwd")
        d_z, d_el, d_er = _bwd(op.spec, op.arrays, z, el, er, ctx.pres,
                               ctx.seeds, ctx.hidx, ctx.drop, ctx.slope,
                               m_v, d_v, g, op.chunk_gathers)
        if op.timer is not None:
            op.timer.stop("bwd")
        return (d_z.to(z.dtype), d_el.to(el.dtype), d_er.to(er.dtype),
                None, None, None, None, None, None)


class GatAttention:
    """attention(z [n_ext, H, F], el [n_ext, H], er [n_dst, H], presence,
    seeds, ...) -> [n_dst, H, F] over one part's layout (device tensors
    keyed as build_gat_layouts names them, without the part axis);
    differentiable in z, el and er through the two-pass backward.
    Counterpart of the JAX package's gat_ell_attention, without its feat
    axis' head offset. `seeds`: the attention dropout's two uint32 words
    (int64 [2]). `timer`, when set, is called around each forward and
    backward (chip_smoke's CUDA events per layer)."""

    def __init__(self, spec: GatEllSpec, arrays: dict,
                 chunk_gathers: int = CHUNK_GATHERS):
        self.spec, self.chunk_gathers = spec, chunk_gathers
        self.arrays = {k: v.long() for k, v in arrays.items()}
        self.timer = None

    def __call__(self, z, el, er, presence=None, seeds=None,
                 attn_dropout: float = 0.0, training: bool = False,
                 negative_slope: float = 0.2):
        drop = attn_dropout if training else 0.0
        if seeds is None:
            seeds = torch.zeros(2, dtype=torch.int64, device=z.device)
        hidx = torch.arange(z.shape[1], device=z.device)
        pres = _pad_rows(presence, False) if presence is not None else None
        if self.timer is not None:
            self.timer.start("fwd")
        out = _GatFn.apply(z, el, er, self, pres, seeds, hidx, drop,
                           negative_slope)
        if self.timer is not None:
            self.timer.stop("fwd")
        return out


class EventTimer:
    """A GatAttention.timer: CUDA events around each forward and backward,
    per kind in call order; a rank hands it back pickled, as the
    milliseconds of each span (`ms`), read after one synchronization."""

    def __init__(self):
        self.spans = {"fwd": [], "bwd": []}
        self._open = {}

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def start(self, kind: str):
        self._open[kind] = self._event()

    def stop(self, kind: str):
        self.spans[kind].append((self._open.pop(kind), self._event()))

    def __getstate__(self):
        torch.cuda.synchronize()
        return {"ms": {k: [a.elapsed_time(b) for a, b in v]
                       for k, v in self.spans.items()}}

    def __setstate__(self, state):
        self.ms = state["ms"]


def part_gat_layouts(art, row: int) -> tuple[GatEllSpec, dict]:
    """build_gat_layouts of the part in row `row` of `art`, with the global
    pads of the artifacts' 'gat_fwd' and 'bwd' geometry (computed from the
    part itself when the artifacts carry none)."""
    geo = art.ell_geometry or {}
    return build_gat_layouts(
        art.src[row:row + 1], art.dst[row:row + 1], art.pad_inner, art.n_ext,
        geometry=geo.get("gat_fwd"), geometry_bwd=geo.get("bwd"))


def build_gat_attention(art, row: int, device,
                        layouts: Optional[Callable] = None) -> GatAttention:
    """The GAT attention of the part in row `row` of `art` on `device`: its
    layouts from `layouts()` (part_gat_layouts by default; the trainer's
    layout cache), the build's seconds in `build_seconds`."""
    t0 = time.perf_counter()
    spec, arrays = (layouts or (lambda: part_gat_layouts(art, row)))()
    op = GatAttention(spec, {k: torch.from_numpy(np.ascontiguousarray(v[0]))
                             .to(device) for k, v in arrays.items()})
    op.build_seconds = time.perf_counter() - t0
    return op
