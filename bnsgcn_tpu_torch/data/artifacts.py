"""Partition artifacts, in memory (counterpart of bnsgcn_tpu/data/artifacts.py).

The same padded, stacked layout as the JAX package builds, so the two agree
array for array (tests/test_torch_data.py pins it at P=1):

  * parts stacked on a leading axis of size P, padded to common sizes;
  * extended node index space of part p: rows [0, pad_inner) are p's inner
    nodes (sorted by global id), then P * pad_boundary halo slots;
  * padded edges: src = 0, dst = pad_inner (the trash row);
  * degrees are global full-graph degrees including self-loops.

On disk it is the JAX package's format v2 (meta.json + shared.npz +
part{p}.npz), so a directory written by either package loads in the other.
`build_artifacts_streaming` writes the same format for papers100M-scale
graphs one part at a time, optionally with the features stored as bf16
bits (meta.json's 'feat_dtype'); `read_meta` reads a directory's meta.json
and shared.npz alone, which is all a launcher needs.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from bnsgcn_tpu_torch.data.graph import Graph
from bnsgcn_tpu_torch.data.partitioner import (degree_norm_row,
                                               validate_artifact_dir)


def _pad_to(x: int, mult: int) -> int:
    return max(mult, ((x + mult - 1) // mult) * mult)


@dataclass
class PartitionArtifacts:
    n_parts: int
    pad_inner: int                 # padded inner-node count per part
    pad_boundary: int              # padded boundary size per (sender, receiver) pair
    pad_edges: int                 # padded edge count per part
    n_inner: np.ndarray            # [P] real inner counts
    n_b: np.ndarray                # [P, P] boundary sizes, n_b[p, j] = |B(p->j)|, diag 0
    # stacked per-part arrays (leading axis P)
    feat: np.ndarray               # [P, pad_inner, F] f32, or uint16: the
                                   # bits of bf16 storage (feat_values)
    label: np.ndarray              # [P, pad_inner] i32  or [P, pad_inner, C] f32
    train_mask: np.ndarray         # [P, pad_inner] bool
    val_mask: np.ndarray
    test_mask: np.ndarray
    inner_mask: np.ndarray         # [P, pad_inner] bool (real rows)
    in_deg: np.ndarray             # [P, pad_inner] f32, global, padded rows 1
    out_deg_ext: np.ndarray        # [P, pad_inner + P*pad_boundary] f32, padded 1
    src: np.ndarray                # [P, pad_edges] i32 extended index space
    dst: np.ndarray                # [P, pad_edges] i32 in [0, pad_inner]
    bnd: np.ndarray                # [P, P, pad_boundary] i32 local indices (sender rows)
    global_nid: np.ndarray         # [P, pad_inner] i64, padded rows -1
    n_feat: int = 0
    n_class: int = 0
    n_train: int = 0
    multilabel: bool = False
    ell_geometry: "dict | None" = None   # global ELL pads (ops/ell.compute_geometry)

    @property
    def n_halo_slots(self) -> int:
        return self.n_parts * self.pad_boundary

    @property
    def n_ext(self) -> int:
        return self.pad_inner + self.n_halo_slots


def build_artifacts(g: Graph, part_id: np.ndarray,
                    node_mult: int = 8, boundary_mult: int = 8,
                    edge_mult: int = 8) -> PartitionArtifacts:
    """Build padded partition artifacts from a canonicalized training graph."""
    P = int(part_id.max()) + 1 if part_id.size else 1
    part_id = np.asarray(part_id, dtype=np.int32)
    N = g.n_nodes
    in_deg_g = g.in_degrees().astype(np.float32)
    out_deg_g = g.out_degrees().astype(np.float32)

    inner = [np.nonzero(part_id == p)[0] for p in range(P)]   # sorted global ids
    n_inner = np.array([len(x) for x in inner], dtype=np.int64)
    loc = np.full(N, -1, dtype=np.int64)
    for p in range(P):
        loc[inner[p]] = np.arange(n_inner[p])

    pad_inner = _pad_to(int(n_inner.max()), node_mult)

    src_o, dst_o = part_id[g.src], part_id[g.dst]
    cross = src_o != dst_o

    # boundary lists B(p -> j): p-local indices of p's nodes with edges into j
    bnd_lists: list[list[np.ndarray]] = [[np.empty(0, np.int64)] * P for _ in range(P)]
    # halo edges per destination part, in (sender, k) slot space
    halo_edges: list[list[tuple[np.ndarray, np.ndarray]]] = [[] for _ in range(P)]
    cs, cd = g.src[cross], g.dst[cross]
    cso, cdo = src_o[cross], dst_o[cross]
    max_b = 0
    for j in range(P):
        into_j = cdo == j
        u_gl, v_gl, u_own = cs[into_j], cd[into_j], cso[into_j]
        for p in range(P):
            if p == j:
                continue
            m = u_own == p
            if not m.any():
                continue
            uniq, inv = np.unique(u_gl[m], return_inverse=True)
            bnd_lists[p][j] = loc[uniq]           # sorted by global id ✓
            max_b = max(max_b, len(uniq))
            halo_edges[j].append((p, inv, loc[v_gl[m]], uniq))

    pad_boundary = _pad_to(max_b, boundary_mult) if max_b else boundary_mult
    n_halo = P * pad_boundary
    n_ext = pad_inner + n_halo

    n_b = np.zeros((P, P), dtype=np.int32)
    bnd = np.zeros((P, P, pad_boundary), dtype=np.int32)
    for p in range(P):
        for j in range(P):
            b = bnd_lists[p][j]
            n_b[p, j] = len(b)
            bnd[p, j, :len(b)] = b

    # per-part edge arrays in extended index space
    srcs, dsts, max_e = [], [], 0
    out_deg_ext = np.ones((P, n_ext), dtype=np.float32)
    for p in range(P):
        own = part_id[g.src] == p
        both = own & (part_id[g.dst] == p)
        e_src = [loc[g.src[both]]]
        e_dst = [loc[g.dst[both]]]
        for (q, inv, v_loc, uniq) in halo_edges[p]:
            e_src.append(pad_inner + q * pad_boundary + inv)
            e_dst.append(v_loc)
            out_deg_ext[p, pad_inner + q * pad_boundary:
                        pad_inner + q * pad_boundary + len(uniq)] = out_deg_g[uniq]
        es = np.concatenate(e_src) if e_src else np.empty(0, np.int64)
        ed = np.concatenate(e_dst) if e_dst else np.empty(0, np.int64)
        srcs.append(es)
        dsts.append(ed)
        max_e = max(max_e, len(es))
        out_deg_ext[p, :pad_inner] = degree_norm_row(out_deg_g, inner[p],
                                                     pad_inner)

    pad_edges = _pad_to(max_e, edge_mult)
    src_a = np.zeros((P, pad_edges), dtype=np.int32)
    dst_a = np.full((P, pad_edges), pad_inner, dtype=np.int32)
    for p in range(P):
        src_a[p, :len(srcs[p])] = srcs[p]
        dst_a[p, :len(dsts[p])] = dsts[p]

    # node data, padded
    F = g.n_feat
    feat = np.zeros((P, pad_inner, F), dtype=np.float32)
    if g.label.ndim == 1:
        label = np.zeros((P, pad_inner), dtype=np.int32)
    else:
        label = np.zeros((P, pad_inner, g.label.shape[1]), dtype=np.float32)
    tm = np.zeros((P, pad_inner), dtype=bool)
    vm = np.zeros((P, pad_inner), dtype=bool)
    sm = np.zeros((P, pad_inner), dtype=bool)
    im = np.zeros((P, pad_inner), dtype=bool)
    ind = np.ones((P, pad_inner), dtype=np.float32)
    gnid = np.full((P, pad_inner), -1, dtype=np.int64)
    for p in range(P):
        k = n_inner[p]
        feat[p, :k] = g.feat[inner[p]]
        label[p, :k] = g.label[inner[p]]
        tm[p, :k] = g.train_mask[inner[p]]
        vm[p, :k] = g.val_mask[inner[p]]
        sm[p, :k] = g.test_mask[inner[p]]
        im[p, :k] = True
        ind[p] = degree_norm_row(in_deg_g, inner[p], pad_inner)
        gnid[p, :k] = inner[p]

    # 'gat_fwd': the GAT attention's uncapped forward geometry
    # (bnsgcn_tpu/ops/ell_attention.py gat_geometry), written so meta.json
    # is the JAX package's; the port's GAT waits for a later slice
    from bnsgcn_tpu_torch.ops.ell import compute_geometry
    n_ext_rows = pad_inner + P * pad_boundary
    geometry = compute_geometry(src_a, dst_a, pad_inner, n_ext_rows)
    geometry["gat_fwd"] = compute_geometry(src_a, dst_a, pad_inner,
                                           n_ext_rows, cap=None,
                                           directions=("fwd",))["fwd"]

    return PartitionArtifacts(
        n_parts=P, pad_inner=pad_inner, pad_boundary=pad_boundary,
        pad_edges=pad_edges, n_inner=n_inner, n_b=n_b,
        feat=feat, label=label, train_mask=tm, val_mask=vm, test_mask=sm,
        inner_mask=im, in_deg=ind, out_deg_ext=out_deg_ext,
        src=src_a, dst=dst_a, bnd=bnd, global_nid=gnid,
        n_feat=F, n_class=g.n_class, n_train=g.n_train,
        multilabel=g.multilabel, ell_geometry=geometry,
    )


_PER_PART = ["feat", "label", "train_mask", "val_mask", "test_mask",
             "inner_mask", "in_deg", "out_deg_ext", "src", "dst", "bnd",
             "global_nid"]


# ----------------------------------------------------------------------------
# the streaming builder (bnsgcn_tpu/data/artifacts.py build_artifacts_streaming)
# ----------------------------------------------------------------------------

FEAT_DTYPES = ("float32", "bfloat16")      # meta.json's 'feat_dtype'


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 values -> their bf16 bits as uint16, rounded to nearest even
    (torch's conversion; the card's machine has no ml_dtypes)."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """bf16 bits (uint16) -> f32 values, exactly."""
    return (np.asarray(bits, dtype=np.uint16).astype(np.uint32)
            << 16).view(np.float32)


def feat_dtype(art: PartitionArtifacts) -> str:
    """The artifacts' feature storage: 'bfloat16' (uint16 bits) or
    'float32'."""
    return "bfloat16" if art.feat.dtype == np.uint16 else "float32"


def feat_values(art: PartitionArtifacts) -> np.ndarray:
    """The artifacts' features as f32 values: bf16 storage upcast exactly
    (the JAX package's art.feat.astype(float32))."""
    return (bf16_to_f32(art.feat) if feat_dtype(art) == "bfloat16"
            else art.feat)


def build_artifacts_streaming(g: Graph, part_id: np.ndarray, path: str,
                              feat_dtype: str = "float32",
                              with_gat: bool = True,
                              node_mult: int = 8, boundary_mult: int = 8,
                              edge_mult: int = 8, compress: bool = False,
                              log=None, on_part_written=None) -> None:
    """Build and write the artifacts of `g` under `part_id` to `path`, one
    part resident at a time. The arrays are save_artifacts(build_artifacts(
    g, part_id)) up to the within-part edge order (edges grouped by
    destination part in edge order), and bitwise the JAX package's
    build_artifacts_streaming:

      * no [P, pad_inner, F] feature stack: the peak is the global per-edge
        arrays (int32) plus one part;
      * every O(E) pass vectorized (sorts, bincounts); the per-part loop
        only fills and writes one part;
      * feat_dtype='bfloat16' stores the features as bf16 bits (uint16,
        round to nearest even), half the bytes on disk and at load;
      * uncompressed part files unless `compress`;
      * `on_part_written(file, p)` is called after each part file.
    """
    from bnsgcn_tpu_torch.ops.ell import ELL_SPLIT_CAP, GeoAccum

    if feat_dtype not in FEAT_DTYPES:
        raise ValueError(f"feat_dtype {feat_dtype!r} not in {FEAT_DTYPES}")
    log = log or (lambda *a: None)
    part_id = np.asarray(part_id, dtype=np.int32)
    P = int(part_id.max()) + 1 if part_id.size else 1
    N = g.n_nodes
    in_deg_g = g.in_degrees().astype(np.float32)
    out_deg_g = g.out_degrees().astype(np.float32)

    # inner nodes grouped by part, ascending global id
    counts = np.bincount(part_id, minlength=P).astype(np.int64)
    off = np.concatenate([[0], np.cumsum(counts)])
    order = np.argsort(part_id, kind="stable")
    loc = np.empty(N, dtype=np.int64)
    loc[order] = np.arange(N, dtype=np.int64) - np.repeat(off[:-1], counts)
    pad_inner = _pad_to(int(counts.max()), node_mult)

    src_o = part_id[g.src]
    dst_o = part_id[g.dst]
    cross = src_o != dst_o
    log(f"  [stream] {N} nodes, {g.n_edges} edges, {int(cross.sum())} cross")

    # the boundary sets of every ordered pair in one unique pass over the
    # key (u, receiver j): uniques sorted by u, regrouped by (sender p, j);
    # an int32 key whenever N * P fits, which halves the sort's copy
    kdt = np.int32 if N * P < 2**31 else np.int64
    cu = g.src[cross].astype(kdt)
    cj = dst_o[cross].astype(kdt)
    ukey, inv = np.unique(cu * kdt(P) + cj, return_inverse=True)
    del cu, cj
    bu = ukey // P                                   # boundary node (global)
    bj = (ukey % P).astype(np.int32)                 # receiver
    bp = part_id[bu]                                 # sender
    gkey = bp.astype(np.int64) * P + bj
    gorder = np.argsort(gkey, kind="stable")         # by (p, j), u ascending
    nb_flat = np.bincount(gkey, minlength=P * P).astype(np.int64)
    n_b = nb_flat.reshape(P, P).astype(np.int32)
    goff = np.concatenate([[0], np.cumsum(nb_flat)])
    slot = np.empty(len(ukey), dtype=np.int64)
    slot[gorder] = np.arange(len(ukey), dtype=np.int64) - \
        np.repeat(goff[:-1], nb_flat)
    max_b = int(nb_flat.max()) if len(ukey) else 0
    pad_boundary = _pad_to(max_b, boundary_mult) if max_b else boundary_mult
    n_ext = pad_inner + P * pad_boundary

    # each edge's extended source index (the receiver's halo slot for a
    # cross edge), int32 per edge: n_ext must fit, since numpy's setitem
    # would wrap an int64 value into the int32 array silently
    if n_ext >= 2**31:
        raise ValueError(
            f"extended index space n_ext={n_ext} overflows the int32 "
            f"per-edge arrays (pad_inner={pad_inner}, P={P}, "
            f"pad_boundary={pad_boundary})")
    loc32 = loc.astype(np.int32)
    ext_src = np.empty(g.n_edges, dtype=np.int32)
    ext_src[~cross] = loc32[g.src[~cross]]
    ext_src[cross] = (pad_inner + bp[inv].astype(np.int64) * pad_boundary
                      + slot[inv])
    del inv
    ldst = loc32[g.dst]

    # edges grouped by destination part, the owner of their aggregation
    eorder = np.argsort(dst_o, kind="stable")
    e_counts = np.bincount(dst_o, minlength=P).astype(np.int64)
    eoff = np.concatenate([[0], np.cumsum(e_counts)])
    pad_edges = _pad_to(int(e_counts.max()), edge_mult)

    geo_fwd = GeoAccum(ELL_SPLIT_CAP)
    geo_bwd = GeoAccum(ELL_SPLIT_CAP)
    geo_gat = GeoAccum(None) if with_gat else None

    os.makedirs(path, exist_ok=True)
    save = np.savez_compressed if compress else np.savez
    multilabel = g.label.ndim > 1
    for p in range(P):
        k = int(counts[p])
        ids = order[off[p]:off[p + 1]]               # sorted global ids
        eidx = eorder[eoff[p]:eoff[p + 1]]
        src_p = np.zeros(pad_edges, dtype=np.int32)
        dst_p = np.full(pad_edges, pad_inner, dtype=np.int32)
        src_p[:len(eidx)] = ext_src[eidx]
        dst_p[:len(eidx)] = ldst[eidx]

        # the sender's boundary lists bnd[p, j, :]
        bnd_p = np.zeros((P, pad_boundary), dtype=np.int32)
        for j in range(P):
            s, e = goff[p * P + j], goff[p * P + j + 1]
            if e > s:
                bnd_p[j, :e - s] = loc[bu[gorder[s:e]]]

        # the receiver's halo out-degrees (sender q's boundary toward p)
        out_ext = np.ones(n_ext, dtype=np.float32)
        out_ext[:k] = out_deg_g[ids]
        for q in range(P):
            s, e = goff[q * P + p], goff[q * P + p + 1]
            if e > s:
                base = pad_inner + q * pad_boundary
                out_ext[base:base + (e - s)] = out_deg_g[bu[gorder[s:e]]]

        if feat_dtype == "bfloat16":
            feat_p = np.zeros((pad_inner, g.n_feat), dtype=np.uint16)
            feat_p[:k] = bf16_bits(g.feat[ids])
        else:
            feat_p = np.zeros((pad_inner, g.n_feat), dtype=np.float32)
            feat_p[:k] = g.feat[ids]
        if multilabel:
            label_p = np.zeros((pad_inner, g.label.shape[1]), dtype=np.float32)
        else:
            label_p = np.zeros(pad_inner, dtype=np.int32)
        label_p[:k] = g.label[ids]
        masks = {}
        for name, m in (("train_mask", g.train_mask), ("val_mask", g.val_mask),
                        ("test_mask", g.test_mask)):
            mp = np.zeros(pad_inner, dtype=bool)
            mp[:k] = m[ids]
            masks[name] = mp
        im = np.zeros(pad_inner, dtype=bool)
        im[:k] = True
        ind = np.ones(pad_inner, dtype=np.float32)
        ind[:k] = in_deg_g[ids]
        gnid = np.full(pad_inner, -1, dtype=np.int64)
        gnid[:k] = ids

        # the geometry's statistics from this part's degrees (fwd rows:
        # local dst; bwd rows: extended src)
        real_d = dst_p[:len(eidx)]
        fwd_deg = np.bincount(real_d, minlength=pad_inner)
        geo_fwd.add_part(fwd_deg)
        geo_bwd.add_part(np.bincount(src_p[:len(eidx)], minlength=n_ext))
        if geo_gat is not None:
            geo_gat.add_part(fwd_deg)

        part_file = os.path.join(path, f"part{p}.npz")
        save(part_file, feat=feat_p, label=label_p, inner_mask=im,
             in_deg=ind, out_deg_ext=out_ext, src=src_p, dst=dst_p,
             bnd=bnd_p, global_nid=gnid, **masks)
        log(f"  [stream] part {p}: {k} inner, {len(eidx)} edges written")
        if on_part_written is not None:
            on_part_written(part_file, p)

    geometry = {"fwd": geo_fwd.finish(), "bwd": geo_bwd.finish()}
    if geo_gat is not None:
        geometry["gat_fwd"] = geo_gat.finish()
    meta = {
        "format_version": 2,
        "n_parts": P, "pad_inner": pad_inner,
        "pad_boundary": pad_boundary, "pad_edges": pad_edges,
        "n_feat": g.n_feat, "n_class": g.n_class,
        "n_train": int(g.train_mask.sum()),
        "multilabel": bool(multilabel),
        "n_inner": counts.tolist(),
        "feat_dtype": feat_dtype,
        "ell_geometry": geometry,
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    np.savez_compressed(os.path.join(path, "shared.npz"), n_b=n_b)


def save_artifacts(art: PartitionArtifacts, path: str):
    """Write meta.json + shared.npz + part{p}.npz (format v2). The part files
    are uncompressed npz, as the JAX package's streaming builder writes them:
    np.load reads both, and compressing hundreds of MB of features costs
    more than it saves."""
    os.makedirs(path, exist_ok=True)
    meta = {
        "format_version": 2,
        "n_parts": art.n_parts, "pad_inner": art.pad_inner,
        "pad_boundary": art.pad_boundary, "pad_edges": art.pad_edges,
        "n_feat": art.n_feat, "n_class": art.n_class, "n_train": art.n_train,
        "multilabel": art.multilabel,
        "n_inner": art.n_inner.tolist(),
        "ell_geometry": art.ell_geometry,
    }
    if feat_dtype(art) != "float32":
        meta["feat_dtype"] = feat_dtype(art)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    np.savez_compressed(os.path.join(path, "shared.npz"), n_b=art.n_b)
    for p in range(art.n_parts):
        np.savez(os.path.join(path, f"part{p}.npz"),
                 **{k: getattr(art, k)[p] for k in _PER_PART})


@dataclass
class ArtifactMeta:
    """An artifact directory's meta.json and shared.npz: the pads, widths
    and boundary sizes, without any part's arrays."""
    n_parts: int
    pad_inner: int
    pad_boundary: int
    pad_edges: int
    n_inner: np.ndarray
    n_b: np.ndarray
    n_feat: int
    n_class: int
    n_train: int
    multilabel: bool
    ell_geometry: "dict | None"
    feat_dtype: str


def read_meta(path: str) -> ArtifactMeta:
    """meta.json and shared.npz of a format-v2 directory; the part files are
    not opened."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    feat_dtype = meta.get("feat_dtype", "float32")
    if feat_dtype not in FEAT_DTYPES:
        from bnsgcn_tpu_torch.config import ConfigError
        raise ConfigError(f"artifact dir {path}: unknown feature storage "
                          f"{feat_dtype!r}")
    with np.load(os.path.join(path, "shared.npz")) as shared:
        n_b = shared["n_b"]
    return ArtifactMeta(
        n_parts=meta["n_parts"], pad_inner=meta["pad_inner"],
        pad_boundary=meta["pad_boundary"], pad_edges=meta["pad_edges"],
        n_inner=np.asarray(meta["n_inner"], dtype=np.int64), n_b=n_b,
        n_feat=meta["n_feat"], n_class=meta["n_class"],
        n_train=meta["n_train"], multilabel=meta["multilabel"],
        ell_geometry=meta.get("ell_geometry"), feat_dtype=feat_dtype)


def load_artifacts(path: str, parts: "list[int] | None" = None
                   ) -> PartitionArtifacts:
    """Load a format-v2 artifact directory. `parts` restricts the per-part
    arrays to the listed part ids (a rank loads only its own): the stacked
    axis then has len(parts) rows in that order; n_parts and the pads stay
    global. bf16 feature storage stays bf16 bits (uint16) in `feat`."""
    meta = read_meta(path)
    validate_artifact_dir(path, meta.n_parts, parts)
    part_ids = list(range(meta.n_parts)) if parts is None else list(parts)
    stacked = {k: [] for k in _PER_PART}
    for p in part_ids:
        with np.load(os.path.join(path, f"part{p}.npz")) as pt:
            for k in _PER_PART:
                stacked[k].append(pt[k])
    fields = {k: v for k, v in vars(meta).items() if k != "feat_dtype"}
    return PartitionArtifacts(
        **fields, **{k: np.stack(v) for k, v in stacked.items()})
