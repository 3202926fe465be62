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
The streaming builder for papers100M-scale graphs is not ported yet.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

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
    feat: np.ndarray               # [P, pad_inner, F] f32
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
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    np.savez_compressed(os.path.join(path, "shared.npz"), n_b=art.n_b)
    for p in range(art.n_parts):
        np.savez(os.path.join(path, f"part{p}.npz"),
                 **{k: getattr(art, k)[p] for k in _PER_PART})


def load_artifacts(path: str, parts: "list[int] | None" = None
                   ) -> PartitionArtifacts:
    """Load a format-v2 artifact directory. `parts` restricts the per-part
    arrays to the listed part ids (a rank loads only its own): the stacked
    axis then has len(parts) rows in that order; n_parts and the pads stay
    global."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    validate_artifact_dir(path, meta["n_parts"], parts)
    if meta.get("feat_dtype", "float32") != "float32":
        from bnsgcn_tpu_torch.config import ConfigError
        raise ConfigError(f"artifact dir {path}: {meta['feat_dtype']} "
                          f"feature storage is not ported yet")
    shared = np.load(os.path.join(path, "shared.npz"))
    part_ids = list(range(meta["n_parts"])) if parts is None else list(parts)
    loaded = [np.load(os.path.join(path, f"part{p}.npz")) for p in part_ids]
    stacked = {k: np.stack([pt[k] for pt in loaded]) for k in _PER_PART}
    return PartitionArtifacts(
        n_parts=meta["n_parts"], pad_inner=meta["pad_inner"],
        pad_boundary=meta["pad_boundary"], pad_edges=meta["pad_edges"],
        n_inner=np.asarray(meta["n_inner"], dtype=np.int64),
        n_b=shared["n_b"],
        n_feat=meta["n_feat"], n_class=meta["n_class"],
        n_train=meta["n_train"], multilabel=meta["multilabel"],
        ell_geometry=meta.get("ell_geometry"),
        **stacked,
    )
