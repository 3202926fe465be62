"""Graph reordering as an artifact pass, --reorder (counterpart of
bnsgcn_tpu/data/reorder.py).

The hybrid SpMM's economics rest on dense-tile coverage: with a part's rows
in locality order, edges gather into few [tile x tile] cells that K2 sums
as dense tiles, and K1 takes the rest. `cluster_reorder` orders one part's
real inner rows: degree-anchored label propagation, then the clusters
packed first-fit-decreasing into tile-row bins, rows degree-descending
within a cluster (pure numpy, deterministic; the JAX package's algorithm
line for line). `apply_reorder` permutes the artifacts once: row-indexed
arrays gather by the order, edge endpoints and boundary-list values remap
by its inverse; halo slots, the pad_inner trash row, every padded shape,
n_b and the degree multiset stay, so the halo plans, the BNS draw and the
ELL geometry see a consistent graph. `global_nid` moves with its rows, so
results mapped back through it stay in global id order.

`maybe_reorder` resolves --reorder {auto,cluster,off} as the JAX package's
does, with one difference of process model: the JAX package holds every
part in one process, a rank of the port holds its own. Each rank orders
its part (memoized under --cache-dir, keyed by the part's pre-permutation
digest), measures its coverage before (the hybrid's per-build cluster
order, the baseline the off path builds with) and after (the artifact
order), and the ranks add their per-part sums in part order through one
small all-reduce, so `auto`'s verdict and the logged coverages are the
JAX package's numbers. --n-nodes > 1 forces off, as the JAX package does
for a multi-process run. The `reorder` telemetry event waits for the
port's telemetry; the log line is printed.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Optional

import numpy as np
import torch

from bnsgcn_tpu_torch.config import Config, ConfigError
from bnsgcn_tpu_torch.data.artifacts import PartitionArtifacts
from bnsgcn_tpu_torch.ops.block_spmm import (cluster_order,
                                             effective_occupancy,
                                             estimate_coverage)
from bnsgcn_tpu_torch.utils.diskcache import atomic_dump, try_load

REORDER_ALGO = "lpa-ffd"      # versions the disk cache, as the JAX package's
LPA_SWEEPS = 3                # label-propagation sweeps
LPA_MAX_EDGES = 8_000_000     # the vote's deterministic edge stride cap
FFD_WINDOW = 128              # open bins a cluster's first-fit scan checks


def _majority_vote(u, v, labels, n_labels):
    """One LPA sweep: every node with a labeled neighbor takes the most
    frequent neighbor label (ties to the smallest), as a sort and a
    run-length encode over (node, label) keys."""
    lv = labels[v]
    has = lv >= 0
    if not has.any():
        return
    keys = u[has] * np.int64(n_labels) + lv[has]
    keys.sort(kind="stable")
    starts = np.concatenate([[0], np.flatnonzero(np.diff(keys)) + 1])
    uk = keys[starts]
    cnt = np.diff(np.concatenate([starts, [len(keys)]]))
    node = uk // n_labels
    lab = uk % n_labels
    o = np.lexsort((lab, -cnt, node))
    node_o, lab_o = node[o], lab[o]
    first = np.concatenate([[True], node_o[1:] != node_o[:-1]])
    labels[node_o[first]] = lab_o[first]


def cluster_reorder(src, dst, pad_inner: int, n_inner: int,
                    tile_r: int = 512, sweeps: int = LPA_SWEEPS
                    ) -> np.ndarray:
    """One part's inner-row order, `order[new] = old`, identity on the
    padding rows [n_inner, pad_inner): label propagation over the
    inner-inner edges from the ceil(n_inner / tile_r) highest-degree rows
    (pinned), the clusters packed first-fit-decreasing by degree mass into
    tile_r-row bins, rows degree-descending within a cluster."""
    order = np.arange(pad_inner, dtype=np.int64)
    if n_inner <= 1:
        return order
    s = np.asarray(src).astype(np.int64, copy=False)
    d = np.asarray(dst).astype(np.int64, copy=False)
    m = (s < n_inner) & (d < n_inner)
    s, d = s[m], d[m]
    deg = (np.bincount(d, minlength=n_inner)
           + np.bincount(s, minlength=n_inner)).astype(np.int64)
    n_clusters = max(int(np.ceil(n_inner / max(tile_r, 1))), 1)
    labels = np.full(n_inner, -1, dtype=np.int64)
    if n_clusters > 1 and len(s):
        if len(s) > LPA_MAX_EDGES:
            step = (len(s) + LPA_MAX_EDGES - 1) // LPA_MAX_EDGES
            s, d = s[::step], d[::step]
        u = np.concatenate([d, s])
        v = np.concatenate([s, d])
        anchors = np.argsort(-deg, kind="stable")[:n_clusters]
        anchor_labels = np.arange(n_clusters, dtype=np.int64)
        labels[anchors] = anchor_labels
        for _ in range(max(sweeps, 1)):
            _majority_vote(u, v, labels, n_clusters)
            labels[anchors] = anchor_labels
    # unlabeled rows form one trailing cluster
    lab = np.where(labels >= 0, labels, n_clusters)
    n_lab = n_clusters + 1
    sizes = np.bincount(lab, minlength=n_lab)
    mass = np.bincount(lab, weights=deg.astype(np.float64), minlength=n_lab)
    by_mass = np.lexsort((np.arange(n_lab), -mass))
    bins: list[list[int]] = []
    room: list[int] = []
    for c in by_mass:
        sz = int(sizes[c])
        if sz == 0:
            continue
        placed = False
        if sz < tile_r:
            for b in range(max(len(bins) - FFD_WINDOW, 0), len(bins)):
                if room[b] >= sz:
                    bins[b].append(int(c))
                    room[b] -= sz
                    placed = True
                    break
        if not placed:
            bins.append([int(c)])
            room.append(max(tile_r - sz, 0))
    cluster_pos = np.zeros(n_lab, dtype=np.int64)
    k = 0
    for b in bins:
        for c in b:
            cluster_pos[c] = k
            k += 1
    order[:n_inner] = np.lexsort((-deg, cluster_pos[lab]))
    return order


def held_parts(art: PartitionArtifacts, part: Optional[int] = None) -> list:
    """The global part ids of art's stacked rows: all of them, or `part`
    for a rank's own load."""
    held = art.feat.shape[0]
    if held == art.n_parts:
        return list(range(held))
    if held == 1 and part is not None:
        return [part]
    raise ValueError(f"artifacts hold {held} of {art.n_parts} parts; name "
                     f"the one part held")


def compute_orders(art: PartitionArtifacts, tile_r: int = 512,
                   parts: Optional[list] = None) -> np.ndarray:
    """The held parts' orders, stacked [held, pad_inner] (`parts`: the
    held rows' global part ids, for n_inner's row; all by default)."""
    parts = held_parts(art) if parts is None else parts
    return np.stack([
        cluster_reorder(art.src[p], art.dst[p], art.pad_inner,
                        int(art.n_inner[parts[p]]), tile_r=tile_r)
        for p in range(art.feat.shape[0])])


def apply_reorder(art: PartitionArtifacts, orders: np.ndarray,
                  parts: Optional[list] = None) -> PartitionArtifacts:
    """New artifacts with each held part's inner rows permuted by its order:
    row-indexed arrays gathered by the order; src, dst and the part's own
    boundary lists (bnd, n_b's row of the part, `parts[p]` for held row p)
    remapped through the inverse (halo slots >= pad_inner and the trash
    row untouched). A partial load (a rank's own part) names its parts'
    global ids in `parts`."""
    held = art.feat.shape[0]
    if parts is None:
        if held != art.n_b.shape[0]:
            raise ValueError(
                f"apply_reorder needs full artifacts (all "
                f"{art.n_b.shape[0]} parts) or the held parts' ids; got "
                f"{held} part rows")
        parts = list(range(held))
    pad_inner = art.pad_inner

    def rows(a):
        return np.stack([a[p][orders[p]] for p in range(held)])

    out_deg_ext = art.out_deg_ext.copy()
    src = art.src.copy()
    dst = np.empty_like(art.dst)
    bnd = art.bnd.copy()
    for p in range(held):
        pos = np.empty(pad_inner, dtype=np.int64)
        pos[orders[p]] = np.arange(pad_inner)
        out_deg_ext[p, :pad_inner] = out_deg_ext[p, :pad_inner][orders[p]]
        sp = src[p]
        inner = sp < pad_inner
        sp[inner] = pos[sp[inner]].astype(sp.dtype)
        pos_ext = np.concatenate([pos, [pad_inner]])
        dst[p] = pos_ext[art.dst[p]].astype(art.dst.dtype)
        for j in range(art.bnd.shape[1]):
            k = int(art.n_b[parts[p], j])
            if k:
                bnd[p, j, :k] = pos[art.bnd[p, j, :k]].astype(bnd.dtype)
    return dataclasses.replace(
        art, feat=rows(art.feat), label=rows(art.label),
        train_mask=rows(art.train_mask), val_mask=rows(art.val_mask),
        test_mask=rows(art.test_mask), inner_mask=rows(art.inner_mask),
        in_deg=rows(art.in_deg), out_deg_ext=out_deg_ext, src=src, dst=dst,
        bnd=bnd, global_nid=rows(art.global_nid))


def coverage_sums(art: PartitionArtifacts, occupancy_min: int,
                  tile_budget_bytes: int, tile: int, perms=None) -> np.ndarray:
    """Per held part, (edges on dense tiles, real edges) under `perms`
    (stacked row [held, pad_inner] and column [held, n_ext] orders; None:
    the artifact order), [held, 2] float64: the JAX package's
    artifact_coverage before its sum over the parts."""
    ident_i = np.arange(art.pad_inner, dtype=np.int64)
    ident_e = np.arange(art.n_ext, dtype=np.int64)
    out = np.zeros((art.feat.shape[0], 2))
    for p in range(art.feat.shape[0]):
        pi = ident_i if perms is None else perms[0][p]
        pe = ident_e if perms is None else perms[1][p]
        real = art.dst[p] < art.pad_inner
        d, s = art.dst[p][real], art.src[p][real]
        cov = estimate_coverage(pi, pe, art.pad_inner, art.n_ext, d, s,
                                occupancy_min=occupancy_min,
                                tile_budget_bytes=tile_budget_bytes,
                                tile_r=tile, tile_c=tile)
        out[p] = (cov * len(d), len(d))
    return out


def _fraction(sums: np.ndarray) -> float:
    """Parts' (dense, total) sums added in part order, as a fraction."""
    dense = total = 0.0
    for d, t in sums:
        dense += d
        total += t
    return dense / max(total, 1.0)


def artifact_coverage(art: PartitionArtifacts, occupancy_min: int,
                      tile_budget_bytes: int, tile: int,
                      perms=None) -> float:
    """Edge-weighted dense-tile coverage of the held parts under `perms`
    (bnsgcn_tpu/data/reorder.py artifact_coverage)."""
    return _fraction(coverage_sums(art, occupancy_min, tile_budget_bytes,
                                   tile, perms))


def reorder_cache_path(cfg: Config, art: PartitionArtifacts,
                       tile: int) -> Optional[str]:
    """The memoized orders' file under --cache-dir (None without one),
    content-addressed by the held parts' pre-permutation (n_b, src, dst) as
    the JAX package's is by the whole partition's, and versioned with the
    algorithm and the tile."""
    if not cfg.cache_dir:
        return None
    dg = hashlib.sha1()
    for a in (art.n_b, art.src, art.dst):
        dg.update(np.ascontiguousarray(a))
    gname = cfg.graph_name or cfg.derive_graph_name()
    return os.path.join(
        cfg.cache_dir,
        f"reorder_{gname}_{dg.hexdigest()[:12]}_{REORDER_ALGO}_t{tile}.pkl")


def maybe_reorder(cfg: Config, art: PartitionArtifacts, log=print,
                  comm=None, part: Optional[int] = None
                  ) -> tuple[PartitionArtifacts, str, dict]:
    """Resolve --reorder for this run: (artifacts, 'cluster' | 'off',
    info). 'off' returns `art` untouched. 'cluster' applies the orders;
    'auto' applies them only when the coverage of the artifact order after
    beats that of the hybrid's per-build cluster order before. `art` holds
    every part (P=1, or a test's full load) or, with `comm`, the rank's
    own part `part`; the ranks' per-part coverage sums meet in one
    all-reduce (each rank's row, zeros elsewhere, then added in part
    order), so every rank reaches the JAX package's verdict."""
    mode = cfg.reorder or "off"
    if mode == "off":
        return art, "off", {}
    if mode not in ("auto", "cluster"):
        raise ConfigError(
            f"--reorder must be 'auto', 'cluster' or 'off', got {mode!r}")
    if cfg.n_nodes > 1:
        log("reorder: multi-host partial loads keep the on-disk row order "
            "(--reorder forced off)")
        return art, "off", {}
    tile = int(cfg.block_tile or 512)
    occ = effective_occupancy(int(cfg.block_occupancy or 0), tile, tile)
    budget = int(cfg.block_tile_budget_mb) << 20
    parts = held_parts(art, part)
    t0 = time.perf_counter()
    held = art.feat.shape[0]
    base_i = np.stack([cluster_order(art.src[p], art.dst[p], art.pad_inner,
                                     art.n_ext)[0] for p in range(held)])
    base_e = np.concatenate(
        [base_i, np.tile(np.arange(art.pad_inner, art.n_ext), (held, 1))],
        axis=1)
    before = coverage_sums(art, occ, budget, tile, perms=(base_i, base_e))
    orders, cached = None, False
    path = reorder_cache_path(cfg, art, tile)
    if path is not None:
        orders = try_load(path, log)
        cached = orders is not None
        if cached and orders.shape != (held, art.pad_inner):
            orders, cached = None, False
    if orders is None:
        orders = compute_orders(art, tile_r=tile, parts=parts)
        if path is not None:
            os.makedirs(cfg.cache_dir, exist_ok=True)
            atomic_dump(orders, path)
    art2 = apply_reorder(art, orders, parts)
    after = coverage_sums(art2, occ, budget, tile)
    build_ms = (time.perf_counter() - t0) * 1e3
    rows = np.zeros((art.n_parts, 4))
    rows[parts] = np.concatenate([before, after], axis=1)
    if comm is not None:
        t = torch.from_numpy(rows).to(comm.device)
        rows = comm.all_reduce_(t, kind="reduce").cpu().numpy()
    cov_before = _fraction(rows[:, :2])
    cov_after = _fraction(rows[:, 2:])
    applied = mode == "cluster" or cov_after > cov_before + 1e-9
    resolved = "cluster" if applied else "off"
    info = {"algorithm": REORDER_ALGO, "mode": mode, "resolved": resolved,
            "tile": tile, "coverage_before": round(cov_before, 4),
            "coverage_after": round(cov_after, 4),
            "build_ms": round(build_ms, 1), "cached": bool(cached)}
    log(f"reorder: {mode} -> {resolved} [{REORDER_ALGO}, t{tile}] tile "
        f"coverage {cov_before:.1%} -> {cov_after:.1%} "
        f"({build_ms:.0f} ms{', order cached' if cached else ''})")
    return (art2 if applied else art), resolved, info
