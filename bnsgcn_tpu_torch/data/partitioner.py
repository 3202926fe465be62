"""Graph partitioning, offline on the host (counterpart of
bnsgcn_tpu/data/partitioner.py). Methods:

  * 'random' -- balanced random assignment;
  * 'metis'  -- locality-minimizing partition by the port's copy of the
    native C++ partitioner (native/), with the pure-Python BFS region
    growing in its place when the library cannot be built (said on stderr).

Both return `part_id: [N] int32` with every node in exactly one part; the
partition artifacts (halo metadata and so on) come from artifacts.py.
"""

from __future__ import annotations

import os
import re
import sys
from collections import deque

import numpy as np

from bnsgcn_tpu_torch.data.graph import Graph


def random_partition(g: Graph, n_parts: int, seed: int = 0) -> np.ndarray:
    """Balanced random assignment: shuffle nodes, deal them out round-robin."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(g.n_nodes)
    part_id = np.empty(g.n_nodes, dtype=np.int32)
    part_id[perm] = np.arange(g.n_nodes, dtype=np.int32) % n_parts
    return part_id


def _csr(g: Graph):
    order = np.argsort(g.src, kind="stable")
    dst_sorted = g.dst[order]
    indptr = np.zeros(g.n_nodes + 1, dtype=np.int64)
    np.add.at(indptr[1:], g.src, 1)
    indptr = np.cumsum(indptr)
    return indptr, dst_sorted


def bfs_partition(g: Graph, n_parts: int, seed: int = 0) -> np.ndarray:
    """Balanced BFS region growing: grow each part from a random seed until it
    reaches N/P nodes, keeping parts locally connected (low edge cut)."""
    rng = np.random.default_rng(seed)
    indptr, adj = _csr(g)
    n = g.n_nodes
    cap = -(-n // n_parts)           # ceil
    part_id = np.full(n, -1, dtype=np.int32)
    seen = np.zeros(n, dtype=bool)          # enqueued-or-assigned guard
    sizes = np.zeros(n_parts, dtype=np.int64)
    order = rng.permutation(n)
    cursor = 0
    for p in range(n_parts):
        while cursor < n and part_id[order[cursor]] != -1:
            cursor += 1
        if cursor >= n:
            break
        q = deque([order[cursor]])
        seen[order[cursor]] = True
        while q and sizes[p] < cap:
            u = q.popleft()
            if part_id[u] != -1:
                continue
            part_id[u] = p
            sizes[p] += 1
            for v in adj[indptr[u]:indptr[u + 1]]:
                if not seen[v]:
                    seen[v] = True
                    q.append(int(v))
        # nodes left in the queue stay available for the next region
        for u in q:
            if part_id[u] == -1:
                seen[u] = False
    # any leftovers -> smallest parts
    for u in np.nonzero(part_id == -1)[0]:
        p = int(np.argmin(sizes))
        part_id[u] = p
        sizes[p] += 1
    return part_id


def partition_graph(g: Graph, n_parts: int, method: str = "metis",
                    obj: str = "vol", seed: int = 0) -> np.ndarray:
    if n_parts == 1:
        return np.zeros(g.n_nodes, dtype=np.int32)
    if method == "random":
        return random_partition(g, n_parts, seed)
    if method == "metis":
        from bnsgcn_tpu_torch.native import native_partition
        try:
            return native_partition(g.src, g.dst, g.n_nodes, n_parts, obj,
                                    seed)
        except RuntimeError as e:
            print(f"[partition] BFS region growing in place of the native "
                  f"partitioner ({e})", file=sys.stderr)
            return bfs_partition(g, n_parts, seed)
    raise ValueError(f"unknown partition method {method!r}")


def degree_tables(src: np.ndarray, dst: np.ndarray,
                  n_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Degree recompute from COO edges: (in_deg, out_deg), [N] int64."""
    in_deg = np.bincount(np.asarray(dst), minlength=n_nodes).astype(np.int64)
    out_deg = np.bincount(np.asarray(src), minlength=n_nodes).astype(np.int64)
    return in_deg, out_deg


def degree_norm_row(deg_g: np.ndarray, ids: np.ndarray, pad: int) -> np.ndarray:
    """One part's padded degree row: global degrees at `ids` (the part's
    sorted inner node ids), padding rows pinned to 1 so the normalization
    divide is a no-op on them. f32."""
    row = np.ones(pad, dtype=np.float32)
    row[:len(ids)] = deg_g[ids]
    return row


def validate_artifact_dir(path: str, n_parts: int,
                          parts: "list[int] | None" = None) -> None:
    """Check that the part files on disk match meta.json's part count (a
    stale meta.json beside re-partitioned files would otherwise fail deep in
    np.stack). `parts` restricts the check to a partial load's part ids."""
    from bnsgcn_tpu_torch.config import ConfigError
    present = set()
    for fn in os.listdir(path):
        m = re.fullmatch(r"part(\d+)\.npz", fn)
        if m:
            present.add(int(m.group(1)))
    want = set(range(n_parts)) if parts is None else set(parts)
    missing = sorted(want - present)
    extra = sorted(p for p in present if p >= n_parts)
    if missing:
        raise ConfigError(
            f"artifact dir {path}: meta.json says n_parts={n_parts} but part "
            f"files {missing} are missing (have {sorted(present)}); "
            f"re-run partitioning")
    if extra:
        raise ConfigError(
            f"artifact dir {path}: meta.json says n_parts={n_parts} but extra "
            f"part files {extra} exist -- stale meta.json next to a "
            f"re-partitioned dir; re-run partitioning or remove the dir")
