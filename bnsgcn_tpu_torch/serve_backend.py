"""The partition-sharded serving fleet, backend half (counterpart of
bnsgcn_tpu/serve_backend.py): one process per (part, replica), owning
exactly its training partition's shard of the serving state, on the card
unless --device cpu.

Each backend holds the table rows of its part's nodes (the global id ->
shard row map comes from the `global_nid` tables the training halo
exchange indexes by), the in- and out-CSR slices of the edges whose
destination (resp. source) it owns, its slice of the delta journal, and a
cache of remote halo rows. Tier A is a shard lookup. Tier B builds the
exact L-hop closure: the rows it needs from OTHER parts are fetched
batched per remote part (the peers' `resolve` op over pooled
connections), cached, and dropped when their owner mutates them (the
router's `invalidate` fan-out), so the closure's inputs are always the
owners' current state and the scores are bitwise the single-host
server's.

Exactness rests on two invariants:

  * The CSR slices keep order: the in-CSR keeps the edges whose
    destination is owned by an order-preserving filter and a stable sort,
    so every destination's in-edge order (its summation order, and with
    it its score) is the single-host DynamicGraph's.
  * Deltas land pre-routed: the router serializes writes and answers only
    after apply, invalidate and mark have all landed, so a read that
    follows a write sees what one lock hold gives the single-host core.

Locking: the shard's graph state (features, degrees, CSR, append lists)
is guarded by the owning core's lock, as DynamicGraph's is. Only the halo
cache has its own lock: `prefetch` runs OUTSIDE the core lock (a peer
round trip never stalls concurrent predicts; peers answer `resolve` under
their own short lock alone, so no distributed lock cycle can form), and
the locked build reads the cache alone, raising serve.HaloCacheMiss to
fetch again when a delta races the prefetch.

The closure, the subgraph's edges and the halo cache are numpy arrays
(the JAX package walks Python dicts node by node); their outputs are
array-equal to the JAX class's.

CLI:  python -m bnsgcn_tpu_torch.main serve-backend --dataset ... \\
          --serve-part 0 [--serve-replica 0] [--serve-backend-port 0] \\
          [--serve-router host:port] --ckpt-path ... [--device cpu]
Exit codes: 0 after the router's forwarded `shutdown`, 75 after
SIGTERM/SIGINT (the delta-log shard flushed, resumable), 2 a config error
(no CUDA device without --device cpu among them).
"""

from __future__ import annotations

import os
import socket
import sys
import threading
import time
from typing import Iterable, Optional

import numpy as np

from bnsgcn_tpu_torch import checkpoint as ckpt
from bnsgcn_tpu_torch import obs as obs_mod
from bnsgcn_tpu_torch import resilience
from bnsgcn_tpu_torch import serve
from bnsgcn_tpu_torch.config import Config, ConfigError, parse_config
from bnsgcn_tpu_torch.data.graph import Graph
from bnsgcn_tpu_torch.evaluate import full_graph_embeddings
from bnsgcn_tpu_torch.models.gnn import GNN, ModelSpec
from bnsgcn_tpu_torch.parallel import coord as coord_mod
from bnsgcn_tpu_torch.serve_router import (artifacts_dir, load_owner_map,
                                           router_endpoint)

# remote rows asked of one peer per `resolve` request: keeps each answer a
# few MB at Reddit's feature width and the owner's lock hold short
RESOLVE_CHUNK = 256


def _spans(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The positions [starts[i], starts[i] + lens[i]) for every i,
    concatenated in order."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    shift = np.repeat(starts - (np.cumsum(lens) - lens), lens)
    return shift + np.arange(total, dtype=np.int64)


def _grow(a: np.ndarray, n: int) -> np.ndarray:
    """`a` with its first axis grown to n rows (the new rows zero)."""
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    out[:a.shape[0]] = a
    return out


# ----------------------------------------------------------------------------
# the shard graph: owned CSR slices + remote-halo cache
# ----------------------------------------------------------------------------

class PartGraph:
    """serve.DynamicGraph's protocol over one partition shard. Every id in
    and out is a GLOBAL node id; storage is shard-local ([n_own] arrays
    indexed through `_local`). Remote rows come from the halo cache, which
    `prefetch` fills through the installed `resolver` callable
    ((part, ids) -> {gid: {"feat", "in_deg", "out_deg", "in"}}).

    The halo cache is an arena: `_hslot[v]` is remote node v's slot (-1
    when not cached), each slot's feature row, degrees and the span of its
    in-neighbour list in `_hnbr`; dropped slots are reused, and the list
    buffer is compacted when half of it is dead."""

    def __init__(self, g: Graph, owner: np.ndarray, part: int):
        if np.asarray(owner).shape[0] != g.n_nodes:
            raise ConfigError(
                f"owner map covers {np.asarray(owner).shape[0]} nodes but "
                f"the serving graph has {g.n_nodes} — artifacts from another "
                f"dataset/mode (inductive artifacts cannot back distributed "
                f"serving of the full graph)")
        self.n_nodes = g.n_nodes
        self.owner = np.asarray(owner, dtype=np.int32)
        self.part = int(part)
        self.own_ids = np.flatnonzero(self.owner == self.part
                                      ).astype(np.int64)     # sorted
        self.n_own = int(self.own_ids.shape[0])
        if self.n_own == 0:
            raise ConfigError(f"part {part} owns no nodes")
        # global id -> shard row, -1 for nodes owned elsewhere
        self._local = np.full(self.n_nodes, -1, np.int64)
        self._local[self.own_ids] = np.arange(self.n_own)
        self.feat = np.array(np.asarray(g.feat)[self.own_ids],
                             dtype=np.float32, copy=True)
        self.in_deg = g.in_degrees().astype(np.int64)[self.own_ids].copy()
        self.out_deg = g.out_degrees().astype(np.int64)[self.own_ids].copy()
        src = np.asarray(g.src, np.int64)
        dst = np.asarray(g.dst, np.int64)
        # in-CSR over OWNED destinations, src kept global: the order-
        # preserving filter and the stable sort leave each destination's
        # in-edge order as the single-host DynamicGraph builds it
        keep = self.owner[dst] == self.part
        self._in_src, self._in_ptr = serve._csr(self._local[dst[keep]],
                                                src[keep], self.n_own)
        # out-CSR over OWNED sources, dst kept global (the dirty mark)
        keep = self.owner[src] == self.part
        self._out_dst, self._out_ptr = serve._csr(self._local[src[keep]],
                                                  dst[keep], self.n_own)
        self._extra_in: dict[int, list[int]] = {}    # owned v -> [global u]
        self._extra_out: dict[int, list[int]] = {}   # owned u -> [global v]
        # installed by the CLI once the fleet map is known; None: remote
        # rows cannot resolve
        self.resolver = None
        self._hlock = threading.Lock()
        self._hslot = np.full(self.n_nodes, -1, np.int64)  # guarded-by: self._hlock
        self._hfeat = np.zeros((0, self.n_feat), np.float32)  # guarded-by: self._hlock
        self._hdeg = np.zeros((0, 2), np.int64)     # guarded-by: self._hlock
        self._hstart = np.zeros(0, np.int64)        # guarded-by: self._hlock
        self._hlen = np.zeros(0, np.int64)          # guarded-by: self._hlock
        self._hlive = np.zeros(0, bool)             # guarded-by: self._hlock
        self._hnbr = np.zeros(0, np.int64)          # guarded-by: self._hlock
        self._hnbr_end = 0                          # guarded-by: self._hlock
        self._hdead = 0                             # guarded-by: self._hlock
        self._hslots = 0                            # guarded-by: self._hlock
        self._hfree: list[int] = []                 # guarded-by: self._hlock
        self.halo_cached = 0                        # guarded-by: self._hlock
        self.halo_fetches = 0                       # guarded-by: self._hlock
        self.halo_hits = 0                          # guarded-by: self._hlock
        self.prefetch_s = 0.0                       # guarded-by: self._hlock

    # -- id mapping --

    def _check(self, *nodes: int):
        for v in nodes:
            if not 0 <= v < self.n_nodes:
                raise ValueError(f"node {v} out of range [0, {self.n_nodes})")

    def owns(self, v: int) -> bool:
        return int(self.owner[v]) == self.part

    def local_of(self, v: int) -> int:
        """Shard row of an owned global id (named error on a mis-route)."""
        v = int(v)
        self._check(v)
        i = int(self._local[v])
        if i < 0:
            raise ValueError(f"node {v} is owned by part "
                             f"{int(self.owner[v])}, not part {self.part} — "
                             f"mis-routed request?")
        return i

    # -- the halo arena (callers hold self._hlock) --

    def _slots_locked(self, ids: np.ndarray) -> np.ndarray:
        slots = self._hslot[ids]
        miss = np.flatnonzero(slots < 0)
        if miss.size:
            v = int(ids[miss[0]])
            raise serve.HaloCacheMiss(
                f"part {self.part}: remote row {v} (owner part "
                f"{int(self.owner[v])}) not in the halo cache")
        return slots

    def _alloc_locked(self, k: int) -> np.ndarray:
        got = [self._hfree.pop() for _ in range(min(k, len(self._hfree)))]
        need = k - len(got)
        if need:
            got += range(self._hslots, self._hslots + need)
            self._hslots += need
            if self._hslots > self._hlen.shape[0]:
                cap = max(2 * self._hlen.shape[0], self._hslots, 64)
                self._hfeat = _grow(self._hfeat, cap)
                self._hdeg = _grow(self._hdeg, cap)
                self._hstart = _grow(self._hstart, cap)
                self._hlen = _grow(self._hlen, cap)
                self._hlive = _grow(self._hlive, cap)
        return np.asarray(got, np.int64)

    def _reserve_nbr_locked(self, n: int):
        if self._hnbr_end + n <= self._hnbr.shape[0]:
            return
        if self._hdead > self._hnbr_end // 2:           # compact first
            live = np.flatnonzero(self._hlive[:self._hslots])
            lens = self._hlen[live]
            self._hnbr = self._hnbr[_spans(self._hstart[live], lens)]
            self._hstart[live] = np.cumsum(lens) - lens
            self._hnbr_end = int(lens.sum())
            self._hdead = 0
        if self._hnbr_end + n > self._hnbr.shape[0]:
            self._hnbr = _grow(self._hnbr, max(2 * self._hnbr.shape[0],
                                               self._hnbr_end + n, 1024))

    def _drop_locked(self, ids: np.ndarray) -> int:
        """Forget the cached rows of `ids` (unique); how many were cached."""
        slots = self._hslot[ids]
        hit = slots >= 0
        slots = slots[hit]
        self._hslot[ids[hit]] = -1
        self._hlive[slots] = False
        self._hdead += int(self._hlen[slots].sum())
        self._hfree += slots.tolist()
        self.halo_cached -= int(slots.size)
        return int(slots.size)

    def _store_rows_locked(self, rows: dict):
        """Cache resolved rows; a row fetched twice (racing prefetches)
        replaces the first."""
        if not rows:
            return
        ids = np.fromiter((int(g) for g in rows), np.int64, len(rows))
        vals = list(rows.values())
        self._drop_locked(ids)
        slots = self._alloc_locked(ids.size)
        self._hfeat[slots] = np.asarray(
            [r["feat"] for r in vals], np.float32).reshape(ids.size,
                                                           self.n_feat)
        self._hdeg[slots] = [[int(r["in_deg"]), int(r["out_deg"])]
                             for r in vals]
        ins = [np.asarray(r["in"], np.int64) for r in vals]
        lens = np.fromiter((x.size for x in ins), np.int64, len(ins))
        total = int(lens.sum())
        self._reserve_nbr_locked(total)
        if total:
            self._hnbr[self._hnbr_end:self._hnbr_end + total] = \
                np.concatenate(ins)
        self._hstart[slots] = self._hnbr_end + np.cumsum(lens) - lens
        self._hlen[slots] = lens
        self._hlive[slots] = True
        self._hnbr_end += total
        self._hslot[ids] = slots
        self.halo_cached += int(ids.size)

    # -- the scorer-facing protocol (global ids, owned or cached-remote) --

    @property
    def n_feat(self) -> int:
        return self.feat.shape[1]

    def feat_rows(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        loc = self._local[ids]
        own = loc >= 0
        out = np.empty((ids.size, self.n_feat), dtype=np.float32)
        out[own] = self.feat[loc[own]]
        if not own.all():
            with self._hlock:
                out[~own] = self._hfeat[self._slots_locked(ids[~own])]
        return out

    def _deg_of(self, ids, mine: np.ndarray, col: int) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        loc = self._local[ids]
        own = loc >= 0
        out = np.empty(ids.size, np.int64)
        out[own] = mine[loc[own]]
        if not own.all():
            with self._hlock:
                out[~own] = self._hdeg[self._slots_locked(ids[~own]), col]
        return out

    def in_deg_of(self, ids: np.ndarray) -> np.ndarray:
        return self._deg_of(ids, self.in_deg, 0)

    def out_deg_of(self, ids: np.ndarray) -> np.ndarray:
        return self._deg_of(ids, self.out_deg, 1)

    def in_nbrs(self, v: int) -> list[int]:
        v = int(v)
        if self.owns(v):
            lv = self.local_of(v)
            base = self._in_src[self._in_ptr[lv]:self._in_ptr[lv + 1]]
            extra = self._extra_in.get(v)
            return base.tolist() + extra if extra else base.tolist()
        with self._hlock:
            s = int(self._slots_locked(np.asarray([v]))[0])
            a = int(self._hstart[s])
            return self._hnbr[a:a + int(self._hlen[s])].tolist()

    def out_nbrs(self, v: int) -> list[int]:
        lv = self.local_of(v)       # the mark only ever expands owned nodes
        base = self._out_dst[self._out_ptr[lv]:self._out_ptr[lv + 1]]
        extra = self._extra_out.get(int(v))
        return base.tolist() + extra if extra else base.tolist()

    def _extras_of(self, extra: dict, nodes: np.ndarray) -> list:
        """(v, its appended list) for the owned `nodes` with appended
        edges, ascending v. Safe beside a concurrent delta: the dict's
        keys are copied in one step."""
        if not extra:
            return []
        keys = np.asarray(list(extra), np.int64)
        keys = np.sort(keys[np.isin(keys, nodes)])
        return [(int(k), list(extra.get(int(k), ()))) for k in keys]

    def _in_nbrs_of(self, nodes: np.ndarray, strict: bool = True
                    ) -> np.ndarray:
        """Every in-neighbour (repeats kept) of `nodes`: owned ones from
        the CSR slice and the appended edges, remote ones from the halo
        cache (strict: a missing row raises HaloCacheMiss; else it is
        skipped, as prefetch wants)."""
        loc = self._local[nodes]
        own = loc >= 0
        got = [self._in_src[serve._ranges(self._in_ptr, loc[own])[0]]]
        got += [np.asarray(x, np.int64)
                for _, x in self._extras_of(self._extra_in, nodes[own])]
        if not own.all():
            with self._hlock:
                if strict:
                    slots = self._slots_locked(nodes[~own])
                else:
                    slots = self._hslot[nodes[~own]]
                    slots = slots[slots >= 0]
                got.append(self._hnbr[_spans(self._hstart[slots],
                                             self._hlen[slots])])
        return np.concatenate(got) if len(got) > 1 else got[0]

    def _out_nbrs_of(self, nodes: np.ndarray) -> np.ndarray:
        """Every out-neighbour (repeats kept) of OWNED `nodes`."""
        got = [self._out_dst[serve._ranges(self._out_ptr,
                                           self._local[nodes])[0]]]
        got += [np.asarray(x, np.int64)
                for _, x in self._extras_of(self._extra_out, nodes)]
        return np.concatenate(got) if len(got) > 1 else got[0]

    def in_closure_depths(self, targets: Iterable[int], hops: int
                          ) -> np.ndarray:
        """DynamicGraph.in_closure_depths's walk, reading the halo cache
        alone for remote nodes: a missing row raises HaloCacheMiss (the
        caller prefetches outside the lock and retries)."""
        depth = np.full(self.n_nodes, -1, np.int64)
        frontier = np.unique(np.asarray(list(targets), np.int64))
        depth[frontier] = 0
        for d in range(1, hops + 1):
            if frontier.size == 0:
                break
            hit = np.zeros(self.n_nodes, bool)
            hit[self._in_nbrs_of(frontier)] = True
            frontier = np.nonzero(hit & (depth < 0))[0]
            depth[frontier] = d
        return depth

    def in_closure(self, targets: Iterable[int], hops: int) -> dict[int, int]:
        depth = self.in_closure_depths(targets, hops)
        nodes = np.nonzero(depth >= 0)[0]
        return dict(zip(nodes.tolist(), depth[nodes].tolist()))

    def in_edges_of(self, nodes: np.ndarray) -> tuple[np.ndarray,
                                                      np.ndarray]:
        """(src, dst) global ids of every in-edge of `nodes` (ascending),
        grouped by destination in `nodes`' order, each destination's
        in-edges in in_nbrs order: an owned one's CSR slice then its
        appended edges, a remote one's cached list (its owner's in_nbrs)."""
        nodes = np.asarray(nodes, np.int64)
        loc = self._local[nodes]
        own = loc >= 0
        base_pos, base_len = serve._ranges(self._in_ptr, loc[own])
        lens = np.zeros(nodes.size, np.int64)
        lens[own] = base_len
        extras = self._extras_of(self._extra_in, nodes[own])
        at = np.searchsorted(nodes, np.asarray([k for k, _ in extras],
                                               np.int64))
        ends = lens[at].copy()                  # each extra list's offset
        lens[at] += np.asarray([len(x) for _, x in extras], np.int64)
        if not own.all():
            with self._hlock:
                slots = self._slots_locked(nodes[~own])
                rlen = self._hlen[slots]
                rvals = self._hnbr[_spans(self._hstart[slots], rlen)]
            lens[~own] = rlen
        off = np.cumsum(lens) - lens
        src = np.empty(int(lens.sum()), np.int64)
        src[_spans(off[own], base_len)] = self._in_src[base_pos]
        for (_, x), i, e in zip(extras, at.tolist(), ends.tolist()):
            src[off[i] + e:off[i] + e + len(x)] = x
        if not own.all():
            src[_spans(off[~own], rlen)] = rvals
        return src, np.repeat(nodes, lens)

    # -- halo fetch/invalidate (prefetch runs OUTSIDE the core lock) --

    def prefetch(self, targets: Iterable[int], hops: int):
        """Fetch every remote row the closure of `targets` can touch,
        batched per remote part per BFS level (and the leaf level, whose
        rows feed the feature and degree lookups though their in-lists do
        not expand). The local topology is read without the core lock: a
        raced delta only changes WHICH rows are prefetched; the locked
        build walks again exactly and a row then missing raises
        HaloCacheMiss, which retries through here."""
        if self.resolver is None:
            return
        t0 = time.perf_counter()
        seen = np.zeros(self.n_nodes, bool)
        frontier = np.unique(np.asarray(list(targets), np.int64))
        seen[frontier] = True
        for _ in range(int(hops)):
            self._fetch_missing(frontier[self._local[frontier] < 0])
            nxt = self._in_nbrs_of(frontier, strict=False)
            nxt = np.unique(nxt[~seen[nxt]])
            seen[nxt] = True
            frontier = nxt
        self._fetch_missing(frontier[self._local[frontier] < 0])
        with self._hlock:
            self.prefetch_s += time.perf_counter() - t0

    def _fetch_missing(self, nodes: np.ndarray):
        if nodes.size == 0:
            return
        with self._hlock:
            cached = self._hslot[nodes] >= 0
            self.halo_hits += int(cached.sum())
        need = nodes[~cached]
        if need.size == 0:
            return
        parts = self.owner[need]
        for p in np.unique(parts).tolist():
            rows = self.resolver(int(p), np.unique(need[parts == p]).tolist())
            with self._hlock:
                self.halo_fetches += len(rows)
                self._store_rows_locked(rows)

    def invalidate(self, nodes: Iterable[int]) -> int:
        """Drop cached remote rows the router reports as mutated; returns
        how many were cached here."""
        ids = np.unique(np.asarray([int(v) for v in nodes], np.int64))
        with self._hlock:
            return self._drop_locked(ids)

    def halo_stats(self) -> dict:
        with self._hlock:
            out = {"halo_cached": self.halo_cached,
                   "halo_fetches": self.halo_fetches,
                   "halo_hits": self.halo_hits,
                   "halo_prefetch_s": self.prefetch_s}
        if isinstance(self.resolver, PeerResolver):
            out.update(self.resolver.wire_stats())
        return out

    # -- owner-side delta application + export --

    def add_edges(self, edges: Iterable[tuple[int, int]]) -> set[int]:
        """Apply the owned halves of a router-fanned edge delta: the
        in-edge and in-degree land iff this part owns v, the out-edge and
        out-degree iff it owns u. Returns the owned touched nodes."""
        touched: set[int] = set()
        for u, v in edges:
            u, v = int(u), int(v)
            self._check(u, v)
            if self.owns(u):
                self._extra_out.setdefault(u, []).append(v)
                self.out_deg[self.local_of(u)] += 1
                touched.add(u)
            if self.owns(v):
                self._extra_in.setdefault(v, []).append(u)
                self.in_deg[self.local_of(v)] += 1
                touched.add(v)
        return touched

    def set_feat(self, v: int, vec) -> set[int]:
        v = int(v)
        self._check(v)
        lv = self.local_of(v)
        vec = np.asarray(vec, dtype=np.float32)
        if vec.shape != self.feat[lv].shape:
            raise ValueError(f"feature length {vec.shape} != "
                             f"{self.feat[lv].shape}")
        self.feat[lv] = vec
        return {v}

    def export_rows(self, nodes: Iterable[int]) -> dict:
        """The halo payload peers cache: the current feature row, degrees
        and in-neighbour list of OWNED nodes, JSON-ready (string keys;
        float32 values survive the float64 JSON round trip exactly). The
        caller holds the core lock: the resolve handler's short critical
        section."""
        nodes = [int(v) for v in nodes]
        loc = np.asarray([self.local_of(v) for v in nodes], np.int64)
        pos, lens = serve._ranges(self._in_ptr, loc)
        base = self._in_src[pos].tolist()
        off = (np.cumsum(lens) - lens).tolist()
        feat = self.feat[loc].tolist()
        ind = self.in_deg[loc].tolist()
        outd = self.out_deg[loc].tolist()
        rows: dict[str, dict] = {}
        for i, (v, o, n) in enumerate(zip(nodes, off, lens.tolist())):
            rows[str(v)] = {"feat": feat[i], "in_deg": ind[i],
                            "out_deg": outd[i],
                            "in": base[o:o + n] + self._extra_in.get(v, [])}
        return rows

    # -- compaction support (DynamicGraph's contract) --

    def mutation_state(self) -> dict:
        ein_v, ein_u = [], []
        for v in sorted(self._extra_in):
            for u in self._extra_in[v]:
                ein_v.append(v)
                ein_u.append(u)
        eout_u, eout_v = [], []
        for u in sorted(self._extra_out):
            for v in self._extra_out[u]:
                eout_u.append(u)
                eout_v.append(v)
        return {
            "feat": self.feat.copy(),
            "in_deg": self.in_deg.copy(),
            "out_deg": self.out_deg.copy(),
            "ein_v": np.asarray(ein_v, dtype=np.int64),
            "ein_u": np.asarray(ein_u, dtype=np.int64),
            "eout_u": np.asarray(eout_u, dtype=np.int64),
            "eout_v": np.asarray(eout_v, dtype=np.int64),
        }

    def restore_mutations(self, state: dict):
        feat = np.array(state["feat"], dtype=np.float32, copy=True)
        if feat.shape != self.feat.shape:
            raise ConfigError(
                f"snapshot shard shape {feat.shape} != part {self.part} "
                f"shard {self.feat.shape} — snapshot from another "
                f"partitioning?")
        self.feat = feat
        self.in_deg = np.array(state["in_deg"], dtype=np.int64, copy=True)
        self.out_deg = np.array(state["out_deg"], dtype=np.int64, copy=True)
        self._extra_in = {}
        self._extra_out = {}
        for v, u in zip(np.asarray(state["ein_v"]).tolist(),
                        np.asarray(state["ein_u"]).tolist()):
            self._extra_in.setdefault(int(v), []).append(int(u))
        for u, v in zip(np.asarray(state["eout_u"]).tolist(),
                        np.asarray(state["eout_v"]).tolist()):
            self._extra_out.setdefault(int(u), []).append(int(v))


# ----------------------------------------------------------------------------
# the backend core: shard table + pre-routed delta ops
# ----------------------------------------------------------------------------

class BackendCore(serve.ServeCore):
    """serve.ServeCore over one PartGraph: the table holds the owned rows
    alone (global id -> shard row through _row), client-facing deltas are
    refused (they must route), and the pre-routed fan-out ops (apply_delta,
    apply_feat, mark, invalidate, resolve) with a per-(part, replica)
    delta-log shard take their place."""

    def __init__(self, cfg: Config, spec: ModelSpec, graph: PartGraph,
                 model: GNN, hidden: np.ndarray, logits: np.ndarray,
                 log=print, obs: Optional[obs_mod.Obs] = None,
                 multilabel: bool = False):
        super().__init__(cfg, spec, graph, model, hidden, logits, log=log,
                         obs=obs, multilabel=multilabel)
        self.part = graph.part
        self.replica = int(cfg.serve_replica)
        self.backend_id = f"p{self.part}.r{self.replica}"
        # per-(part, replica) files: two replicas of one part sharing a
        # serve dir never race on one file
        self._delta_log_name = f"delta_log.{self.backend_id}.jsonl"
        self._snapshot_name = f"serve_snapshot.{self.backend_id}.blob"

    def _check_table(self, hidden: np.ndarray, logits: np.ndarray):
        n_own = self.graph.n_own
        if hidden.shape[0] != n_own or logits.shape[0] != n_own:
            raise ConfigError(
                f"table shard rows ({hidden.shape[0]}/{logits.shape[0]}) != "
                f"part {self.graph.part} owned nodes ({n_own}) — wrong "
                f"--embeddings artifact or partitioning?")

    def _row(self, node: int) -> int:
        return self.graph.local_of(int(node))

    # client-facing deltas must route: the owning parts, the halo
    # invalidation and the cross-part dirty mark are the ROUTER's job
    def add_edges(self, edges: list) -> dict:
        raise ValueError(
            "add_edges must route through the serve-router (backends only "
            "accept the pre-routed apply_delta/mark/invalidate fan-out)")

    def update_feat(self, node: int, vec) -> dict:
        raise ValueError(
            "update_feat must route through the serve-router (backends "
            "only accept the pre-routed apply_feat/mark/invalidate fan-out)")

    # -- pre-routed fan-out ops --

    def apply_delta(self, edges: list) -> dict:
        """Phase 1 of a routed add_edges: append the halves this part owns
        and journal the entry (a replay applies exactly this again)."""
        pairs = [(int(u), int(v)) for u, v in edges]
        with self._lock:
            touched = self.graph.add_edges(pairs)
            self.deltas.append({"op": "apply_delta",
                                "edges": [[u, v] for u, v in pairs]})
            self.stats["deltas"] += 1
        if self.obs is not None:
            self.obs.emit("delta", op="apply_delta", edges=len(pairs),
                          part=self.part, touched=len(touched))
        return {"ok": True, "touched": len(touched)}

    def apply_feat(self, node: int, vec) -> dict:
        with self._lock:
            self.graph.set_feat(int(node), vec)
            self.deltas.append({"op": "apply_feat", "node": int(node),
                                "feat": np.asarray(
                                    vec, dtype=np.float32).tolist()})
            self.stats["deltas"] += 1
        if self.obs is not None:
            self.obs.emit("delta", op="apply_feat", node=int(node),
                          part=self.part)
        return {"ok": True}

    def _mark_walk_locked(self, pairs: list) -> tuple:
        """The dirty-mark walk over owned out-edges: (reached owned nodes,
        {remote node: its best remaining hop budget}). Budgets are settled
        from the largest down, so each node keeps the best budget any seed
        reaches it with (the JAX package's stack walk, level by level);
        remote nodes are not expanded. Caller holds the lock."""
        g = self.graph
        best = np.full(g.n_nodes, -1, np.int64)
        if pairs:
            np.maximum.at(best, np.asarray([v for v, _ in pairs], np.int64),
                          np.asarray([h for _, h in pairs], np.int64))
        for b in range(int(best.max(initial=-1)), 0, -1):
            fr = np.flatnonzero((best == b) & (g._local >= 0))
            if fr.size == 0:
                continue
            nb = g._out_nbrs_of(fr)
            best[nb[best[nb] < b - 1]] = b - 1
        hit = np.flatnonzero(best >= 0)
        own = g._local[hit] >= 0
        remote = hit[~own]
        return (set(hit[own].tolist()),
                dict(zip(remote.tolist(), best[remote].tolist())))

    def mark_nodes(self, seeds: list) -> dict:
        """One shard's slice of the router's distributed dirty-mark BFS:
        walk owned out-edges with the remaining hop budget, mark every
        owned node reached (its logits can have changed), and hand nodes
        owned elsewhere back as the frontier. Journaled, so a relaunch
        replays its own dirty marks without any cross-part traffic."""
        pairs = [(int(v), int(h)) for v, h in seeds]
        with self._lock:
            reached, remote = self._mark_walk_locked(pairs)
            added = reached - self.dirty
            self.dirty |= reached
            self._mark_dirty_stamps_locked(reached)
            self.deltas.append({"op": "mark", "nodes": [[v, h]
                                                        for v, h in pairs]})
            self.stats["deltas"] += 1
            dirty_total = len(self.dirty)
        return {"ok": True, "marked": len(added), "dirty_total": dirty_total,
                "frontier": sorted([v, h] for v, h in remote.items())}

    def invalidate(self, nodes: list) -> dict:
        """Phase 2 of a routed delta: drop mutated remote rows from the
        halo cache. Not journaled: a relaunch starts with an empty cache."""
        return {"ok": True, "dropped": self.graph.invalidate(nodes)}

    def resolve(self, nodes: list) -> dict:
        """The peers' halo lookup: the current rows of OWNED nodes, under
        one short lock hold (the only cross-backend read path, and it takes
        no other lock: no distributed lock cycle)."""
        with self._lock:
            return {"ok": True, "part": self.part,
                    "rows": self.graph.export_rows(nodes)}

    def _apply_logged(self, d: dict):
        if d["op"] == "apply_delta":
            self.apply_delta(d["edges"])
        elif d["op"] == "apply_feat":
            self.apply_feat(d["node"], d["feat"])
        elif d["op"] == "mark":
            self.mark_nodes(d["nodes"])
        else:
            super()._apply_logged(d)

    def snapshot_stats(self) -> dict:
        out = super().snapshot_stats()
        out["part"] = self.part
        out["replica"] = self.replica
        out["backend"] = self.backend_id
        out["n_own"] = self.graph.n_own
        out.update(self.graph.halo_stats())
        return out


class BackendServer(serve.ServeServer):
    """serve.ServeServer plus the fan-out and peer ops; client-facing
    delta ops come back as named route-through-the-router errors.

    Fault injection (`--inject servekill@N:p0.r1,...`) counts ROUTED
    data-path ops alone (reads and the pre-routed write fan-out), never
    ping or stats (the prober must see the truth) and never a peer
    `resolve` (its timing follows other backends' prefetches, which would
    make the Nth-request trigger nondeterministic)."""

    FAULT_OPS = ("predict", "predict_many", "apply_delta", "apply_feat",
                 "mark")

    def __init__(self, core: serve.ServeCore, port: int, addr: str = "",
                 log=print,
                 faults: Optional[resilience.ServeFaultPlan] = None):
        # set before super().__init__ starts the listener thread
        self.faults = faults
        self._fault_count = 0           # guarded-by: self._fault_lock
        self._fault_lock = threading.Lock()
        super().__init__(core, port, addr, log=log)

    def _handle(self, req: dict) -> Optional[dict]:
        fp = self.faults
        if fp is not None and not fp.empty() \
                and req.get("op") in self.FAULT_OPS:
            with self._fault_lock:
                self._fault_count += 1
                n = self._fault_count
            if fp.pop("servekill", n):
                self.log(f"[inject] servekill at data-path request {n}: "
                         f"exiting hard (no drain, no journal flush)")
                os._exit(1)
            if fp.pop("servehang", n):
                self.log(f"[inject] servehang at data-path request {n}: "
                         f"wedging this handler (probes still answer)")
                time.sleep(3600.0)
                return None
            if fp.pop("servedrop", n):
                self.log(f"[inject] servedrop at data-path request {n}: "
                         f"tearing the connection without a response")
                return None
        return super()._handle(req)

    def _dispatch(self, op: Optional[str], req: dict) -> dict:
        core = self.core
        if op == "apply_delta":
            out = core.apply_delta(req["edges"])
            core.maybe_compact()
            return out
        if op == "apply_feat":
            out = core.apply_feat(req["node"], req["feat"])
            core.maybe_compact()
            return out
        if op == "mark":
            out = core.mark_nodes(req["nodes"])
            core.maybe_compact()
            return out
        if op == "invalidate":
            return core.invalidate(req["nodes"])
        if op == "resolve":
            return core.resolve(req["nodes"])
        if op == "part_info":
            return {"ok": True, "part": core.part, "replica": core.replica,
                    "n_own": core.graph.n_own, "n_nodes": core.graph.n_nodes}
        return super()._dispatch(op, req)


# ----------------------------------------------------------------------------
# peer resolver: halo rows through the fleet map
# ----------------------------------------------------------------------------

class PeerResolver:
    """Resolves remote halo rows for a PartGraph: asks the router where
    each part lives (cached), keeps one pooled connection per peer, asks
    for RESOLVE_CHUNK rows at a time, and on a dead peer refreshes the
    fleet map and retries: `resolve` is idempotent, so pooled retries are
    safe. `wire_stats` gives the requests and bytes it exchanged."""

    def __init__(self, router_addr: str, router_port: int,
                 timeout_s: float = 30.0):
        self.router_addr = router_addr
        self.router_port = int(router_port)
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._clients: dict = {}    # guarded-by: self._lock
        self._retired = [0, 0]      # bytes of dropped clients; guarded-by: self._lock
        self.requests = 0           # guarded-by: self._lock

    def _client(self, part: int) -> coord_mod.LineJsonClient:
        with self._lock:
            c = self._clients.get(part)
        if c is not None:
            return c
        resp = coord_mod.rpc_line_json(
            self.router_addr, self.router_port, {"op": "fleet"},
            time.monotonic() + self.timeout_s, what="serve router")
        entries = (resp.get("parts") or {}).get(str(part)) or []
        if not entries:
            raise coord_mod.CoordTimeout(
                f"no backend registered for part {part} — halo rows it "
                f"owns cannot resolve")
        e = entries[0]
        c = coord_mod.LineJsonClient(e["addr"], int(e["port"]),
                                     timeout_s=self.timeout_s,
                                     what=f"peer backend {e['id']}")
        with self._lock:
            self._clients[part] = c
        return c

    def _drop(self, part: int):
        with self._lock:
            c = self._clients.pop(part, None)
        if c is not None:
            sent, got = c.traffic()
            c.close()
            with self._lock:
                self._retired[0] += sent
                self._retired[1] += got

    def _resolve(self, part: int, ids: list[int]) -> dict:
        # the backoff rides out the window between a replica dying and the
        # router's health checker dropping it from the map the refetch
        # returns
        for attempt in range(4):
            try:
                resp = self._client(part).request(
                    {"op": "resolve", "nodes": [int(v) for v in ids]})
                break
            except coord_mod.CoordTimeout:
                self._drop(part)        # stale map: refetch + retry
                if attempt == 3:
                    raise
                time.sleep(0.25 * (attempt + 1))
        with self._lock:
            self.requests += 1
        if not resp.get("ok"):
            raise RuntimeError(f"part {part} resolve failed: "
                               f"{resp.get('err')}")
        return {int(g): {"feat": r["feat"], "in_deg": int(r["in_deg"]),
                         "out_deg": int(r["out_deg"]), "in": r["in"]}
                for g, r in resp["rows"].items()}

    def __call__(self, part: int, ids: list[int]) -> dict:
        rows: dict = {}
        for i in range(0, len(ids), RESOLVE_CHUNK):
            rows.update(self._resolve(part, ids[i:i + RESOLVE_CHUNK]))
        return rows

    def wire_stats(self) -> dict:
        """Resolve requests answered, and the bytes sent and received on
        the peer connections (JSON lines, newline included)."""
        with self._lock:
            clients = list(self._clients.values())
            out = {"halo_requests": self.requests,
                   "halo_bytes_out": self._retired[0],
                   "halo_bytes_in": self._retired[1]}
        for c in clients:
            sent, got = c.traffic()
            out["halo_bytes_out"] += sent
            out["halo_bytes_in"] += got
        return out

    def close(self):
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for c in clients:
            c.close()


# ----------------------------------------------------------------------------
# construction + CLI
# ----------------------------------------------------------------------------

def build_backend_core(cfg: Config, g: Graph, owner: np.ndarray, model: GNN,
                       log=print, hidden: Optional[np.ndarray] = None,
                       logits: Optional[np.ndarray] = None,
                       obs: Optional[obs_mod.Obs] = None) -> BackendCore:
    """BackendCore for part cfg.serve_part with `model` (on its device). A
    full (hidden, logits) table is sliced to the shard; without one the
    full table is precomputed (evaluate.full_graph_embeddings, the
    single-host server's precompute, so every backend's rows are bitwise
    the single-host server's on the same device)."""
    cfg = cfg.replace(n_feat=g.n_feat, n_class=g.n_class, n_train=g.n_train)
    graph = PartGraph(g, owner, cfg.serve_part)
    if hidden is None or logits is None:
        t0 = time.perf_counter()
        hidden, logits = full_graph_embeddings(
            model, g, next(model.parameters()).device)
        log(f"[backend {graph.part}] precomputed the full table in "
            f"{time.perf_counter() - t0:.1f}s; keeping the "
            f"{graph.n_own}-row shard")
    hidden = np.asarray(hidden)
    logits = np.asarray(logits)
    if hidden.shape[0] == g.n_nodes:        # full table -> shard slice
        hidden = hidden[graph.own_ids]
        logits = logits[graph.own_ids]
    return BackendCore(cfg, model.spec, graph, model,
                       np.array(hidden, copy=True),
                       np.array(logits, copy=True), log=log, obs=obs,
                       multilabel=g.multilabel)


def mint_incarnation(part: int, replica: int) -> str:
    """Process-unique incarnation token for one (part, replica) slot. The
    router retires the previous token when a new one registers, so a
    zombie of the old process re-registering later is refused by name."""
    return (f"p{part}.r{replica}@{socket.gethostname()}:"
            f"{os.getpid()}:{int(time.time() * 1000)}")


def _register_with_router(cfg: Config, port: int, log,
                          deadline_s: float = 120.0,
                          incarnation: Optional[str] = None) -> None:
    """Announce (part, replica, addr, port) to the router, retrying while
    it comes up: backends and the router start in any order."""
    raddr, rport = router_endpoint(cfg)
    resp = coord_mod.rpc_line_json(
        raddr, rport,
        {"op": "register", "part": cfg.serve_part,
         "replica": cfg.serve_replica,
         "addr": cfg.serve_addr or "127.0.0.1", "port": port,
         "incarnation": incarnation},
        time.monotonic() + deadline_s, what="serve router")
    if not resp.get("ok"):
        raise ConfigError(f"router at {raddr}:{rport} rejected "
                          f"registration: {resp.get('err')}")
    log(f"[backend] registered as {resp.get('id')} with the router at "
        f"{raddr}:{rport}"
        + (f" (health state {resp['state']!r})" if resp.get("state")
           else "")
        + (f" (fleet waiting on parts {resp['missing_parts']})"
           if resp.get("missing_parts") else ""))


def backend_main(argv=None) -> int:
    """`python -m bnsgcn_tpu_torch.main serve-backend ...`.

    Exit codes: 0 clean shutdown (the router's forwarded 'shutdown' op),
    75 graceful SIGTERM/SIGINT drain (delta-log shard flushed, resumable),
    2 config error."""
    from bnsgcn_tpu_torch.data.datasets import load_data
    from bnsgcn_tpu_torch.run import resolve_device, set_float32_math
    try:
        cfg = parse_config(argv, training=False)
    except ConfigError as ex:
        print(f"[config] {ex}", file=sys.stderr)
        return 2
    if not cfg.graph_name:
        cfg = cfg.replace(graph_name=cfg.derive_graph_name())
    log = print
    # a fixed obs rank from the shard coordinates (rank 0 is the router):
    # each backend's event log lands as PATH.r<rank>
    rank = 1 + cfg.serve_part * max(cfg.part_replicas, 1) + cfg.serve_replica
    obs = obs_mod.make_obs(cfg, rank=rank, log=log)
    try:
        part_dir = artifacts_dir(cfg)
        owner = load_owner_map(part_dir)
        n_parts = int(owner.max()) + 1
        if not 0 <= cfg.serve_part < n_parts:
            raise ConfigError(f"--serve-part {cfg.serve_part} out of range "
                              f"[0, {n_parts}) for the artifacts at "
                              f"{part_dir}")
        if cfg.serve_replica < 0:
            raise ConfigError(f"--serve-replica must be >= 0, got "
                              f"{cfg.serve_replica}")
        device = resolve_device(cfg.device)
        set_float32_math()
        g, _, _ = load_data(cfg)
        cfg = cfg.replace(n_feat=g.n_feat, n_class=g.n_class,
                          n_train=g.n_train)
        model, _, _ = serve.load_model(cfg, device, log)
        hidden = logits = None
        if cfg.embeddings:
            hidden, logits, _ = serve.load_table(cfg.embeddings)
            log(f"[backend] cold start from embedding table "
                f"{cfg.embeddings} ({hidden.shape[0]} rows)")
        core = build_backend_core(cfg, g, owner, model, log=log,
                                  hidden=hidden, logits=logits, obs=obs)
    except ConfigError as ex:
        print(f"[config] {ex}", file=sys.stderr)
        return 2
    except ckpt.CheckpointCorrupt as ex:
        print(f"[config] embedding artifact unusable: {ex}", file=sys.stderr)
        return 2

    serve_dir = cfg.serve_dir or os.path.join(cfg.ckpt_path, "serve")
    core.serve_dir = serve_dir
    try:
        counts = core.load_serving_state(serve_dir)
    except ckpt.CheckpointCorrupt as ex:
        print(f"[config] serving snapshot unusable: {ex} — the delta log "
              f"is only a tail past a snapshot; refusing to resume from a "
              f"hole in history", file=sys.stderr)
        core.close()
        return 2
    if counts["replayed"] or counts["folded"]:
        log(f"[backend {core.backend_id}] resumed: {counts['folded']} "
            f"delta(s) from the snapshot + {counts['replayed']} replayed "
            f"from the tail log")

    signals = resilience.PreemptSignals(
        action="drain in-flight requests and flush the delta-log shard",
        boundary="request boundary")
    signals.install()
    faults = None
    if cfg.inject:
        try:
            faults = resilience.ServeFaultPlan.parse(
                cfg.inject, part=cfg.serve_part, replica=cfg.serve_replica)
        except (ValueError, ConfigError) as ex:
            print(f"[config] {ex}", file=sys.stderr)
            core.close()
            return 2
        if faults.empty():
            faults = None
        else:
            log(f"[backend {core.backend_id}] armed serve fault(s): "
                f"{sorted(faults.faults)}")
    server = BackendServer(core, cfg.serve_backend_port, cfg.serve_addr,
                           log=log, faults=faults)
    resolver = PeerResolver(*router_endpoint(cfg))
    core.graph.resolver = resolver
    try:
        _register_with_router(cfg, server.port, log,
                              incarnation=mint_incarnation(
                                  cfg.serve_part, cfg.serve_replica))
    except (ConfigError, coord_mod.CoordTimeout) as ex:
        print(f"[config] {ex}", file=sys.stderr)
        server.drain(timeout_s=2.0)
        core.close()
        return 2

    stop_refresh = threading.Event()

    def _refresher():
        while not stop_refresh.wait(cfg.serve_refresh_s):
            try:
                core.refresh_some()
            except Exception as ex:             # noqa: BLE001 - keep serving
                log(f"[backend {core.backend_id}] background refresh "
                    f"failed: {type(ex).__name__}: {ex}")

    refresher = None
    if cfg.serve_refresh_s > 0:
        refresher = threading.Thread(target=_refresher,
                                     name="bnsgcn-backend-refresh",
                                     daemon=True)
        refresher.start()

    log(f"[backend {core.backend_id}] ready on port {server.port}: "
        f"{core.graph.n_own}/{core.graph.n_nodes} nodes owned, delta-log "
        f"shard {os.path.join(serve_dir, core._delta_log_name)}")
    if obs is not None:
        obs.emit("serve_header", port=server.port,
                 n_nodes=core.graph.n_nodes, n_own=core.graph.n_own,
                 part=core.part, replica=core.replica,
                 backend=core.backend_id, model=cfg.model, hops=core.hops,
                 max_batch=cfg.serve_max_batch,
                 replayed=counts["replayed"], folded=counts["folded"])
    try:
        while signals.requested is None:
            if server.shutdown_requested.wait(0.05):
                break
    finally:
        stop_refresh.set()
        if refresher is not None:
            # a rejoined backend can be mid-step refreshing its dirty
            # backlog: let the pass end before the process does
            refresher.join(timeout=120.0)
        server.drain()
        core.close()
        resolver.close()
        path = core.flush_delta_log(serve_dir)
        stats = core.snapshot_stats()
        log(f"[backend {core.backend_id}] drained: {stats['requests']} "
            f"request(s) (A {stats['tier_a']} / B {stats['tier_b']}), "
            f"{stats['deltas']} journaled delta(s) flushed to {path}, "
            f"{stats['dirty']} node(s) left dirty")
        if obs is not None:
            obs.emit("serve_drain", **{k: stats[k] for k in sorted(stats)})
            obs.close()
        signals.restore()
    if signals.requested is not None:
        log(f"[backend {core.backend_id}] {signals.requested} honored: "
            f"resumable delta-log shard flushed")
        return resilience.EXIT_PREEMPTED
    return 0


if __name__ == "__main__":
    sys.stdout.reconfigure(line_buffering=True)
    sys.exit(backend_main())
