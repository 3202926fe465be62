"""Online inference serving (counterpart of bnsgcn_tpu/serve.py): two-tier
node prediction over a trained model, on the card unless --device cpu.

A server loads a trained checkpoint through the integrity chain
(checkpoint.serving_checkpoint, a checkpoint of this port or of the JAX
package), precomputes the all-node embedding table through the eval
forward (evaluate.full_graph_embeddings; or cold-starts from an
--embeddings table, which --dump-embeddings writes), then answers over the
line-JSON TCP protocol of the rank coordinator (parallel/coord.py
LineJsonServer).

* **Tier A: table lookup.** A clean node's scores are its row of the
  table, the eval forward's own output.
* **Tier B: exact L-hop re-aggregation.** A node whose neighbourhood
  changed is scored on its L-hop in-closure (L = the graph layers) with the
  current global degrees as norms. A batcher thread coalesces concurrent
  requests into one step per (node, edge) bucket of a power-of-two ladder.
  On every device the step sums each row's terms in the order of its own
  in-edges (ops/spmm.FixedOrderSum) and runs the per-row dense work on
  fixed row tiles (models/gnn.by_rows), so a request scored alone is
  bitwise the same request in a full bucket, on a card too.

**Delta ingestion**: `add_edges` / `update_feat` mutate the serving graph
and mark the <= L-hop forward closure of the touched nodes dirty; a
background thread re-scores the dirty set through tier B and writes the
fresh rows back. SIGTERM/SIGINT (resilience.PreemptSignals) drains the
requests in flight, flushes every delta to a resumable JSONL log under
--serve-dir and exits 75; a relaunch replays it. `--serve-compact-deltas
N` folds the log into an integrity-headed snapshot every N deltas.

The continual trainer's handshake (the ops `export_deltas` and `promote`,
a promotion blob found at start-up) is not ported yet: the ops answer so,
and a promotion blob makes the server exit 2 by name.

The closure and the subgraph are built with numpy over CSR arrays (the
JAX package loops over nodes in Python); their output is array-equal to
the JAX functions'.

CLI:  python -m bnsgcn_tpu_torch.main serve --dataset ... --model ... \\
          --ckpt-path ... --serve-port 18120
      (or python -m bnsgcn_tpu_torch.serve ...)
Exit codes: 0 after the `shutdown` op, 75 after SIGTERM/SIGINT (deltas
flushed, resumable), 2 a config error or an unusable checkpoint, table or
snapshot.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Iterable, Optional

import numpy as np
import torch

from bnsgcn_tpu_torch import checkpoint as ckpt
from bnsgcn_tpu_torch import obs as obs_mod
from bnsgcn_tpu_torch import resilience
from bnsgcn_tpu_torch.config import Config, ConfigError, parse_config
from bnsgcn_tpu_torch.data.graph import Graph
from bnsgcn_tpu_torch.evaluate import _to_host, coo_env, full_graph_embeddings
from bnsgcn_tpu_torch.models.gnn import (GNN, ModelSpec, apply_model,
                                         spec_from_config)
from bnsgcn_tpu_torch.parallel import coord as coord_mod

DELTA_LOG = "delta_log.jsonl"
SNAPSHOT = "serve_snapshot.blob"


class HaloCacheMiss(RuntimeError):
    """A tier-B build touched a remote halo row that is not (or no longer)
    in the local cache. Raised only under the core lock by the partition
    backend's graph (serve_backend.PartGraph); the fetch itself happens
    outside the lock (graph.prefetch), so the caller un-claims, prefetches
    again and retries the build."""


# ----------------------------------------------------------------------------
# embedding-table artifact (--dump-embeddings / cold start)
# ----------------------------------------------------------------------------

def save_table(path: str, hidden, logits, meta: Optional[dict] = None):
    """Write the all-node embedding table (the final layer's input and the
    logits) under the checkpoint integrity header (checkpoint.write_blob):
    the JAX package's file, which either package loads."""
    ckpt.write_blob(path, {
        "hidden": np.asarray(hidden),
        "logits": np.asarray(logits),
        "meta": meta or {},
    })


def load_table(path: str) -> tuple[np.ndarray, np.ndarray, dict]:
    """(hidden, logits, meta); raises checkpoint.CheckpointCorrupt on a
    torn, zero-byte or checksum-failing file."""
    payload = ckpt.read_blob(path)
    return (np.asarray(payload["hidden"]), np.asarray(payload["logits"]),
            dict(payload.get("meta") or {}))


# ----------------------------------------------------------------------------
# the serving graph: base CSR + appended deltas
# ----------------------------------------------------------------------------

def _ranges(ptr: np.ndarray, nodes: np.ndarray) -> tuple[np.ndarray,
                                                          np.ndarray]:
    """(positions, lengths): the CSR positions [ptr[v], ptr[v + 1]) of
    every v in `nodes`, concatenated in that order, and each v's count."""
    starts = ptr[nodes]
    lens = ptr[nodes + 1] - starts
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64), lens
    shift = np.repeat(starts - (np.cumsum(lens) - lens), lens)
    return shift + np.arange(total, dtype=np.int64), lens


def _csr(key: np.ndarray, val: np.ndarray, n: int):
    """(val stably sorted by key as int64, ptr [n + 1]): a CSR index
    (torch's stable sort: the permutation numpy's stable argsort gives, in
    a fraction of its time on a large edge list)."""
    order = torch.sort(torch.from_numpy(np.asarray(key, np.int64)),
                       stable=True).indices.numpy()
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(key, minlength=n), out=ptr[1:])
    return np.asarray(val)[order].astype(np.int64), ptr


class DynamicGraph:
    """The server's mutable view of the canonical full graph: the base
    edges in two CSR indexes (in-neighbours for tier-B closures,
    out-neighbours for the dirty frontier) plus per-node append lists for
    ingested edges, and a mutable feature matrix. Degrees move with every
    delta, so tier-B norms are always the current global degrees."""

    def __init__(self, g: Graph):
        self.n_nodes = g.n_nodes
        self.feat = np.array(g.feat, dtype=np.float32, copy=True)
        self.in_deg = g.in_degrees().astype(np.int64).copy()
        self.out_deg = g.out_degrees().astype(np.int64).copy()
        src = np.asarray(g.src)
        dst = np.asarray(g.dst)
        self._in_src, self._in_ptr = _csr(dst, src, self.n_nodes)
        self._out_dst, self._out_ptr = _csr(src, dst, self.n_nodes)
        self._extra_in: dict[int, list[int]] = {}
        self._extra_out: dict[int, list[int]] = {}

    def _check(self, *nodes: int):
        for v in nodes:
            if not 0 <= v < self.n_nodes:
                raise ValueError(f"node {v} out of range [0, {self.n_nodes})")

    @property
    def n_feat(self) -> int:
        return self.feat.shape[1]

    def feat_rows(self, ids: np.ndarray) -> np.ndarray:
        return self.feat[ids]

    def in_deg_of(self, ids: np.ndarray) -> np.ndarray:
        return self.in_deg[ids]

    def out_deg_of(self, ids: np.ndarray) -> np.ndarray:
        return self.out_deg[ids]

    def prefetch(self, targets: Iterable[int], hops: int):
        """Every row is local: nothing to fetch."""

    def in_nbrs(self, v: int) -> list[int]:
        base = self._in_src[self._in_ptr[v]:self._in_ptr[v + 1]]
        extra = self._extra_in.get(v)
        return base.tolist() + extra if extra else base.tolist()

    def out_nbrs(self, v: int) -> list[int]:
        base = self._out_dst[self._out_ptr[v]:self._out_ptr[v + 1]]
        extra = self._extra_out.get(v)
        return base.tolist() + extra if extra else base.tolist()

    def add_edges(self, edges: Iterable[tuple[int, int]]) -> set[int]:
        """Append directed edges (u -> v); returns the touched nodes the
        dirty marking expands from (u too: its out-degree moves every
        out-neighbour's GCN out-norm)."""
        touched: set[int] = set()
        for u, v in edges:
            u, v = int(u), int(v)
            self._check(u, v)
            self._extra_out.setdefault(u, []).append(v)
            self._extra_in.setdefault(v, []).append(u)
            self.out_deg[u] += 1
            self.in_deg[v] += 1
            touched.add(u)
            touched.add(v)
        return touched

    def set_feat(self, v: int, vec) -> set[int]:
        self._check(int(v))
        vec = np.asarray(vec, dtype=np.float32)
        if vec.shape != self.feat[int(v)].shape:
            raise ValueError(f"feature length {vec.shape} != "
                             f"{self.feat[int(v)].shape}")
        self.feat[int(v)] = vec
        return {int(v)}

    def _nbrs_of(self, nodes: np.ndarray, inward: bool) -> np.ndarray:
        """Every neighbour (repeats kept) of `nodes`: in- or out-."""
        ptr, idx, extra = ((self._in_ptr, self._in_src, self._extra_in)
                           if inward else
                           (self._out_ptr, self._out_dst, self._extra_out))
        got = [idx[_ranges(ptr, nodes)[0]]]
        if extra:
            keys = np.fromiter(extra, np.int64, len(extra))
            for v in keys[np.isin(keys, nodes)].tolist():
                got.append(np.asarray(extra[v], np.int64))
        return np.concatenate(got) if len(got) > 1 else got[0]

    def _bfs(self, seeds: Iterable[int], hops: int, inward: bool
             ) -> np.ndarray:
        """[n_nodes] int64: each node's hop distance from `seeds` along
        in-edges (inward) or out-edges, -1 beyond `hops`."""
        depth = np.full(self.n_nodes, -1, np.int64)
        frontier = np.unique(np.asarray(list(seeds), np.int64))
        depth[frontier] = 0
        for d in range(1, hops + 1):
            if frontier.size == 0:
                break
            hit = np.zeros(self.n_nodes, bool)
            hit[self._nbrs_of(frontier, inward)] = True
            frontier = np.nonzero(hit & (depth < 0))[0]
            depth[frontier] = d
        return depth

    def forward_closure(self, seeds: Iterable[int], hops: int) -> set[int]:
        """Nodes within `hops` out-edge steps of `seeds` (seeds included):
        the nodes whose final-layer output can depend on a change at the
        seeds, the <= L-hop dirty frontier."""
        return set(np.nonzero(self._bfs(seeds, hops, False) >= 0)[0]
                   .tolist())

    def in_closure_depths(self, targets: Iterable[int], hops: int
                          ) -> np.ndarray:
        """in_closure as an [n_nodes] array of depths (-1 outside)."""
        return self._bfs(targets, hops, True)

    def in_closure(self, targets: Iterable[int], hops: int) -> dict[int, int]:
        """{node: depth} of the `hops`-hop in-neighbourhood closure of
        `targets` (depth 0): the exact computation subgraph of an L-layer
        forward at the targets."""
        depth = self.in_closure_depths(targets, hops)
        nodes = np.nonzero(depth >= 0)[0]
        return dict(zip(nodes.tolist(), depth[nodes].tolist()))

    def in_edges_of(self, nodes: np.ndarray) -> tuple[np.ndarray,
                                                      np.ndarray]:
        """(src, dst) global ids of every in-edge of `nodes` (ascending),
        grouped by destination in `nodes`' order, each destination's
        in-edges in in_nbrs order (the base CSR's, then the appended)."""
        if nodes.size == self.n_nodes:          # every node: the whole CSR
            src, lens = self._in_src, np.diff(self._in_ptr)
        else:
            pos, lens = _ranges(self._in_ptr, nodes)
            src = self._in_src[pos]
        dst = np.repeat(nodes, lens)
        if self._extra_in:
            keys = np.fromiter(self._extra_in, np.int64, len(self._extra_in))
            keys = np.sort(keys[np.isin(keys, nodes)])
            if keys.size:
                ends = np.cumsum(lens)[np.searchsorted(nodes, keys)]
                ex = [self._extra_in[int(v)] for v in keys]
                at = np.repeat(ends, [len(x) for x in ex])
                vals = np.concatenate([np.asarray(x, np.int64) for x in ex])
                src = np.insert(src, at, vals)
                dst = np.insert(dst, at, np.repeat(keys, [len(x)
                                                          for x in ex]))
        return src, dst

    # -- compaction: the mutated state as a msgpack-able tree --

    def mutation_state(self) -> dict:
        """What a relaunch needs to rebuild this graph's mutations over the
        base CSR: the current features and degrees, and the appended edges
        in per-node insertion order (so in_nbrs order, and with it tier B's
        summation order, survives the round trip)."""
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
        """Inverse of mutation_state(), over a freshly built base graph."""
        self.feat = np.array(state["feat"], dtype=np.float32, copy=True)
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
# tier-B engine: bucketed fresh-subgraph scoring
# ----------------------------------------------------------------------------

def _bucket(n: int, floor: int) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


class SubgraphScorer:
    """Exact L-hop re-scoring: the closure subgraph padded to a (node,
    edge) bucket of a power-of-two ladder (padded edges dst == nb, src ==
    0; padded rows unit norms), then the eval forward on the model's
    device with the fixed-order sums and ROW_TILE-row tiles. `last` holds
    the latest step's seconds on the host clock (build, transfer of the
    arrays to the device, forward with the copy back) and its sizes."""

    NODE_FLOOR = 32
    EDGE_FLOOR = 128
    ROW_TILE = 1024

    def __init__(self, spec: ModelSpec):
        self.spec = spec
        self.hops = spec.n_graph_layers
        self.last: dict = {}

    def build_arrays(self, graph: DynamicGraph, targets: list[int]):
        """(nodes, feat, src, dst, in_norm, out_norm): the padded closure
        subgraph of `targets`, array-equal to the JAX function's. Edges
        are grouped by destination in ascending global id, each
        destination's in-edges in in_nbrs order, so a node's summation
        order, and its score, does not depend on the other targets."""
        t0 = time.perf_counter()
        depth = graph.in_closure_depths(targets, self.hops)
        nodes = np.nonzero(depth >= 0)[0]
        local = np.full(graph.n_nodes, -1, np.int64)
        local[nodes] = np.arange(nodes.size)
        inner = nodes[depth[nodes] <= self.hops - 1]
        src_g, dst_g = graph.in_edges_of(inner)
        n_e = src_g.size
        nb = _bucket(nodes.size, self.NODE_FLOOR)
        eb = _bucket(max(n_e, 1), self.EDGE_FLOOR)
        feat = np.zeros((nb, graph.n_feat), dtype=np.float32)
        feat[:nodes.size] = graph.feat_rows(nodes)
        src = np.zeros(eb, dtype=np.int32)
        dst = np.full(eb, nb, dtype=np.int32)          # trash row
        whole = nodes.size == graph.n_nodes            # local ids are global
        src[:n_e] = src_g if whole else local[src_g]
        dst[:n_e] = dst_g if whole else local[dst_g]
        in_norm = np.ones(nb, dtype=np.float32)
        out_norm = np.ones(nb, dtype=np.float32)
        ind = graph.in_deg_of(nodes).astype(np.float32)
        outd = graph.out_deg_of(nodes).astype(np.float32)
        if self.spec.model == "gcn":
            in_norm[:nodes.size] = np.sqrt(ind)
            out_norm[:nodes.size] = np.sqrt(outd)
        else:
            in_norm[:nodes.size] = ind
            out_norm[:nodes.size] = outd               # unused by SAGE/GAT
        self.last = {"build_s": time.perf_counter() - t0,
                     "nodes": int(nodes.size), "edges": int(n_e),
                     "node_bucket": nb, "edge_bucket": eb}
        return nodes, feat, src, dst, in_norm, out_norm

    def run_arrays(self, model: GNN, targets: list[int], arrays
                   ) -> dict[int, tuple[np.ndarray, np.ndarray]]:
        """Score pre-built subgraph arrays on the model's device (the
        caller may have built them under its graph lock; this needs
        none): {target: (hidden row, logits row)}."""
        nodes, feat, src, dst, in_norm, out_norm = arrays
        dev = next(model.parameters()).device
        t0 = time.perf_counter()
        feat_t, src_t, dst_t, in_t, out_t = (
            torch.from_numpy(np.asarray(a)).to(dev)
            for a in (feat, src, dst, in_norm, out_norm))
        t1 = time.perf_counter()
        with torch.no_grad():
            env = coo_env(src_t.long(), dst_t.long(), feat.shape[0], in_t,
                          out_t, row_tile=self.ROW_TILE)
            logits, hidden = apply_model(model, feat_t, env,
                                         return_hidden=True)
            hidden, logits = _to_host(hidden), _to_host(logits)
        self.last = dict(self.last, transfer_s=t1 - t0,
                         forward_s=time.perf_counter() - t1)
        at = np.searchsorted(nodes, np.asarray(targets, np.int64))
        return {int(t): (hidden[i], logits[i])
                for t, i in zip(targets, at.tolist())}

    def score(self, graph: DynamicGraph, model: GNN, targets: list[int]
              ) -> dict[int, tuple[np.ndarray, np.ndarray]]:
        """{node: (hidden row, logits row)}, exact under the graph's
        current edges, features and degrees."""
        return self.run_arrays(model, targets,
                               self.build_arrays(graph, targets))


class _TierBBatcher:
    """Coalesces concurrent tier-B requests into one bucket step: handler
    threads enqueue and wait; one worker thread drains up to `max_batch`
    targets per step after a short accumulation window."""

    def __init__(self, score_fn, max_batch: int, window_s: float = 0.002):
        self._score_fn = score_fn
        self.max_batch = max(int(max_batch), 1)
        self.window_s = window_s
        self._pending: list[tuple[int, dict, threading.Event]] = []  # guarded-by: self._cv
        self._cv = threading.Condition()
        self._stop = False      # guarded-by: self._cv
        self.batches = 0
        self.batched_requests = 0
        self._thread = threading.Thread(target=self._run,
                                        name="bnsgcn-serve-batcher",
                                        daemon=True)
        self._thread.start()

    def submit(self, node: int, timeout_s: float = 120.0):
        box: dict = {}
        ev = threading.Event()
        with self._cv:
            if self._stop:
                raise RuntimeError("server draining")
            self._pending.append((int(node), box, ev))
            self._cv.notify()
        if not ev.wait(timeout_s):
            raise TimeoutError(f"tier-B scoring of node {node} timed out")
        if "err" in box:
            raise RuntimeError(box["err"])
        return box["r"]

    def _run(self):
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait(0.1)
                if self._stop and not self._pending:
                    return
            if self.window_s > 0:
                time.sleep(self.window_s)       # let concurrent arrivals pool
            with self._cv:
                batch = self._pending[:self.max_batch]
                del self._pending[:len(batch)]
            if not batch:
                continue
            targets = sorted({n for n, _, _ in batch})
            try:
                results = self._score_fn(targets)
                self.batches += 1
                self.batched_requests += len(batch)
                for node, box, ev in batch:
                    box["r"] = results[node]
                    ev.set()
            except Exception as ex:             # noqa: BLE001 - answer, don't die
                for _, box, ev in batch:
                    box["err"] = f"{type(ex).__name__}: {ex}"
                    ev.set()

    def drain(self, timeout_s: float = 30.0):
        """Stop accepting, finish what is queued, join the worker."""
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=timeout_s)


# ----------------------------------------------------------------------------
# the serving core: table + dirty frontier + delta ingestion
# ----------------------------------------------------------------------------

class ServeCore:
    """The protocol-independent serving state machine (ServeServer is a
    thin dispatcher over it; tests drive it directly): the embedding and
    score table, the dirty set, the ingested-delta journal and the tier-B
    batcher, over `model` (a GNN in eval use on its device). All public
    methods are thread-safe."""

    def __init__(self, cfg: Config, spec: ModelSpec, graph: DynamicGraph,
                 model: GNN, hidden: np.ndarray, logits: np.ndarray,
                 log=print, obs: Optional[obs_mod.Obs] = None,
                 multilabel: bool = False):
        self.cfg = cfg
        self.spec = spec
        self.graph = graph
        self._check_table(hidden, logits)
        self.model = model
        self.hidden = hidden
        self.logits = logits
        self.hops = spec.n_graph_layers
        self.multilabel = multilabel
        self.log = log
        # registry-backed metrics (obs.py): per-tier latency histograms,
        # refresh lag, queue depth; `stats` and `metrics` serve them
        self.obs = obs
        self.registry = obs.registry if obs is not None else obs_mod.Registry()
        self._lat = {t: self.registry.histogram(f"serve/latency_ms/{t}")
                     for t in ("A", "B")}
        self._lag_hist = self.registry.histogram("serve/refresh_lag_s")
        # node -> first dirty ts        # guarded-by: self._lock
        self._dirty_since: dict[int, float] = {}
        self.scorer = SubgraphScorer(spec)
        self.dirty: set[int] = set()        # guarded-by: self._lock
        # claimed by an in-flight refresh step: still stale for tier
        # routing, never picked twice
        self._refreshing: set[int] = set()  # guarded-by: self._lock
        self.deltas: list[dict] = []        # guarded-by: self._lock
        self._lock = threading.RLock()
        # guarded-by: self._lock
        self.stats = {"requests": 0, "tier_a": 0, "tier_b": 0,
                      "refreshed_nodes": 0, "deltas": 0}
        # delta-log compaction (--serve-compact-deltas): the directory (set
        # by serve_main; "" disables), the deltas folded into the snapshot,
        # an overlap guard
        self.serve_dir = ""
        # the core's own file names (a partition backend shards them per
        # part and replica)
        self._delta_log_name = DELTA_LOG
        self._snapshot_name = SNAPSHOT
        self._folded = 0            # guarded-by: self._lock
        self._compacting = False    # guarded-by: self._lock
        self.stats["exported_to"] = 0
        self.stats["promotions"] = 0
        self.batcher = _TierBBatcher(self._score_batch, cfg.serve_max_batch)

    def _check_table(self, hidden: np.ndarray, logits: np.ndarray):
        if (hidden.shape[0] != self.graph.n_nodes
                or logits.shape[0] != self.graph.n_nodes):
            raise ConfigError(
                f"embedding table rows ({hidden.shape[0]}/{logits.shape[0]}) "
                f"!= graph nodes ({self.graph.n_nodes}) — wrong --embeddings "
                f"artifact for this dataset?")

    def _row(self, node: int) -> int:
        """The table row of a global node id (the identity here; a
        partition backend maps it to its shard's row)."""
        return node

    # -- scoring --

    def _score_batch(self, targets: list[int]):
        """One bucket step for `targets`: claim the dirty ones, build the
        subgraph arrays under the lock (a delta landing mid-build cannot
        tear them), run the step outside it, then write the fresh rows
        back for every claimed node not re-dirtied meanwhile. Clean
        targets are never written back: their rows stay the table's.

        A partition backend's graph fetches the remote rows the closure
        needs outside the lock (graph.prefetch: a peer round trip never
        stalls concurrent predicts), and its locked build reads the cache
        alone; a delta that drops a cached row between the two raises
        HaloCacheMiss, and the claim, prefetch and build are tried again,
        four times in all. On a single-host graph prefetch does nothing."""
        for attempt in range(4):
            self.graph.prefetch(targets, self.hops)
            with self._lock:
                was_dirty = [t for t in targets if t in self.dirty]
                self.dirty.difference_update(was_dirty)
                self._refreshing.update(was_dirty)
                try:
                    arrays = self.scorer.build_arrays(self.graph, targets)
                except Exception as ex:
                    self._refreshing.difference_update(was_dirty)
                    self.dirty.update(was_dirty)
                    if isinstance(ex, HaloCacheMiss) and attempt < 3:
                        continue
                    raise
            break
        try:
            results = self.scorer.run_arrays(self.model, targets, arrays)
        except Exception:
            with self._lock:                # a failed step re-queues its claim
                self._refreshing.difference_update(was_dirty)
                self.dirty.update(was_dirty)
            raise
        with self._lock:
            now = time.monotonic()
            self._refreshing.difference_update(was_dirty)
            for t in was_dirty:
                if t in self.dirty:         # re-dirtied mid-step: stale, skip
                    continue
                hid, lg = results[t]
                self.hidden[self._row(t)] = hid
                self.logits[self._row(t)] = lg
                self.stats["refreshed_nodes"] += 1
                since = self._dirty_since.pop(t, None)
                if since is not None:
                    self._lag_hist.observe(now - since)
        return results

    def predict(self, node: int, tier: Optional[str] = None) -> dict:
        t_in = time.perf_counter()
        node = int(node)
        self.graph._check(node)
        with self._lock:
            self.stats["requests"] += 1
            is_dirty = node in self.dirty or node in self._refreshing
        if tier == "A" or (tier is None and not is_dirty):
            with self._lock:
                self.stats["tier_a"] += 1
                scores = self.logits[self._row(node)].copy()
            out = {"ok": True, "node": node, "tier": "A",
                   "scores": scores.tolist()}
            if is_dirty:
                out["stale"] = True     # forced tier A on a dirty node
        else:
            _, lg = self.batcher.submit(node)
            with self._lock:
                self.stats["tier_b"] += 1
            out = {"ok": True, "node": node, "tier": "B",
                   "scores": np.asarray(lg).tolist()}
        if not self.multilabel:
            out["pred"] = int(np.argmax(out["scores"]))
        self._lat[out["tier"]].observe((time.perf_counter() - t_in) * 1e3)
        return out

    def predict_many(self, nodes, tier: Optional[str] = None) -> list[dict]:
        """Batch predict: the request's tier-B set runs as coalesced bucket
        steps directly; the step time is attributed to the tier-B nodes
        alone."""
        t_in = time.perf_counter()
        nodes = [int(n) for n in nodes]
        for n in nodes:
            self.graph._check(n)
        with self._lock:
            self.stats["requests"] += len(nodes)
            stale = {n for n in nodes
                     if n in self.dirty or n in self._refreshing}
        fresh = sorted({n for n in nodes if tier == "B" or n in stale})
        scored: dict[int, tuple] = {}
        t_b0 = time.perf_counter()
        for i in range(0, len(fresh), self.cfg.serve_max_batch):
            scored.update(self._score_batch(
                fresh[i:i + self.cfg.serve_max_batch]))
        t_b = time.perf_counter() - t_b0
        n_b = sum(1 for n in nodes if n in scored)
        n_a = len(nodes) - n_b
        per_b_ms = t_b * 1e3 / max(n_b, 1)
        per_a_ms = ((time.perf_counter() - t_in - t_b) * 1e3 / max(n_a, 1))
        out = []
        for n in nodes:
            if n in scored:
                r = {"ok": True, "node": n, "tier": "B",
                     "scores": np.asarray(scored[n][1]).tolist()}
                with self._lock:
                    self.stats["tier_b"] += 1
            else:
                with self._lock:
                    self.stats["tier_a"] += 1
                    scores = self.logits[self._row(n)].copy()
                r = {"ok": True, "node": n, "tier": "A",
                     "scores": scores.tolist()}
                if n in stale:
                    r["stale"] = True       # forced tier A on a dirty node
            if not self.multilabel:
                r["pred"] = int(np.argmax(r["scores"]))
            self._lat[r["tier"]].observe(per_b_ms if r["tier"] == "B"
                                         else per_a_ms)
            out.append(r)
        return out

    # -- delta ingestion --

    def _mark_dirty_stamps_locked(self, new_dirty: set):
        """First-dirty timestamps for the refresh lag (a node already
        waiting keeps its first stamp)."""
        now = time.monotonic()
        for n in new_dirty:
            self._dirty_since.setdefault(n, now)

    def _ingest(self, touched: set, entry: dict) -> dict:
        """Under the lock: mark the forward closure of `touched` dirty and
        journal `entry`."""
        new_dirty = self.graph.forward_closure(touched, self.hops)
        added = new_dirty - self.dirty
        self.dirty |= new_dirty
        self._mark_dirty_stamps_locked(new_dirty)
        self.deltas.append(entry)
        self.stats["deltas"] += 1
        return {"ok": True, "dirty_new": len(added),
                "dirty_total": len(self.dirty)}

    def add_edges(self, edges: list) -> dict:
        pairs = [(int(u), int(v)) for u, v in edges]
        with self._lock:
            touched = self.graph.add_edges(pairs)
            out = self._ingest(touched, {"op": "add_edges", "edges":
                                         [[u, v] for u, v in pairs]})
        if self.obs is not None:
            # outside the lock: a stalled log write never blocks predicts
            self.obs.emit("delta", op="add_edges", edges=len(pairs),
                          dirty_new=out["dirty_new"],
                          dirty_total=out["dirty_total"])
        return out

    def update_feat(self, node: int, vec) -> dict:
        with self._lock:
            touched = self.graph.set_feat(int(node), vec)
            out = self._ingest(touched, {
                "op": "update_feat", "node": int(node),
                "feat": np.asarray(vec, dtype=np.float32).tolist()})
        if self.obs is not None:
            self.obs.emit("delta", op="update_feat", node=int(node),
                          dirty_new=out["dirty_new"],
                          dirty_total=out["dirty_total"])
        return out

    # -- incremental refresh --

    def refresh_some(self, limit: Optional[int] = None) -> int:
        """Re-score up to `limit` dirty nodes (ascending id) in one bucket
        step and fold the fresh rows into the table; how many were
        picked."""
        limit = limit if limit is not None else self.cfg.serve_max_batch
        with self._lock:
            pick = sorted(self.dirty)[:max(int(limit), 1)]
        if not pick:
            return 0
        self._score_batch(pick)
        return len(pick)

    def flush(self, timeout_s: float = 600.0) -> int:
        """Drain the whole dirty set synchronously (claims held by a
        concurrent step too); returns the nodes this call picked."""
        total = 0
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            total += self.refresh_some()
            with self._lock:
                if not self.dirty and not self._refreshing:
                    return total
                busy = not self.dirty       # only claims in flight elsewhere
            if busy:
                time.sleep(0.005)
        with self._lock:
            n = len(self.dirty)
        raise TimeoutError(f"flush: {n} nodes still dirty")

    # -- resumable delta log --

    def flush_delta_log(self, serve_dir: str) -> str:
        """Atomically persist every un-compacted delta as JSONL."""
        os.makedirs(serve_dir, exist_ok=True)
        path = os.path.join(serve_dir, self._delta_log_name)
        with self._lock:
            lines = [json.dumps(d) for d in self.deltas]
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path

    def _apply_logged(self, d: dict):
        """Re-ingest one logged delta (a partition backend extends the op
        set with its fan-out entries)."""
        if d["op"] == "add_edges":
            self.add_edges(d["edges"])
        elif d["op"] == "update_feat":
            self.update_feat(d["node"], d["feat"])

    def replay_delta_log(self, serve_dir: str) -> int:
        """Re-ingest a previous run's flushed deltas (their dirty frontier
        too); how many."""
        path = os.path.join(serve_dir, self._delta_log_name)
        if not os.path.exists(path):
            return 0
        n = 0
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                self._apply_logged(json.loads(line))
                n += 1
        return n

    # -- delta-log compaction (--serve-compact-deltas) --

    def maybe_compact(self):
        """Fold the log into a snapshot once it holds
        --serve-compact-deltas deltas (the ingesting client pays the
        write; predicts go on: the blob is written outside the lock)."""
        if self.cfg.serve_compact_deltas <= 0 or not self.serve_dir:
            return
        with self._lock:
            if (self._compacting
                    or len(self.deltas) < self.cfg.serve_compact_deltas):
                return
            self._compacting = True
        try:
            self.compact(self.serve_dir)
        finally:
            with self._lock:
                self._compacting = False

    def compact(self, serve_dir: str) -> dict:
        """Snapshot the mutated graph, the tables and the dirty frontier
        (write_blob) and cut the log to the deltas after the snapshot
        point."""
        os.makedirs(serve_dir, exist_ok=True)
        with self._lock:
            k = len(self.deltas)
            payload = self.graph.mutation_state()
            payload["hidden"] = self.hidden.copy()
            payload["logits"] = self.logits.copy()
            payload["dirty"] = np.asarray(
                sorted(self.dirty | self._refreshing), dtype=np.int64)
            payload["n_deltas"] = int(self._folded + k)
        ckpt.write_blob(os.path.join(serve_dir, self._snapshot_name), payload)
        with self._lock:
            # deltas that landed while the blob was written stay in the tail
            del self.deltas[:k]
            self._folded += k
            tail = len(self.deltas)
        self.flush_delta_log(serve_dir)
        out = {"folded": k, "tail": tail}
        if self.obs is not None:
            self.obs.emit("serve_compact", **out)
        self.log(f"[serve] compacted delta log: {k} delta(s) folded into "
                 f"{self._snapshot_name}, {tail} left in the tail")
        return out

    def load_serving_state(self, serve_dir: str) -> dict:
        """Relaunch: adopt the compaction snapshot if there is one, then
        replay the tail log. A corrupt snapshot raises CheckpointCorrupt:
        the log is only a tail, so skipping it would resume from a hole in
        history."""
        snap = os.path.join(serve_dir, self._snapshot_name)
        folded = 0
        if os.path.exists(snap):
            payload = ckpt.read_blob(snap)
            hidden = np.array(payload["hidden"], copy=True)
            logits = np.array(payload["logits"], copy=True)
            self.graph.restore_mutations(payload)
            self._check_table(hidden, logits)
            folded = int(payload["n_deltas"])
            with self._lock:
                self.hidden = hidden
                self.logits = logits
                dirty = set(np.asarray(payload["dirty"]).tolist())
                self.dirty |= dirty
                self._mark_dirty_stamps_locked(dirty)
                self._folded = folded
                self.stats["deltas"] += folded
            self.log(f"[serve] snapshot {self._snapshot_name}: "
                     f"{folded} folded delta(s), {len(dirty)} node(s) dirty")
        return {"folded": folded,
                "replayed": self.replay_delta_log(serve_dir)}

    def snapshot_stats(self) -> dict:
        with self._lock:
            out = dict(self.stats)
            out["dirty"] = len(self.dirty) + len(self._refreshing)
            out["n_nodes"] = self.graph.n_nodes
            out["batches"] = self.batcher.batches
            out["batched_requests"] = self.batcher.batched_requests
            now = time.monotonic()
            out["refresh_lag_s"] = round(
                now - min(self._dirty_since.values()), 6) \
                if self._dirty_since else 0.0
            out["queue_depth"] = len(self.batcher._pending)
        for t in ("A", "B"):
            snap = self._lat[t].snapshot()
            out[f"tier_{t.lower()}_p50_ms"] = snap["p50"]
            out[f"tier_{t.lower()}_p99_ms"] = snap["p99"]
        lag = self._lag_hist.snapshot()
        out["refresh_lag_p50_s"] = lag["p50"]
        out["refresh_lag_p99_s"] = lag["p99"]
        self.registry.gauge("serve/queue_depth").set(out["queue_depth"])
        self.registry.gauge("serve/stalest_dirty_age_s").set(
            out["refresh_lag_s"])
        self.registry.gauge("serve/dirty").set(out["dirty"])
        return out

    def close(self):
        self.batcher.drain()


# ----------------------------------------------------------------------------
# TCP front end (parallel/coord.py's line-JSON transport)
# ----------------------------------------------------------------------------

# the continual trainer's handshake (bnsgcn_tpu/serve.py:885-1022)
NOT_PORTED_OPS = ("export_deltas", "promote")


class ServeServer:
    """A line-JSON dispatcher over a ServeCore on the coordinator's
    LineJsonServer (one JSON request line, one JSON response line)."""

    def __init__(self, core: ServeCore, port: int, addr: str = "",
                 log=print):
        self.core = core
        self.log = log
        self._inflight = 0      # guarded-by: self._lock
        self._draining = False  # guarded-by: self._lock
        self._lock = threading.Lock()
        self.shutdown_requested = threading.Event()
        self.server = coord_mod.LineJsonServer(port, self._handle,
                                               addr=addr).start()

    @property
    def port(self) -> int:
        return self.server.port

    def _handle(self, req: dict) -> dict:
        op = req.get("op")
        with self._lock:
            if self._draining and op not in ("ping", "stats", "metrics"):
                return {"ok": False, "err": "draining"}
            self._inflight += 1
        try:
            return self._dispatch(op, req)
        except (KeyError, ValueError, TypeError) as ex:
            return {"ok": False, "err": f"{type(ex).__name__}: {ex}"}
        finally:
            with self._lock:
                self._inflight -= 1

    def _dispatch(self, op: Optional[str], req: dict) -> dict:
        if op == "ping":
            return {"ok": True}
        if op == "predict":
            return self.core.predict(req["node"], tier=req.get("tier"))
        if op == "predict_many":
            return {"ok": True,
                    "results": self.core.predict_many(
                        req["nodes"], tier=req.get("tier"))}
        if op == "add_edges":
            out = self.core.add_edges(req["edges"])
            self.core.maybe_compact()
            return out
        if op == "update_feat":
            out = self.core.update_feat(req["node"], req["feat"])
            self.core.maybe_compact()
            return out
        if op in NOT_PORTED_OPS:
            return {"ok": False, "err": f"{op} is not ported yet"}
        if op == "dirty":
            # in-flight claims count: a claimed node is still stale
            with self.core._lock:
                n = len(self.core.dirty) + len(self.core._refreshing)
            return {"ok": True, "count": n}
        if op == "flush":
            return {"ok": True, "refreshed": self.core.flush()}
        if op == "stats":
            return {"ok": True, **self.core.snapshot_stats()}
        if op == "metrics":
            self.core.snapshot_stats()      # refresh the gauges first
            return {"ok": True, "metrics": self.core.registry.snapshot()}
        if op == "shutdown":
            self.shutdown_requested.set()
            return {"ok": True}
        return {"ok": False, "err": f"unknown op {op!r}"}

    def drain(self, timeout_s: float = 30.0):
        """Stop taking work, wait for the handlers in flight, stop the
        listener."""
        with self._lock:
            self._draining = True
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._inflight == 0:
                    break
            time.sleep(0.01)
        self.server.stop()


def request(port: int, payload: dict, addr: str = "127.0.0.1",
            timeout_s: float = 30.0) -> dict:
    """One client round trip against a running server, at most once (a
    sent request is never re-sent: add_edges and flush are not
    idempotent)."""
    return coord_mod.rpc_line_json(addr or "127.0.0.1", port, payload,
                                   time.monotonic() + timeout_s,
                                   what="serve server", retry_sent=False)


# ----------------------------------------------------------------------------
# construction + CLI
# ----------------------------------------------------------------------------

def build_core(cfg: Config, g: Graph, model: GNN, log=print,
               hidden: Optional[np.ndarray] = None,
               logits: Optional[np.ndarray] = None,
               obs: Optional[obs_mod.Obs] = None) -> ServeCore:
    """A ServeCore over graph `g` with `model` (on its device) and a
    precomputed (or supplied) table."""
    cfg = cfg.replace(n_feat=g.n_feat, n_class=g.n_class, n_train=g.n_train)
    if hidden is None or logits is None:
        t0 = time.perf_counter()
        hidden, logits = full_graph_embeddings(
            model, g, next(model.parameters()).device)
        log(f"[serve] precomputed {hidden.shape[0]}-node embedding table "
            f"(hidden {hidden.shape[1]}, classes {logits.shape[1]}) in "
            f"{time.perf_counter() - t0:.1f}s")
    return ServeCore(cfg, model.spec, DynamicGraph(g), model,
                     np.array(hidden, copy=True), np.array(logits, copy=True),
                     log=log, obs=obs, multilabel=g.multilabel)


def load_model(cfg: Config, device, log=print) -> tuple:
    """(model on `device`, payload, path) through the integrity chain
    (checkpoint.serving_checkpoint): the parameters of a checkpoint of
    this port or of the JAX package (trainer.params_from_jax), its
    SyncBatchNorm statistics too. cfg carries the graph's n_feat and
    n_class."""
    from bnsgcn_tpu_torch.trainer import params_from_jax
    found = ckpt.serving_checkpoint(cfg, log=log)
    if found is None:
        raise ConfigError(
            f"no loadable checkpoint for graph {cfg.graph_name!r} rate "
            f"{cfg.sampling_rate:.2f} under {cfg.ckpt_path} — train first, "
            f"or point --ckpt-path at a finished run")
    path, payload = found
    spec = spec_from_config(cfg)
    model = GNN(spec, int(payload.get("seed", 0)))
    model.load_state_dict(params_from_jax(payload["params"], spec,
                                          payload.get("bn_state")))
    model = model.to(device).eval()
    log(f"[serve] checkpoint {path}: epoch {int(payload.get('epoch', -1))}, "
        f"best_acc {float(payload.get('best_acc', 0.0)):.4f}")
    return model, payload, path


def serve_main(argv=None) -> int:
    """`python -m bnsgcn_tpu_torch.main serve ...` / `python -m
    bnsgcn_tpu_torch.serve ...`. Exit codes: 0 after the `shutdown` op, 75
    after SIGTERM/SIGINT (drained, delta log flushed), 2 a config error or
    an unusable checkpoint, table or snapshot."""
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
    serve_dir = cfg.serve_dir or os.path.join(cfg.ckpt_path, "serve")
    promo = ckpt.promotion_path(serve_dir)
    if os.path.exists(promo):
        print(f"[config] promotion blob {promo} found: adopting a continual "
              f"training promotion is not ported yet; move it away to "
              f"serve the checkpoint", file=sys.stderr)
        return 2
    obs = obs_mod.make_obs(cfg, rank=0, log=log)
    try:
        device = resolve_device(cfg.device)
        set_float32_math()
        g, _, _ = load_data(cfg)
        cfg = cfg.replace(n_feat=g.n_feat, n_class=g.n_class,
                          n_train=g.n_train)
        model, _, _ = load_model(cfg, device, log)
        hidden = logits = None
        if cfg.embeddings:
            hidden, logits, meta = load_table(cfg.embeddings)
            log(f"[serve] cold start from embedding table {cfg.embeddings} "
                f"({hidden.shape[0]} nodes"
                + (f", exported at epoch {meta.get('epoch')}" if meta else "")
                + ")")
        core = build_core(cfg, g, model, log=log, hidden=hidden,
                          logits=logits, obs=obs)
    except ConfigError as ex:
        print(f"[config] {ex}", file=sys.stderr)
        return 2
    except ckpt.CheckpointCorrupt as ex:
        print(f"[config] embedding artifact unusable: {ex}", file=sys.stderr)
        return 2

    core.serve_dir = serve_dir
    try:
        counts = core.load_serving_state(serve_dir)
    except ckpt.CheckpointCorrupt as ex:
        print(f"[config] serving snapshot unusable: {ex} — the delta log is "
              f"only a tail past a snapshot; refusing to resume from a hole "
              f"in history", file=sys.stderr)
        return 2
    replayed = counts["replayed"]
    if replayed or counts["folded"]:
        log(f"[serve] resumed: {counts['folded']} delta(s) from the "
            f"snapshot + {replayed} replayed from the tail log "
            f"({len(core.dirty)} nodes dirty, refreshing in background)")

    signals = resilience.PreemptSignals(
        action="drain in-flight requests and flush the delta log",
        boundary="request boundary")
    signals.install()
    server = ServeServer(core, cfg.serve_port, cfg.serve_addr, log=log)
    stop_refresh = threading.Event()

    def _refresher():
        while not stop_refresh.wait(cfg.serve_refresh_s):
            try:
                core.refresh_some()
            except Exception as ex:             # noqa: BLE001 - keep serving
                log(f"[serve] background refresh failed: "
                    f"{type(ex).__name__}: {ex}")

    refresher = None
    if cfg.serve_refresh_s > 0:
        refresher = threading.Thread(target=_refresher,
                                     name="bnsgcn-serve-refresh", daemon=True)
        refresher.start()

    log(f"[serve] ready on port {server.port}: tier A table lookup + tier B "
        f"{core.hops}-hop re-aggregation (max batch {cfg.serve_max_batch}), "
        f"delta log at {os.path.join(serve_dir, DELTA_LOG)}")
    if obs is not None:
        obs.emit("serve_header", port=server.port, n_nodes=core.graph.n_nodes,
                 model=cfg.model, hops=core.hops,
                 max_batch=cfg.serve_max_batch, replayed=replayed,
                 folded=counts["folded"])
    try:
        while signals.requested is None:
            if server.shutdown_requested.wait(0.05):
                break
    finally:
        stop_refresh.set()
        server.drain()
        core.close()
        if refresher is not None:
            refresher.join(timeout=60)
        path = core.flush_delta_log(serve_dir)
        stats = core.snapshot_stats()
        log(f"[serve] drained: {stats['requests']} requests served "
            f"(A {stats['tier_a']} / B {stats['tier_b']}), "
            f"{stats['deltas']} delta(s) flushed to {path}, "
            f"{stats['dirty']} node(s) left dirty for the next run")
        log(f"[serve] latency: tier A p50 {stats['tier_a_p50_ms']:.3f} ms / "
            f"p99 {stats['tier_a_p99_ms']:.3f} ms | tier B p50 "
            f"{stats['tier_b_p50_ms']:.3f} ms / p99 "
            f"{stats['tier_b_p99_ms']:.3f} ms | refresh lag p50 "
            f"{stats['refresh_lag_p50_s']:.3f} s")
        if obs is not None:
            obs.emit("serve_drain", **{k: stats[k] for k in sorted(stats)})
            obs.close()
        signals.restore()
    if signals.requested is not None:
        log(f"[serve] {signals.requested} honored: resumable delta log "
            f"flushed — relaunch continues ingestion exactly here")
        return resilience.EXIT_PREEMPTED
    return 0


if __name__ == "__main__":
    sys.stdout.reconfigure(line_buffering=True)
    sys.exit(serve_main())
