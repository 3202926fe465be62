"""The partition-sharded serving fleet, router half (counterpart of
bnsgcn_tpu/serve_router.py): one line-JSON listener fronting a fleet of
per-part backends (serve_backend.py).

The training partition artifacts are the serving shard map: meta.json and
each part's `global_nid` give the `global node id -> owning part` table,
and the router forwards every op to the backend(s) owning the nodes it
touches. Reads (`predict`, `predict_many`) go to ONE replica of the owning
part, round-robined, over pooled persistent connections (coord.
LineJsonClient, which resends once on a torn response: reads are
idempotent). Writes (`add_edges`, `update_feat`) are serialized under the
router's delta lock and fan out in three phases, each at most once
(`rpc_line_json(retry_sent=False)`: a delta must never be ingested twice):

  1. apply      -- the owning parts' replicas append the edge halves or the
                   feature row they own and journal them to their delta-log
                   shards;
  2. invalidate -- EVERY backend drops the touched nodes from its remote-halo
                   cache (a cached boundary row is valid exactly until its
                   owner changes it);
  3. mark       -- the <= L-hop forward closure of the touched nodes is
                   marked dirty by a distributed BFS: each owning part walks
                   its local out-edges and returns the cross-part frontier
                   with the remaining hop budget; the router continues the
                   wave, keeping each node's best budget, until it dries up.

The router answers the writing client only after all three phases, so the
client's own next read sees its delta (the order one lock hold gives the
single-host server).

Failure semantics: without health tracking, a backend that misses its
deadline on a read is evicted and the next replica tried; with no live
replica left the client gets a named error (`RouteError: part P ...`)
within the route deadline, never a hang. With --serve-probe-s,
--serve-degraded or --serve-hedge the router tracks each backend's health
(up, suspect, down, quarantined by the flap breaker), fails reads over,
hedges tier-A reads, answers whole-part outages per row, queues the writes
a down backend missed in a bounded WAL and, when it re-registers, replays
them and admits it only after a bitwise warm-up against an up peer.

The router holds no table and runs no forward: it imports no torch (its
CLI takes resilience's signal handling, which is torch-free) and never
touches a device, so it takes no --device.

CLI:  python -m bnsgcn_tpu_torch.main serve-router --dataset ... \\
          --part-path ... --serve-port 18120 [--parts P] [--part-replicas R]
Exit codes: 0 after a client `shutdown` (forwarded to every backend), 75
after SIGTERM/SIGINT (the backends keep serving), 2 a config error.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Optional

import numpy as np

from bnsgcn_tpu_torch import obs as obs_mod
from bnsgcn_tpu_torch.config import Config, ConfigError, parse_config
from bnsgcn_tpu_torch.parallel import coord as coord_mod


class RouteError(ValueError):
    """No live backend could answer for a part — named, deadline-bounded,
    and converted to an {"ok": False} response by the dispatcher."""


def router_endpoint(cfg: Config) -> tuple[str, int]:
    """(addr, port) a backend registers with / a client connects to, from
    --serve-router 'host:port' (default 127.0.0.1:{--serve-port})."""
    if cfg.serve_router:
        host, _, port = cfg.serve_router.rpartition(":")
        if not host or not port.isdigit():
            raise ConfigError(f"--serve-router must be 'host:port', got "
                              f"{cfg.serve_router!r}")
        return host, int(port)
    return "127.0.0.1", cfg.serve_port


def artifacts_dir(cfg: Config) -> str:
    """Where the training partition artifacts live: run.artifacts_dir's
    directory, without importing the training stack (and torch)."""
    name = cfg.graph_name or cfg.derive_graph_name()
    return os.path.join(cfg.part_path, name)


def load_owner_map(part_dir: str) -> np.ndarray:
    """[n_nodes] int32 `global node id -> owning part`, from the training
    partition artifacts (meta.json n_inner + each part{p}.npz global_nid).
    The boundary-node tables the training halo exchange indexes by are the
    same ids — this map IS the serving shard map, no re-partitioning."""
    meta_path = os.path.join(part_dir, "meta.json")
    if not os.path.exists(meta_path):
        raise ConfigError(
            f"no partition artifacts at {part_dir} — build them first "
            f"(python -m bnsgcn_tpu_torch.partition_cli ... or any training "
            f"run over this dataset/partition config)")
    with open(meta_path) as f:
        meta = json.load(f)
    n = int(np.sum(np.asarray(meta["n_inner"], dtype=np.int64)))
    owner = np.full(n, -1, dtype=np.int32)
    for p in range(int(meta["n_parts"])):
        with np.load(os.path.join(part_dir, f"part{p}.npz")) as z:
            gnid = np.asarray(z["global_nid"], dtype=np.int64)
        gnid = gnid[gnid >= 0]
        if gnid.size and (gnid.max() >= n or (owner[gnid] >= 0).any()):
            raise ConfigError(
                f"partition artifacts at {part_dir} are inconsistent: part "
                f"{p} claims nodes outside [0, {n}) or already owned")
        owner[gnid] = p
    if (owner < 0).any():
        raise ConfigError(
            f"partition artifacts at {part_dir} do not cover the graph "
            f"({int((owner < 0).sum())}/{n} nodes unowned)")
    return owner


# ----------------------------------------------------------------------------
# self-healing: health-state machine, circuit breaker, failover WAL
# ----------------------------------------------------------------------------

def _env_f(name: str, default: float) -> float:
    return float(os.environ.get(name, default))


class HealthPolicy:
    """Probe cadence + thresholds for the router-side health checker.
    Cadence is the CLI knob (--serve-probe-s; 0 disables probing), the
    thresholds are env knobs like the $BNSGCN_COORD_* family so CI can
    shrink them without widening the CLI surface."""

    def __init__(self, probe_s: float = 0.0):
        self.probe_s = float(probe_s)
        self.probe_timeout_s = _env_f("BNSGCN_SERVE_PROBE_TIMEOUT_S", 1.0)
        # consecutive failures: up -> suspect after N, -> down after M >= N
        self.suspect_after = int(_env_f("BNSGCN_SERVE_SUSPECT_AFTER", 1))
        self.down_after = int(_env_f("BNSGCN_SERVE_DOWN_AFTER", 3))
        # consecutive probe successes that earn re-admission
        self.readmit = int(_env_f("BNSGCN_SERVE_READMIT", 2))
        # circuit breaker: >= FLAPS down-transitions inside WINDOW_S
        # quarantines the backend for HOLD_S (probes ignored meanwhile)
        self.breaker_flaps = int(_env_f("BNSGCN_SERVE_BREAKER_FLAPS", 3))
        self.breaker_window_s = _env_f("BNSGCN_SERVE_BREAKER_WINDOW_S", 30.0)
        self.breaker_hold_s = _env_f("BNSGCN_SERVE_BREAKER_HOLD_S", 10.0)
        # warm-up: nodes spot-checked bitwise against an up peer replica
        # before a rejoining backend is promoted
        self.spotcheck = int(_env_f("BNSGCN_SERVE_SPOTCHECK", 3))
        # hedged reads: delay floor under the p99-derived trigger
        self.hedge_floor_ms = _env_f("BNSGCN_SERVE_HEDGE_FLOOR_MS", 10.0)


class HealthState:
    """Per-backend up/suspect/down/quarantined state machine, driven by
    probe and request outcomes. Pure (injectable clock, no I/O) so the
    unit matrix covers every transition directly.

    up --fail x suspect_after--> suspect --fail (total down_after)--> down
    down --ok x readmit--> ready (caller runs the warm-up spot-check,
    then admit() -> up); suspect recovers to up on the same streak with
    no warm-up (its table never left the fleet). A backend that flaps
    down >= breaker_flaps times inside breaker_window_s is quarantined:
    probe successes are ignored until the hold expires, then it resumes
    as down and must earn the streak again."""

    def __init__(self, policy: HealthPolicy, now: float = 0.0,
                 state: str = "up"):
        self.policy = policy
        self.state = state
        self.fails = 0
        self.oks = 0
        self.flaps: list[float] = []    # down-transition timestamps
        self.hold_until = 0.0
        self.down_since: Optional[float] = now if state == "down" else None

    def _expire_hold(self, now: float):
        if self.state == "quarantined" and now >= self.hold_until:
            self.state = "down"

    def on_fail(self, now: float) -> Optional[str]:
        """Returns the new state on a transition, else None."""
        self._expire_hold(now)
        self.oks = 0
        self.fails += 1
        if self.state == "up" and self.fails >= self.policy.suspect_after:
            self.state = "suspect"
            if self.fails >= self.policy.down_after:
                return self._to_down(now)
            return "suspect"
        if self.state == "suspect" and self.fails >= self.policy.down_after:
            return self._to_down(now)
        return None

    def _to_down(self, now: float) -> str:
        self.state = "down"
        self.down_since = now
        self.flaps = [t for t in self.flaps
                      if now - t < self.policy.breaker_window_s]
        self.flaps.append(now)
        if len(self.flaps) >= self.policy.breaker_flaps:
            self.state = "quarantined"
            self.hold_until = now + self.policy.breaker_hold_s
            return "quarantined"
        return "down"

    def on_ok(self, now: float) -> Optional[str]:
        """Returns 'up' (suspect recovered), 'ready' (down backend earned
        the streak — caller must warm-up then admit()), or None."""
        if self.state == "quarantined":
            if now < self.hold_until:
                return None             # breaker holds: successes ignored
            self.state = "down"
        self.fails = 0
        if self.state == "up":
            return None
        self.oks += 1
        if self.oks < self.policy.readmit:
            return None
        if self.state == "suspect":
            self.state = "up"
            self.oks = 0
            return "up"
        return "ready"                  # down: warm-up gate before up

    def admit(self, now: float) -> float:
        """Promote to up after the warm-up spot-check passed; returns the
        outage wall clock (seconds since the down transition)."""
        outage = now - self.down_since if self.down_since is not None else 0.0
        self.state = "up"
        self.oks = self.fails = 0
        self.down_since = None
        return outage

    def reject_warmup(self):
        """Spot-check failed: stay down, re-earn the whole streak."""
        self.oks = 0


class DeltaWAL:
    """Bounded router-side write-ahead log for delta ops a down backend
    missed: per-part ordered entries, each tagged with the replica set
    that confirmed it, drained per replica on rejoin. An entry retires
    once every replica slot of its part took it. Append past `cap`
    pending entries for one part raises RouteError — the WAL is a
    recovery buffer, not unbounded spool. Callers serialize through the
    router's delta lock; there is deliberately no internal lock."""

    def __init__(self, cap: int, slots: int):
        self.cap = int(cap)
        self.slots = int(slots)         # replica slots per part
        self._log: dict[int, list] = {}  # part -> [[seq, taken_set, op], ...]
        self._seq = 0
        self.queued = 0                 # lifetime appends (stats)
        self.replayed = 0               # lifetime per-replica replays

    def record(self, part: int, op: dict, taken) -> Optional[int]:
        """Remember `op` for the replicas of `part` NOT in `taken`;
        returns the entry seq (None when every slot already took it)."""
        taken = set(int(r) for r in taken)
        if len(taken) >= self.slots:
            return None
        q = self._log.setdefault(int(part), [])
        if len(q) >= self.cap:
            raise RouteError(
                f"part {part}: failover WAL full ({self.cap} queued "
                f"deltas) — the down backend(s) must rejoin (or be "
                f"re-provisioned) before more writes are accepted")
        self._seq += 1
        self.queued += 1
        q.append([self._seq, taken, dict(op)])
        return self._seq

    def pending_for(self, part: int, replica: int) -> list:
        """[(seq, op)] this replica still misses, in commit order."""
        return [(seq, op) for seq, taken, op in self._log.get(int(part), [])
                if int(replica) not in taken]

    def mark_taken(self, part: int, replica: int, seqs) -> None:
        seqs = set(seqs)
        q = self._log.get(int(part), [])
        for ent in q:
            if ent[0] in seqs:
                ent[1].add(int(replica))
                self.replayed += 1
        self._log[int(part)] = [e for e in q if len(e[1]) < self.slots]

    def depth(self, part: int) -> int:
        return len(self._log.get(int(part), []))

    def snapshot(self) -> dict:
        return {str(p): len(q) for p, q in sorted(self._log.items()) if q}


# ----------------------------------------------------------------------------
# the fleet: registered backends + pooled read connections
# ----------------------------------------------------------------------------

class Fleet:
    """Registry of live backends keyed (part, replica): addresses, a small
    pool of persistent read connections each (a LineJsonClient serializes
    its in-flight request, so one connection per backend would queue
    concurrent routed reads behind each other), and per-part round-robin
    state."""

    POOL = 4        # persistent read connections per backend

    def __init__(self, n_parts: int, replicas: int,
                 route_timeout_s: float = 15.0):
        self.n_parts = int(n_parts)
        self.replicas = int(replicas)
        self.route_timeout_s = route_timeout_s
        self._lock = threading.Lock()
        self._backends: dict = {}   # guarded-by: self._lock
        self._clients: dict = {}    # guarded-by: self._lock
        self._rr: dict = {}         # guarded-by: self._lock
        self._crr: dict = {}        # guarded-by: self._lock
        self._hedge_free: dict = {}  # guarded-by: self._lock

    def register(self, part: int, replica: int, addr: str, port: int) -> str:
        part, replica = int(part), int(replica)
        if not 0 <= part < self.n_parts:
            raise ValueError(f"part {part} out of range [0, {self.n_parts})")
        if not 0 <= replica < self.replicas:
            raise ValueError(f"replica {replica} out of range "
                             f"[0, {self.replicas})")
        bid = f"p{part}.r{replica}"
        with self._lock:
            old = self._clients.pop((part, replica), [])
            old += self._hedge_free.pop((part, replica), [])
            self._backends[(part, replica)] = {
                "addr": addr, "port": int(port), "id": bid}
        for c in old:
            c.close()       # re-registration (backend restart) wins
        return bid

    def evict(self, part: int, replica: int):
        with self._lock:
            self._backends.pop((part, replica), None)
            old = self._clients.pop((part, replica), [])
            old += self._hedge_free.pop((part, replica), [])
        for c in old:
            c.close()

    def missing_parts(self) -> list[int]:
        with self._lock:
            covered = {p for p, _ in self._backends}
        return [p for p in range(self.n_parts) if p not in covered]

    def replicas_of(self, part: int) -> list[int]:
        with self._lock:
            return sorted(r for p, r in self._backends if p == int(part))

    def endpoint(self, part: int, replica: int) -> Optional[dict]:
        with self._lock:
            be = self._backends.get((int(part), int(replica)))
            return dict(be) if be else None

    def client(self, part: int, replica: int
               ) -> Optional[coord_mod.LineJsonClient]:
        """A pooled read connection to one backend (idempotent ops only):
        grown lazily up to POOL, then round-robined — concurrent routed
        reads must not queue behind one another's round trip."""
        key = (int(part), int(replica))
        with self._lock:
            be = self._backends.get(key)
            if be is None:
                return None
            pool = self._clients.setdefault(key, [])
            if len(pool) < self.POOL:
                c = coord_mod.LineJsonClient(be["addr"], be["port"],
                                             timeout_s=self.route_timeout_s,
                                             what=f"backend {be['id']}")
                pool.append(c)
                return c
            i = self._crr.get(key, 0)
            self._crr[key] = i + 1
            return pool[i % len(pool)]

    def pick(self, part: int) -> Optional[int]:
        """Round-robin replica choice for a read on `part`."""
        part = int(part)
        with self._lock:
            live = sorted(r for p, r in self._backends if p == part)
            if not live:
                return None
            i = self._rr.get(part, 0)
            self._rr[part] = i + 1
        return live[i % len(live)]

    def entries(self) -> list[tuple[int, int, dict]]:
        """Snapshot of every registered backend as (part, replica, be) —
        the health prober's iteration set."""
        with self._lock:
            return [(p, r, dict(be))
                    for (p, r), be in sorted(self._backends.items())]

    # -- hedged-read clients: exclusive checkout, never shared --
    #
    # The shared pool above round-robins client objects across concurrent
    # requests, so cancel() on a pooled client could tear a socket some
    # OTHER request is using. Hedge losers are cancelled by design, so
    # hedged reads check out a dedicated client (reused when returned
    # intact, discarded when cancelled/errored).

    def checkout(self, part: int, replica: int
                 ) -> Optional[coord_mod.LineJsonClient]:
        key = (int(part), int(replica))
        with self._lock:
            be = self._backends.get(key)
            if be is None:
                return None
            free = self._hedge_free.setdefault(key, [])
            if free:
                return free.pop()
        return coord_mod.LineJsonClient(be["addr"], be["port"],
                                        timeout_s=self.route_timeout_s,
                                        what=f"backend {be['id']}")

    def checkin(self, part: int, replica: int,
                client: coord_mod.LineJsonClient) -> None:
        key = (int(part), int(replica))
        with self._lock:
            if key in self._backends \
                    and len(self._hedge_free.get(key, ())) < self.POOL:
                self._hedge_free.setdefault(key, []).append(client)
                return
        client.close()

    def snapshot(self) -> dict:
        with self._lock:
            out: dict = {str(p): [] for p in range(self.n_parts)}
            for (p, r), be in sorted(self._backends.items()):
                out[str(p)].append({"replica": r, "addr": be["addr"],
                                    "port": be["port"], "id": be["id"]})
        return out

    def close(self):
        with self._lock:
            clients = [c for pool in self._clients.values() for c in pool]
            clients += [c for pool in self._hedge_free.values() for c in pool]
            self._clients.clear()
            self._hedge_free.clear()
        for c in clients:
            c.close()


# ----------------------------------------------------------------------------
# the router core: ownership routing + three-phase delta fan-out
# ----------------------------------------------------------------------------

class RouterCore:
    """Protocol-level router over a Fleet (the TCP layer below is a thin
    dispatcher; tests drive this directly). Thread-safe: counters under
    self._lock, delta fan-out serialized under self._delta_lock."""

    def __init__(self, owner: np.ndarray, n_parts: int, replicas: int = 1,
                 hops: int = 2, log=print,
                 obs: Optional[obs_mod.Obs] = None,
                 route_timeout_s: float = 15.0,
                 delta_timeout_s: float = 60.0,
                 health: Optional[HealthPolicy] = None,
                 degraded: str = "off", hedge: bool = False,
                 wal_cap: int = 256):
        self.owner = np.asarray(owner, dtype=np.int32)
        self.n_nodes = int(self.owner.shape[0])
        self.hops = int(hops)
        self.log = log
        self.obs = obs
        self.route_timeout_s = route_timeout_s
        self.delta_timeout_s = delta_timeout_s
        self.fleet = Fleet(n_parts, replicas, route_timeout_s=route_timeout_s)
        self.registry = obs.registry if obs is not None else obs_mod.Registry()
        # router-side route-latency histograms under the backends' key
        # names, so `stats` reads as a single server's
        self._lat = {t: self.registry.histogram(f"serve/latency_ms/{t}")
                     for t in ("A", "B")}
        self._lock = threading.Lock()
        # guarded-by: self._lock
        self.stats = {"requests": 0, "tier_a": 0, "tier_b": 0, "deltas": 0,
                      "fanout_rpcs": 0, "evictions": 0,
                      # self-healing counters (inert in legacy mode)
                      "requests_ok": 0, "requests_degraded": 0,
                      "requests_failed": 0, "failovers": 0, "hedges": 0,
                      "wal_queued": 0, "wal_replayed": 0, "recoveries": 0}
        self._delta_lock = threading.Lock()
        # -- self-healing state (all inert when health is None: the
        # evict-on-error protocol is the health=None code path) --
        self.health_policy = health
        self.degraded = degraded
        self.hedge = bool(hedge) and health is not None
        self.wal = DeltaWAL(wal_cap, replicas)
        # the WAL only queues when the operator opted into degraded mode:
        # with it off, a down part refuses writes
        self._wal_active = degraded != "off" and health is not None
        self._health: dict = {}         # (part, replica) -> HealthState;
                                        # guarded-by: self._lock
        self._incarnations: dict = {}   # (part, replica) -> token
        self._retired: set = set()      # superseded incarnation tokens
        self._read_rr: dict = {}        # per-part up-replica round-robin
        self._failover_lat = self.registry.histogram("serve/failover_ms")
        self._recovery_s: list[float] = []  # outage wall clocks (admits)
        self._probe_halt = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None

    # -- readiness --

    def ready(self) -> list[int]:
        """[] when every part has at least one live backend; else the
        missing part ids."""
        return self.fleet.missing_parts()

    def _require_ready(self):
        missing = self.ready()
        if missing:
            raise RouteError(f"fleet not ready: no backend registered for "
                             f"part(s) {missing}")

    def _owner_of(self, node: int) -> int:
        node = int(node)
        if not 0 <= node < self.n_nodes:
            raise ValueError(f"node {node} out of range [0, {self.n_nodes})")
        return int(self.owner[node])

    # -- health bookkeeping (health_policy=None keeps every path inert) --

    def _state_of(self, part: int, replica: int) -> Optional[HealthState]:
        with self._lock:
            return self._health.get((int(part), int(replica)))

    def _emit_health(self, part: int, replica: int, state: str, **kw):
        self.log(f"[router] backend p{part}.r{replica} -> {state}"
                 + (f" ({kw.get('why')})" if kw.get("why") else ""))
        if self.obs is not None:
            self.obs.emit("serve_health", part=int(part),
                          replica=int(replica), state=state, **kw)

    def _note_fail(self, part: int, replica: int, why: str):
        hs = self._state_of(part, replica)
        if hs is None:
            return
        with self._lock:
            trans = hs.on_fail(time.monotonic())
        if trans is not None:
            self._emit_health(part, replica, trans, why=why)

    def _note_ok(self, part: int, replica: int) -> Optional[str]:
        hs = self._state_of(part, replica)
        if hs is None:
            return None
        with self._lock:
            trans = hs.on_ok(time.monotonic())
        if trans == "up":
            self._emit_health(part, replica, "up", why="probe streak")
        return trans

    def _candidates(self, part: int) -> list[int]:
        """Replicas to try for a read, in preference order: `up` replicas
        round-robined first, then `suspect` as a last resort. `down` and
        quarantined backends are skipped entirely — that is what keeps a
        single dead backend from costing every request a timeout."""
        part = int(part)
        regs = self.fleet.replicas_of(part)
        ups, suspects = [], []
        with self._lock:
            for r in regs:
                hs = self._health.get((part, r))
                if hs is None or hs.state == "up":
                    ups.append(r)
                elif hs.state == "suspect":
                    suspects.append(r)
            i = self._read_rr.get(part, 0)
            self._read_rr[part] = i + 1
        ups = ups[i % len(ups):] + ups[:i % len(ups)] if ups else []
        return ups + suspects

    # -- reads: round-robined, evict-on-timeout, pooled connections --

    def _forward_read(self, part: int, req: dict) -> tuple[dict, int]:
        """(response, replica) from the first live replica of `part`; a
        replica missing its deadline is evicted and the next one tried —
        no live replica left raises a named RouteError, never a hang."""
        if self.health_policy is not None:
            return self._forward_read_health(part, req)
        tried: list[str] = []
        for _ in range(max(self.fleet.replicas, 1)):
            replica = self.fleet.pick(part)
            if replica is None:
                break
            client = self.fleet.client(part, replica)
            if client is None:
                continue
            try:
                resp = client.request(req)
            except coord_mod.CoordTimeout as ex:
                tried.append(f"r{replica} ({ex})")
                self.fleet.evict(part, replica)
                with self._lock:
                    self.stats["evictions"] += 1
                self.log(f"[router] evicted backend p{part}.r{replica}: {ex}")
                continue
            return resp, replica
        raise RouteError(
            f"part {part}: no live backend within {self.route_timeout_s}s "
            f"deadline (tried: {', '.join(tried) or 'none registered'})")

    def _forward_read_health(self, part: int, req: dict) -> tuple[dict, int]:
        """Health-aware twin of `_forward_read`: failures mark the replica
        (up -> suspect -> down, breaker past that) instead of evicting it,
        and the request fails over to the next candidate. A read answered
        by a non-primary candidate is a failover (counted, latency
        histogrammed, obs 'failover' event)."""
        t0 = time.perf_counter()
        tried: list[str] = []
        cands = self._candidates(part)
        for i, replica in enumerate(cands):
            client = self.fleet.client(part, replica)
            if client is None:
                continue
            try:
                resp = client.request(req)
            except coord_mod.CoordCancelled:
                raise
            except coord_mod.CoordTimeout as ex:
                tried.append(f"r{replica} ({ex})")
                self._note_fail(part, replica, f"read {req.get('op')!r}")
                continue
            self._note_ok(part, replica)
            if i > 0:
                ms = (time.perf_counter() - t0) * 1e3
                with self._lock:
                    self.stats["failovers"] += 1
                self._failover_lat.observe(ms)
                if self.obs is not None:
                    self.obs.emit("failover", what="read", part=int(part),
                                  to_replica=int(replica), attempts=i + 1,
                                  ms=ms)
            return resp, replica
        raise RouteError(
            f"part {part}: no live backend within {self.route_timeout_s}s "
            f"deadline (tried: {', '.join(tried) or 'none up'})")

    # -- hedged tier-A reads: second replica after a p99-derived delay --

    def _hedge_delay_s(self) -> float:
        p99 = self._lat["A"].snapshot()["p99"] or 0.0
        return max(float(p99), self.health_policy.hedge_floor_ms) / 1e3

    def _hedged_read(self, part: int, req: dict) -> tuple[dict, int]:
        """Fire the primary; if no answer within the hedge delay, fire the
        next up replica. First answer wins, the loser's in-flight request
        is cancelled (dedicated checked-out clients — never the shared
        pool, so a cancel cannot tear another request's socket)."""
        cands = self._candidates(part)
        if len(cands) < 2:
            return self._forward_read(part, req)
        done = threading.Event()
        state = {"resp": None, "replica": None, "fails": 0, "fired": 0}
        lock = threading.Lock()
        clients: dict[int, coord_mod.LineJsonClient] = {}

        def fire(replica: int):
            client = self.fleet.checkout(part, replica)
            if client is None:
                with lock:
                    state["fails"] += 1
                    if state["fails"] >= state["fired"]:
                        done.set()
                return
            with lock:
                clients[replica] = client
            try:
                resp = client.request(req)
            except coord_mod.CoordCancelled:
                client.close()          # cancelled loser: discard
                return
            except coord_mod.CoordTimeout as ex:
                client.close()
                self._note_fail(part, replica, f"hedged read ({ex})")
                with lock:
                    state["fails"] += 1
                    if state["fails"] >= state["fired"] \
                            and state["resp"] is None:
                        done.set()
                return
            self._note_ok(part, replica)
            losers = []
            with lock:
                if state["resp"] is None:
                    state["resp"], state["replica"] = resp, replica
                    losers = [c for r, c in clients.items() if r != replica]
                    self.fleet.checkin(part, replica, client)
                else:
                    losers = [client]   # raced a winner: we are the loser
                done.set()
            for c in losers:
                c.cancel()

        with lock:
            state["fired"] = 1
        threading.Thread(target=fire, args=(cands[0],), daemon=True).start()
        if not done.wait(self._hedge_delay_s()):
            with self._lock:
                self.stats["hedges"] += 1
            with lock:
                state["fired"] += 1
            threading.Thread(target=fire, args=(cands[1],),
                             daemon=True).start()
        done.wait(self.route_timeout_s + 1.0)
        with lock:
            resp, replica = state["resp"], state["replica"]
        if resp is None:
            # both attempts died: fall back to the sequential path for the
            # named RouteError (or a late-recovering replica)
            return self._forward_read(part, req)
        return resp, replica

    # -- graceful degradation: partial answers instead of request failure --

    def _degraded_rows(self, nodes, part: int, err: str) -> list[dict]:
        """Per-node answers for an unreachable part: `stale-ok` first tries
        a possibly-stale tier-A batch from any still-registered replica
        (whatever its health state — a suspect or warming backend's table
        is stale at worst, and the rows are tagged); otherwise (and in
        `partial`) each row is status:'unavailable'. Either way the
        request as a whole succeeds — that is the degradation contract."""
        nodes = [int(n) for n in nodes]
        part = int(part)
        if self.degraded == "stale-ok":
            budget = max(self.health_policy.probe_timeout_s
                         if self.health_policy else 1.0, 0.25)
            for p, r, be in self.fleet.entries():
                if p != part:
                    continue
                try:
                    resp = coord_mod.rpc_line_json(
                        be["addr"], be["port"],
                        {"op": "predict_many", "nodes": nodes, "tier": "A"},
                        time.monotonic() + budget,
                        what=f"backend {be['id']} (stale-ok)")
                except coord_mod.CoordTimeout:
                    continue
                if resp.get("ok"):
                    rows = resp["results"]
                    for row in rows:
                        row["status"] = "stale"
                        row["part"] = part
                        row["backend"] = be["id"]
                    if self.obs is not None:
                        self.obs.emit("failover", what="stale_read",
                                      part=part, nodes=len(rows),
                                      backend=be["id"])
                    return rows
        return [{"ok": True, "node": n, "status": "unavailable",
                 "part": part, "err": err} for n in nodes]

    def predict(self, node: int, tier: Optional[str] = None) -> dict:
        self._require_ready()
        t0 = time.perf_counter()
        part = self._owner_of(node)
        req = {"op": "predict", "node": int(node)}
        if tier is not None:
            req["tier"] = tier
        try:
            if self.hedge and tier != "B":
                resp, replica = self._hedged_read(part, req)
            else:
                resp, replica = self._forward_read(part, req)
        except RouteError as ex:
            if self.degraded == "off":
                with self._lock:
                    self.stats["requests_failed"] += 1
                raise
            row = self._degraded_rows([node], part, str(ex))[0]
            with self._lock:
                self.stats["requests"] += 1
                self.stats["requests_degraded"] += 1
            return row
        with self._lock:
            self.stats["requests"] += 1
            self.stats["fanout_rpcs"] += 1
            self.stats["requests_ok"] += 1
            if resp.get("tier") == "B":
                self.stats["tier_b"] += 1
            elif resp.get("tier") == "A":
                self.stats["tier_a"] += 1
        # shard tags: a client splits its percentiles by these without a
        # second round trip
        resp["part"] = part
        resp["backend"] = f"p{part}.r{replica}"
        if self.degraded != "off":
            resp.setdefault("status", "ok")
        if resp.get("tier") in ("A", "B"):
            self._lat[resp["tier"]].observe((time.perf_counter() - t0) * 1e3)
        return resp

    def predict_many(self, nodes, tier: Optional[str] = None) -> list[dict]:
        """Split by owning part, forward each shard's slice concurrently,
        merge back in request order (each result carries its shard tags)."""
        self._require_ready()
        nodes = [int(n) for n in nodes]
        by_part: dict[int, list[int]] = {}
        for n in nodes:
            by_part.setdefault(self._owner_of(n), []).append(n)
        results: dict[int, dict] = {}
        errors: list[str] = []
        res_lock = threading.Lock()

        degraded_n = [0]

        def _one(part: int, shard: list[int]):
            req = {"op": "predict_many", "nodes": shard}
            if tier is not None:
                req["tier"] = tier
            try:
                resp, replica = self._forward_read(part, req)
            except (RouteError, ValueError) as ex:
                if self.degraded == "off" or not isinstance(ex, RouteError):
                    with res_lock:
                        errors.append(str(ex))
                    return
                rows = self._degraded_rows(shard, part, str(ex))
                with res_lock:
                    degraded_n[0] += len(rows)
                    for r in rows:
                        results[int(r["node"])] = r
                return
            if not resp.get("ok"):
                with res_lock:
                    errors.append(f"part {part}: {resp.get('err')}")
                return
            with res_lock:
                for r in resp["results"]:
                    r["part"] = part
                    r["backend"] = f"p{part}.r{replica}"
                    if self.degraded != "off":
                        r.setdefault("status", "ok")
                    results[int(r["node"])] = r

        threads = [threading.Thread(target=_one, args=(p, shard))
                   for p, shard in sorted(by_part.items())]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            with self._lock:
                self.stats["requests_failed"] += len(nodes)
            raise RouteError("; ".join(errors))
        with self._lock:
            self.stats["requests"] += len(nodes)
            self.stats["fanout_rpcs"] += len(by_part)
            self.stats["requests_degraded"] += degraded_n[0]
            self.stats["requests_ok"] += len(nodes) - degraded_n[0]
            for n in nodes:
                tr = results[n].get("tier")
                if tr == "B":
                    self.stats["tier_b"] += 1
                elif tr == "A":
                    self.stats["tier_a"] += 1
        return [results[n] for n in nodes]

    # -- writes: three-phase fan-out under the delta lock --

    def _send_write(self, part: int, replica: int, req: dict,
                    timeout_s: Optional[float] = None) -> Optional[dict]:
        """At-most-once write to ONE backend (rpc_line_json fresh
        connection, retry_sent=False — a delta must never apply twice).
        Returns None on failure (and evicts when health tracking is off)."""
        return self._send_write2(part, replica, req, timeout_s)[0]

    def _send_write2(self, part: int, replica: int, req: dict,
                     timeout_s: Optional[float] = None
                     ) -> tuple[Optional[dict], bool]:
        """`_send_write` plus a delivered-maybe bit: True when the request
        reached the wire (ok response, or timeout AFTER send). A sent-but-
        unanswered write is delivered-unknown — it must count as taken and
        never be re-sent (at-most-once); under-delivery is caught later by
        the rejoin warm-up spot-check."""
        be = self.fleet.endpoint(part, replica)
        if be is None:
            return None, False
        try:
            resp = coord_mod.rpc_line_json(
                be["addr"], be["port"], req,
                time.monotonic() + (timeout_s or self.delta_timeout_s),
                what=f"backend {be['id']}", retry_sent=False)
        except coord_mod.CoordTimeout as ex:
            sent = bool(getattr(ex, "request_sent", False))
            if self.health_policy is not None:
                self._note_fail(part, replica, f"write {req.get('op')!r}")
            else:
                self.fleet.evict(part, replica)
                with self._lock:
                    self.stats["evictions"] += 1
                self.log(f"[router] evicted backend p{part}.r{replica} "
                         f"mid-write: {ex}")
            return None, sent
        with self._lock:
            self.stats["fanout_rpcs"] += 1
        return resp, True

    def _fan_part_write(self, part: int, req: dict) -> list[dict]:
        """The same write to EVERY live replica of `part` (replica state
        must stay identical); returns the ok responses."""
        return self._fan_part_write_taken(part, req)[0]

    def _fan_part_write_taken(self, part: int,
                              req: dict) -> tuple[list[dict], set[int]]:
        """`_fan_part_write` plus the set of replica slots that took (or
        may have taken — delivered-unknown) the write, for WAL cursors."""
        out: list[dict] = []
        taken: set[int] = set()
        for replica in self.fleet.replicas_of(part):
            if self.health_policy is not None:
                hs = self._state_of(part, replica)
                if hs is not None and hs.state in ("down", "quarantined"):
                    # known-dead: don't stall the whole delta fan-out on
                    # its connect-retry deadline — the WAL queues for it
                    continue
            resp, maybe = self._send_write2(part, replica, req)
            if resp is not None and resp.get("ok"):
                out.append(resp)
                taken.add(replica)
            elif maybe:
                taken.add(replica)  # delivered-unknown: never re-send
        return out, taken

    def _wal_record(self, part: int, op: dict, taken: set) -> bool:
        """Queue `op` for the replica slots of `part` that missed it.
        Slots that have never registered count as taken — a first-time
        replica builds from artifacts + its own journal, not the WAL.
        Raises RouteError when the per-part WAL is full (bounded memory:
        at that point the part must rejoin or the write is refused)."""
        if not self._wal_active:
            return False
        regs = set(self.fleet.replicas_of(part))
        taken = set(taken) | {r for r in range(self.fleet.replicas)
                              if r not in regs}
        seq = self.wal.record(int(part), op, taken)
        if seq is None:
            return False
        with self._lock:
            self.stats["wal_queued"] += 1
        self.log(f"[router] WAL p{part} seq {seq}: queued {op.get('op')!r} "
                 f"for replica(s) missing it (depth "
                 f"{self.wal.depth(int(part))})")
        if self.obs is not None:
            self.obs.emit("failover", what="wal_queue", part=int(part),
                          op=op.get("op"), seq=int(seq),
                          depth=self.wal.depth(int(part)))
        return True

    def _invalidate_all(self, nodes: list[int]):
        """Phase 2: every backend drops the touched nodes from its halo
        cache — a cached boundary row is valid exactly until its owner
        changes it."""
        req = {"op": "invalidate", "nodes": [int(v) for v in nodes]}
        for part in range(self.fleet.n_parts):
            self._fan_part_write(part, req)

    def _mark_bfs(self, seeds: dict[int, int]) -> int:
        """Phase 3: distributed dirty-mark BFS. Each wave sends every
        pending (node, hops_left) to the owning part (ALL replicas — their
        dirty sets must agree; the frontier is taken from the first ok
        response since replica graphs are identical); the router dedups
        globally on best remaining budget, so no node is ever re-walked
        with a smaller budget than it already got."""
        best: dict[int, int] = {}
        work = {int(v): int(h) for v, h in seeds.items()}
        best.update(work)
        marked = 0
        while work:
            by_part: dict[int, list] = {}
            for v, h in work.items():
                by_part.setdefault(self._owner_of(v), []).append([v, h])
            work = {}
            for part, batch in sorted(by_part.items()):
                req = {"op": "mark", "nodes": sorted(batch)}
                resps, taken = self._fan_part_write_taken(part, req)
                self._wal_record(part, req, taken)
                if not resps:
                    if self._wal_active:
                        # whole part down: the mark is queued; its frontier
                        # resumes when the rejoiner replays it (the replay
                        # path feeds the answered frontier back into BFS)
                        continue
                    raise RouteError(
                        f"part {part}: no live backend took the dirty-mark "
                        f"fan-out — delta partially applied, retry after "
                        f"the part re-registers")
                marked += int(resps[0].get("marked", 0))
                for v, h in resps[0].get("frontier", []):
                    v, h = int(v), int(h)
                    if best.get(v, -1) >= h:
                        continue
                    best[v] = h
                    work[v] = h
        return marked

    def _dirty_total(self) -> int:
        total = 0
        for part in range(self.fleet.n_parts):
            try:
                resp, _ = self._forward_read(part, {"op": "dirty"})
            except RouteError:
                continue
            total += int(resp.get("count", 0))
        return total

    def add_edges(self, edges: list) -> dict:
        self._require_ready()
        pairs = [(int(u), int(v)) for u, v in edges]
        for u, v in pairs:
            self._owner_of(u), self._owner_of(v)      # range check up front
        with self._delta_lock:
            # phase 1: the owning parts append the halves they own
            by_part: dict[int, list] = {}
            for u, v in pairs:
                by_part.setdefault(self._owner_of(u), []).append([u, v])
                pv = self._owner_of(v)
                if pv != self._owner_of(u):
                    by_part.setdefault(pv, []).append([u, v])
            for part, batch in sorted(by_part.items()):
                req = {"op": "apply_delta", "edges": batch}
                resps, taken = self._fan_part_write_taken(part, req)
                self._wal_record(part, req, taken)
                if not resps and not self._wal_active:
                    raise RouteError(
                        f"part {part}: no live backend took the delta — "
                        f"nothing applied there; retry after it re-registers")
            touched = sorted({n for uv in pairs for n in uv})
            self._invalidate_all(touched)
            marked = self._mark_bfs({n: self.hops for n in touched})
            with self._lock:
                self.stats["deltas"] += 1
        out = {"ok": True, "dirty_new": marked,
               "dirty_total": self._dirty_total()}
        if self.obs is not None:
            self.obs.emit("delta", op="add_edges", edges=len(pairs),
                          dirty_new=out["dirty_new"],
                          dirty_total=out["dirty_total"], routed=True)
        return out

    def update_feat(self, node: int, vec) -> dict:
        self._require_ready()
        node = int(node)
        part = self._owner_of(node)
        with self._delta_lock:
            req = {"op": "apply_feat", "node": node, "feat": list(vec)}
            resps, taken = self._fan_part_write_taken(part, req)
            self._wal_record(part, req, taken)
            if not resps and not self._wal_active:
                raise RouteError(
                    f"part {part}: no live backend took the feature "
                    f"update — nothing applied; retry after it re-registers")
            self._invalidate_all([node])
            marked = self._mark_bfs({node: self.hops})
            with self._lock:
                self.stats["deltas"] += 1
        out = {"ok": True, "dirty_new": marked,
               "dirty_total": self._dirty_total()}
        if self.obs is not None:
            self.obs.emit("delta", op="update_feat", node=node,
                          dirty_new=out["dirty_new"],
                          dirty_total=out["dirty_total"], routed=True)
        return out

    # -- rejoin: incarnation tokens, WAL replay, warm-up, probes --

    def register_backend(self, part: int, replica: int, addr: str,
                         port: int, incarnation: Optional[str] = None
                         ) -> dict:
        """Fleet registration, health-aware. A re-register of a slot the
        router has already seen is a rejoin: the new incarnation token
        retires the old one (a zombie of the previous process is refused),
        the backend starts `down`, replays the WAL tail it missed, and is
        promoted only after the warm-up spot-check answers bitwise against
        an up peer. With health off this is exactly fleet.register."""
        part, replica = int(part), int(replica)
        key = (part, replica)
        if self.health_policy is not None and incarnation:
            with self._lock:
                if incarnation in self._retired:
                    raise RouteError(
                        f"backend p{part}.r{replica}: stale incarnation "
                        f"token {incarnation!r} refused — a newer "
                        f"incarnation of this slot registered after it")
        bid = self.fleet.register(part, replica, addr, port)
        if self.health_policy is None:
            return {"id": bid, "state": "up"}
        now = time.monotonic()
        with self._lock:
            prev_tok = self._incarnations.get(key)
            if incarnation:
                if prev_tok and prev_tok != incarnation:
                    self._retired.add(prev_tok)
                self._incarnations[key] = incarnation
            prev_hs = self._health.get(key)
            rejoin = prev_hs is not None
            hs = HealthState(self.health_policy, now,
                             state="down" if rejoin else "up")
            if rejoin:
                # keep the outage clock and the breaker history — a
                # crash-looping backend must not reset its flap count by
                # re-registering
                if prev_hs.down_since is not None:
                    hs.down_since = prev_hs.down_since
                hs.flaps = list(prev_hs.flaps)
                if prev_hs.state == "quarantined" and now < prev_hs.hold_until:
                    hs.state = "quarantined"
                    hs.hold_until = prev_hs.hold_until
            self._health[key] = hs
        if not rejoin:
            self._emit_health(part, replica, "up", why="registered")
        elif hs.state == "quarantined":
            self._emit_health(part, replica, "quarantined",
                              why="re-registered inside breaker hold")
        else:
            self._emit_health(part, replica, "down",
                              why="re-registered; replaying + warming up")
            # inline admission attempt: deterministic for orchestrators
            # that re-register and immediately expect service; the probe
            # loop retries if the warm-up fails here
            self._try_admit(part, replica)
        with self._lock:
            state = self._health[key].state
        return {"id": bid, "state": state}

    def _replay_wal(self, part: int, replica: int) -> int:
        """Drain this replica's WAL cursor in commit order, at-most-once
        each (a delivered-unknown entry is marked taken and NEVER re-sent;
        the warm-up spot-check catches under-delivery). Returns entries
        confirmed. Stops at the first failure — remaining entries wait
        for the next admission attempt."""
        if not self._wal_active:
            return 0
        n = 0
        with self._delta_lock:
            for seq, op in self.wal.pending_for(part, replica):
                resp, maybe = self._send_write2(part, replica, op)
                if resp is not None and resp.get("ok"):
                    self.wal.mark_taken(part, replica, [seq])
                    n += 1
                    if op.get("op") == "mark":
                        # resume the dirty BFS the outage cut short
                        fr = {int(v): int(h)
                              for v, h in resp.get("frontier", [])}
                        if fr:
                            self._mark_bfs(fr)
                elif maybe:
                    self.wal.mark_taken(part, replica, [seq])
                    break
                else:
                    break
        if n:
            with self._lock:
                self.stats["wal_replayed"] += n
            self.log(f"[router] WAL p{part}.r{replica}: replayed {n} "
                     f"queued delta op(s) on rejoin")
            if self.obs is not None:
                self.obs.emit("failover", what="wal_replay", part=part,
                              replica=int(replica), entries=n)
        return n

    def _spot_read(self, part: int, replica: int,
                   node: int) -> Optional[dict]:
        be = self.fleet.endpoint(part, replica)
        if be is None:
            return None
        try:
            resp = coord_mod.rpc_line_json(
                be["addr"], be["port"],
                {"op": "predict", "node": int(node), "tier": "A"},
                time.monotonic() + max(self.health_policy.probe_timeout_s,
                                       0.25),
                what=f"backend {be['id']} (warm-up)")
        except coord_mod.CoordTimeout:
            return None
        return resp if resp.get("ok") else None

    def _warmup_check(self, part: int, replica: int) -> bool:
        """Bitwise tier-A spot-check of the rejoiner against an up peer
        replica on a spread of owned nodes. Rows that are dirty (stale
        tag) on either side are skipped — a mid-refresh table row differs
        legitimately. No up peer -> trivially passes (nothing to compare;
        the rejoiner IS the part now)."""
        peers = []
        for r in self.fleet.replicas_of(part):
            if r == replica:
                continue
            hs = self._state_of(part, r)
            if hs is not None and hs.state == "up":
                peers.append(r)
        if not peers:
            return True
        own = np.flatnonzero(self.owner == part)
        if own.size == 0:
            return True
        k = min(max(self.health_policy.spotcheck, 1), int(own.size))
        idx = np.linspace(0, own.size - 1, num=k).astype(np.int64)
        for node in (int(own[i]) for i in idx):
            a = self._spot_read(part, replica, node)
            b = self._spot_read(part, peers[0], node)
            if a is None or b is None:
                return False
            if a.get("stale") or b.get("stale"):
                continue
            if a.get("scores") != b.get("scores"):
                self.log(f"[router] warm-up p{part}.r{replica}: node "
                         f"{node} differs from peer r{peers[0]} — "
                         f"admission refused")
                return False
        return True

    def _try_admit(self, part: int, replica: int) -> bool:
        """WAL-tail replay -> bitwise warm-up -> promote to up."""
        hs = self._state_of(part, replica)
        if hs is None:
            return False
        with self._lock:
            if hs.state == "quarantined" and \
                    time.monotonic() < hs.hold_until:
                return False
        self._replay_wal(part, replica)
        if self._wal_active and self.wal.pending_for(part, replica):
            with self._lock:
                hs.reject_warmup()
            return False                # replay incomplete: stay down
        if not self._warmup_check(part, replica):
            with self._lock:
                hs.reject_warmup()
            self._emit_health(part, replica, "down",
                              why="warm-up spot-check mismatch")
            return False
        with self._lock:
            outage = hs.admit(time.monotonic())
            self.stats["recoveries"] += 1
            self._recovery_s.append(outage)
        self._emit_health(part, replica, "up",
                          why=f"rejoined after {outage:.2f}s outage")
        if self.obs is not None:
            self.obs.emit("failover", what="rejoin", part=int(part),
                          replica=int(replica), outage_s=round(outage, 3))
        return True

    def start_probes(self):
        """Background liveness prober (no-op unless --serve-probe-s > 0)."""
        if self.health_policy is None or self.health_policy.probe_s <= 0:
            return
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="bnsgcn-router-prober",
            daemon=True)
        self._probe_thread.start()

    def _probe_loop(self):
        while not self._probe_halt.wait(self.health_policy.probe_s):
            try:
                self.probe_once()
            except Exception as ex:        # noqa: BLE001 - prober must
                self.log(f"[router] probe sweep error: {ex}")  # outlive any

    def probe_once(self):
        """One liveness sweep over every registered backend; a down
        backend that earns its ok-streak goes through the full admission
        gate (WAL replay + warm-up) right here."""
        pol = self.health_policy
        for part, replica, be in self.fleet.entries():
            r = coord_mod.probe_line_json(be["addr"], be["port"],
                                          timeout_s=pol.probe_timeout_s,
                                          what=f"backend {be['id']}")
            if r.get("ok"):
                if self._note_ok(part, replica) == "ready":
                    self._try_admit(part, replica)
            else:
                self._note_fail(part, replica,
                                f"probe ({r.get('err', '?')})")

    def health_snapshot(self) -> dict:
        with self._lock:
            return {f"p{p}.r{r}": hs.state
                    for (p, r), hs in sorted(self._health.items())}

    def fleet_snapshot(self) -> dict:
        """The fleet map peers resolve halo rows through. Health-aware:
        down/quarantined replicas are dropped from a part's entry list so
        a peer's next resolve lands on a live replica — unless EVERY
        replica of the part is down (then the raw list stays; the peer's
        error should name the dead backend, not 'no backend')."""
        snap = self.fleet.snapshot()
        if self.health_policy is None:
            return snap
        with self._lock:
            dead = {(p, r) for (p, r), hs in self._health.items()
                    if hs.state in ("down", "quarantined")}
        for p, entries in snap.items():
            live = [e for e in entries
                    if (int(p), int(e["replica"])) not in dead]
            if live:
                snap[p] = live
        return snap

    def availability(self) -> dict:
        """The operator's fleet availability summary (the `health` op and
        the router's drain line read it)."""
        with self._lock:
            ok = self.stats["requests_ok"]
            deg = self.stats["requests_degraded"]
            failed = self.stats["requests_failed"]
            failovers = self.stats["failovers"]
            hedges = self.stats["hedges"]
            rec = list(self._recovery_s)
        total = ok + deg + failed
        snap = self._failover_lat.snapshot()
        return {"requests_ok": ok, "requests_degraded": deg,
                "requests_failed": failed,
                "availability": round((ok + deg) / total, 6) if total
                else None,
                "failovers": failovers, "hedges": hedges,
                "failover_p99_ms": snap["p99"],
                "recoveries": len(rec),
                "recovery_s": round(max(rec), 3) if rec else None}

    # -- aggregation ops --

    def flush(self) -> int:
        """Drain every backend's dirty set (long deadline: a flush is a
        full re-score of the dirty frontier). Non-idempotent (expensive to
        double-start), so at-most-once per backend."""
        self._require_ready()
        total = 0
        for part in range(self.fleet.n_parts):
            for resp in self._fan_part_write(
                    part, {"op": "flush"}):
                total += int(resp.get("refreshed", 0))
        return total

    def snapshot_stats(self) -> dict:
        out: dict = {"ok": True, "n_nodes": self.n_nodes,
                     "parts": self.fleet.n_parts,
                     "router": True, "missing_parts": self.ready()}
        with self._lock:
            out.update(self.stats)
        if self.health_policy is not None:
            out["health"] = self.health_snapshot()
            out["wal_depth"] = self.wal.snapshot()
            out["availability"] = self.availability()
        out["dirty"] = self._dirty_total()
        backends = []
        for part in range(self.fleet.n_parts):
            for replica in self.fleet.replicas_of(part):
                client = self.fleet.client(part, replica)
                if client is None:
                    continue
                try:
                    resp = client.request({"op": "stats"})
                except coord_mod.CoordTimeout:
                    continue
                if resp.get("ok"):
                    resp["backend"] = f"p{part}.r{replica}"
                    backends.append(resp)
        out["backends"] = backends
        # router-side route-latency percentiles under the single-host
        # server's keys
        for t in ("A", "B"):
            snap = self._lat[t].snapshot()
            out[f"tier_{t.lower()}_p50_ms"] = snap["p50"]
            out[f"tier_{t.lower()}_p99_ms"] = snap["p99"]
        return out

    def metrics(self) -> dict:
        """Router registry + nested per-backend registry snapshots."""
        per_backend: dict = {}
        for part in range(self.fleet.n_parts):
            for replica in self.fleet.replicas_of(part):
                client = self.fleet.client(part, replica)
                if client is None:
                    continue
                try:
                    resp = client.request({"op": "metrics"})
                except coord_mod.CoordTimeout:
                    continue
                if resp.get("ok"):
                    per_backend[f"p{part}.r{replica}"] = resp["metrics"]
        return {"ok": True, "metrics": self.registry.snapshot(),
                "backends": per_backend}

    def shutdown_fleet(self, log=None) -> int:
        """Forward shutdown to every backend (each drains, flushes its
        delta-log shard, and exits 0). Returns how many acknowledged."""
        n = 0
        for part in range(self.fleet.n_parts):
            for replica in self.fleet.replicas_of(part):
                resp = self._send_write(part, replica, {"op": "shutdown"},
                                        timeout_s=10.0)
                if resp is not None and resp.get("ok"):
                    n += 1
        return n

    def close(self):
        self._probe_halt.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=2.0)
        self.fleet.close()


# ----------------------------------------------------------------------------
# TCP front end
# ----------------------------------------------------------------------------

class RouterServer:
    """Line-JSON dispatcher over a RouterCore — same framing, drain
    discipline and in-flight accounting as serve.ServeServer."""

    # ops that stay answerable while draining, or before the fleet is
    # complete (registration must be possible before readiness, by
    # definition)
    ALWAYS = ("ping", "stats", "metrics", "fleet", "register", "health")

    def __init__(self, core: RouterCore, port: int, addr: str = "",
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
            if self._draining and op not in self.ALWAYS:
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
        core = self.core
        if op == "ping":
            return {"ok": True, "router": True}
        if op == "register":
            reg = core.register_backend(req["part"], req.get("replica", 0),
                                        req.get("addr") or "127.0.0.1",
                                        req["port"],
                                        incarnation=req.get("incarnation"))
            missing = core.ready()
            self.log(f"[router] registered backend {reg['id']} at "
                     f"{req.get('addr') or '127.0.0.1'}:{req['port']}"
                     + (f" (waiting on parts {missing})" if missing
                        else " (fleet complete)"))
            return {"ok": True, "id": reg["id"], "missing_parts": missing,
                    "state": reg["state"]}
        if op == "health":
            return {"ok": True, "health": core.health_snapshot(),
                    "wal_depth": core.wal.snapshot(),
                    "availability": core.availability()}
        if op == "fleet":
            return {"ok": True, "parts": core.fleet_snapshot(),
                    "missing_parts": core.ready()}
        if op == "predict":
            return core.predict(req["node"], tier=req.get("tier"))
        if op == "predict_many":
            return {"ok": True, "results": core.predict_many(
                req["nodes"], tier=req.get("tier"))}
        if op == "add_edges":
            return core.add_edges(req["edges"])
        if op == "update_feat":
            return core.update_feat(req["node"], req["feat"])
        if op == "flush":
            return {"ok": True, "refreshed": core.flush()}
        if op == "dirty":
            core._require_ready()
            return {"ok": True, "count": core._dirty_total()}
        if op == "stats":
            return core.snapshot_stats()
        if op == "metrics":
            return core.metrics()
        if op == "shutdown":
            self.shutdown_requested.set()
            return {"ok": True}
        return {"ok": False, "err": f"unknown op {op!r}"}

    def drain(self, timeout_s: float = 30.0, stop: bool = True):
        """Reject new client ops, wait out in-flight handlers; `stop=False`
        keeps the listener up (the shutdown sequence still answers
        ping/stats while the backends drain behind it)."""
        with self._lock:
            self._draining = True
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._inflight == 0:
                    break
            time.sleep(0.01)
        if stop:
            self.server.stop()

    def stop(self):
        self.server.stop()


# ----------------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------------

def router_main(argv=None) -> int:
    """`python -m bnsgcn_tpu_torch.main serve-router ...`.

    Exit codes: 0 clean fleet shutdown (client 'shutdown' op, forwarded to
    every backend), 75 graceful SIGTERM/SIGINT drain (backends keep
    running; the orchestrator owns their lifecycle), 2 config error."""
    from bnsgcn_tpu_torch import resilience
    try:
        cfg = parse_config(argv, training=False)
    except ConfigError as ex:
        print(f"[config] {ex}", file=sys.stderr)
        return 2
    if not cfg.graph_name:
        cfg = cfg.replace(graph_name=cfg.derive_graph_name())
    log = print
    obs = obs_mod.make_obs(cfg, rank=0, log=log)
    try:
        part_dir = artifacts_dir(cfg)
        owner = load_owner_map(part_dir)
        n_parts_art = int(owner.max()) + 1
        n_parts = cfg.parts if cfg.parts > 0 else n_parts_art
        if n_parts != n_parts_art:
            raise ConfigError(
                f"--parts {n_parts} != the {n_parts_art} parts in the "
                f"artifacts at {part_dir} — the shard map comes from the "
                f"training partition; re-partition or drop --parts")
        if cfg.part_replicas < 1:
            raise ConfigError(f"--part-replicas must be >= 1, got "
                              f"{cfg.part_replicas}")
        # L-hop budget for the distributed dirty-mark BFS: the model's
        # graph-layer count (ModelSpec.n_graph_layers = n_layers - n_linear,
        # computed flag-side so the router stays torch-free), same hop budget
        # as the single-host forward_closure
        hops = cfg.n_layers - cfg.n_linear
        if hops < 1:
            raise ConfigError(f"--n-layers {cfg.n_layers} with --n-linear "
                              f"{cfg.n_linear} leaves no graph layer")
    except ConfigError as ex:
        print(f"[config] {ex}", file=sys.stderr)
        return 2

    # any self-healing knob flips on health tracking; all defaults off
    # keeps the evict-on-error protocol
    healing = (cfg.serve_probe_s > 0 or cfg.serve_degraded != "off"
               or cfg.serve_hedge == "on")
    core = RouterCore(owner, n_parts, replicas=cfg.part_replicas, hops=hops,
                      log=log, obs=obs,
                      health=HealthPolicy(cfg.serve_probe_s) if healing
                      else None,
                      degraded=cfg.serve_degraded,
                      hedge=cfg.serve_hedge == "on",
                      wal_cap=cfg.serve_wal_cap)
    core.start_probes()
    signals = resilience.PreemptSignals(
        action="drain in-flight routed requests",
        boundary="request boundary")
    signals.install()
    server = RouterServer(core, cfg.serve_port, cfg.serve_addr, log=log)
    log(f"[router] ready on port {server.port}: {n_parts} part(s) x "
        f"{cfg.part_replicas} replica(s), {core.n_nodes} nodes, "
        f"{hops}-hop dirty fan-out; waiting for backends to register")
    try:
        while signals.requested is None:
            if server.shutdown_requested.wait(0.05):
                break
    finally:
        clean = server.shutdown_requested.is_set()
        # drain ordering: stop taking client ops -> wait in-flight -> (on a
        # clean shutdown) forward shutdown so every backend flushes its
        # delta-log shard -> stop the listener
        server.drain(stop=False)
        acked = core.shutdown_fleet() if clean else 0
        server.stop()
        with core._lock:
            stats = dict(core.stats)
        log(f"[router] drained: {stats['requests']} request(s) routed "
            f"(A {stats['tier_a']} / B {stats['tier_b']}), "
            f"{stats['deltas']} delta(s) fanned out over "
            f"{stats['fanout_rpcs']} backend RPCs, "
            f"{stats['evictions']} eviction(s)"
            + (f", {acked} backend(s) shut down" if clean else ""))
        avail = core.availability() if healing else {}
        if healing and avail["availability"] is not None:
            log(f"[router] availability {avail['availability']:.4f} "
                f"(ok {avail['requests_ok']} / degraded "
                f"{avail['requests_degraded']} / failed "
                f"{avail['requests_failed']}), {avail['failovers']} "
                f"failover(s), {avail['recoveries']} recovery(ies)")
        if obs is not None:
            obs.emit("serve_fleet", parts=n_parts,
                     replicas=cfg.part_replicas, shutdown_acked=acked,
                     **{k: stats[k] for k in sorted(stats)},
                     **({"availability": avail["availability"],
                         "failover_p99_ms": avail["failover_p99_ms"],
                         "recovery_s": avail["recovery_s"]}
                        if healing else {}))
            obs.close()
        core.close()
        signals.restore()
    if signals.requested is not None:
        log(f"[router] {signals.requested} honored: backends keep serving; "
            f"relaunch the router to resume fronting them")
        return resilience.EXIT_PREEMPTED
    return 0


if __name__ == "__main__":
    sys.stdout.reconfigure(line_buffering=True)
    sys.exit(router_main())
