"""The port's partition-sharded serving fleet (bnsgcn_tpu_torch/
serve_router.py and serve_backend.py) in one process, on the CPU.

The laws of tests/test_serve_router.py on the port's classes: the owner
map from the partition artifacts, router endpoints, fleet registration and
round-robin, the CSR slices keeping the single-host edge order, unrouted
writes refused, a dead backend a named error within its deadline, drain
ordering, a 2-backend fleet bitwise the single-host server (tier A, tier B
on closures that cross the cut, a post-delta refresh, a feature update),
replicas answering the same bytes, compaction and relaunch from snapshot
plus tail, and the pooled client's reconnect.

The unit matrix of tests/test_serve_failover.py on the port's classes:
HealthState's every transition and the flap breaker, the bounded
DeltaWAL, the serve-fault grammar (resilience.ServeFaultPlan), degraded
answers, incarnation tokens, the health-filtered fleet map and the WAL
queueing of a write to a down part.

Held to the JAX package:
  * PartGraph against the JAX PartGraph on the same sbm graph and a random
    3-way owner map, before and after deltas: in_closure depths, in_nbrs,
    out_nbrs, feat_rows, degrees, export_rows, mutation_state and the halo
    counters, array-equal; the dirty-mark walk's reach and frontier equal;
  * a port fleet within 1e-5 of the JAX in-process fleet on one JAX
    checkpoint (tier A, tier B across the cut, after a delta and a flush);
  * the JAX package's RouterServer fronting two port BackendServers
    answers the port router's bits (the wire is the JAX package's).

The subprocess twins are in tests/test_torch_serve_fleet_e2e.py.
"""

import json
import os
import socket
import time
from functools import lru_cache
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from bnsgcn_tpu import checkpoint as j_ckpt
from bnsgcn_tpu import serve_backend as j_sb
from bnsgcn_tpu import serve_router as j_sr
from bnsgcn_tpu.config import Config as JConfig
from bnsgcn_tpu.data.graph import sbm_graph as j_sbm_graph
from bnsgcn_tpu.evaluate import full_graph_embeddings as j_embeddings
from bnsgcn_tpu.models.gnn import init_params as j_init_params
from bnsgcn_tpu.models.gnn import spec_from_config as j_spec_from_config
from bnsgcn_tpu_torch import resilience
from bnsgcn_tpu_torch import serve
from bnsgcn_tpu_torch import serve_backend as sb
from bnsgcn_tpu_torch import serve_router as sr
from bnsgcn_tpu_torch.config import Config, ConfigError
from bnsgcn_tpu_torch.data.graph import sbm_graph
from bnsgcn_tpu_torch.evaluate import full_graph_embeddings
from bnsgcn_tpu_torch.models.gnn import GNN, spec_from_config
from bnsgcn_tpu_torch.parallel import coord
from bnsgcn_tpu_torch.trainer import params_from_jax

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
_silent = lambda *a, **k: None  # noqa: E731


# ----------------------------------------------------------------------------
# shared fixture: one graph + model + full table, partitioned two ways
# ----------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _setup():
    """Both packages' 300-node sbm graph, a GCN 8 -> 8 -> 4 from the JAX
    draw of key(1) carried into the port's GNN, each package's full table,
    and a random 2-way owner map (tests/test_serve_router.py's)."""
    kw = dict(n_nodes=300, n_class=4, n_feat=8, seed=0)
    jg, g = j_sbm_graph(**kw), sbm_graph(**kw)
    common = dict(dataset="sbm", model="gcn", n_layers=2, n_hidden=8,
                  n_feat=g.n_feat, n_class=g.n_class, n_train=g.n_train,
                  serve_max_batch=16)
    jcfg, cfg = JConfig(**common), Config(**common)
    params, state = j_init_params(jax.random.key(1), j_spec_from_config(jcfg))
    spec = spec_from_config(cfg)
    net = GNN(spec)
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                        spec))
    net.eval()
    hidden, logits = full_graph_embeddings(net, g, CPU)
    rng = np.random.default_rng(7)
    owner = rng.integers(0, 2, size=g.n_nodes).astype(np.int32)
    owner[:2] = [0, 1]                      # both parts non-empty
    return SimpleNamespace(jg=jg, jcfg=jcfg, params=params, state=state,
                           g=g, cfg=cfg, net=net, hidden=hidden,
                           logits=logits, owner=owner)


class _Fleet2:
    """Two (or 2xR) real port backends behind a real router server, all
    in-process: TCP routing and fan-out as in production, tables sliced
    from ONE precomputed full table, so bitwise comparisons are against
    the rows the single-host core serves. `router` picks the package whose
    RouterCore and RouterServer front them (sr or j_sr)."""

    def __init__(self, replicas=1, serve_dir="", compact=0, router=sr,
                 net=None, hidden=None, logits=None):
        s = _setup()
        self.g, self.owner = s.g, s.owner
        net = s.net if net is None else net
        hidden = s.hidden if hidden is None else hidden
        logits = s.logits if logits is None else logits
        self.cfg = s.cfg.replace(part_replicas=replicas,
                                 serve_compact_deltas=compact)
        self.rcore = router.RouterCore(s.owner, 2, replicas=replicas, hops=2,
                                       log=_silent)
        self.router = router.RouterServer(self.rcore, 0, log=_silent)
        self.cores, self.servers, self.resolvers = [], [], []
        for part in (0, 1):
            for rep in range(replicas):
                c = sb.build_backend_core(
                    self.cfg.replace(serve_part=part, serve_replica=rep),
                    s.g, s.owner, net, log=_silent, hidden=hidden,
                    logits=logits)
                if serve_dir:
                    c.serve_dir = serve_dir
                    c.load_serving_state(serve_dir)
                srv = sb.BackendServer(c, 0, log=_silent)
                res = sb.PeerResolver("127.0.0.1", self.router.port)
                c.graph.resolver = res
                self.rcore.fleet.register(part, rep, "127.0.0.1", srv.port)
                self.cores.append(c)
                self.servers.append(srv)
                self.resolvers.append(res)

    def close(self):
        for srv in self.servers:
            srv.drain(timeout_s=2.0)
        for c in self.cores:
            c.close()
        for r in self.resolvers:
            r.close()
        self.router.drain(timeout_s=2.0)
        self.rcore.close()


def _ref_core():
    s = _setup()
    return serve.build_core(s.cfg, s.g, s.net, log=_silent, hidden=s.hidden,
                            logits=s.logits)


def _cross_edge(owner, k):
    u = int(np.flatnonzero(owner == 0)[k])
    v = int(np.flatnonzero(owner == 1)[k])
    return u, v


# ----------------------------------------------------------------------------
# ownership map from the training partition artifacts
# ----------------------------------------------------------------------------

def _write_parts(path, n_inner, gnids):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"n_parts": len(gnids), "n_inner": n_inner}, f)
    for p, ids in enumerate(gnids):
        np.savez(os.path.join(path, f"part{p}.npz"),
                 global_nid=np.asarray(ids, dtype=np.int64))


def test_load_owner_map_roundtrip(tmp_path):
    d = str(tmp_path / "parts")
    # padded global_nid rows (-1 tail) exactly as the artifacts write them
    _write_parts(d, [3, 2], [[4, 0, 2, -1], [1, 3, -1, -1]])
    owner = sr.load_owner_map(d)
    assert owner.tolist() == [0, 1, 0, 1, 0]
    assert np.array_equal(owner, j_sr.load_owner_map(d))


def test_load_owner_map_named_errors(tmp_path):
    with pytest.raises(ConfigError, match="no partition artifacts"):
        sr.load_owner_map(str(tmp_path / "nope"))
    d = str(tmp_path / "gap")
    _write_parts(d, [3, 2], [[4, 0, -1], [1, 3, -1]])     # node 2 unowned
    with pytest.raises(ConfigError, match="do not cover"):
        sr.load_owner_map(d)
    d = str(tmp_path / "dup")
    _write_parts(d, [3, 2], [[4, 0, 2], [1, 3, 2]])       # node 2 owned twice
    with pytest.raises(ConfigError, match="inconsistent"):
        sr.load_owner_map(d)


def test_router_endpoint_parsing():
    assert sr.router_endpoint(Config(serve_port=1234)) == ("127.0.0.1", 1234)
    assert sr.router_endpoint(Config(serve_router="h0:9")) == ("h0", 9)
    with pytest.raises(ConfigError):
        sr.router_endpoint(Config(serve_router="garbage"))


# ----------------------------------------------------------------------------
# fleet units: registration, round-robin, eviction
# ----------------------------------------------------------------------------

def test_fleet_registration_and_round_robin():
    f = sr.Fleet(2, 2)
    assert f.missing_parts() == [0, 1]
    assert f.pick(0) is None
    assert f.register(0, 0, "a", 1) == "p0.r0"
    assert f.register(0, 1, "a", 2) == "p0.r1"
    assert f.missing_parts() == [1]
    f.register(1, 0, "a", 3)
    assert f.missing_parts() == []
    # round-robin alternates the live replicas of part 0
    assert [f.pick(0) for _ in range(4)] == [0, 1, 0, 1]
    f.evict(0, 0)
    assert [f.pick(0) for _ in range(2)] == [1, 1]
    assert f.replicas_of(0) == [1]
    with pytest.raises(ValueError):
        f.register(2, 0, "a", 4)            # part out of range
    with pytest.raises(ValueError):
        f.register(0, 2, "a", 4)            # replica out of range
    f.close()


def test_part_graph_preserves_single_host_edge_order():
    """The owned-dst CSR slice is an order-preserving filter: every owned
    node's in- and out-neighbour lists are the single-host DynamicGraph's,
    the root of the tier-B bitwise contract."""
    s = _setup()
    dg = serve.DynamicGraph(s.g)
    pg = sb.PartGraph(s.g, s.owner, 0)
    own = np.flatnonzero(s.owner == 0)[:40]
    for v in own.tolist():
        assert pg.in_nbrs(v) == dg.in_nbrs(v)
        assert pg.out_nbrs(v) == dg.out_nbrs(v)
        assert pg.in_deg_of([v])[0] == dg.in_deg[v]
        assert pg.out_deg_of([v])[0] == dg.out_deg[v]
        assert np.array_equal(pg.feat_rows([v])[0], dg.feat[v])
    remote = int(np.flatnonzero(s.owner == 1)[0])
    with pytest.raises(serve.HaloCacheMiss):
        pg.in_nbrs(remote)                  # cache-only without a resolver
    with pytest.raises(ValueError, match="mis-routed"):
        pg.local_of(remote)


def test_backend_rejects_unrouted_writes():
    s = _setup()
    core = sb.build_backend_core(s.cfg.replace(serve_part=0), s.g, s.owner,
                                 s.net, log=_silent, hidden=s.hidden,
                                 logits=s.logits)
    try:
        with pytest.raises(ValueError, match="must route"):
            core.add_edges([[0, 1]])
        with pytest.raises(ValueError, match="must route"):
            core.update_feat(0, [0.0] * s.g.n_feat)
    finally:
        core.close()


# ----------------------------------------------------------------------------
# failure semantics: named error within the deadline, never a hang
# ----------------------------------------------------------------------------

def test_backend_down_is_named_error_not_hang():
    s = _setup()
    core = sr.RouterCore(s.owner, 2, hops=2, log=_silent,
                         route_timeout_s=1.0)
    with socket.socket() as sock:           # a port nothing listens on
        sock.bind(("127.0.0.1", 0))
        dead = sock.getsockname()[1]
    core.fleet.register(0, 0, "127.0.0.1", dead)
    core.fleet.register(1, 0, "127.0.0.1", dead)
    t0 = time.monotonic()
    with pytest.raises(sr.RouteError, match=r"part \d: no live backend"):
        core.predict(0)
    assert time.monotonic() - t0 < 10.0     # bounded by the route deadline
    with core._lock:
        assert core.stats["evictions"] >= 1
    # the dead backend was evicted -> the fleet is no longer ready, which
    # is itself a named error
    with pytest.raises(sr.RouteError, match="fleet not ready"):
        core.predict(0)
    core.close()


def test_router_not_ready_and_drain_ordering():
    s = _setup()
    core = sr.RouterCore(s.owner, 2, hops=2, log=_silent)
    server = sr.RouterServer(core, 0, log=_silent)
    try:
        port = server.port
        r = serve.request(port, {"op": "ping"})
        assert r["ok"] and r["router"]
        # reads before the fleet is complete: named error, not a hang
        r = serve.request(port, {"op": "predict", "node": 0})
        assert not r["ok"] and "fleet not ready" in r["err"]
        r = serve.request(port, {"op": "register", "part": 0, "replica": 0,
                                 "addr": "127.0.0.1", "port": 1})
        assert r["ok"] and r["id"] == "p0.r0" and r["missing_parts"] == [1]
        r = serve.request(port, {"op": "fleet"})
        assert r["ok"] and r["parts"]["0"][0]["id"] == "p0.r0"
        # drain ordering: client ops are refused first, while ping, stats
        # and register stay answerable (a late backend must still be able
        # to register mid-shutdown)
        server.drain(stop=False)
        assert not serve.request(port, {"op": "predict", "node": 0})["ok"]
        assert serve.request(port, {"op": "ping"})["ok"]
        assert serve.request(port, {"op": "stats"})["ok"]
        assert serve.request(port, {"op": "register", "part": 1,
                                    "replica": 0, "addr": "127.0.0.1",
                                    "port": 2})["ok"]
    finally:
        server.stop()
        core.close()


# ----------------------------------------------------------------------------
# the bitwise contract: 2 sharded backends == one single-host server
# ----------------------------------------------------------------------------

def test_two_backend_fleet_bitwise_vs_single_host():
    s = _setup()
    g, owner = s.g, s.owner
    ref = _ref_core()
    fleet = _Fleet2()
    try:
        # tier A: a routed lookup is the single-host table row, bitwise
        probe = [0, 1, 7, 123, g.n_nodes - 1]
        for v in probe:
            routed = fleet.rcore.predict(v)
            local = ref.predict(v)
            assert routed["tier"] == "A"
            assert routed["scores"] == local["scores"]
            assert routed["part"] == owner[v]
            assert routed["backend"] == f"p{owner[v]}.r0"
        many = fleet.rcore.predict_many(probe)
        assert [r["scores"] for r in many] == \
               [ref.predict(v)["scores"] for v in probe]

        # a cross-part edge delta: the apply fans to both owners, the mark
        # crosses the cut, tier-B closures need remote halo rows
        u, v = _cross_edge(owner, 3)
        edges = [[u, v], [v, u]]
        r = fleet.rcore.add_edges(edges)
        ref_r = ref.add_edges(edges)
        assert r["ok"]
        # the distributed mark covers exactly the single-host closure
        fleet_dirty = set()
        for c in fleet.cores:
            with c._lock:
                fleet_dirty |= c.dirty
        assert fleet_dirty == ref.dirty
        assert r["dirty_total"] == ref_r["dirty_total"]

        # tier B on dirty nodes, both sides of the cut: bitwise
        dirty_probe = sorted(ref.dirty)[:4] + [u, v]
        for w in set(dirty_probe):
            routed = fleet.rcore.predict(w)
            local = ref.predict(w)
            assert routed["tier"] == local["tier"] == "B", f"node {w}"
            assert routed["scores"] == local["scores"], f"node {w}"

        # the post-delta refresh: flush both, then tier A again, bitwise
        assert fleet.rcore.flush() == ref.flush()
        assert fleet.rcore._dirty_total() == 0
        for w in set(dirty_probe):
            routed = fleet.rcore.predict(w)
            local = ref.predict(w)
            assert routed["tier"] == local["tier"] == "A", f"node {w}"
            assert routed["scores"] == local["scores"], f"node {w}"

        # a feature update routes to the owner and dirties its closure
        newf = np.full(g.n_feat, 0.5, dtype=np.float32)
        fleet.rcore.update_feat(u, newf.tolist())
        ref.update_feat(u, newf)
        routed, local = fleet.rcore.predict(u), ref.predict(u)
        assert routed["tier"] == local["tier"] == "B"
        assert routed["scores"] == local["scores"]

        stats = fleet.rcore.snapshot_stats()
        assert stats["router"] and stats["parts"] == 2
        assert len(stats["backends"]) == 2
        assert {b["backend"] for b in stats["backends"]} == {"p0.r0", "p1.r0"}
        assert all("halo_fetches" in b and b["halo_bytes_in"] > 0
                   for b in stats["backends"])
    finally:
        fleet.close()
        ref.close()


def test_replica_read_consistency_and_delta_broadcast():
    """With 2 replicas a part, a routed delta reaches BOTH replicas and
    round-robined reads return the same bytes whichever replica answers."""
    s = _setup()
    fleet = _Fleet2(replicas=2)
    try:
        u, v = _cross_edge(s.owner, 5)
        fleet.rcore.add_edges([[u, v]])
        per_part: dict = {}
        for c in fleet.cores:
            with c._lock:
                per_part.setdefault(c.part, []).append(
                    (set(c.dirty), c.stats["deltas"]))
        for part, states in per_part.items():
            assert states[0] == states[1], f"part {part} replicas diverged"
        for w in (u, v):
            a = fleet.rcore.predict(w)
            b = fleet.rcore.predict(w)
            assert a["backend"] != b["backend"]
            assert a["scores"] == b["scores"] and a["tier"] == b["tier"]
        fleet.rcore.flush()
        for w in (u, v):
            a, b = fleet.rcore.predict(w), fleet.rcore.predict(w)
            assert a["backend"] != b["backend"]
            assert a["tier"] == b["tier"] == "A"
            assert a["scores"] == b["scores"]
    finally:
        fleet.close()


# ----------------------------------------------------------------------------
# delta-log compaction: snapshot + tail, the replay count drops on relaunch
# ----------------------------------------------------------------------------

def test_backend_compaction_snapshot_plus_tail_relaunch(tmp_path):
    s = _setup()
    serve_dir = str(tmp_path / "sdir")
    fleet = _Fleet2(serve_dir=serve_dir, compact=4)
    own0 = np.flatnonzero(s.owner == 0)
    try:
        # 6 routed deltas -> each backend journals >= 6 entries (apply and
        # mark shards) and compacts past the threshold of 4
        for i in range(6):
            fleet.rcore.add_edges([[int(own0[i]), int(own0[i + 1])]])
        back0 = next(c for c in fleet.cores if c.part == 0)
        with back0._lock:
            folded0, tail0 = back0._folded, len(back0.deltas)
        assert folded0 >= 4                     # compaction ran
        assert os.path.exists(os.path.join(serve_dir, back0._snapshot_name))
        assert back0._snapshot_name == "serve_snapshot.p0.r0.blob"
        expect_dirty = dict()
        for c in fleet.cores:
            with c._lock:
                expect_dirty[c.part] = set(c.dirty) | set(c._refreshing)
        fleet.rcore.close()                     # drop pooled reads first
        for srv in fleet.servers:
            srv.drain(timeout_s=2.0)
        for c in fleet.cores:
            c.flush_delta_log(serve_dir)
            c.close()
        assert os.path.exists(os.path.join(serve_dir,
                                           "delta_log.p1.r0.jsonl"))

        # relaunch both parts from the same serve dir: the snapshot holds
        # the folded deltas, the tail log replays the rest, and the dirty
        # sets come back exactly
        for part in (0, 1):
            c2 = sb.build_backend_core(
                s.cfg.replace(serve_part=part), s.g, s.owner, s.net,
                log=_silent, hidden=s.hidden, logits=s.logits)
            c2.serve_dir = serve_dir
            counts = c2.load_serving_state(serve_dir)
            try:
                if part == 0:
                    assert counts["folded"] == folded0
                    assert counts["replayed"] == tail0
                with c2._lock:
                    assert set(c2.dirty) == expect_dirty[part]
            finally:
                c2.close()
    finally:
        for r in fleet.resolvers:
            r.close()
        fleet.router.drain(timeout_s=2.0)


def test_pooled_client_survives_server_side_idle_drop():
    """LineJsonClient (the router's pooled read path) reconnects once on a
    torn pooled connection: an evicted pool entry looks like one
    transparent retry, not an error."""
    got = []

    def handler(req):
        got.append(req)
        return {"ok": True, "n": len(got)}

    srv = coord.LineJsonServer(0, handler).start()
    try:
        cli = coord.LineJsonClient("127.0.0.1", srv.port, timeout_s=5.0)
        assert cli.request({"op": "a"})["n"] == 1
        assert cli.request({"op": "b"})["n"] == 2   # same pooled connection
        # kill the server socket under the pooled client, then restart on
        # the SAME port: the retry path must reconnect
        port = srv.port
        srv.stop()
        srv = coord.LineJsonServer(port, handler).start()
        assert cli.request({"op": "c"})["ok"]
        sent, recv = cli.traffic()
        assert sent > 0 and recv > 0
        cli.close()
        with pytest.raises(coord.CoordTimeout, match="unreachable"):
            dead = coord.LineJsonClient("127.0.0.1", 1, timeout_s=0.5,
                                        what="nobody")
            dead.request({"op": "x"})
    finally:
        srv.stop()


# ----------------------------------------------------------------------------
# the failover unit matrix (tests/test_serve_failover.py)
# ----------------------------------------------------------------------------

def _policy(suspect_after=1, down_after=2, readmit=1, breaker_flaps=99,
            breaker_window_s=100.0, breaker_hold_s=5.0, spotcheck=1):
    """Every threshold pinned, immune to $BNSGCN_SERVE_* on the host."""
    pol = sr.HealthPolicy(0.0)
    pol.probe_timeout_s = 0.2
    pol.suspect_after = suspect_after
    pol.down_after = down_after
    pol.readmit = readmit
    pol.breaker_flaps = breaker_flaps
    pol.breaker_window_s = breaker_window_s
    pol.breaker_hold_s = breaker_hold_s
    pol.spotcheck = spotcheck
    pol.hedge_floor_ms = 0.0
    return pol


def test_health_up_suspect_down_thresholds():
    hs = sr.HealthState(_policy(suspect_after=2, down_after=3))
    assert hs.on_fail(1.0) is None and hs.state == "up"
    assert hs.on_fail(2.0) == "suspect"
    assert hs.on_fail(3.0) == "down"
    assert hs.down_since == 3.0


def test_health_suspect_recovers_to_up_without_warmup():
    hs = sr.HealthState(_policy(suspect_after=1, down_after=3, readmit=2))
    assert hs.on_fail(1.0) == "suspect"
    assert hs.on_ok(2.0) is None        # streak 1/2
    assert hs.on_ok(3.0) == "up"        # no warm-up gate: never left
    assert hs.state == "up" and hs.oks == 0


def test_health_ok_resets_fail_streak():
    hs = sr.HealthState(_policy(suspect_after=2, down_after=3))
    hs.on_fail(1.0)
    hs.on_ok(2.0)
    assert hs.on_fail(3.0) is None      # streak restarted, still up
    assert hs.state == "up"


def test_health_down_earns_ready_then_admit_reports_outage():
    hs = sr.HealthState(_policy(down_after=2, readmit=2))
    hs.on_fail(1.0)
    assert hs.on_fail(2.0) == "down"
    assert hs.on_ok(3.0) is None
    assert hs.on_ok(4.0) == "ready"     # warm-up gate before up
    assert hs.state == "down"           # ready is a verdict, not a state
    assert hs.admit(10.0) == pytest.approx(8.0)
    assert hs.state == "up" and hs.down_since is None


def test_health_reject_warmup_re_earns_whole_streak():
    hs = sr.HealthState(_policy(down_after=1, readmit=2))
    hs.on_fail(1.0)
    hs.on_ok(2.0)
    assert hs.on_ok(3.0) == "ready"
    hs.reject_warmup()                  # spot-check failed: stay down
    assert hs.state == "down"
    assert hs.on_ok(4.0) is None        # streak starts over
    assert hs.on_ok(5.0) == "ready"


def test_health_breaker_quarantines_flapping_backend():
    hs = sr.HealthState(_policy(down_after=1, readmit=1, breaker_flaps=2,
                                breaker_window_s=100.0, breaker_hold_s=5.0))
    assert hs.on_fail(1.0) == "down"    # flap 1
    assert hs.on_ok(2.0) == "ready"
    hs.admit(2.0)
    assert hs.on_fail(3.0) == "quarantined"   # flap 2 inside the window
    assert hs.hold_until == pytest.approx(8.0)
    assert hs.on_ok(4.0) is None        # breaker holds: successes ignored
    assert hs.state == "quarantined"
    assert hs.on_ok(9.0) == "ready"     # hold expired: resumes as down,
    assert hs.state == "down"           # must re-earn the streak + warm-up


def test_health_breaker_window_forgets_old_flaps():
    hs = sr.HealthState(_policy(down_after=1, readmit=1, breaker_flaps=2,
                                breaker_window_s=10.0))
    assert hs.on_fail(1.0) == "down"
    hs.on_ok(2.0)
    hs.admit(2.0)
    # the second flap lands OUTSIDE the window: plain down, no quarantine
    assert hs.on_fail(50.0) == "down"
    assert hs.state == "down"


def test_wal_orders_pending_per_replica_and_retires_full_entries():
    wal = sr.DeltaWAL(cap=8, slots=2)
    s1 = wal.record(0, {"op": "apply_feat", "node": 1}, taken={0})
    s2 = wal.record(0, {"op": "apply_delta", "edges": [[1, 2]]}, taken=set())
    assert s1 is not None and s2 == s1 + 1
    # replica 1 missed both, replica 0 only the second: commit order
    assert [op["op"] for _, op in wal.pending_for(0, 1)] == \
           ["apply_feat", "apply_delta"]
    assert [seq for seq, _ in wal.pending_for(0, 0)] == [s2]
    wal.mark_taken(0, 1, [s1])          # every slot took s1: it retires
    assert wal.depth(0) == 1
    assert wal.pending_for(0, 1) == [(s2, {"op": "apply_delta",
                                           "edges": [[1, 2]]})]
    wal.mark_taken(0, 0, [s2])
    wal.mark_taken(0, 1, [s2])
    assert wal.depth(0) == 0 and wal.snapshot() == {}
    assert wal.queued == 2
    assert wal.replayed == 3            # three per-replica confirmations


def test_wal_skips_fully_taken_and_bounds_per_part():
    wal = sr.DeltaWAL(cap=2, slots=2)
    assert wal.record(0, {"op": "mark"}, taken={0, 1}) is None
    assert wal.depth(0) == 0            # every slot took it: nothing queued
    wal.record(0, {"op": "a"}, taken=set())
    wal.record(0, {"op": "b"}, taken=set())
    with pytest.raises(sr.RouteError, match="WAL full"):
        wal.record(0, {"op": "c"}, taken=set())
    # the bound is per part: another part still has room
    assert wal.record(1, {"op": "c"}, taken=set()) is not None


def test_serve_fault_plan_targets_one_backend():
    plan = resilience.ServeFaultPlan.parse("servekill@3:p0.r1",
                                           part=0, replica=1)
    assert plan.faults == {"servekill": {3}}
    assert not plan.pop("servekill", 2)
    assert plan.pop("servekill", 3)
    assert not plan.pop("servekill", 3)     # fires exactly once
    assert plan.empty()
    # the same term scoped to a DIFFERENT backend parses to nothing
    other = resilience.ServeFaultPlan.parse("servekill@3:p0.r1",
                                            part=1, replica=0)
    assert other.empty()


def test_serve_fault_plan_servedrop_may_stay_fleet_wide():
    plan = resilience.ServeFaultPlan.parse("servedrop@2", part=1, replica=1)
    assert plan.pop("servedrop", 2)


def test_serve_fault_plan_ignores_training_terms():
    plan = resilience.ServeFaultPlan.parse("nan@E5,servedrop@2,sigterm@E3",
                                           part=0, replica=0)
    assert plan.faults == {"servedrop": {2}}
    # and the training parser skips (but validates) the serving terms
    assert resilience.FaultPlan.parse("nan@E5,servedrop@2").faults == \
        {"nan": {5}}


def test_serve_fault_plan_grammar_errors():
    with pytest.raises(ConfigError, match="needs an explicit"):
        resilience.ServeFaultPlan.parse("servekill@3")     # no target
    with pytest.raises(ValueError, match="bad --inject term"):
        resilience.ServeFaultPlan.parse("servehang@x:p0.r0")
    with pytest.raises(ValueError, match="backend target"):
        resilience.ServeFaultPlan.parse("servekill@3:r0.p0")


def _down_core(degraded):
    core = sr.RouterCore(np.zeros(4, dtype=np.int32), 1, replicas=1,
                         hops=1, log=_silent, route_timeout_s=0.5,
                         delta_timeout_s=0.5, health=_policy(),
                         degraded=degraded)
    core.register_backend(0, 0, "127.0.0.1", 1, incarnation="inc-A")
    core._note_fail(0, 0, "unit: process died")
    core._note_fail(0, 0, "unit: process died")
    assert core.health_snapshot()["p0.r0"] == "down"
    return core


def test_degraded_partial_answers_tagged_unavailable_rows():
    core = _down_core("partial")
    row = core.predict(2)
    assert row["ok"] is True and row["status"] == "unavailable"
    assert row["node"] == 2 and row["part"] == 0 and "err" in row
    rows = core.predict_many([0, 3])
    assert [r["node"] for r in rows] == [0, 3]
    assert all(r["status"] == "unavailable" for r in rows)
    assert core.stats["requests_degraded"] == 3
    assert core.stats["requests_failed"] == 0
    core.close()


def test_degraded_off_raises_and_counts_failed():
    core = _down_core("off")
    with pytest.raises(sr.RouteError, match="no live backend"):
        core.predict(0)
    assert core.stats["requests_failed"] == 1
    core.close()


def test_degraded_stale_ok_falls_back_to_unavailable_when_unreachable():
    core = _down_core("stale-ok")
    row = core.predict(1)
    assert row["ok"] is True and row["status"] == "unavailable"
    core.close()


def test_stale_incarnation_token_is_refused():
    core = _down_core("partial")
    # a respawn registers a fresh token: inc-A is retired, the slot
    # re-admitted (one replica: an empty WAL and no up peer pass warm-up)
    resp = core.register_backend(0, 0, "127.0.0.1", 2, incarnation="inc-B")
    assert resp["state"] == "up"
    with pytest.raises(sr.RouteError, match="stale incarnation"):
        core.register_backend(0, 0, "127.0.0.1", 3, incarnation="inc-A")
    # the zombie never displaced the live endpoint, and the CURRENT token
    # may register again (the same process reconnecting is no zombie)
    assert core.fleet.endpoint(0, 0)["port"] == 2
    core.register_backend(0, 0, "127.0.0.1", 2, incarnation="inc-B")
    core.close()


def test_fleet_snapshot_drops_down_replicas_unless_all_down():
    core = sr.RouterCore(np.zeros(4, dtype=np.int32), 1, replicas=2,
                         hops=1, log=_silent, route_timeout_s=0.5,
                         health=_policy(), degraded="partial")
    core.register_backend(0, 0, "127.0.0.1", 1, incarnation="a")
    core.register_backend(0, 1, "127.0.0.1", 2, incarnation="b")
    core._note_fail(0, 0, "unit")
    core._note_fail(0, 0, "unit")
    entries = core.fleet_snapshot()["0"]
    assert [e["replica"] for e in entries] == [1]   # down replica filtered
    core._note_fail(0, 1, "unit")
    core._note_fail(0, 1, "unit")
    entries = core.fleet_snapshot()["0"]
    # every replica down: the raw list stays so errors name dead backends
    assert sorted(e["replica"] for e in entries) == [0, 1]
    core.close()


def test_write_fanout_skips_down_replica_and_wal_queues():
    core = _down_core("partial")
    out = core.update_feat(0, [1.0, 2.0])           # the only replica is down
    assert out == {"ok": True, "dirty_new": 0, "dirty_total": 0}
    # both the feature write and its dirty-mark wave queued for the slot
    assert core.wal.depth(0) == 2
    assert core.wal.pending_for(0, 0)[0][1]["op"] == "apply_feat"
    assert core.stats["wal_queued"] == core.wal.queued == 2
    core.close()


# ----------------------------------------------------------------------------
# held to the JAX package
# ----------------------------------------------------------------------------

def _export_resolver(graphs):
    """An in-process resolver over the owners' PartGraphs: the rows their
    export_rows answer, parsed as a PeerResolver parses the wire's."""
    def resolve(part, ids):
        rows = json.loads(json.dumps(graphs[part].export_rows(ids)))
        return {int(k): {"feat": np.asarray(r["feat"], np.float32),
                         "in_deg": r["in_deg"], "out_deg": r["out_deg"],
                         "in": r["in"]} for k, r in rows.items()}
    return resolve


def test_part_graph_array_equal_to_jax():
    """The vectorized PartGraph against the JAX class on a 3-way random
    owner map, before and after an edge delta (its halo rows invalidated
    and fetched again) and a feature update."""
    kw = dict(n_nodes=300, n_class=4, n_feat=8, seed=0)
    jg, g = j_sbm_graph(**kw), sbm_graph(**kw)
    owner = np.random.default_rng(3).integers(0, 3, g.n_nodes
                                              ).astype(np.int32)
    owner[:3] = [0, 1, 2]
    jp = [j_sb.PartGraph(jg, owner, p) for p in range(3)]
    pp = [sb.PartGraph(g, owner, p) for p in range(3)]
    for graphs in (jp, pp):
        for x in graphs:
            x.resolver = _export_resolver(graphs)
    dg = serve.DynamicGraph(g)
    deltas = [[], [(5, 9), (9, 5), (0, 299), (1, 2), (1, 2)]]
    for step, edges in enumerate(deltas):
        dg.add_edges(edges)
        for a, b in zip(jp, pp):
            assert a.add_edges(edges) == b.add_edges(edges)
        if step:
            vec = np.linspace(0, 1, g.n_feat).astype(np.float32)
            p7 = int(owner[7])
            assert jp[p7].set_feat(7, vec) == pp[p7].set_feat(7, vec)
            dg.set_feat(7, vec)
            touched = sorted({u for e in edges for u in e} | {7})
            for a, b in zip(jp, pp):
                assert a.invalidate(touched) == b.invalidate(touched)
        for a, b in zip(jp, pp):
            for t, h in (([0], 2), ([7, 150], 2), ([3], 3), ([], 2)):
                a.prefetch(t, h)
                b.prefetch(t, h)
                depth = b.in_closure(t, h)
                assert a.in_closure(t, h) == depth == dg.in_closure(t, h)
                ids = np.asarray(sorted(depth), np.int64)
                assert np.array_equal(a.feat_rows(ids), b.feat_rows(ids))
                assert np.array_equal(a.in_deg_of(ids), b.in_deg_of(ids))
                assert np.array_equal(a.out_deg_of(ids), b.out_deg_of(ids))
                for v in ids.tolist():
                    assert a.in_nbrs(v) == b.in_nbrs(v) == dg.in_nbrs(v)
                inner = ids[[depth[v] <= h - 1 for v in ids.tolist()]] \
                    if ids.size else ids
                for x, y in zip(b.in_edges_of(inner), dg.in_edges_of(inner)):
                    assert np.array_equal(x, y)
            assert a.halo_stats() == {k: v for k, v in b.halo_stats().items()
                                      if k in a.halo_stats()}
            own = a.own_ids.tolist()
            assert a.export_rows(own) == b.export_rows(own)
            assert all(a.out_nbrs(v) == b.out_nbrs(v) for v in own)
            ja, pb = a.mutation_state(), b.mutation_state()
            assert sorted(ja) == sorted(pb)
            assert all(np.array_equal(ja[k], pb[k]) for k in ja)
            # the dirty-mark walk: JAX's stack walk and the port's levels
            seeds = [(int(v), 2) for v in own[:3]] + [(int(own[-1]), 1)]
            assert (j_sb.BackendCore._mark_walk_locked(
                SimpleNamespace(graph=a), seeds)
                == sb.BackendCore._mark_walk_locked(
                    SimpleNamespace(graph=b), seeds))
    fresh = sb.PartGraph(g, owner, 1)
    fresh.restore_mutations(pp[1].mutation_state())
    assert all(fresh.in_nbrs(v) == pp[1].in_nbrs(v)
               for v in pp[1].own_ids.tolist())


def _jax_fleet(s, hidden, logits):
    """The JAX package's in-process fleet (its test's _Fleet2) over the
    same JAX parameters and table."""
    rcore = j_sr.RouterCore(s.owner, 2, replicas=1, hops=2, log=_silent)
    router = j_sr.RouterServer(rcore, 0, log=_silent)
    cores, servers, resolvers = [], [], []
    for part in (0, 1):
        c = j_sb.build_backend_core(s.jcfg.replace(serve_part=part), s.jg,
                                    s.owner, s.params, s.state, log=_silent,
                                    hidden=hidden, logits=logits)
        srv = j_sb.BackendServer(c, 0, log=_silent)
        res = j_sb.PeerResolver("127.0.0.1", router.port)
        c.graph.resolver = res
        rcore.fleet.register(part, 0, "127.0.0.1", srv.port)
        cores.append(c)
        servers.append(srv)
        resolvers.append(res)

    def close():
        for srv in servers:
            srv.drain(timeout_s=2.0)
        for c in cores:
            c.close()
        for r in resolvers:
            r.close()
        router.drain(timeout_s=2.0)
        rcore.close()
    return rcore, cores, close


def test_fleet_within_tol_of_jax_fleet_on_a_jax_checkpoint(tmp_path):
    """One JAX checkpoint, served by the JAX in-process fleet and by a port
    fleet whose model serve.load_model read from that file: tier A, tier B
    across the cut, the dirty sets after a delta, and tier A after the
    flush, within 1e-5."""
    s = _setup()
    jc = s.jcfg.replace(ckpt_path=str(tmp_path), graph_name="fleet")
    j_ckpt.save_checkpoint(j_ckpt.final_path(jc), params=s.params,
                           bn_state=s.state, epoch=3, best_acc=0.5, seed=1)
    net, _, path = serve.load_model(
        s.cfg.replace(ckpt_path=str(tmp_path), graph_name="fleet"), CPU,
        log=_silent)
    assert path == j_ckpt.final_path(jc)
    hidden, logits = full_graph_embeddings(net, s.g, CPU)
    jhidden, jlogits = j_embeddings(s.params, s.state,
                                    j_spec_from_config(s.jcfg), s.jg)
    np.testing.assert_allclose(logits, np.asarray(jlogits), **TOL)
    jrouter, jcores, jclose = _jax_fleet(s, np.asarray(jhidden),
                                         np.asarray(jlogits))
    fleet = _Fleet2(net=net, hidden=hidden, logits=logits)
    try:
        probe = [0, 1, 7, 123, s.g.n_nodes - 1]
        for v in probe:
            a, b = fleet.rcore.predict(v), jrouter.predict(v)
            assert a["tier"] == b["tier"] == "A"
            assert (a["part"], a["backend"]) == (b["part"], b["backend"])
            np.testing.assert_allclose(a["scores"], b["scores"], **TOL)
        for v in (probe[2], probe[3]):
            a, b = (fleet.rcore.predict(v, tier="B"),
                    jrouter.predict(v, tier="B"))
            assert a["tier"] == b["tier"] == "B"
            np.testing.assert_allclose(a["scores"], b["scores"], **TOL)
        u, v = _cross_edge(s.owner, 4)
        a, b = (fleet.rcore.add_edges([[u, v], [v, u]]),
                jrouter.add_edges([[u, v], [v, u]]))
        assert a == b
        dirty = [set(c.dirty) for c in fleet.cores]
        assert dirty == [set(c.dirty) for c in jcores]
        for w in dict.fromkeys(sorted(dirty[0])[:2] + sorted(dirty[1])[:2]
                               + [u, v]):
            a, b = fleet.rcore.predict(w), jrouter.predict(w)
            assert a["tier"] == b["tier"] == "B"
            np.testing.assert_allclose(a["scores"], b["scores"], **TOL)
        assert fleet.rcore.flush() == jrouter.flush()
        many = fleet.rcore.predict_many(probe + [u, v])
        jmany = jrouter.predict_many(probe + [u, v])
        assert [r["tier"] for r in many] == [r["tier"] for r in jmany]
        np.testing.assert_allclose([r["scores"] for r in many],
                                   [r["scores"] for r in jmany], **TOL)
    finally:
        fleet.close()
        jclose()


def test_jax_router_fronts_port_backends_bitwise():
    """The wire is the JAX package's: its RouterServer, registering and
    fanning out to port BackendServers (whose PeerResolvers read its fleet
    map), answers the port router's fleet bit for bit, through a delta and
    a flush."""
    s = _setup()
    ours, theirs = _Fleet2(), _Fleet2(router=j_sr)
    try:
        probe = [0, 1, 7, 123, s.g.n_nodes - 1]
        u, v = _cross_edge(s.owner, 6)

        def drive(port):
            out = [serve.request(port, {"op": "predict_many",
                                        "nodes": probe})]
            out.append(serve.request(port, {"op": "predict", "node": 7,
                                            "tier": "B"}))
            out.append(serve.request(port, {"op": "add_edges",
                                            "edges": [[u, v], [v, u]]}))
            out += [serve.request(port, {"op": "predict", "node": w})
                    for w in (u, v)]
            out.append(serve.request(port, {"op": "flush"}))
            out.append(serve.request(port, {"op": "predict_many",
                                            "nodes": probe + [u, v]}))
            out.append(serve.request(port, {"op": "dirty"}))
            return out

        a, b = drive(ours.router.port), drive(theirs.router.port)
        assert all(x.get("ok", True) for x in a), a
        assert a == b
        assert a[3]["tier"] == "B" and a[-2]["results"][-1]["tier"] == "A"
        stats = serve.request(theirs.router.port, {"op": "stats"})
        assert {x["backend"] for x in stats["backends"]} == {"p0.r0",
                                                             "p1.r0"}
    finally:
        ours.close()
        theirs.close()


def test_halo_cache_holds_under_concurrent_prefetch_and_invalidate():
    """The halo arena shared by prefetching threads, invalidating threads
    and locked builds: 8 threads for ~1 s with a shortened switch interval,
    then every cached row is its owner's current row and the arena's
    counts agree (a lost update would break one of them)."""
    import sys
    import threading
    kw = dict(n_nodes=300, n_class=4, n_feat=8, seed=0)
    g = sbm_graph(**kw)
    owner = np.random.default_rng(4).integers(0, 3, g.n_nodes
                                              ).astype(np.int32)
    graphs = [sb.PartGraph(g, owner, p) for p in range(3)]
    for x in graphs:
        x.resolver = _export_resolver(graphs)
    pg, stop, errors = graphs[0], threading.Event(), []

    def prefetcher(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            t = rng.integers(0, g.n_nodes, 3).tolist()
            try:
                pg.prefetch(t, 2)
                depth = pg.in_closure_depths(t, 2)
                pg.feat_rows(np.flatnonzero(depth >= 0))
            except serve.HaloCacheMiss:
                pass                # an invalidation won the race: retried
            except Exception as ex:             # noqa: BLE001
                errors.append(ex)

    def invalidator(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            pg.invalidate(rng.integers(0, g.n_nodes, 20).tolist())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=prefetcher, args=(i,))
                   for i in range(5)]
        threads += [threading.Thread(target=invalidator, args=(10 + i,))
                    for i in range(3)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:3]
    cached = np.flatnonzero(pg._hslot >= 0)
    assert pg.halo_cached == cached.size == int(pg._hlive.sum())
    assert cached.size and (owner[cached] != 0).all()
    for v in cached.tolist():
        row = graphs[int(owner[v])].export_rows([v])[str(v)]
        assert pg.in_nbrs(v) == row["in"]
        assert pg.feat_rows([v])[0].tolist() == row["feat"]
        assert pg.in_deg_of([v])[0] == row["in_deg"]
