"""The port's serving fleet through its command lines (`python -m
bnsgcn_tpu_torch.main serve-router|serve-backend ... --device cpu`), in
subprocesses over real TCP, on one JAX checkpoint:

  * tests/test_serve_dist_e2e.py's contract: a router and 2 backends serve
    bitwise what the port's single-host core (in this process, the same
    checkpoint through serve.load_model) serves, for tier A, tier B on
    closures that cross the cut and after a delta's flush; one client
    `shutdown` ends the fleet, every process exits 0 and each backend's
    delta-log shard holds the delta;
  * tests/test_serve_failover.py's kill drill: 2 parts x 2 replicas behind a
    probing router in degraded 'partial' mode, p0.r0 dying hard at its 3rd
    data-path request (--inject servekill@3:p0.r0) under load with no
    client answer failed or degraded, a delta queued in the failover WAL
    while it is down, and the relaunched process rejoining through the WAL
    replay and the bitwise warm-up;
  * the exit codes of a signal: SIGTERM makes a backend flush its
    delta-log shard and exit 75, and the router exit 75 leaving its
    backends serving.

Every wait has a deadline of minutes, not seconds: the processes share a
loaded host with other test workers.
"""

import json
import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import torch

from bnsgcn_tpu import checkpoint as j_ckpt
from bnsgcn_tpu.config import Config as JConfig
from bnsgcn_tpu.models.gnn import init_params as j_init_params
from bnsgcn_tpu.models.gnn import spec_from_config as j_spec_from_config
from bnsgcn_tpu_torch import serve
from bnsgcn_tpu_torch.config import Config
from bnsgcn_tpu_torch.data.datasets import load_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
_silent = lambda *a, **k: None  # noqa: E731


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _setup_fleet_dirs(tmp_path):
    """One JAX checkpoint, partition artifacts (a random 2-way owner map
    over the sbm graph, in the artifacts' own format) and the flags every
    process launches with. Returns (args, g, cfg, owner)."""
    common = dict(dataset="sbm", model="graphsage", n_layers=2, n_hidden=8,
                  use_pp=True, seed=3, sampling_rate=1.0,
                  ckpt_path=str(tmp_path / "ckpt"),
                  part_path=str(tmp_path / "parts"))
    cfg = Config(**common)
    cfg = cfg.replace(graph_name=cfg.derive_graph_name())
    g, _, _ = load_data(cfg)
    cfg = cfg.replace(n_feat=g.n_feat, n_class=g.n_class, n_train=g.n_train)
    jcfg = JConfig(**common, graph_name=cfg.graph_name, n_feat=g.n_feat,
                   n_class=g.n_class, n_train=g.n_train)
    params, state = j_init_params(jax.random.key(3), j_spec_from_config(jcfg))
    j_ckpt.save_checkpoint(j_ckpt.final_path(jcfg), params=params,
                           bn_state=state, epoch=7, best_acc=0.5, seed=3)
    rng = np.random.default_rng(11)
    owner = rng.integers(0, 2, size=g.n_nodes).astype(np.int32)
    owner[:2] = [0, 1]
    part_dir = os.path.join(cfg.part_path, cfg.graph_name)
    os.makedirs(part_dir, exist_ok=True)
    gnids = [np.flatnonzero(owner == p).astype(np.int64) for p in (0, 1)]
    with open(os.path.join(part_dir, "meta.json"), "w") as f:
        json.dump({"n_parts": 2, "n_inner": [len(x) for x in gnids]}, f)
    for p, ids in enumerate(gnids):
        np.savez(os.path.join(part_dir, f"part{p}.npz"), global_nid=ids)
    args = ["--dataset", "sbm", "--model", "graphsage", "--n-layers", "2",
            "--n-hidden", "8", "--use-pp", "--fix-seed", "--seed", "3",
            "--device", "cpu", "--ckpt-path", str(tmp_path / "ckpt"),
            "--part-path", str(tmp_path / "parts")]
    return args, g, cfg, owner


def _ref_core(cfg, g):
    """The port's single-host server over the same checkpoint."""
    net, _, _ = serve.load_model(cfg, CPU, log=_silent)
    return serve.build_core(cfg, g, net, log=_silent)


def _spawn(subcmd, args, extra):
    cmd = [sys.executable, "-m", "bnsgcn_tpu_torch.main", subcmd] + args + \
        extra
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _dump(procs):
    out = []
    for name, p in procs:
        p.kill()
        try:
            out.append(f"--- {name} ---\n{p.stdout.read()[-3000:]}")
        except Exception:
            pass
    return "\n".join(out)


def _wait_fleet(rport, procs, replicas=1, deadline_s=300.0):
    """Until every backend has registered (`replicas` a part in the
    router's fleet map); a process that dies first fails the test with
    every process's output."""
    deadline = time.monotonic() + deadline_s
    while True:
        for name, p in procs:
            if p.poll() is not None:
                raise AssertionError(f"{name} died rc={p.returncode}:\n"
                                     f"{_dump(procs)}")
        try:
            r = serve.request(rport, {"op": "fleet"}, timeout_s=2.0)
            if r.get("ok") and all(len(r["parts"].get(str(p), ()))
                                   == replicas for p in (0, 1)):
                return
        except Exception:
            pass
        if time.monotonic() > deadline:
            raise AssertionError(f"fleet never ready:\n{_dump(procs)}")
        time.sleep(0.5)


def test_e2e_two_backend_fleet_bitwise_and_clean_shutdown(tmp_path):
    args, g, cfg, owner = _setup_fleet_dirs(tmp_path)
    rport = _free_port()
    router = _spawn("serve-router", args, ["--serve-port", str(rport)])
    procs = [("router", router)]
    backends = []
    try:
        for part in (0, 1):
            # --serve-refresh-s 0: a background refresh would race the
            # post-delta tier-B checks; the `flush` op drains instead
            b = _spawn("serve-backend", args,
                       ["--serve-part", str(part),
                        "--serve-router", f"127.0.0.1:{rport}",
                        "--serve-refresh-s", "0",
                        "--serve-dir", str(tmp_path / f"sdir{part}")])
            backends.append(b)
            procs.append((f"backend{part}", b))
        _wait_fleet(rport, procs)
        ref = _ref_core(cfg, g)
        try:
            probe = [0, 1, 17, 123, g.n_nodes - 1]
            for v in probe:
                r = serve.request(rport, {"op": "predict", "node": v})
                local = ref.predict(v)
                assert r["ok"] and r["tier"] == "A"
                assert r["scores"] == local["scores"], f"node {v}"
                assert r["part"] == owner[v]
            r = serve.request(rport, {"op": "predict_many", "nodes": probe})
            assert [x["scores"] for x in r["results"]] == \
                   [ref.predict(v)["scores"] for v in probe]

            # a cross-part delta: the apply fans to both owners, the mark
            # crosses the cut, tier-B closures pull remote halo rows
            u = int(np.flatnonzero(owner == 0)[4])
            w = int(np.flatnonzero(owner == 1)[4])
            r = serve.request(rport, {"op": "add_edges",
                                      "edges": [[u, w], [w, u]]},
                              timeout_s=120.0)
            ref_r = ref.add_edges([[u, w], [w, u]])
            assert r["ok"] and r["dirty_total"] == ref_r["dirty_total"]
            for v in (u, w):
                r = serve.request(rport, {"op": "predict", "node": v},
                                  timeout_s=120.0)
                local = ref.predict(v)
                assert r["tier"] == local["tier"] == "B", f"node {v}"
                assert r["scores"] == local["scores"], f"node {v}"

            # the post-delta refresh: drain the dirty frontier everywhere,
            # then tier A is bitwise again
            r = serve.request(rport, {"op": "flush"}, timeout_s=300.0)
            ref.flush()
            assert r["ok"]
            assert serve.request(rport, {"op": "dirty"})["count"] == 0
            for v in (u, w):
                r = serve.request(rport, {"op": "predict", "node": v})
                local = ref.predict(v)
                assert r["tier"] == local["tier"] == "A", f"node {v}"
                assert r["scores"] == local["scores"], f"node {v}"

            stats = serve.request(rport, {"op": "stats"})
            assert stats["router"] and len(stats["backends"]) == 2
            assert stats["deltas"] == 1 and stats["evictions"] == 0
            assert all(b["halo_fetches"] > 0 for b in stats["backends"])
        finally:
            ref.close()

        # one client op ends the fleet: the router forwards the shutdown,
        # every backend drains, flushes its delta-log shard and exits 0,
        # then the router exits 0
        serve.request(rport, {"op": "shutdown"})
        assert router.wait(timeout=120) == 0, _dump(procs)
        for part, b in enumerate(backends):
            assert b.wait(timeout=120) == 0, _dump(procs)
            log = os.path.join(str(tmp_path / f"sdir{part}"),
                               f"delta_log.p{part}.r0.jsonl")
            assert os.path.exists(log)      # the journaled delta survived
            with open(log) as f:
                assert any(json.loads(ln)["op"] == "apply_delta"
                           for ln in f if ln.strip())
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()


def test_e2e_servekill_failover_and_bitwise_rejoin(tmp_path, monkeypatch):
    """2 parts x 2 replicas behind a probing router in degraded 'partial'
    mode; p0.r0 dies hard (--inject servekill@3:p0.r0) under client load.
    No client answer fails or degrades (its peer replica covers), a delta
    landing during the outage queues in the failover WAL, and the
    relaunched process (a fresh incarnation) rejoins through the WAL
    replay and the warm-up; then both p0 replicas answer tier A bitwise."""
    args, g, cfg, owner = _setup_fleet_dirs(tmp_path)
    rport = _free_port()
    # the subprocesses inherit these: a backend is down after 2 failed
    # probes, and a probe waits 5 s (a live backend starved of the CPU by
    # other test workers must not look dead; a killed one refuses at once)
    monkeypatch.setenv("BNSGCN_SERVE_DOWN_AFTER", "2")
    monkeypatch.setenv("BNSGCN_SERVE_PROBE_TIMEOUT_S", "5")
    router = _spawn("serve-router", args,
                    ["--serve-port", str(rport), "--part-replicas", "2",
                     "--serve-degraded", "partial", "--serve-probe-s", "0.2"])
    procs = [("router", router)]

    def backend(part, rep, extra=()):
        b = _spawn("serve-backend", args,
                   ["--serve-part", str(part), "--serve-replica", str(rep),
                    "--serve-router", f"127.0.0.1:{rport}",
                    "--serve-dir", str(tmp_path / f"sdir{part}{rep}"),
                    *extra])
        procs.append((f"backend p{part}.r{rep}", b))
        return b

    victim = backend(0, 0, ["--inject", "servekill@3:p0.r0"])
    for part, rep in ((0, 1), (1, 0), (1, 1)):
        backend(part, rep)

    def req(payload, timeout_s=120.0):
        return serve.request(rport, payload, timeout_s=timeout_s)

    def bad_rows(resp):
        rows = resp["results"] if resp.get("ok") else [resp]
        return [x for x in rows
                if not x.get("ok") or x.get("status", "ok") != "ok"]

    try:
        # every replica registered before the kill: p0.r1 must be there
        # to cover p0.r0
        _wait_fleet(rport, procs, replicas=2)
        nodes = [int(n) for n in np.flatnonzero(owner == 0)[:5]] + \
                [int(n) for n in np.flatnonzero(owner == 1)[:5]]
        bad = []
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:      # load until the kill lands
            bad += bad_rows(req({"op": "predict_many", "nodes": nodes}))
            h = req({"op": "health"}, timeout_s=30.0)
            if h["health"].get("p0.r0") in ("down", "quarantined"):
                break
            time.sleep(0.1)
        else:
            raise AssertionError(f"p0.r0 never marked down:\n{_dump(procs)}")
        for _ in range(2):                      # failover keeps serving
            bad += bad_rows(req({"op": "predict_many", "nodes": nodes}))
        assert bad == [], f"client saw bad answers through the kill: {bad}"
        assert victim.wait(timeout=120) == 1    # os._exit(1), no drain

        # a delta lands during the outage: the WAL queues it for the slot
        r = req({"op": "add_edges",
                 "edges": [[nodes[0], nodes[5]], [nodes[5], nodes[0]]]},
                timeout_s=300.0)
        assert r.get("ok"), r
        h = req({"op": "health"}, timeout_s=30.0)
        assert sum(h["wal_depth"].values()) > 0

        # relaunch: a fresh incarnation, the WAL replay, the warm-up, up
        backend(0, 0)
        deadline = time.monotonic() + 300
        while True:
            h = req({"op": "health"}, timeout_s=30.0)
            if h["health"].get("p0.r0") == "up":
                break
            assert time.monotonic() < deadline, \
                f"rejoin stuck {h['health']}:\n{_dump(procs)}"
            time.sleep(0.5)
        assert sum(h["wal_depth"].values()) == 0    # cursor drained
        stats = req({"op": "stats"})
        assert stats["wal_replayed"] > 0
        assert h["availability"]["requests_failed"] == 0

        # the rejoined replica is bitwise: flush the dirty frontier, then
        # both p0 replicas answer the same tier-A scores directly
        assert req({"op": "flush"}, timeout_s=300.0)["ok"]
        p0 = req({"op": "fleet"})["parts"]["0"]
        assert len(p0) == 2
        for v in nodes[:5]:
            answers = [serve.request(e["port"],
                                     {"op": "predict", "node": v,
                                      "tier": "A"}, timeout_s=120.0)
                       for e in p0]
            assert all(a.get("ok") for a in answers), (v, answers)
            assert answers[0]["scores"] == answers[1]["scores"], f"node {v}"

        req({"op": "shutdown"}, timeout_s=60.0)
        assert router.wait(timeout=120) == 0, _dump(procs)
        for name, p in procs[1:]:
            if p is victim:
                continue
            assert p.wait(timeout=120) == 0, f"{name}:\n{_dump(procs)}"
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()


def test_e2e_sigterm_exits_75_with_the_shard_flushed(tmp_path):
    """SIGTERM to a backend: it drains, flushes its delta-log shard (the
    routed delta it journaled) and exits 75; SIGTERM to the router: 75,
    its backends left serving; the last backend's own `shutdown`: 0."""
    import signal
    args, g, cfg, owner = _setup_fleet_dirs(tmp_path)
    rport = _free_port()
    router = _spawn("serve-router", args, ["--serve-port", str(rport)])
    procs = [("router", router)]
    try:
        ports = {}
        for part in (0, 1):
            b = _spawn("serve-backend", args,
                       ["--serve-part", str(part),
                        "--serve-router", f"127.0.0.1:{rport}",
                        "--serve-refresh-s", "0",
                        "--serve-dir", str(tmp_path / "sdir")])
            procs.append((f"backend{part}", b))
        _wait_fleet(rport, procs)
        for e in serve.request(rport, {"op": "fleet"})["parts"].values():
            ports[e[0]["id"]] = e[0]["port"]
        u = int(np.flatnonzero(owner == 0)[2])
        w = int(np.flatnonzero(owner == 1)[2])
        assert serve.request(rport, {"op": "add_edges", "edges": [[u, w]]},
                             timeout_s=120.0)["ok"]
        b0 = procs[1][1]
        b0.send_signal(signal.SIGTERM)
        assert b0.wait(timeout=120) == 75, _dump(procs)
        with open(tmp_path / "sdir" / "delta_log.p0.r0.jsonl") as f:
            ops = [json.loads(ln)["op"] for ln in f if ln.strip()]
        assert "apply_delta" in ops and "mark" in ops
        router.send_signal(signal.SIGTERM)
        assert router.wait(timeout=120) == 75, _dump(procs)
        b1 = procs[2][1]
        assert b1.poll() is None            # left serving by the router
        assert serve.request(ports["p1.r0"], {"op": "ping"})["ok"]
        serve.request(ports["p1.r0"], {"op": "shutdown"})
        assert b1.wait(timeout=120) == 0, _dump(procs)
        assert (tmp_path / "sdir" / "delta_log.p1.r0.jsonl").exists()
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
