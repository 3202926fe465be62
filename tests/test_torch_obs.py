"""The port's telemetry bus (bnsgcn_tpu_torch/obs.py) and its wiring, against
the JAX package's (bnsgcn_tpu/obs.py), on the CPU:

  * the units of tests/test_obs.py (the serving ones excepted) on the port's
    module: the streaming histogram's error bound, registry snapshots, the
    event log's rank tag, rotation bound and strict JSON, the per-rank log
    path, make_obs under --obs off, post-mortem files, the degraded paths;
    EVENT_KINDS the JAX package's tuple;
  * one spawned group of 2 gloo ranks (the JAX tests' small sbm graph,
    GraphSAGE 2x8, rate 0.5, 8 epochs, log every 2): `--obs off` trains
    bitwise as `on`; a `nan@E5` run's log has the JAX package's log's kinds
    in its order, with the same keys and equal non-timing fields (the
    losses and norms within 1e-4 relative), beside the JAX run_training of
    the same config; tools/obs_report.py (the JAX package's) renders it;
  * SIGUSR1 under --obs on: a post-mortem snapshot and a `profile_request`
    event at the next step boundary, training on.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from bnsgcn_tpu import obs as j_obs
from bnsgcn_tpu.config import Config as JConfig
from bnsgcn_tpu.data.graph import sbm_graph as j_sbm_graph
from bnsgcn_tpu.run import run_training as j_run_training
from bnsgcn_tpu_torch import obs as obs_mod
from bnsgcn_tpu_torch.config import Config, parse_config
from bnsgcn_tpu_torch.data.graph import sbm_graph
from bnsgcn_tpu_torch.parallel.mesh import launch
from bnsgcn_tpu_torch.resilience import PreemptSignals
from bnsgcn_tpu_torch.run import (prepare_partition, prepare_rank,
                                  run_training, train_loop)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH = dict(n_nodes=240, n_class=3, n_feat=8, p_in=0.12, p_out=0.01, seed=3)
LOSS_RTOL = 1e-4


def _quiet(*a, **k):
    pass


def _report_tool():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import obs_report
    finally:
        sys.path.pop(0)
    return obs_report


# ----------------------------------------------------------------------------
# the units of tests/test_obs.py on the port's module
# ----------------------------------------------------------------------------

def test_event_kinds_are_the_jax_packages():
    assert obs_mod.EVENT_KINDS == j_obs.EVENT_KINDS


def test_histogram_known_quantiles():
    h = obs_mod.Histogram()
    vals = np.arange(1, 1001, dtype=np.float64)
    np.random.default_rng(0).shuffle(vals)
    for v in vals:
        h.observe(float(v))
    assert h.count == 1000 and h.vmin == 1.0 and h.vmax == 1000.0
    assert h.total == pytest.approx(float(vals.sum()))
    for q, exact in ((50, 500.0), (90, 900.0), (99, 990.0)):
        assert abs(h.percentile(q) - exact) <= 0.06 * exact
    j = j_obs.Histogram()
    for v in vals:
        j.observe(float(v))
    assert h.snapshot() == j.snapshot()


def test_histogram_empty_single_and_clamping():
    h = obs_mod.Histogram()
    assert h.percentile(50) == 0.0 and h.snapshot()["count"] == 0
    h.observe(3.7)
    assert h.percentile(50) == pytest.approx(3.7)
    assert h.percentile(99) == pytest.approx(3.7)
    h2 = obs_mod.Histogram()
    for v in (0.0, 1e9, float("nan"), float("inf")):
        h2.observe(v)
    assert h2.count == 2
    assert h2.percentile(1) == pytest.approx(0.0)
    assert h2.percentile(99) == pytest.approx(1e9)


def test_registry_snapshot_and_idempotent_instruments():
    r = obs_mod.Registry()
    c = r.counter("a/b")
    c.inc()
    c.inc(4)
    assert r.counter("a/b") is c
    r.gauge("g").set(2.5)
    r.histogram("h").observe(10.0)
    snap = r.snapshot()
    assert snap["counters"]["a/b"] == 5 and snap["gauges"]["g"] == 2.5
    assert snap["histograms"]["h"]["count"] == 1


def test_eventlog_emit_and_load_both_ways(tmp_path):
    path = str(tmp_path / "obs.jsonl")
    ev = obs_mod.EventLog(path, rank=3)
    ev.emit("epoch", epoch=1, loss=0.5)
    ev.emit("rollback", epoch=2, restart=1)
    ev.close()
    got = obs_mod.load_events(path)
    assert [e["kind"] for e in got] == ["epoch", "rollback"]
    assert all(e["rank"] == 3 and "ts" in e for e in got)
    assert j_obs.load_events(path) == got       # the JAX reader's view


def test_eventlog_rotation_bound(tmp_path):
    path = str(tmp_path / "obs.jsonl")
    ev = obs_mod.EventLog(path, max_bytes=2000)
    for i in range(300):
        ev.emit("epoch", epoch=i, loss=1.0 / (i + 1))
    ev.close()
    assert os.path.exists(path) and os.path.exists(path + ".1")
    assert os.path.getsize(path) + os.path.getsize(path + ".1") <= 4200
    got = obs_mod.load_events(path)
    assert len(got) >= 2 and got[0]["epoch"] < got[-1]["epoch"]


def test_eventlog_nan_is_strict_json(tmp_path):
    path = str(tmp_path / "obs.jsonl")
    ev = obs_mod.EventLog(path)
    ev.emit("rollback", loss=float("nan"), inf=float("inf"),
            nested={"v": float("nan")})
    ev.close()

    def no_const(_):
        raise AssertionError("non-strict JSON constant in event line")

    rec = json.loads(open(path).read().strip(), parse_constant=no_const)
    assert rec["loss"] == "nan" and rec["nested"]["v"] == "nan"


def test_rank_log_path_and_make_obs(tmp_path):
    assert obs_mod.rank_log_path("/x/o.jsonl", 0) == "/x/o.jsonl"
    assert obs_mod.rank_log_path("/x/o.jsonl", 2) == "/x/o.jsonl.r2"
    cfg = Config(obs="off", obs_log=str(tmp_path / "o.jsonl"))
    assert obs_mod.make_obs(cfg, log=_quiet) is None
    obs = obs_mod.make_obs(Config(obs_log=str(tmp_path / "o.jsonl")),
                           rank=1, log=_quiet)
    obs.emit("x")
    obs.close()
    assert os.path.exists(str(tmp_path / "o.jsonl.r1"))
    assert obs_mod.postmortem_dir(Config(ckpt_path="/c")) == os.path.join(
        "/c", "postmortem")
    assert obs_mod.postmortem_dir(Config(obs_dir="/d")) == "/d"


def test_obs_report_renders_nan_sanitized_records(tmp_path):
    obs_report = _report_tool()
    path = str(tmp_path / "div.jsonl")
    ev = obs_mod.EventLog(path)
    for e in range(3):
        ev.emit("epoch", epoch=e, loss=float("nan") if e else 1.2,
                step_s=0.01, comm_s=float("nan"), comm_tag="host")
    ev.emit("eval", epoch=2, val_acc=float("nan"))
    ev.close()
    s = obs_report.summarize(obs_report.load_run([path]))
    lines = []
    obs_report.render(s, write=lines.append)
    assert any("nan" in ln for ln in lines)
    obs_report.compare(s, s, path, path, write=lines.append)


def test_write_postmortem_failure_returns_empty():
    assert obs_mod.write_postmortem("/proc/nonexistent/pm", "t") == ""


def test_eventlog_unwritable_path_degrades_not_raises(capsys):
    ev = obs_mod.EventLog("/proc/nonexistent/obs.jsonl")
    ev.emit("epoch", epoch=0)
    ev.close()
    assert "telemetry log disabled" in capsys.readouterr().err


def test_eventlog_bad_max_mb_env_degrades(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("BNSGCN_OBS_MAX_MB", "64MB")
    ev = obs_mod.EventLog(str(tmp_path / "o.jsonl"))
    assert ev.max_bytes == 64 * 2 ** 20
    ev.emit("x")
    ev.close()
    assert "bad $BNSGCN_OBS_MAX_MB" in capsys.readouterr().err


def test_eventlog_emit_bounded_skips_on_held_lock(tmp_path):
    ev = obs_mod.EventLog(str(tmp_path / "o.jsonl"))
    ev.emit("a")
    assert ev._lock.acquire()
    try:
        t0 = time.monotonic()
        ev.emit_bounded("watchdog_fire", timeout_s=0.2)
        assert time.monotonic() - t0 < 2.0
    finally:
        ev._lock.release()
    ev.emit_bounded("b")
    ev.close()
    kinds = [e["kind"] for e in obs_mod.load_events(str(tmp_path / "o.jsonl"))]
    assert kinds == ["a", "b"]


def test_write_postmortem(tmp_path):
    r = obs_mod.Registry()
    r.counter("c").inc()
    path = obs_mod.write_postmortem(str(tmp_path / "pm"), "watchdog_E3",
                                    text="hung", registry=r)
    body = open(path).read()
    assert "hung" in body and "all-thread stacks" in body
    metrics = path.replace(".txt", "_metrics.json")
    assert json.load(open(metrics))["counters"]["c"] == 1


def test_cli_obs_flags_parse():
    cfg = parse_config(["--obs", "off", "--obs-log", "/tmp/x.jsonl",
                        "--obs-dir", "/tmp/pm"])
    assert (cfg.obs, cfg.obs_log, cfg.obs_dir) == ("off", "/tmp/x.jsonl",
                                                   "/tmp/pm")
    assert parse_config([]).obs == "on"


# ----------------------------------------------------------------------------
# SIGUSR1: the on-demand capture
# ----------------------------------------------------------------------------

def test_sigusr1_is_a_flag_taken_once():
    sig = PreemptSignals(profile=True).install()
    try:
        signal.raise_signal(signal.SIGUSR1)
        assert sig.take_profile_request() and not sig.take_profile_request()
        assert sig.requested is None            # training goes on
    finally:
        sig.restore()


def test_sigusr1_leaves_a_snapshot_and_an_event(tmp_path, monkeypatch):
    """P=1 with --obs-dir: SIGUSR1 during the run writes a post-mortem
    snapshot (stacks and metrics) and a `profile_request` event, and the
    run trains on to its end."""
    monkeypatch.setenv("BNSGCN_EPOCH_THROTTLE_S", "0.3")
    log = str(tmp_path / "obs.jsonl")
    cfg = Config(dataset="sbm", model="graphsage", n_partitions=1,
                 n_layers=2, n_hidden=8, use_pp=True, eval=False,
                 n_epochs=10, log_every=5, seed=7, device="cpu",
                 obs_log=log, obs_dir=str(tmp_path / "pm"),
                 part_path=str(tmp_path / "parts"),
                 ckpt_path=str(tmp_path / "ck"),
                 results_path=str(tmp_path / "res"))
    old = signal.signal(signal.SIGUSR1, lambda *a: None)
    done = threading.Event()

    def poke():
        # until the run's handler has taken one (an early one is swallowed
        # by the no-op handler above)
        while not done.wait(0.2):
            if any(e["kind"] == "profile_request"
                   for e in obs_mod.load_events(log)):
                return
            os.kill(os.getpid(), signal.SIGUSR1)

    t = threading.Thread(target=poke)
    t.start()
    try:
        res = run_training(cfg, g=sbm_graph(**GRAPH), log=_quiet)
    finally:
        done.set()
        t.join()
        signal.signal(signal.SIGUSR1, old)
    assert len(res.losses) == 10
    req = [e for e in obs_mod.load_events(log)
           if e["kind"] == "profile_request"]
    assert req and req[0]["snapshot"].startswith(str(tmp_path / "pm"))
    assert "all-thread stacks" in open(req[0]["snapshot"]).read()


# ----------------------------------------------------------------------------
# one spawned group of 2 ranks: off == on, and the JAX package's log
# ----------------------------------------------------------------------------

def _base(tmp, **kw):
    d = dict(dataset="sbm", model="graphsage", n_partitions=2, n_layers=2,
             n_hidden=8, sampling_rate=0.5, dropout=0.5, use_pp=True,
             eval=False, n_epochs=8, log_every=2, seed=7,
             part_path=str(tmp / "parts"), ckpt_path=str(tmp / "ckpt"),
             results_path=str(tmp / "res"))
    d.update(kw)
    return d


CASES = (("off", dict(obs="off")), ("on", dict(obs_log="on.jsonl")),
         ("nan5", dict(obs_log="nan5.jsonl", inject="nan@E5")))


def _rank_job(ctx, cfg, path, work):
    os.environ["BNSGCN_RETRY_BACKOFF_S"] = "0"
    pr = prepare_rank(ctx, cfg, path, None, _quiet)
    out = {}
    for name, kw in CASES:
        kw = dict(kw)
        if "obs_log" in kw:
            kw["obs_log"] = os.path.join(work, kw["obs_log"])
        c = pr.cfg.replace(ckpt_path=os.path.join(work, "ck_" + name), **kw)
        res, _ = train_loop(dataclasses.replace(pr, cfg=c), None, _quiet,
                            None, ctx)
        out[name] = res.losses
    return out


@pytest.fixture(scope="module")
def p2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs")
    old = os.environ.get("BNSGCN_RETRY_BACKOFF_S")
    os.environ["BNSGCN_RETRY_BACKOFF_S"] = "0"
    try:
        jlog = str(tmp / "jax.jsonl")
        jres = j_run_training(JConfig(**_base(
            tmp / "jax", comm_trace=False, obs_log=jlog, inject="nan@E5")),
            g=j_sbm_graph(**GRAPH), verbose=False)
        # no trace window on either side: the JAX run's comm_trace=False
        cfg = Config(**_base(tmp, device="cpu", dist_backend="gloo",
                             comm_trace=False))
        prepare_partition(cfg, sbm_graph(**GRAPH), load=False)
        path = os.path.join(cfg.part_path, cfg.derive_graph_name())
        work = str(tmp / "work")
        os.makedirs(work)
        ranks = launch(_rank_job, 2, [(cfg, path, work)] * 2, "gloo", "cpu",
                       log=_quiet, forward_signals=True)
    finally:
        if old is None:
            os.environ.pop("BNSGCN_RETRY_BACKOFF_S", None)
        else:
            os.environ["BNSGCN_RETRY_BACKOFF_S"] = old
    return dict(tmp=tmp, work=work, ranks=ranks, jlog=jlog, jres=jres)


def test_obs_off_is_bitwise_on(p2):
    for r in p2["ranks"]:
        assert r["off"] == r["on"] and len(r["on"]) == 8
    kinds = {e["kind"] for e in
             obs_mod.load_events(os.path.join(p2["work"], "on.jsonl"))}
    assert {"run_header", "epoch", "run_end"} <= kinds
    # rank 0 of the launch alone writes (its coordination rank's log)
    assert not os.path.exists(os.path.join(p2["work"], "on.jsonl.r1"))


# timing fields, and the exchange's seconds (the port's measured span, the
# JAX package's microbench)
TIMING = {"ts", "ms", "step_s", "comm_s", "comm_tag", "epoch_time_s",
          "comm_time_s", "reduce_time_s"}
CLOSE = {"loss", "param_norm", "final_loss"}


def test_the_log_is_the_jax_packages(p2):
    got = obs_mod.load_events(os.path.join(p2["work"], "nan5.jsonl"))
    want = j_obs.load_events(p2["jlog"])
    assert [e["kind"] for e in got] == [e["kind"] for e in want]
    for g, w in zip(got, want):
        assert set(g) - {"comm_s", "comm_tag"} == \
            set(w) - {"comm_s", "comm_tag"}, (g, w)
        for k in set(g) - TIMING:
            if k in CLOSE and g[k] != "nan":
                assert g[k] == pytest.approx(w[k], rel=LOSS_RTOL), (k, g, w)
            elif k == "step_hist":
                assert g[k].keys() == w[k].keys()
                assert g[k]["count"] == w[k]["count"]
            else:
                assert g[k] == w[k], (k, g, w)
    rb = [e for e in got if e["kind"] == "rollback"]
    assert rb[0]["source"].endswith("_3.ckpt") and rb[0]["loss"] == "nan"
    np.testing.assert_allclose(p2["ranks"][0]["nan5"], p2["jres"].losses,
                               rtol=LOSS_RTOL)


def test_obs_report_renders_the_ports_log(p2):
    log = os.path.join(p2["work"], "nan5.jsonl")
    env = dict(os.environ, PYTHONPATH=ROOT)
    rep = subprocess.run([sys.executable, "tools/obs_report.py", log],
                         capture_output=True, text=True, timeout=60,
                         cwd=ROOT, env=env)
    assert rep.returncode == 0, rep.stdout + rep.stderr
    assert "rollback" in rep.stdout and "per-epoch" in rep.stdout
    cmp_ = subprocess.run([sys.executable, "tools/obs_report.py",
                           "--compare", log, p2["jlog"]],
                          capture_output=True, text=True, timeout=60,
                          cwd=ROOT, env=env)
    assert cmp_.returncode == 0, cmp_.stdout + cmp_.stderr
    assert "mean step" in cmp_.stdout
