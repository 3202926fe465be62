"""The port's comm auto-tuner (bnsgcn_tpu_torch/tune.py, run.py's actuation)
against the JAX package's (bnsgcn_tpu/tune.py, tests/test_tune.py), on the
CPU.

  * unit parity on the same inputs: every grammar case of
    tests/test_tune.py:49-128 through both parse_schedule's (accepted and
    refused, with the same messages), validate_mode, startup_changes,
    reachable_lever_states and bench_schedule; decide() and Tuner (the
    schedule's boundaries, rewind and replay, restore, the auto history's
    JSON round trip) on the same synthetic streams with equal decisions;
    retune_strategy equal on the same n_b tables;
  * the CLI contract of tests/test_tune.py:446-578 through `python -m
    bnsgcn_tpu_torch.main` at P=2 over gloo with the JAX tests' BASE_ARGS:
    --tune off is bitwise the run without the flag; --tune off with a
    schedule exits 2 with the JAX words; K=4@0,K=2@4,K=1@7 under
    --strict-exec gives tune_decision epochs [0, 4, 7] with the JAX reasons,
    one `retune` halo refresh and the audit's (2 re-arms, 0 violations),
    which tools/obs_report.py renders; nan@E5 replays the K=2 move and two
    runs land bitwise-equal; the resume (slow, as the JAX one);
  * the same schedule with nan@E5 through bnsgcn_tpu.run.run_training and
    through the port: losses within 1e-4 relative, equal tune trails;
  * --tune auto at P=2 in one launch: rank 1's clock inflated, every rank
    applies rank 0's decisions; --tune auto with a coordinator exits 2
    with the JAX words; --tune-prior model stays refused by name.
"""

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from bnsgcn_tpu import tune as j_tune
from bnsgcn_tpu.config import Config as JConfig
from bnsgcn_tpu.config import ConfigError as JConfigError
from bnsgcn_tpu.parallel import halo as j_halo
from bnsgcn_tpu_torch import tune
from bnsgcn_tpu_torch.config import Config, ConfigError
from bnsgcn_tpu_torch.parallel import halo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4


# ----------------------------------------------------------------------------
# unit parity
# ----------------------------------------------------------------------------

GOOD = ["K=1@60, wire=bf16@30 ,K=4@0,K=2@30,mode=grad-only@0", "k=2@5", "",
        "  , ,", "strategy=ragged@3", "K=4@0,K=2@4,K=1@7",
        "strategy=shift@1,wire=int8@1,mode=exchange@2", "wire=fp8@0"]
BAD = ["K=4", "K@4", "K=4@x", "warp=9@0", "K=fast@0", "K=0@0", "K=4@-1",
       "mode=sometimes@0", "strategy=auto@0", "wire=int4@0",
       "K=4@2,k=2@2"]


@pytest.mark.parametrize("text", GOOD + BAD)
def test_parse_schedule_equals_the_jax_package(text):
    try:
        want = j_tune.parse_schedule(text)
    except JConfigError as e:
        with pytest.raises(ConfigError) as got:
            tune.parse_schedule(text)
        assert str(got.value) == str(e)
        return
    assert tune.parse_schedule(text) == want


MODES = [dict(tune="off"), dict(tune="schedule", tune_schedule="K=2@3"),
         dict(tune="auto"), dict(tune="off", tune_schedule="K=2@3"),
         dict(tune="schedule"), dict(tune="always"),
         dict(tune="auto", tune_prior="model"),
         dict(tune="schedule", tune_schedule="K=2@3", tune_prior="model")]


@pytest.mark.parametrize("kw", MODES)
@pytest.mark.parametrize("multi_host,coordinated",
                         [(False, False), (True, False), (False, True)])
def test_validate_mode_equals_the_jax_package(kw, multi_host, coordinated):
    def run(mod, cfg):
        try:
            mod.validate_mode(cfg, multi_host=multi_host,
                              coordinated=coordinated)
            return None
        except (ConfigError, JConfigError) as e:
            return str(e)
    assert run(tune, Config(**kw)) == run(j_tune, JConfig(**kw))


STARTS = [dict(tune="schedule", tune_schedule="K=4@0,K=1@9"),
          dict(tune="schedule", halo_refresh=4, tune_schedule="K=4@0,K=1@9"),
          dict(tune="schedule", tune_schedule="K=2@3"),
          dict(tune="schedule", tune_schedule="mode=grad-only@0,wire=bf16@0"),
          dict(tune="auto"), dict(tune="auto", halo_refresh=8),
          dict(tune="auto", halo_mode="grad-only"), dict(tune="off"),
          dict(tune="auto", halo_exchange="shift", halo_wire="int8")]


@pytest.mark.parametrize("kw", STARTS)
def test_startup_and_reachable_states_equal_the_jax_package(kw):
    assert tune.startup_changes(Config(**kw)) == \
        j_tune.startup_changes(JConfig(**kw))
    assert tune.reachable_lever_states(Config(**kw)) == \
        j_tune.reachable_lever_states(JConfig(**kw))


@pytest.mark.parametrize("n", [3, 8, 12, 100])
def test_bench_schedule_equals_the_jax_package(n):
    assert tune.bench_schedule(n) == j_tune.bench_schedule(n)


def test_constants_equal_the_jax_package():
    for name in ("LEVER_ALIASES", "VALID_VALUES", "TUNED_LEVERS",
                 "STALENESS_LADDER", "AUTO_WINDOW", "AUTO_HOLD",
                 "AUTO_COOLDOWN", "TIGHTEN_RTOL", "AUTO_COMM_FRAC",
                 "WIRE_ANNEAL"):
        assert getattr(tune, name) == getattr(j_tune, name), name


def _streams():
    rng = np.random.default_rng(5)
    flat = [1.0] * 40
    mixed = ([1.0] * 12 + [0.5, 0.4, 0.3, 0.25] + [0.25] * 12
             + [0.12, 0.1] + [0.1] * 12 + [0.1] * 20)
    noisy = list(np.cumprod(1 - rng.uniform(0, 0.04, 60)) * 3.0)
    improving = list(10.0 * 0.9 ** np.arange(30))
    return {"flat": flat, "mixed": mixed, "noisy": noisy,
            "improving": improving}


LEVER_STARTS = [
    {"halo_mode": "exchange", "halo_refresh": 4, "halo_exchange": "padded",
     "halo_wire": "native"},
    {"halo_mode": "grad-only", "halo_refresh": 1, "halo_exchange": "padded",
     "halo_wire": "bf16"},
    {"halo_mode": "exchange", "halo_refresh": 1, "halo_exchange": "ragged",
     "halo_wire": "native"}]


@pytest.mark.parametrize("stream", ["flat", "mixed", "noisy", "improving"])
@pytest.mark.parametrize("start", range(len(LEVER_STARTS)))
@pytest.mark.parametrize("comm", [0.0, 0.1, 0.6])
def test_decide_equals_the_jax_package_on_a_stream(stream, start, comm):
    """The same synthetic stream through both decide()s, each on its own
    AutoState and levers: the same decision at every epoch, and the same
    counters after."""
    alt = ("shift", "shift beats padded on bytes")
    st, jst = tune.AutoState(), j_tune.AutoState()
    lv, jlv = dict(LEVER_STARTS[start]), dict(LEVER_STARTS[start])
    for lo in _streams()[stream]:
        m = {"loss": lo, "step_s": 1.0, "comm_s": comm or None}
        st.observe(m)
        jst.observe(m)
        out = tune.decide(st, lv, strategy_alt=alt)
        jout = j_tune.decide(jst, jlv, strategy_alt=alt)
        assert out == jout
        if out is not None:
            lv.update(out[0])
            jlv.update(jout[0])
    assert dataclasses.asdict(st) == dataclasses.asdict(jst)


def _pair(mod, cfg_cls, **kw):
    cfg = cfg_cls(**kw)
    return mod.Tuner(cfg, levers=dict(LEVER_STARTS[0]), log=lambda *a: None)


@pytest.mark.parametrize("kw", [
    dict(tune="schedule", tune_schedule="K=4@0,K=2@3,K=1@6"),
    dict(tune="schedule", tune_schedule="K=4@0,K=2@4,K=1@7,wire=bf16@5"),
    dict(tune="auto", halo_refresh=4)])
def test_tuner_equals_the_jax_package(kw):
    """Decisions, rewind + replay, state_dict's JSON round trip and
    restore, step for step on both Tuners."""
    t, jt = _pair(tune, Config, **kw), _pair(j_tune, JConfig, **kw)
    start = ({"halo_refresh": 4}, "schedule@0" if kw["tune"] == "schedule"
             else "auto-start")
    assert t.record_startup(*start) == jt.record_startup(*start)
    for e in range(16):
        m = {"loss": 1.0 if e > 3 else 2.0 - 0.1 * e}
        assert t.on_epoch_end(e, m) == jt.on_epoch_end(e, m)
    assert t.levers == jt.levers and t.history == jt.history
    assert t.rewind(4) == jt.rewind(4)
    for e in range(4, 16):
        m = {"loss": 9.9}
        assert t.on_epoch_end(e, m) == jt.on_epoch_end(e, m)
    state = json.loads(json.dumps(t.state_dict()))
    assert state == json.loads(json.dumps(jt.state_dict()))
    r, jr = _pair(tune, Config, **kw), _pair(j_tune, JConfig, **kw)
    r.record_startup(*start)
    jr.record_startup(*start)
    assert r.restore(5, state) == jr.restore(5, state)
    assert (r.levers, r.max_seen, r.history) == (jr.levers, jr.max_seen,
                                                 jr.history)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("current", ["padded", "shift", "ragged"])
@pytest.mark.parametrize("rate", [0.1, 1.0])
def test_retune_strategy_equals_the_jax_package(seed, current, rate):
    rng = np.random.default_rng(seed)
    P = 4
    n_b = rng.integers(0, 400, (P, P)) * (rng.uniform(size=(P, P)) < 0.7)
    np.fill_diagonal(n_b, 0)
    pad_b = int(n_b.max()) + 8
    for allow in (True, False):
        got = halo.retune_strategy(n_b, 1000, pad_b, rate, current,
                                   allow_ragged=allow)
        want = j_halo.retune_strategy(n_b, 1000, pad_b, rate, current,
                                      allow_ragged=allow)
        assert got == want


# ----------------------------------------------------------------------------
# the CLI contract at P=2 (tests/test_tune.py:446-578)
# ----------------------------------------------------------------------------

BASE_ARGS = [
    "--dataset", "sbm", "--partition-method", "random", "--n-partitions", "2",
    "--model", "graphsage", "--n-layers", "2", "--n-hidden", "8",
    "--sampling-rate", "0.5", "--use-pp", "--n-epochs", "8",
    "--log-every", "2", "--no-eval", "--no-comm-trace",
    "--fix-seed", "--seed", "11", "--device", "cpu", "--dist-backend", "gloo",
]


def _env():
    env = dict(os.environ)
    env.update(BNSGCN_RETRY_BACKOFF_S="0", PYTHONPATH=REPO,
               JAX_PLATFORMS="cpu")
    return env


def _run(tmp_path, extra=(), timeout=240, parts=None):
    cmd = ([sys.executable, "-m", "bnsgcn_tpu_torch.main"] + BASE_ARGS
           + ["--part-path", str(parts or tmp_path / "parts"),
              "--ckpt-path", str(tmp_path / "ckpt"),
              "--results-path", str(tmp_path / "res")] + list(extra))
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, cwd=REPO, env=_env())


def _final_loss(stdout):
    m = re.search(r"RESULT final_loss=(\S+)", stdout)
    assert m, stdout[-2000:]
    return float(m.group(1))


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _trail(path):
    return [(e["epoch"], tuple(sorted(e["changes"].items())), e["reason"])
            for e in _events(path) if e["kind"] == "tune_decision"]


def _both(*jobs):
    """Two CLI runs side by side (each is a launcher and its 2 ranks)."""
    with ThreadPoolExecutor(len(jobs)) as pool:
        return [f.result() for f in [pool.submit(*j) for j in jobs]]


def test_cli_tune_off_is_bitwise_the_run_without_it(tmp_path):
    base, off = _both((_run, tmp_path / "a", (), 240, tmp_path / "pa"),
                      (_run, tmp_path / "b", ["--tune", "off"], 240,
                       tmp_path / "pb"))
    assert base.returncode == 0, base.stdout + base.stderr
    assert off.returncode == 0, off.stdout + off.stderr
    assert _final_loss(base.stdout) == _final_loss(off.stdout)
    assert "[tune]" not in off.stdout


def test_cli_tune_off_rejects_schedule_text(tmp_path):
    r = _run(tmp_path, ["--tune", "off", "--tune-schedule", "K=2@3"])
    assert r.returncode == 2, (r.returncode, r.stdout, r.stderr)
    assert "only read under --tune schedule" in (r.stdout + r.stderr)


@pytest.mark.parametrize("argv,words", [
    (["--tune", "auto", "--coord", "file", "--coord-world", "2",
      "--coord-rank", "0", "--skip-partition"], "single-process only"),
    (["--tune", "auto", "--tune-prior", "model"],
     "--tune-prior model is not ported yet"),
    (["--tune", "schedule"], "needs a --tune-schedule")])
def test_cli_refusals_exit_2(tmp_path, argv, words):
    r = _run(tmp_path, argv, timeout=120)
    assert r.returncode == 2, (r.returncode, r.stdout[-2000:], r.stderr)
    assert words in r.stdout + r.stderr


@pytest.fixture(scope="module")
def schedule_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sched")
    log = str(tmp / "obs.jsonl")
    r = _run(tmp, ["--n-epochs", "10", "--tune", "schedule",
                   "--tune-schedule", "K=4@0,K=2@4,K=1@7", "--strict-exec",
                   "--obs-log", log])
    return r, log


def test_cli_schedule_events_and_strict_audit(schedule_run):
    r, log = schedule_run
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[tune] schedule@0" in r.stdout
    assert re.search(r"\[tune\] epoch 4: schedule -> halo_refresh=2",
                     r.stdout), r.stdout[-4000:]
    assert re.search(r"\[tune\] epoch 7: schedule -> halo_refresh=1",
                     r.stdout), r.stdout[-4000:]
    evs = _events(log)
    hdr = next(e for e in evs if e["kind"] == "run_header")
    assert hdr["config"]["tune"] == "schedule"
    assert "K=2@4" in hdr["config"]["tune_schedule"]
    td = [e for e in evs if e["kind"] == "tune_decision"]
    assert [e["epoch"] for e in td] == [0, 4, 7], td
    assert [e["reason"] for e in td] == ["schedule@0", "schedule",
                                         "schedule"], td
    assert td[1]["changes"] == {"halo_refresh": 2}
    assert td[2]["changes"] == {"halo_refresh": 1}
    ref = [e["reason"] for e in evs if e["kind"] == "halo_refresh"]
    assert ref.count("retune") == 1, ref
    m = re.search(r"(\d+) retune re-arm\(s\), (\d+) violation\(s\)",
                  r.stdout)
    assert m, r.stdout[-4000:]
    assert (int(m.group(1)), int(m.group(2))) == (2, 0)
    se = next(e for e in evs if e["kind"] == "strict_exec")
    assert se["violations"] == 0 and se["rearms"] == 2
    assert se["variants"] == ["cached", "full", "step"]
    assert sum(se["steps"].values()) == 10 and se["fetches"] >= 10


def test_cli_schedule_renders_in_obs_report(schedule_run):
    _, log = schedule_run
    env = _env()
    rep = subprocess.run([sys.executable, "tools/obs_report.py", log],
                         capture_output=True, text=True, timeout=60,
                         cwd=REPO, env=env)
    assert rep.returncode == 0, rep.stdout + rep.stderr
    assert "tune schedule (3 applied decision(s))" in rep.stdout
    cmp_ = subprocess.run([sys.executable, "tools/obs_report.py",
                           "--compare", log, log], capture_output=True,
                          text=True, timeout=60, cwd=REPO, env=env)
    assert cmp_.returncode == 0, cmp_.stdout + cmp_.stderr
    assert "retuned the comm stack mid-run" in cmp_.stdout


def test_cli_rollback_replays_schedule_deterministically(tmp_path):
    losses, trails = [], []
    runs = _both(*[(_run, tmp_path / f"r{i}", [
        "--tune", "schedule", "--tune-schedule", "K=4@0,K=2@5",
        "--inject", "nan@E5", "--obs-log", str(tmp_path / f"obs{i}.jsonl")])
        for i in (0, 1)])
    for i, r in enumerate(runs):
        log = str(tmp_path / f"obs{i}.jsonl")
        assert r.returncode == 0, r.stdout + r.stderr
        kinds = [e["kind"] for e in _events(log)]
        assert "rollback" in kinds
        trail = _trail(log)
        reasons = [t[2] for t in trail]
        assert "rollback" in reasons and "replay" in reasons, trail
        rep = next(t for t in trail if t[2] == "replay")
        assert rep == (5, (("halo_refresh", 2),), "replay"), trail
        losses.append(_final_loss(r.stdout))
        trails.append(trail)
    assert losses[0] == losses[1], losses
    assert trails[0] == trails[1], trails


@pytest.mark.slow
def test_cli_resume_continues_the_schedule(tmp_path):
    interrupted = _run(tmp_path, ["--n-epochs", "10", "--tune", "schedule",
                                  "--tune-schedule", "K=4@0,K=2@2,K=1@7",
                                  "--inject", "sigterm@E3"])
    assert interrupted.returncode == 75, (interrupted.returncode,
                                          interrupted.stderr[-2000:])
    losses = []
    for i in (0, 1):
        ck = str(tmp_path / f"ck_resume{i}")
        shutil.copytree(str(tmp_path / "ckpt"), ck)
        log = str(tmp_path / f"obs_resume{i}.jsonl")
        r = _run(tmp_path, ["--n-epochs", "10", "--tune", "schedule",
                            "--tune-schedule", "K=4@0,K=2@2,K=1@7",
                            "--resume", "--skip-partition",
                            "--ckpt-path", ck, "--obs-log", log])
        assert r.returncode == 0, r.stdout + r.stderr
        assert "Resumed from" in r.stdout
        trail = _trail(log)
        assert any(t[2] == "resume" and ("halo_refresh", 2) in t[1]
                   for t in trail), trail
        assert any(t[0] == 7 and ("halo_refresh", 1) in t[1]
                   for t in trail), trail
        losses.append(_final_loss(r.stdout))
    assert losses[0] == losses[1], losses


# ----------------------------------------------------------------------------
# held to the JAX package, and the auto rank agreement (one group of 2)
# ----------------------------------------------------------------------------

GRAPH = dict(n_nodes=240, n_class=3, n_feat=8, p_in=0.12, p_out=0.01, seed=3)


def _base(tmp, **kw):
    d = dict(dataset="sbm", model="graphsage", n_partitions=2, n_layers=2,
             n_hidden=8, sampling_rate=0.5, dropout=0.5, use_pp=True,
             eval=False, n_epochs=8, log_every=2, seed=7,
             part_path=str(tmp / "parts"), graph_name="sbm-tune",
             ckpt_path=str(tmp / "ckpt"), results_path=str(tmp / "res"),
             comm_trace=False)
    d.update(kw)
    return d


SCHED = dict(tune="schedule", tune_schedule="K=4@0,K=2@5", inject="nan@E5")


def _quiet(*a, **k):
    pass


def _slow_clock(pr):
    """Rank hook: rank 1's exchange clock reads a hundredfold, so its own
    comm share would cross AUTO_COMM_FRAC where rank 0's need not."""
    import time as time_mod
    import types

    from bnsgcn_tpu_torch.parallel import mesh
    if pr.world.rank == 1:
        real = time_mod.perf_counter
        fake = types.ModuleType("time")
        fake.__dict__.update(time_mod.__dict__)
        fake.perf_counter = lambda: real() * 100.0
        mesh.time = fake
    return None


@pytest.fixture(scope="module")
def p2(tmp_path_factory):
    """The scheduled nan@E5 run through both packages' run_training (the
    port's launcher folds the schedule's epoch-0 entry, as the JAX one
    does), then --tune auto through the port's with rank 1's clock
    inflated."""
    from bnsgcn_tpu.data.graph import sbm_graph as j_sbm_graph
    from bnsgcn_tpu.run import run_training as j_run_training
    from bnsgcn_tpu_torch.data.graph import sbm_graph
    from bnsgcn_tpu_torch.run import run_training
    tmp = tmp_path_factory.mktemp("tune")
    old = os.environ.get("BNSGCN_RETRY_BACKOFF_S")
    os.environ["BNSGCN_RETRY_BACKOFF_S"] = "0"
    obs = str(tmp / "jax_obs.jsonl")
    try:
        jr = j_run_training(JConfig(**_base(
            tmp / "jax", obs_log=obs, **SCHED)), g=j_sbm_graph(**GRAPH),
            verbose=False)
        g = sbm_graph(**GRAPH)
        sched = run_training(Config(**_base(
            tmp, device="cpu", dist_backend="gloo", **SCHED)), g=g,
            log=_quiet)
        auto = run_training(Config(**_base(
            tmp, device="cpu", dist_backend="gloo", tune="auto",
            n_epochs=16, ckpt_path=str(tmp / "ck_auto"))), g=g, log=_quiet,
            rank_hook=_slow_clock)
    finally:
        if old is None:
            os.environ.pop("BNSGCN_RETRY_BACKOFF_S", None)
        else:
            os.environ["BNSGCN_RETRY_BACKOFF_S"] = old
    return dict(jax=(jr.losses, _trail(obs)), sched=sched, auto=auto)


def test_schedule_with_rollback_equals_the_jax_package(p2):
    losses_j, trail_j = p2["jax"]
    assert [t[2] for t in trail_j] == ["schedule@0", "schedule", "rollback",
                                       "replay"], trail_j
    res = p2["sched"]
    assert len(res.losses) == len(losses_j) == 8
    np.testing.assert_allclose(res.losses, losses_j, rtol=LOSS_RTOL)
    for r in res.ranks:
        trail = [(d["epoch"], tuple(sorted(d["changes"].items())),
                  d["reason"]) for d in r["tune_decisions"]]
        assert trail == trail_j
    assert res.rollbacks and res.rollbacks[0]["restart"] == 4


def test_auto_every_rank_applies_rank0s_decisions(p2):
    r0, r1 = p2["auto"].ranks
    trail0 = [(d["epoch"], d["changes"], d["reason"])
              for d in r0["tune_decisions"]]
    trail1 = [(d["epoch"], d["changes"], d["reason"])
              for d in r1["tune_decisions"]]
    assert trail0 == trail1
    assert trail0[0][:2] == (0, {"halo_refresh": 4})
    assert trail0[0][2].startswith("auto-start")
    # rank 1's clock read its exchange a hundredfold longer than rank 0's
    assert sum(r1["comm_times"]) > 20 * sum(r0["comm_times"])
