"""The port's profiler window and trace parsing
(bnsgcn_tpu_torch/utils/traceparse.py, run.py's window) against the JAX
package's contract (tests/test_trace_comm.py:56-232), on the CPU.

  * synthetic torch.profiler events (each rank's file tagged with its
    rank): nested duplicate launches deduped, collectives attributed to
    the step that launched them (gloo's host ops, NCCL's kernels), the
    min over the ranks' lanes stripping the rendezvous wait, c10d's
    dispatch wrappers and the card's projections of host spans ignored, a
    host collective past the step's end (the boundary's agreement) in
    `other`, the hidden exchange of --overlap split, no fabricated column
    without exchange events, comm_by_axis;
  * the same parse over a real trace: --profile-dir at P=2 writes each
    rank's rank_<g>.json, emits `trace` with comm_s > 0 and prints
    `[traced]` after the window, and with --overlap split `overlap`; SIGUSR1
    emits `profile_request` with its trace_dir and `profile`, and re-arms
    the comm-trace window it swallowed; --no-comm-trace writes no trace,
    and the default window leaves no temporary directory behind.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from bnsgcn_tpu_torch.utils import traceparse as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ev(rank, name, ts, dur, cat="user_annotation", tid=1):
    return {"ph": "X", "cat": cat, "name": name, "pid": 100 + rank,
            "tid": tid, "ts": ts, "dur": dur, "rank": rank}


def make_trace():
    """Two ranks, two steps each (launch spans doubled ~1 us apart), then
    one exchange_only sweep of two fires; per step one gloo all-to-all per
    rank with asymmetric wait (rank 0 waits: 50; rank 1 arrives last: 10)
    on gloo worker threads, and one all-reduce."""
    ev = []
    for r in (0, 1):
        for t in (1000.0, 1000.5, 5000.0, 5000.5):
            ev.append(_ev(r, "train_step", t, 300))
        for t in (9000.0, 9000.2, 9500.0, 9500.2):
            ev.append(_ev(r, "exchange_only", t, 100))
    for t0 in (1100.0, 5100.0):
        ev.append(_ev(0, "gloo:all_to_all", t0, 50, tid=7))
        ev.append(_ev(1, "gloo:all_to_all", t0 + 40, 10, tid=8))
        ev.append(_ev(0, "gloo:all_reduce", t0 + 60, 7, tid=9))
        ev.append(_ev(1, "gloo:all_reduce", t0 + 60, 7, tid=7))
    for t0 in (9010.0, 9510.0):
        ev.append(_ev(0, "gloo:all_to_all", t0, 20))
        ev.append(_ev(1, "gloo:all_to_all", t0 + 15, 5))
    # a collective before any launch lands in "other"
    ev.append(_ev(0, "gloo:all_gather", 10.0, 3))
    return ev


def test_launch_dedup_and_sweeps():
    attr = tp.attribute(make_trace())
    assert attr["train_step"]["launches"] == 2
    assert attr["exchange_only"]["launches"] == 2
    assert attr["exchange_only"]["sweeps"] == 1


def test_attribution_categories():
    attr = tp.attribute(make_trace())
    raw, _, nev, nl = tp.program_cost(attr["train_step"], "exchange")
    assert nl == 2 and nev == 2          # 2 steps x 1 a2a per rank
    assert raw == 2 * (50 + 10)
    rraw, _, _, _ = tp.program_cost(attr["train_step"], "reduce")
    assert rraw == 2 * (7 + 7)
    oraw, _, _, _ = tp.program_cost(attr["other"], "reduce")
    assert oraw == 3
    mraw, _, mev, _ = tp.program_cost(attr["exchange_only"], "exchange")
    assert mev == 2 and mraw == 2 * (20 + 5)


def test_min_over_lanes_strips_waiter():
    attr = tp.attribute(make_trace())
    _, est, _, _ = tp.program_cost(attr["train_step"], "exchange")
    assert est == 2 * 10
    _, mest, _, _ = tp.program_cost(attr["exchange_only"], "exchange")
    assert mest == 2 * 5


def test_dispatch_wrappers_and_projections_ignored():
    """c10d's dispatch ops, record_param_comms and the card's projection
    of a gloo span carry no collective of their own."""
    ev = make_trace()
    ev.append(_ev(0, "c10d::alltoall_base_", 1200.0, 999, cat="cpu_op"))
    ev.append(_ev(0, "record_param_comms", 1200.0, 999, cat="cpu_op"))
    ev.append(_ev(0, "gloo:all_to_all", 1150.0, 999,
                  cat="gpu_user_annotation"))
    attr = tp.attribute(ev)
    raw, _, _, _ = tp.program_cost(attr["train_step"], "exchange")
    assert raw == 2 * (50 + 10)


def test_host_collectives_past_the_step_are_other():
    """The step boundary's agreement (gloo's all-reduce after the step
    span ended) belongs to no step; a device kernel after its launch's
    span (the card runs behind) still does."""
    ev = make_trace()
    ev.append(_ev(0, "gloo:all_reduce", 1400.0, 4))
    ev.append(_ev(1, "ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", 1400.0,
                  6, cat="kernel"))
    attr = tp.attribute(ev)
    oraw, _, _, _ = tp.program_cost(attr["other"], "reduce")
    assert oraw == 3 + 4
    lanes = attr["train_step"]["reduce"]
    assert (1, "device") in lanes and lanes[(1, "device")][0][1] == 6


def test_nccl_kernels_are_exchange_and_reduce():
    ev = [_ev(r, "train_step", 1000.0, 300) for r in (0, 1)]
    for r, d in ((0, 40), (1, 12)):
        ev.append(_ev(r, "ncclDevKernel_SendRecv(ncclDevComm*, unsigned "
                         "long, ncclWork*)", 1100.0, d, cat="kernel"))
        ev.append(_ev(r, "ncclKernel_AllGather_RING_LL_Sum_int8_t(x)",
                      1200.0, 5, cat="kernel"))
    ex_s, rd_s, steps = tp.step_comm_from_events(ev)
    assert steps == 1 and abs(ex_s - 12e-6) < 1e-12 and abs(rd_s - 5e-6) < 1e-12


def test_overlap_report_detects_hidden_exchange():
    ev = [_ev(0, "train_step", 1000.0, 300),
          _ev(0, "gloo:all_to_all", 1100.0, 80, tid=7),
          _ev(0, "interior_agg", 1120.0, 100),
          _ev(0, "frontier_agg", 1230.0, 40)]
    rep = tp.overlap_from_events(ev)
    assert rep is not None and rep["n_steps"] == 1
    assert abs(rep["exchange_ms"] - 0.080) < 1e-9
    assert abs(rep["interior_ms"] - 0.100) < 1e-9
    assert abs(rep["frontier_ms"] - 0.040) < 1e-9
    assert abs(rep["hidden_ms"] - 0.060) < 1e-9
    assert rep["overlapped"]
    # on a card the phases' device projections give their own time
    dev = ev + [_ev(0, "interior_agg", 1125.0, 50, cat="gpu_user_annotation")]
    assert abs(tp.overlap_from_events(dev)["interior_ms"] - 0.050) < 1e-9
    # serialized schedule (exchange fully before interior) -> not overlapped
    ev2 = [_ev(0, "train_step", 1000.0, 300),
           _ev(0, "gloo:all_to_all", 1100.0, 80),
           _ev(0, "interior_agg", 1200.0, 100)]
    rep2 = tp.overlap_from_events(ev2)
    assert rep2 is not None and not rep2["overlapped"]
    assert rep2["hidden_ms"] == 0.0
    # a run without --overlap split: no phase spans, None
    assert tp.overlap_from_events(make_trace()) is None


def test_comm_by_axis():
    ev = make_trace()
    grp = _ev(0, "gloo:all_reduce", 1170.0, 11)
    grp["args"] = {"Process Group Ranks": "[0, 1, 2, 3, 4, 5, 6, 7]"}
    table = tp.comm_by_axis(ev + [grp], 4, 2)
    assert table["parts"]["exchange"] == 10 + 10 + 5 + 5
    assert table["replicas x parts"]["reduce"] > 0
    assert tp.classify_axis([[0, 1], [2, 3]], 2, 1, 2) == "feat"
    assert tp.classify_axis([[0, 2], [1, 3]], 2, 1, 2) == "parts"


def _write(d, rank, events):
    os.makedirs(d, exist_ok=True)
    with open(tp.trace_file(str(d), rank), "w") as f:
        json.dump({"traceEvents": [{k: v for k, v in e.items()
                                    if k != "rank"} for e in events]}, f)


def test_step_comm_per_epoch_none_without_exchange_events(tmp_path):
    _write(tmp_path / "a", 0, [_ev(0, "train_step", 1000.0, 300)])
    assert tp.step_comm_per_epoch(str(tmp_path / "a")) is None
    for r in (0, 1):
        _write(tmp_path / "b", r, [e for e in make_trace() if e["rank"] == r])
    ex_s, rd_s, steps = tp.step_comm_per_epoch(str(tmp_path / "b"))
    assert steps == 2
    assert abs(ex_s - 10e-6) < 1e-12 and abs(rd_s - 7e-6) < 1e-12
    assert tp.step_comm_per_epoch(str(tmp_path / "nope")) is None


# ---------------------------------------------------------------------------
# the window in real runs (P=2 over gloo, subprocesses run side by side)
# ---------------------------------------------------------------------------

BASE = ["--dataset", "sbm", "--partition-method", "random", "--n-partitions",
        "2", "--model", "graphsage", "--n-layers", "2", "--n-hidden", "8",
        "--sampling-rate", "0.5", "--use-pp", "--n-epochs", "8",
        "--log-every", "2", "--no-eval", "--fix-seed", "--seed", "11",
        "--device", "cpu", "--dist-backend", "gloo"]


def _env(tmp):
    env = dict(os.environ)
    env.update(PYTHONPATH=REPO, TMPDIR=str(tmp), BNSGCN_RETRY_BACKOFF_S="0")
    return env


def _cmd(tmp, name, extra):
    return ([sys.executable, "-m", "bnsgcn_tpu_torch.main"] + BASE
            + ["--part-path", str(tmp / "parts" / name),
               "--ckpt-path", str(tmp / name / "ck"),
               "--results-path", str(tmp / name / "res"),
               "--obs-log", str(tmp / name / "obs.jsonl")] + list(extra))


def _run(tmp, name, extra):
    tmpdir = tmp / name / "tmp"
    tmpdir.mkdir(parents=True)
    r = subprocess.run(_cmd(tmp, name, extra), capture_output=True,
                       text=True, timeout=300, cwd=REPO, env=_env(tmpdir))
    return r, tmpdir


def _usr1(tmp, name, extra):
    """A throttled run that gets SIGUSR1 after its epoch-3 line."""
    tmpdir = tmp / name / "tmp"
    tmpdir.mkdir(parents=True)
    env = _env(tmpdir)
    env["BNSGCN_EPOCH_THROTTLE_S"] = "0.6"
    p = subprocess.Popen(_cmd(tmp, name, extra), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, cwd=REPO,
                         env=env)
    out = []
    for line in p.stdout:
        out.append(line)
        if "Epoch 00003" in line:
            time.sleep(0.1)
            p.send_signal(signal.SIGUSR1)
    err = p.stderr.read()
    p.wait(timeout=300)
    return (subprocess.CompletedProcess(p.args, p.returncode, "".join(out),
                                        err), tmpdir)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trace")
    jobs = {
        "prof": (_run, ["--profile-dir", str(tmp / "prof_dir"),
                        "--overlap", "split"]),
        "off": (_run, ["--no-comm-trace"]),
        "usr1": (_usr1, ["--n-epochs", "12", "--obs-dir",
                         str(tmp / "usr1" / "pm")]),
    }
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(fn, tmp, k, extra)
                for k, (fn, extra) in jobs.items()}
        out = {k: f.result() for k, f in futs.items()}
    out["tmp"] = tmp
    return out


def _events(tmp, name):
    with open(tmp / name / "obs.jsonl") as f:
        return [json.loads(line) for line in f if line.strip()]


def test_profile_dir_writes_each_ranks_trace(runs):
    r, tmpdir = runs["prof"]
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    prof = runs["tmp"] / "prof_dir"
    assert sorted(os.listdir(prof)) == ["rank_0.json", "rank_1.json"]
    assert "profiler trace written to" in r.stdout
    traces = [e for e in _events(runs["tmp"], "prof") if e["kind"] == "trace"]
    assert len(traces) == 1 and traces[0]["comm_s"] > 0
    assert traces[0]["trace_dir"] == str(prof)
    # the event's seconds are the parse of the files it names
    ex_s, rd_s, steps = tp.step_comm_per_epoch(str(prof))
    assert steps == 2 and abs(traces[0]["comm_s"] - round(ex_s, 6)) < 1e-9
    lines = [ln for ln in r.stdout.splitlines() if "Process 000 | Epoch" in ln]
    assert "[host]" in lines[0] and "[traced]" in lines[-1]
    assert re.search(r"Comm\(s\) \d+\.\d{4} \[traced\]", lines[-1])


def test_overlap_split_emits_overlap(runs):
    r, _ = runs["prof"]
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    ov = [e for e in _events(runs["tmp"], "prof") if e["kind"] == "overlap"]
    assert len(ov) == 1
    assert ov[0]["interior_ms"] > 0 and ov[0]["exchange_ms"] > 0
    assert "overlap[traced]: exchange" in r.stdout
    # the events' numbers are the parse of the window's files
    rep = tp.overlap_report(str(runs["tmp"] / "prof_dir"))
    assert round(rep["interior_ms"], 4) == ov[0]["interior_ms"]


def test_no_comm_trace_writes_no_trace(runs):
    r, tmpdir = runs["off"]
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    evs = _events(runs["tmp"], "off")
    assert not any(e["kind"] in ("trace", "overlap") for e in evs)
    assert all(e.get("comm_tag") != "traced" for e in evs
               if e["kind"] == "epoch")
    assert "[traced]" not in r.stdout
    assert not [d for d in os.listdir(tmpdir)
                if d.startswith("bnsgcn_commtrace_")]


def test_sigusr1_profiles_a_window_and_rearms_the_comm_trace(runs):
    r, _ = runs["usr1"]
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    evs = _events(runs["tmp"], "usr1")
    req = [e for e in evs if e["kind"] == "profile_request"]
    prof = [e for e in evs if e["kind"] == "profile"]
    assert len(req) == 1 and req[0]["trace_dir"], req
    assert req[0]["snapshot"] and os.path.exists(req[0]["snapshot"])
    assert len(prof) == 1 and prof[0]["trace_dir"] == req[0]["trace_dir"]
    assert prof[0]["epoch"] == req[0]["epoch"] + 2
    assert sorted(os.listdir(req[0]["trace_dir"])) == ["rank_0.json",
                                                       "rank_1.json"]
    # the comm-trace window (epochs 6..) was delayed past the SIGUSR1 one,
    # never cancelled; its temporary directory is gone after it
    trace = [e for e in evs if e["kind"] == "trace"]
    assert len(trace) == 1 and trace[0]["epoch"] > prof[0]["epoch"]
    assert req[0]["epoch"] <= 6 <= prof[0]["epoch"]
    _, tmpdir = runs["usr1"]
    assert not [d for d in os.listdir(tmpdir)
                if d.startswith("bnsgcn_commtrace_")]
