"""The port's fault tolerance (bnsgcn_tpu_torch/resilience.py) against the
JAX package's (bnsgcn_tpu/resilience.py), on the CPU.

  * `FaultPlan.parse` equal to the JAX package's on a matrix of specs, and
    refusing the same malformed terms; `ranklost` refused without its
    `:r<rank>` and accepted with it, as by the JAX package;
  * the rollback units of tests/test_resilience.py:135-207 on the port's
    model and Adam: a bitwise restore from a checkpoint, the initial
    snapshot, exhaustion with its report file, the budget reset;
  * parity at P=2 (one spawned gloo group for every case, the JAX side
    `run_training` on the CPU mesh, the JAX tests' small sbm graph and
    `_base_cfg`: GraphSAGE 2x8, rate 0.5, dropout 0.5, 8 epochs, log every
    2, seed 7): `nan@E5` rolls back to `_3.ckpt`, restarting at 4 with
    nonce 1; `nan@E3,nan@E6` with `--resil-retries 1` gives nonces [1, 2];
    `ckpt-corrupt@E6,nan@E6` falls back to `_3.ckpt`; all 8 losses within
    1e-4 relative of the JAX losses (so the nonce folds are the JAX
    package's); `nan@E5:r1` in one launch (the JAX package's rank: the
    coordination rank, 0 without a coordinator) rolls nothing back on
    either side, its losses the JAX run's, and `nan@E5:r0` gives
    `nan@E5`'s record and losses; a JAX
    checkpoint carrying retry_nonce 1, resumed by the port, continues as
    the JAX resume does; `--resilience on` without faults is bitwise `off`
    at P=2 and P=1;
  * through the CLI, in subprocesses at P=2: `sigterm@E3` exits 75 and
    its file loads in bnsgcn_tpu.checkpoint; `--resume --seed 999` reaches
    the uninterrupted run's RESULT final_loss bitwise; a real SIGTERM to the
    launcher after its first epoch line exits 75 and resumes to the same
    RESULT; `hang@E3` with the watchdog shrunk exits 77 with the stack
    dump, the live arrays line and the stalled rank; `nan@E4..7` with
    `--resil-retries 2` exits 76 with the report.
"""

import dataclasses
import os
import re
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from bnsgcn_tpu import checkpoint as j_ckpt
from bnsgcn_tpu import resilience as j_resil
from bnsgcn_tpu.config import Config as JConfig
from bnsgcn_tpu.data.graph import sbm_graph as j_sbm_graph
from bnsgcn_tpu.run import run_training as j_run_training
from bnsgcn_tpu_torch import checkpoint as ckpt
from bnsgcn_tpu_torch import resilience
from bnsgcn_tpu_torch.config import Config, ConfigError
from bnsgcn_tpu_torch.data.graph import sbm_graph
from bnsgcn_tpu_torch.models.gnn import GNN, spec_from_config
from bnsgcn_tpu_torch.parallel.mesh import launch
from bnsgcn_tpu_torch.run import (prepare_partition, prepare_rank,
                                  run_training, train_loop)
from bnsgcn_tpu_torch.trainer import (bn_state_to_jax, make_tx,
                                      opt_state_to_jax, param_global_norm,
                                      params_to_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH = dict(n_nodes=240, n_class=3, n_feat=8, p_in=0.12, p_out=0.01, seed=3)
LOSS_RTOL = 1e-4
TIMEOUT_S = 240


def _quiet(*a, **k):
    pass


# ---------------------------------------------------------------------------
# the inject grammar
# ---------------------------------------------------------------------------

SPECS = ["nan@E12,sigterm@E20,hang@E8,ckpt-corrupt@E10", "nan@E3,nan@E7",
         "", "  ,  ", "nan@E5:r1", "sigterm@E3:r0,nan@E4:r1,hang@E2",
         "nan@E1,servedrop@4", "servekill@5:p0.r1,nan@E2:r2",
         "ranklost@E3:r1", "nan@E2,ranklost@E4:r0"]
BAD = ["nan@12", "nan", "oom@E3", "nan@Ex", "nan@E-2", "sigkill@E1",
       "nan@E3:x1", "nan@E3:r", "servedrop@x", "servekill@3:q1"]


@pytest.mark.parametrize("spec", SPECS + BAD)
@pytest.mark.parametrize("rank", [0, 1, 2])
def test_fault_plan_parse_equals_the_jax_package(spec, rank):
    try:
        want = j_resil.FaultPlan.parse(spec, rank=rank).faults
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            resilience.FaultPlan.parse(spec, rank=rank)
        assert type(got.value).__name__ == type(e).__name__
        return
    assert resilience.FaultPlan.parse(spec, rank=rank).faults == want


@pytest.mark.parametrize("spec", ["ranklost@E3:r1", "nan@E1,ranklost@E2:r0"])
def test_ranklost_is_refused_by_name(spec):
    """The JAX grammar: `ranklost` needs its `:r<rank>` target (losing
    every rank is not a resize), and is accepted with it."""
    for rank in (0, 1):
        assert (resilience.FaultPlan.parse(spec, rank=rank).faults
                == j_resil.FaultPlan.parse(spec, rank=rank).faults)
    resilience.check_inject(spec)
    bare = re.sub(r"(ranklost@E\d+):r\d+", r"\1", spec)
    with pytest.raises(ConfigError, match="losing every rank"):
        resilience.FaultPlan.parse(bare)
    with pytest.raises(ValueError, match="losing every rank"):
        j_resil.FaultPlan.parse(bare)
    with pytest.raises(ConfigError, match="losing every rank"):
        resilience.check_inject(bare)
    with pytest.raises(ConfigError, match="unknown --inject fault"):
        resilience.check_inject("oom@E3")


def test_fault_plan_pops_once():
    plan = resilience.FaultPlan.parse("nan@E12,sigterm@E20")
    assert plan.pop("nan", 12) and not plan.pop("nan", 12)
    assert not plan.pop("sigterm", 19) and plan.pop("sigterm", 20)
    assert plan.empty()


# ---------------------------------------------------------------------------
# the rollback units (tests/test_resilience.py:135-207)
# ---------------------------------------------------------------------------

def _cfg_units(tmp_path, **kw):
    return Config(dataset="sbm", n_partitions=2, sampling_rate=0.5,
                  ckpt_path=str(tmp_path), graph_name="g", **kw)


def _tiny(seed):
    """A GCN 4-4-2 with SyncBatchNorm and an Adam that took one step."""
    cfg = Config(model="gcn", n_layers=2, n_hidden=4, norm="batch",
                 dropout=0.1).replace(n_feat=4, n_class=2, n_train=10)
    model = GNN(spec_from_config(cfg), seed, torch.float32)
    opt = make_tx(cfg, model.parameters())
    gen = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    opt.step()
    with torch.no_grad():
        model.norm_0.mean.add_(0.25 * seed)
    return model, opt


def _save(path, model, opt, epoch):
    sd = model.state_dict()
    ckpt.save_checkpoint(path, params=params_to_jax(sd, model.spec),
                         opt_state=opt_state_to_jax(opt, model),
                         bn_state=bn_state_to_jax(sd, model.spec),
                         epoch=epoch, extra={"retry_nonce": 0})


def _assert_same(model_a, opt_a, model_b, opt_b):
    for k, v in model_a.state_dict().items():
        assert torch.equal(v, model_b.state_dict()[k]), k
    sa, sb = opt_a.state_dict()["state"], opt_b.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


def test_rollback_restores_bitwise_equal_to_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setenv("BNSGCN_RETRY_BACKOFF_S", "0")
    cfg = _cfg_units(tmp_path, resil_retries=3)
    model, opt = _tiny(1)
    _save(ckpt.periodic_path(cfg, 3), model, opt, 3)
    # a different, poisoned state: every leaf must be overwritten
    m2, o2 = _tiny(9)
    with torch.no_grad():
        for p in m2.parameters():
            p.mul_(float("nan"))
    m = resilience.ResilienceManager(cfg, log=_quiet)
    assert (m.rollback(5, float("nan"), m2, o2)) == (4, 1)
    _assert_same(model, opt, m2, o2)
    assert m.rollbacks[0]["epoch"] == 5
    assert m.rollbacks[0]["source"].endswith("_3.ckpt")
    assert np.isfinite(param_global_norm(m2))


def test_rollback_uses_initial_snapshot_before_any_checkpoint(
        tmp_path, monkeypatch):
    monkeypatch.setenv("BNSGCN_RETRY_BACKOFF_S", "0")
    cfg = _cfg_units(tmp_path / "empty")
    model = GNN(_tiny(2)[0].spec, 2, torch.float32)
    opt = make_tx(cfg, model.parameters())       # no Adam state yet
    ref = GNN(model.spec, 2, torch.float32)
    m = resilience.ResilienceManager(cfg, log=_quiet, start_epoch=0)
    m.set_initial_snapshot(model, opt)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    with torch.no_grad():
        model.layer_0.weight.fill_(float("inf"))
    assert not np.isfinite(param_global_norm(model))
    assert m.rollback(1, float("inf"), model, opt) == (0, 1)
    assert m.rollbacks[0]["source"] == "<initial state>"
    _assert_same(ref, make_tx(cfg, ref.parameters()), model, opt)


def test_rollback_exhaustion_raises_the_report(tmp_path, monkeypatch):
    monkeypatch.setenv("BNSGCN_RETRY_BACKOFF_S", "0")
    cfg = _cfg_units(tmp_path, resil_retries=1)
    model, opt = _tiny(3)
    m = resilience.ResilienceManager(cfg, log=_quiet)
    m.set_initial_snapshot(model, opt)
    m.rollback(4, float("nan"), model, opt)          # retry 1: allowed
    with pytest.raises(resilience.DivergenceError, match="unrecovered"):
        m.rollback(4, float("nan"), model, opt)
    reports = [f for f in os.listdir(tmp_path) if f.startswith("divergence")]
    assert reports == ["divergence_report_E4.txt"]


def test_retry_budget_resets_after_a_healed_checkpoint(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("BNSGCN_RETRY_BACKOFF_S", "0")
    cfg = _cfg_units(tmp_path, resil_retries=1)
    model, opt = _tiny(4)
    m = resilience.ResilienceManager(cfg, log=_quiet)
    m.set_initial_snapshot(model, opt)
    m.rollback(2, float("nan"), model, opt)
    assert m.retries == 1
    m.note_progress(2)              # not past the rollback's epoch
    assert m.retries == 1
    m.note_progress(3)
    assert m.retries == 0
    assert m.rollback(6, float("nan"), model, opt)[1] == 2   # nonce goes on


def test_the_launcher_maps_exits_to_one_code():
    """Any 77 wins, else any 76, else 75 from every rank; a mix of 75 and a
    traceback is a failure naming each rank's exit code."""
    from bnsgcn_tpu_torch.parallel import mesh

    class P:
        exitcode = 1

    procs = {0: P(), 1: P()}
    pre = resilience.PreemptedError(3, "f")
    div = resilience.DivergenceError("report")
    hung = resilience.StepHung("timed out")

    now = time.monotonic()

    def verdict(outs):
        return mesh._verdict(outs, {}, procs, range(2), 2,
                             {0: (3, now - 1.0), 1: (2, now - 2.0)})

    v = verdict({0: ("exit", (75, pre)), 1: ("died", 77)})
    assert v.code == 77 and "rank 1 stalled the step" in str(v)
    v = verdict({0: ("exit", (75, pre)), 1: ("exit", (77, hung))})
    assert v.code == 77 and v.exc is hung
    v = verdict({0: ("exit", (76, div)), 1: ("exit", (75, pre))})
    assert v.code == 76 and v.exc is div
    v = verdict({0: ("exit", (75, pre)), 1: ("exit", (75, pre))})
    assert v.code == 75 and v.exc is pre
    v = verdict({0: ("exit", (75, pre)), 1: ("err", "Traceback ...")})
    assert not isinstance(v, mesh.RankExit)
    assert "rank 1 of 2 failed (exit code 1)" in str(v)


# ---------------------------------------------------------------------------
# parity at P=2, one spawned group
# ---------------------------------------------------------------------------

def _base(tmp, **kw):
    d = dict(dataset="sbm", model="graphsage", n_partitions=2, n_layers=2,
             n_hidden=8, sampling_rate=0.5, dropout=0.5, use_pp=True,
             eval=False, n_epochs=8, log_every=2, seed=7,
             part_path=str(tmp / "parts"), graph_name="sbm-resil",
             ckpt_path=str(tmp / "ckpt"), results_path=str(tmp / "res"),
             comm_trace=False)
    d.update(kw)
    return d


# (name, port Config fields); the JAX package runs JAX_CASES
CASES = (("nan5", dict(inject="nan@E5")),
         ("nan5r1", dict(inject="nan@E5:r1")),
         ("nan5r0", dict(inject="nan@E5:r0")),
         ("nan36", dict(inject="nan@E3,nan@E6", resil_retries=1)),
         ("corrupt", dict(inject="ckpt-corrupt@E6,nan@E6")),
         ("on", dict()),
         ("off", dict(resilience="off")))
JAX_CASES = ("nan5", "nan36", "corrupt", "nan5r1")


def _rank_job(ctx, cfg, path, work):
    """Every case on this rank's prepared part: (losses, rollbacks, rank
    0's lines) by case; then the resume of the JAX package's nan@E5 run."""
    os.environ["BNSGCN_RETRY_BACKOFF_S"] = "0"
    torch.set_num_threads(1)
    lines = []
    log = lines.append if ctx.rank == 0 else _quiet
    pr = prepare_rank(ctx, cfg, path, None, _quiet)
    out = {}
    for name, kw in CASES:
        c = pr.cfg.replace(ckpt_path=os.path.join(work, "ck_" + name), **kw)
        del lines[:]
        res, _ = train_loop(dataclasses.replace(pr, cfg=c), None, log,
                            None, ctx)
        out[name] = (res.losses, res.rollbacks, list(lines))
    c = pr.cfg.replace(ckpt_path=os.path.join(work, "ck_jax"), n_epochs=10)
    res, _ = train_loop(dataclasses.replace(pr, cfg=c), None, _quiet,
                        ckpt.periodic_path(c, 7), ctx)
    out["resume"] = (res.start_epoch, res.losses)
    return out


@pytest.fixture(scope="module")
def p2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resil")
    old = os.environ.get("BNSGCN_RETRY_BACKOFF_S")
    os.environ["BNSGCN_RETRY_BACKOFF_S"] = "0"
    try:
        g_j = j_sbm_graph(**GRAPH)
        ref = {}
        for name, kw in CASES:
            if name in JAX_CASES:
                res = j_run_training(JConfig(**_base(
                    tmp / "jax", comm_trace=False,
                    ckpt_path=str(tmp / "jax" / name), **kw)), g=g_j,
                    verbose=False)
                ref[name] = (res.losses, res.rollbacks)
        # the JAX package's nan@E5 run's files (retry_nonce 1 from epoch 5),
        # resumed to 10 epochs by it and by the port
        shutil.copytree(tmp / "jax" / "nan5", tmp / "work" / "ck_jax")
        shutil.copytree(tmp / "jax" / "nan5", tmp / "jax_resume")
        jr = j_run_training(JConfig(**_base(
            tmp / "jax", comm_trace=False, n_epochs=10, resume=True,
            ckpt_path=str(tmp / "jax_resume"))), g=g_j, verbose=False)
        ref["resume"] = (10 - len(jr.losses), jr.losses)
        cfg = Config(**_base(tmp, device="cpu", dist_backend="gloo"))
        prepare_partition(cfg, sbm_graph(**GRAPH), load=False)
        path = os.path.join(cfg.part_path, cfg.graph_name)
        ranks = launch(_rank_job, 2, [(cfg, path, str(tmp / "work"))] * 2,
                       "gloo", "cpu", log=_quiet, forward_signals=True)
    finally:
        if old is None:
            os.environ.pop("BNSGCN_RETRY_BACKOFF_S", None)
        else:
            os.environ["BNSGCN_RETRY_BACKOFF_S"] = old
    return dict(tmp=tmp, ref=ref, ranks=ranks)


def _close(got, want):
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", JAX_CASES[:3])
def test_rollback_runs_equal_the_jax_package(p2, name):
    losses_j, rb_j = p2["ref"][name]
    for losses, rbs, _ in (r[name] for r in p2["ranks"]):
        assert rbs == rb_j
        _close(losses, losses_j)


def test_nan_at_5_rolls_back_to_epoch_3(p2):
    losses, rbs, lines = p2["ranks"][0]["nan5"]
    assert rbs == [{"epoch": 5, "restart": 4, "nonce": 1,
                    "source": "sbm-resil_p0.50_3.ckpt"}]
    assert any("rolled back to sbm-resil_p0.50_3.ckpt, restarting at epoch "
               "4 with retry-nonce 1" in ln for ln in lines)
    assert [rb["nonce"] for rb in p2["ranks"][0]["nan36"][1]] == [1, 2]
    corrupt = p2["ranks"][0]["corrupt"]
    assert corrupt[1][0]["source"].endswith("_3.ckpt")
    assert any("[resilience] skipping corrupt checkpoint" in ln
               for ln in corrupt[2])


def test_a_fault_on_one_rank_rolls_back_every_rank(p2):
    """`:r<k>` names the JAX package's rank, the coordination rank: 0 in a
    run without a coordinator, whatever its gloo ranks. So nan@E5:r1 fires
    nowhere in one launch, as it fires in no JAX process of a single-host
    run: no rollback on either side, the losses the JAX run's; nan@E5:r0
    fires on every rank of the launch, nan@E5's record and losses."""
    losses_j, rb_j = p2["ref"]["nan5r1"]
    assert rb_j == []
    for r in p2["ranks"]:
        assert r["nan5r1"][1] == []
        _close(r["nan5r1"][0], losses_j)
        assert r["nan5r0"][:2] == r["nan5"][:2]
    assert any("nan@E5" in ln for ln in p2["ranks"][0]["nan5"][2])
    assert not any("fault plan armed" in ln
                   for ln in p2["ranks"][0]["nan5r1"][2])


def test_resilience_on_is_bitwise_off_at_p2(p2):
    for r in p2["ranks"]:
        assert r["on"][0] == r["off"][0]
        assert r["on"][1] == r["off"][1] == []


def test_jax_checkpoint_with_a_nonce_resumes_as_jax_does(p2):
    start_j, losses_j = p2["ref"]["resume"]
    for r in p2["ranks"]:
        start, losses = r["resume"]
        assert start == start_j == 8
        np.testing.assert_allclose(losses, losses_j, rtol=LOSS_RTOL)


def test_resilience_on_is_bitwise_off_at_p1(tmp_path):
    g = sbm_graph(**GRAPH)
    out = []
    for mode in ("on", "off"):
        cfg = Config(**_base(tmp_path, n_partitions=1, device="cpu",
                             resilience=mode,
                             ckpt_path=str(tmp_path / mode)))
        out.append(run_training(cfg, g=g, log=_quiet).losses)
    assert out[0] == out[1] and len(out[0]) == 8


# ---------------------------------------------------------------------------
# through the CLI
# ---------------------------------------------------------------------------

CLI = ["--dataset", "sbm", "--n-partitions", "2", "--dist-backend", "gloo",
       "--device", "cpu", "--model", "graphsage", "--n-layers", "2",
       "--n-hidden", "8", "--sampling-rate", "0.5", "--use-pp",
       "--n-epochs", "8", "--log-every", "2", "--no-eval", "--fix-seed",
       "--seed", "11", "--no-comm-trace"]


def _env(extra=None):
    return dict(os.environ, PYTHONPATH=ROOT, BNSGCN_RETRY_BACKOFF_S="0",
                **(extra or {}))


def _argv(tmp, ck, *extra):
    return ([sys.executable, "-m", "bnsgcn_tpu_torch.main"] + CLI
            + ["--part-path", str(tmp / "parts"), "--results-path",
               str(tmp / "res"), "--ckpt-path", str(tmp / ck)]
            + list(extra))


def _run(tmp, ck, *extra, env=None):
    return subprocess.run(_argv(tmp, ck, *extra), capture_output=True,
                          text=True, env=_env(env), timeout=TIMEOUT_S,
                          cwd=tmp)


def _result(out):
    m = re.search(r"RESULT final_loss=(\S+)", out)
    assert m, out[-3000:]
    return m.group(1)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The partition and the uninterrupted run's RESULT final_loss."""
    tmp = tmp_path_factory.mktemp("cli")
    r = _run(tmp, "ck_full")
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return tmp, _result(r.stdout)


def test_sigterm_on_one_rank_exits_75_and_resumes_bitwise(cli):
    tmp, want = cli
    r = _run(tmp, "ck_b", "--skip-partition", "--inject", "sigterm@E3")
    assert r.returncode == 75, r.stdout[-3000:] + r.stderr[-3000:]
    assert "resumable checkpoint" in r.stdout
    path = tmp / "ck_b" / "sbm-2-metis-vol-trans_p0.50_3.ckpt"
    payload = j_ckpt.load_checkpoint(str(path))      # the JAX package reads it
    assert payload["epoch"] == 3 and payload["extra"] == {"retry_nonce": 0}
    r = _run(tmp, "ck_b", "--skip-partition", "--resume", "--seed", "999")
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "Resumed from" in r.stdout and _result(r.stdout) == want


def test_a_real_sigterm_to_the_launcher_exits_75_and_resumes(cli):
    tmp, want = cli
    p = subprocess.Popen(_argv(tmp, "ck_sig", "--skip-partition"),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, cwd=tmp,
                         env=_env({"BNSGCN_EPOCH_THROTTLE_S": "0.5"}))
    out = []
    try:
        for line in p.stdout:
            out.append(line)
            if line.startswith("Process 000 | Epoch 00001"):
                p.send_signal(signal.SIGTERM)
                break
        out.append(p.stdout.read())
        p.wait(timeout=TIMEOUT_S)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    text = "".join(out)
    assert p.returncode == 75, text[-3000:]
    assert "SIGTERM received by the launcher" in text
    assert "resumable checkpoint" in text
    r = _run(tmp, "ck_sig", "--skip-partition", "--resume")
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert _result(r.stdout) == want


def test_a_hung_rank_exits_77_naming_it(cli):
    tmp, _ = cli
    # a deadline of 5 s: a peer that lags a few seconds on a loaded host
    # must still reach its next step boundary before the watchdogs fire
    r = _run(tmp, "ck_hang", "--skip-partition", "--inject", "hang@E3",
             env={"BNSGCN_WATCHDOG_MIN_S": "5",
                  "BNSGCN_WATCHDOG_FACTOR": "2",
                  "BNSGCN_WATCHDOG_GRACE_S": "120"})
    assert r.returncode == 77, r.stdout[-3000:] + r.stderr[-3000:]
    assert "[watchdog] step hung" in r.stderr
    assert "Current thread" in r.stderr or "Thread 0x" in r.stderr
    assert "live arrays" in r.stderr
    assert re.search(r"rank \d stalled the step", r.stderr)


def test_exhausted_retries_exit_76_with_the_report(cli):
    tmp, _ = cli
    inj = ",".join(f"nan@E{e}" for e in range(4, 8))
    r = _run(tmp, "ck_div", "--skip-partition", "--inject", inj,
             "--resil-retries", "2")
    assert r.returncode == 76, r.stdout[-3000:] + r.stderr[-3000:]
    assert "divergence unrecovered after 2 rollback retries" in r.stderr
    assert os.listdir(tmp / "ck_div").count("divergence_report_E6.txt") == 1
