"""The port's strict-execution guard (bnsgcn_tpu_torch/strict.py) against
the JAX package's (bnsgcn_tpu/strict.py), on the CPU.

  * the audit: steps by variant, the first-step build allowance, re-arms,
    audited fetches; the one-line summary word for word the JAX package's
    (tests/test_tune.py parses it) and the `strict_exec` event's keys;
  * the build listener: a kernel library loaded through buildlib inside an
    armed step is a violation, inside a variant's first step (or the first
    after a re-arm) it is allowed;
  * a synchronising call inside the step (torch's sync debug mode error,
    raised here by hand: the CPU has no guard) becomes StrictExecError with
    the JAX package's wording; the staged transfers (strict.suspend /
    resume, a Pending marked staged) count as audited fetches only inside
    a step;
  * --strict-exec on equals off in losses, bitwise, at P=1 and at P=2;
    the audit reads 0 violations with one fetch per step on the CPU.
  Its card twins (the guard armed, an .item() inside a step) are in
  tests/test_torch_cuda.py.
"""

import os

import pytest

from bnsgcn_tpu import strict as j_strict
from bnsgcn_tpu_torch import buildlib, strict
from bnsgcn_tpu_torch.config import Config
from bnsgcn_tpu_torch.data.graph import sbm_graph
from bnsgcn_tpu_torch.run import run_training

GRAPH = dict(n_nodes=240, n_class=3, n_feat=8, p_in=0.12, p_out=0.01, seed=3)


def _fake_load(monkeypatch):
    """buildlib.load without a compiler: any name loads a stand-in library
    (the listener fires as for a real first load)."""
    monkeypatch.setattr(buildlib, "build_many",
                        lambda specs, timeout=600.0: {n: "x" for n, _, _ in
                                                      specs})
    monkeypatch.setattr(buildlib.ctypes, "CDLL", lambda path: object())


def test_a_build_inside_an_armed_step_is_a_violation(monkeypatch):
    _fake_load(monkeypatch)
    lines = []
    st = strict.StrictExec(log=lines.append)
    with st.step("step"):
        buildlib.load("strict_test_first", "cxx", [])
    assert st.first_compiles == {"step": 1}
    with st.step("step"):
        pass                                    # steady state: nothing
    with pytest.raises(strict.StrictExecError,
                       match="steady-state recompile"):
        with st.step("step"):
            buildlib.load("strict_test_late", "cxx", [])
    assert st.violations == 1 and st.steps == {"step": 3}
    # a retune's re-arm: the next step may build once more
    st.rearm("schedule")
    with st.step("step"):
        buildlib.load("strict_test_rearmed", "cxx", [])
    assert st.violations == 1 and st.rearms == 1
    assert any("compile allowance re-armed (schedule)" in ln for ln in lines)
    st.finish()


def test_variants_are_armed_apart(monkeypatch):
    _fake_load(monkeypatch)
    st = strict.StrictExec(log=lambda m: None)
    with st.step("full"):
        pass
    with st.step("cached"):                     # its own first step
        buildlib.load("strict_test_cached", "cxx", [])
    assert st.first_compiles == {"full": 0, "cached": 1}
    with pytest.raises(strict.StrictExecError):
        with st.step("full"):
            buildlib.load("strict_test_full", "cxx", [])
    st.finish()


def test_a_sync_inside_the_step_is_the_jax_packages_error():
    st = strict.StrictExec(log=lambda m: None)
    with pytest.raises(strict.StrictExecError) as got:
        with st.step("cached"):
            raise RuntimeError("called a synchronizing CUDA operation")
    assert str(got.value).startswith(
        "implicit host transfer inside the guarded 'cached' step: called a "
        "synchronizing CUDA operation")
    assert st.violations == 1
    with pytest.raises(ValueError):             # other errors pass through
        with st.step("cached"):
            raise ValueError("x")
    assert st.violations == 1
    st.finish()


def test_staged_transfers_count_only_inside_a_step():
    from bnsgcn_tpu_torch.parallel.mesh import Pending
    st = strict.StrictExec(log=lambda m: None)
    assert strict.suspend() is False            # no step: nothing held
    with st.step("step"):
        assert strict.suspend() is True
        assert strict.suspend() is True          # nested: one more fetch
        strict.resume()
        strict.resume()
        with strict.staged():
            pass
        p = Pending(comm=None, kind=None, works=[], start=None, result=7,
                    staged=strict.suspend())
        assert p.wait() == 7 and st._suspended == 0
    assert st.fetches == 4
    assert st.fetch(3.5) == 3.5 and st.fetches == 5
    st.finish()


def test_the_audit_line_and_event_equal_the_jax_packages():
    """The same counts in both auditors: the same line, and the same
    summary keys (the strict_exec event's)."""
    class Bus:
        def __init__(self):
            self.events = []

        def emit(self, kind, **kw):
            self.events.append((kind, kw))

    ours, theirs, bus_o, bus_t = [], [], Bus(), Bus()
    a = strict.StrictExec(obs=bus_o, log=ours.append)
    b = j_strict.StrictExec(obs=bus_t, log=theirs.append)
    for x in (a, b):
        x.steps = {"full": 1, "cached": 3, "step": 4}
        x.first_compiles = {"full": 2, "cached": 0, "step": 1}
        x.fetches, x.rearms, x.violations = 8, 2, 0
    sa, sb = a.finish(), b.finish()
    assert ours == theirs
    assert sa == sb
    assert bus_o.events == bus_t.events
    assert ours[0].endswith("2 retune re-arm(s), 0 violation(s)")


def _cfg(tmp_path, **kw):
    d = dict(dataset="sbm", model="graphsage", n_layers=2, n_hidden=8,
             sampling_rate=0.5, dropout=0.5, use_pp=True, eval=False,
             n_epochs=6, log_every=2, seed=7, device="cpu",
             dist_backend="gloo", graph_name="sbm-strict", comm_trace=False,
             part_path=str(tmp_path / "parts"),
             ckpt_path=str(tmp_path / "ck"), results_path=str(tmp_path / "r"))
    d.update(kw)
    return Config(**d)


@pytest.mark.parametrize("P,refresh", [(1, 1), (2, 1), (2, 2)])
def test_strict_on_equals_off_bitwise(tmp_path, P, refresh):
    g = sbm_graph(**GRAPH)
    out = {}
    for on in (False, True):
        res = run_training(_cfg(tmp_path, n_partitions=P, strict_exec=on,
                                halo_refresh=refresh,
                                ckpt_path=str(tmp_path / f"ck{on}")),
                           g=g, log=lambda m: None)
        out[on] = res
    assert out[True].losses == out[False].losses and len(out[True].losses) == 6
    s = out[True].strict
    assert out[False].strict is None
    assert s["violations"] == 0 and s["rearms"] == 0
    assert sum(s["steps"].values()) == 6 and s["fetches"] == 6
    assert s["variants"] == (["cached", "full"] if refresh > 1 else ["step"])
    assert os.path.isdir(tmp_path / "ckTrue")
