"""Strict-execution runtime guards (counterpart of bnsgcn_tpu/strict.py):
prove the steady-state step is clean.

`--strict-exec` wraps every step of the loop in run.py in `StrictExec.step`,
with two mechanisms:

* **Transfer guard** - on a card, `torch.cuda.set_sync_debug_mode("error")`
  around the step (the JAX package's `jax.transfer_guard("disallow")`), so
  that any implicit synchronising call inside it (`.item()`, `.tolist()` or
  `.cpu()` of a CUDA tensor, `nonzero`, a blocking copy either way) raises
  StrictExecError instead of stalling the host silently. The loss read goes
  through the audited `StrictExec.fetch` after the step. The deliberate
  transfers inside a step are the host-staged collectives of gloo on a card
  (parallel/mesh.py `Comm.host_staged`): each one suspends the guard from
  its launch until it is waited (`staged`, `suspend`/`resume`) and counts
  as an audited fetch. Under NCCL nothing is staged and the guard covers
  the whole step. On the CPU there is no guard to arm (the JAX package's
  CPU guard cannot see a device-to-host read either); the audit still
  counts the steps, the builds and the fetches.

* **Build listener** - the port compiles nothing inside a step except a
  kernel library that buildlib builds or loads on first use, the twin of an
  XLA compile (buildlib.add_load_listener). Each step variant (`full` /
  `cached` / `step`: the --halo-refresh pair are two programs) may load
  during its first guarded step; a load in a later step of an armed variant
  raises StrictExecError. A retune rebuilds the step functions and re-arms
  every variant (`rearm`).

`finish()` logs the JAX package's one-line audit and emits a `strict_exec`
event on the telemetry bus with the JAX summary's keys.
"""

from __future__ import annotations

import contextlib
import threading
import warnings
from typing import Optional

import torch

from bnsgcn_tpu_torch import buildlib

__all__ = ["StrictExec", "StrictExecError", "staged", "suspend", "resume"]

SYNC_ERROR = "synchronizing"    # torch's sync debug mode error text


class StrictExecError(RuntimeError):
    """A strict-execution invariant failed: an implicit transfer inside the
    guarded step region, or a kernel build after the variant's first
    step. The message names the variant and the fix direction."""


# one build listener per process, routed to the active instance
_ACTIVE: Optional["StrictExec"] = None
_LISTENER_INSTALLED = False


def _on_load(name: str) -> None:
    inst = _ACTIVE
    if inst is not None:
        inst._saw_compile(name)


def _install_listener() -> None:
    global _LISTENER_INSTALLED
    if not _LISTENER_INSTALLED:
        buildlib.add_load_listener(_on_load)
        _LISTENER_INSTALLED = True


def suspend() -> bool:
    """Lift the active guard for one deliberate transfer (a host-staged
    collective) and count it as an audited fetch; True when a guarded step
    was running, so the caller must `resume()` once the transfer is
    waited."""
    inst = _ACTIVE
    return inst is not None and inst._suspend()


def resume() -> None:
    inst = _ACTIVE
    if inst is not None:
        inst._resume()


@contextlib.contextmanager
def staged():
    """suspend() ... resume() around a transfer that is waited inside."""
    held = suspend()
    try:
        yield
    finally:
        if held:
            resume()


class StrictExec:
    """Per-run strict-execution auditor. run.py creates one when
    --strict-exec is set and wraps every step in `step()`; `device` is the
    run's (the guard arms on a card only)."""

    def __init__(self, obs=None, log=print, device=None):
        self.obs = obs
        self.log = log
        self.guard = device is not None and torch.device(device).type == "cuda"
        self._armed: set[str] = set()       # variants past their first step
        self._in_step: Optional[str] = None
        self._step_compiles = 0
        self._lock = threading.Lock()       # the autograd thread stages too
        self._suspended = 0
        self._mode = 0                      # the sync debug mode outside
        self.steps: dict[str, int] = {}
        self.first_compiles: dict[str, int] = {}
        self.fetches = 0
        self.violations = 0
        self.rearms = 0
        _install_listener()

    def _saw_compile(self, name: str) -> None:
        if self._in_step is not None:
            self._step_compiles += 1

    def _arm(self, on: bool) -> None:
        if self.guard:
            with warnings.catch_warnings():
                # torch's note that the mode is a prototype, once a process
                warnings.simplefilter("ignore", UserWarning)
                torch.cuda.set_sync_debug_mode("error" if on else self._mode)

    def _suspend(self) -> bool:
        with self._lock:
            if self._in_step is None:
                return False
            self.fetches += 1
            self._suspended += 1
            if self._suspended == 1:
                self._arm(False)
            return True

    def _resume(self) -> None:
        with self._lock:
            if self._suspended == 0:
                return
            self._suspended -= 1
            if self._suspended == 0 and self._in_step is not None:
                self._arm(True)

    @contextlib.contextmanager
    def step(self, variant: str):
        """Guard one step of the named variant."""
        global _ACTIVE
        _ACTIVE = self
        self._in_step = variant
        self._step_compiles = 0
        self._suspended = 0
        if self.guard:
            self._mode = torch.cuda.get_sync_debug_mode()
        self._arm(True)
        try:
            yield
        except Exception as ex:
            if SYNC_ERROR in str(ex):
                self.violations += 1
                raise StrictExecError(
                    f"implicit host transfer inside the guarded "
                    f"'{variant}' step: {ex}\nEvery host value the step "
                    f"consumes must be uploaded before the guard (the "
                    f"epoch-tensor pattern) and every result fetched "
                    f"through strict.fetch() after it.") from ex
            raise
        finally:
            with self._lock:
                self._in_step = None
                self._suspended = 0
                self._arm(False)
        n = self._step_compiles
        self.steps[variant] = self.steps.get(variant, 0) + 1
        if variant in self._armed:
            if n:
                self.violations += 1
                raise StrictExecError(
                    f"{n} steady-state recompile(s) in step variant "
                    f"'{variant}' (step {self.steps[variant]}): a kernel "
                    f"library was built or loaded after the variant's "
                    f"first step - build every kernel before the loop.")
        else:
            self.first_compiles[variant] = \
                self.first_compiles.get(variant, 0) + n
            self._armed.add(variant)

    def rearm(self, reason: str = "retune"):
        """Re-arm every variant's first-build allowance: the --tune
        controller rebuilt the step functions, so their next guarded step
        may load once more. Counted in the audit."""
        self.rearms += 1
        self._armed.clear()
        self.log(f"[strict] compile allowance re-armed ({reason}): the next "
                 f"step of each variant may compile once")

    def fetch(self, x):
        """Audited explicit device-to-host read (the loss): a Python float
        of a one-element tensor, counted."""
        self.fetches += 1
        return x.item() if isinstance(x, torch.Tensor) else x

    def summary(self) -> dict:
        return {
            "variants": sorted(self.steps),
            "steps": dict(self.steps),
            "first_compiles": dict(self.first_compiles),
            "fetches": self.fetches,
            "violations": self.violations,
            "rearms": self.rearms,
        }

    def finish(self):
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None
        s = self.summary()
        total_steps = sum(s["steps"].values())
        self.log(
            f"[strict] exec audit: {total_steps} guarded steps across "
            f"{len(s['variants'])} variant(s) {s['variants']}, "
            f"first-step compiles {s['first_compiles']}, "
            f"{s['fetches']} audited fetches, "
            f"{s['rearms']} retune re-arm(s), "
            f"{s['violations']} violation(s)")
        if self.obs is not None:
            self.obs.emit("strict_exec", **s)
        return s
