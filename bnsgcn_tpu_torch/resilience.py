"""Fault tolerance of a training run (counterpart of bnsgcn_tpu/resilience.py,
its single-run subsystem), in every rank of a P-rank (R x P x T) launch:

* **Divergence guard and rollback**: the loop checks the loss it already
  read every step, and a parameter-norm probe every `log_every` epochs. On
  NaN/Inf it restores the model, Adam and SyncBatchNorm state from the newest
  valid periodic checkpoint before the failing epoch (or the run's initial
  state), folds a retry nonce into the sampling and dropout keys, so the
  retried epochs draw new boundary samples and masks, and retries after an
  exponential backoff; past `--resil-retries` it raises DivergenceError with
  a report (also written beside the checkpoints) and the CLI exits 76.
* **Preemption**: SIGTERM/SIGINT set a flag the loop reads at the step
  boundary; the loop writes a resumable checkpoint and raises
  PreemptedError, and the CLI exits 75. `--resume` continues the same
  sampling and dropout streams (the checkpoint carries the seed and the
  retry nonce). A second signal kills at once.
* **Hung-step watchdog**: a thread with a deadline from the rolling mean
  epoch time; on expiry it dumps every thread's stack and the live arrays
  to stderr and exits 77.
* **Fault injection**: `--inject nan@E12,sigterm@E20:r1,hang@E8,
  ckpt-corrupt@E10` (or $BNSGCN_FAULT) fires each fault at the named
  epoch's step boundary, on every rank or on global rank r.

Across ranks (run.train_loop, parallel/mesh.launch): the loss is already
all-reduced, so a non-finite loss is every rank's verdict; the preemption
flag and the norm probe's verdict go through one two-element MAX all-reduce
after each step, so every rank acts on them at the same boundary; rank 0
picks the rollback checkpoint, reads it once and broadcasts it; rank 0
alone writes checkpoints, the divergence report and tears a checkpoint for
`ckpt-corrupt`. The launcher forwards its first SIGTERM/SIGINT to its ranks
and maps their exits to one code. The JAX package's rank coordinator,
elastic world size (`ranklost`) and telemetry are not ported: `--coord*`,
`--elastic` and `--obs*` stay refused, and so does a `ranklost` term.

`--resilience off` builds none of this: no handler, no thread, no extra
collective; the loop is the plain loop.

Timing knobs are environment variables, as in the JAX package:
  BNSGCN_WATCHDOG_GRACE_S   deadline before the first step completes (600)
  BNSGCN_WATCHDOG_FACTOR    deadline = max(MIN, FACTOR * rolling mean) (20)
  BNSGCN_WATCHDOG_MIN_S     deadline floor after the first step (300)
  BNSGCN_RETRY_BACKOFF_S    rollback backoff base, doubled per retry (1.0,
                            at most 30 s)
"""

from __future__ import annotations

import faulthandler
import gc
import os
import re
import signal
import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from bnsgcn_tpu_torch import checkpoint as ckpt
from bnsgcn_tpu_torch.config import ConfigError

# distinct exit codes, so a requeue wrapper can tell the states apart
EXIT_PREEMPTED = 75   # resumable checkpoint written; relaunch with --resume
EXIT_DIVERGED = 76    # rollback retries exhausted; report printed
EXIT_WATCHDOG = 77    # hung step: stacks and live arrays dumped to stderr
EXIT_COORD_ABORT = 78  # the JAX package's agreed abort (its coordinator);
                       # the port has no coordinator and never exits 78

FAULT_KINDS = ("nan", "sigterm", "hang", "ckpt-corrupt", "ranklost")
# the serving fleet's faults share the --inject spec; a training run
# validates and skips them
SERVE_FAULT_KINDS = ("servekill", "servehang", "servedrop")


class PreemptedError(Exception):
    """Raised at a step boundary after SIGTERM/SIGINT: the resumable
    checkpoint is already on disk at `.ckpt_path`."""

    exit_code = EXIT_PREEMPTED

    def __init__(self, epoch: int, ckpt_path: str = ""):
        self.epoch = epoch
        self.ckpt_path = ckpt_path
        super().__init__(
            f"preempted at epoch {epoch}; resumable checkpoint at "
            f"{ckpt_path or '<none>'} — relaunch with --resume")

    def __reduce__(self):
        return PreemptedError, (self.epoch, self.ckpt_path)


class DivergenceError(Exception):
    """Raised when the divergence rollback retries are exhausted; the
    message is the report (also written beside the checkpoints)."""

    exit_code = EXIT_DIVERGED


class StepHung(Exception):
    """A step that did not finish: a rank's step collective timed out
    waiting for a peer, or (raised by the launcher) a rank's watchdog
    fired. The CLI exits 77."""

    exit_code = EXIT_WATCHDOG


# ----------------------------------------------------------------------------
# preemption signals
# ----------------------------------------------------------------------------

class PreemptSignals:
    """SIGTERM/SIGINT -> a flag the owner polls at its own boundary; a
    second signal restores the default handling and re-raises it (the
    operator, or the platform's kill escalation, wants out now). `action`
    is what the owner promises to do at its `boundary` before exiting 75."""

    def __init__(self, action: str = "checkpoint",
                 boundary: str = "step boundary"):
        self.action = action
        self.boundary = boundary
        self._requested: Optional[str] = None
        self._old_handlers: dict = {}

    def install(self):
        """In the main thread only (a handler cannot be set elsewhere)."""
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._old_handlers[sig] = signal.signal(sig,
                                                            self._on_signal)
                except (ValueError, OSError):
                    pass
        return self

    def restore(self):
        for sig, old in self._old_handlers.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):
                pass
        self._old_handlers.clear()

    def _on_signal(self, signum, frame):
        name = signal.Signals(signum).name
        if self._requested is not None:
            signal.signal(signum, signal.SIG_DFL)
            signal.raise_signal(signum)
            return
        self._requested = name
        sys.stderr.write(
            f"\n[resilience] {name} received: will {self.action} and exit "
            f"{EXIT_PREEMPTED} at the next {self.boundary} (send again to "
            f"kill immediately)\n")

    @property
    def requested(self) -> Optional[str]:
        return self._requested


# ----------------------------------------------------------------------------
# fault-injection plan
# ----------------------------------------------------------------------------

@dataclass
class FaultPlan:
    """A parsed `--inject` spec: kind -> epochs, each fired once."""

    faults: dict = field(default_factory=dict)   # kind -> set of epochs

    @staticmethod
    def parse(spec: str, rank: int = 0) -> "FaultPlan":
        """Comma-separated `kind@E<epoch>[:r<rank>]` terms, e.g.
        `nan@E12,sigterm@E20:r1,hang@E8,ckpt-corrupt@E10`; `r<rank>` is a
        global rank, and a term without it fires on every rank. Every term
        is validated even when it targets another rank. A malformed term
        raises ValueError; `ranklost` (the JAX package's elastic world
        size) a ConfigError: it is not ported."""
        plan = FaultPlan()
        for term in filter(None, (t.strip() for t in spec.split(","))):
            kind = term.partition("@")[0]
            if kind in SERVE_FAULT_KINDS:
                _parse_serve_term(term)
                continue
            kind, sep, rest = term.partition("@")
            ep, rsep, rk = rest.partition(":")
            if (not sep or not ep.startswith("E")
                    or not ep[1:].isdigit()
                    or (rsep and not (rk.startswith("r")
                                      and rk[1:].isdigit()))):
                raise ValueError(
                    f"bad --inject term {term!r}: expected "
                    f"kind@E<epoch>[:r<rank>] "
                    f"(kinds: {', '.join(FAULT_KINDS)})")
            if kind not in FAULT_KINDS:
                raise ValueError(
                    f"unknown --inject fault {kind!r} "
                    f"(kinds: {', '.join(FAULT_KINDS)})")
            if kind == "ranklost":
                raise ConfigError(f"--inject {term} is not ported yet "
                                  f"(elastic world size)")
            if rsep and int(rk[1:]) != rank:
                continue                # valid term, targets another rank
            plan.faults.setdefault(kind, set()).add(int(ep[1:]))
        return plan

    def pop(self, kind: str, epoch: int) -> bool:
        """True exactly once when `kind` is scheduled at `epoch`."""
        eps = self.faults.get(kind)
        if eps and epoch in eps:
            eps.discard(epoch)
            return True
        return False

    def empty(self) -> bool:
        return not any(self.faults.values())


def _parse_serve_term(term: str) -> None:
    """Validate one serving-fault term, `kind@<N>[:p<part>.r<replica>]`
    (servekill and servehang need the target)."""
    kind, sep, rest = term.partition("@")
    nth, tsep, tgt = rest.partition(":")
    if not sep or not nth.isdigit():
        raise ValueError(
            f"bad --inject term {term!r}: expected "
            f"kind@<N>[:p<part>.r<replica>] "
            f"(serve kinds: {', '.join(SERVE_FAULT_KINDS)})")
    if tsep and not re.fullmatch(r"p(\d+)\.r(\d+)", tgt):
        raise ValueError(
            f"bad --inject term {term!r}: backend target must be "
            f"p<part>.r<replica> (e.g. servekill@5:p0.r1)")
    if kind in ("servekill", "servehang") and not tsep:
        raise ConfigError(
            f"--inject term {term!r}: {kind} needs an explicit "
            f":p<part>.r<replica> target (wedging every backend is not a "
            f"failover test); use {kind}@<N>:p<part>.r<replica>")


def check_inject(spec: str) -> None:
    """Validate an --inject spec before any rank starts: a malformed term
    or `ranklost` raises a ConfigError (the CLI exits 2)."""
    try:
        FaultPlan.parse(spec)
    except ConfigError:
        raise
    except ValueError as e:
        raise ConfigError(str(e)) from e


# ----------------------------------------------------------------------------
# hung-step watchdog
# ----------------------------------------------------------------------------

def live_arrays_lines() -> list[str]:
    """The watchdog's `live arrays` lines: on a card the CUDA caching
    allocator's live allocations and bytes, on the CPU the live tensors;
    then the first 8 live tensors' dtypes and shapes."""
    # type(), not isinstance: isinstance reads `__class__`, which some
    # deprecated module proxies answer with a warning
    tensors = [o for o in gc.get_objects()
               if issubclass(type(o), torch.Tensor)]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        st = torch.cuda.memory_stats()
        lines = [f"[watchdog] {st.get('allocation.all.current', 0)} live "
                 f"arrays, {st.get('allocated_bytes.all.current', 0) / 2**20:.1f}"
                 f" MB on device (the CUDA caching allocator)"]
    else:
        total = sum(t.numel() * t.element_size() for t in tensors)
        lines = [f"[watchdog] {len(tensors)} live arrays (tensors on the "
                 f"host), {total / 2**20:.1f} MB"]
    lines += [f"[watchdog]   {t.dtype} {tuple(t.shape)} {t.device}"
              for t in tensors[:8]]
    return lines


class Watchdog(threading.Thread):
    """Monitor thread: the loop calls `beat()` at each step boundary; if no
    beat lands within the deadline (from the rolling mean once steps flow,
    a grace period before that), dump every thread's stack and the live
    arrays and exit 77. `held()` holds the clock through boundary work,
    `touch()` restarts it without a duration sample. Daemon: never blocks
    the interpreter's exit."""

    POLL_S = 0.25
    ROLLING = 20

    def __init__(self, log=print):
        super().__init__(name="bnsgcn-watchdog", daemon=True)
        self.log = log
        self.grace_s = float(os.environ.get("BNSGCN_WATCHDOG_GRACE_S", 600))
        self.factor = float(os.environ.get("BNSGCN_WATCHDOG_FACTOR", 20))
        # slow but legitimate boundary work must clear the floor: the quarry
        # is hung collectives, which are minutes-to-forever
        self.min_s = float(os.environ.get("BNSGCN_WATCHDOG_MIN_S", 300))
        self._durs: list[float] = []            # guarded-by: self._lock
        self._last_beat = time.monotonic()      # guarded-by: self._lock
        self._epoch = -1                        # guarded-by: self._lock
        self._paused = 0                        # guarded-by: self._lock
        self._halt = threading.Event()
        self._lock = threading.Lock()

    def beat(self, epoch: int):
        now = time.monotonic()
        with self._lock:
            if self._epoch >= 0:
                self._durs.append(now - self._last_beat)
                del self._durs[:-self.ROLLING]
            self._epoch = epoch
            self._last_beat = now

    def touch(self):
        """Restart the liveness clock without a duration sample: after
        boundary work (a checkpoint write, a barrier, an eval, a restore),
        so it never eats into the next step's deadline and the rolling mean
        stays a step time."""
        with self._lock:
            self._last_beat = time.monotonic()

    @contextmanager
    def held(self):
        """The clock held while the block runs (boundary work: a checkpoint
        write, a barrier, an eval's drain, which may wait longer than a
        step's deadline for good reason), restarted after it."""
        with self._lock:
            self._paused += 1
        try:
            yield
        finally:
            with self._lock:
                self._paused -= 1
                self._last_beat = time.monotonic()

    def deadline_s(self) -> float:
        with self._lock:
            if not self._durs:
                return self.grace_s
            mean = sum(self._durs) / len(self._durs)
        return max(self.min_s, self.factor * mean)

    def stop(self):
        self._halt.set()

    def run(self):
        while not self._halt.wait(self.POLL_S):
            with self._lock:
                epoch, last_beat = self._epoch, self._last_beat
                paused = self._paused > 0
            idle = time.monotonic() - last_beat
            deadline = self.deadline_s()
            if paused or idle <= deadline:
                continue
            # the dump runs in a daemon thread of its own with a bounded
            # join: a wedged filesystem must not keep the exit from firing
            t = threading.Thread(target=self._dump,
                                 args=(idle, deadline, epoch),
                                 name="bnsgcn-watchdog-dump", daemon=True)
            t.start()
            t.join(timeout=30.0)
            if t.is_alive():
                sys.stderr.write("[watchdog] dump stalled (wedged "
                                 "filesystem?); exiting without it\n")
            sys.stderr.flush()
            os._exit(EXIT_WATCHDOG)

    def _dump(self, idle: float, deadline: float, epoch: int):
        try:
            sys.stderr.write(
                "\n[watchdog] step hung: no step-boundary heartbeat for "
                f"{idle:.1f}s (deadline {deadline:.1f}s, last epoch "
                f"{epoch}); dumping stacks and exiting "
                f"{EXIT_WATCHDOG}\n")
            sys.stderr.flush()
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
            try:
                for line in live_arrays_lines():
                    sys.stderr.write(line + "\n")
            except Exception:
                pass
            sys.stderr.flush()
        except Exception:
            pass    # dumping must never mask the exit itself


# ----------------------------------------------------------------------------
# the manager train_loop threads its loop through
# ----------------------------------------------------------------------------

class ResilienceManager:
    """One per rank and run (`--resilience on`): the signal handlers, the
    watchdog, the fault plan and the rollback state. `rank` is the global
    rank the fault plan targets, `world` the number of ranks, `lead`
    whether this rank writes checkpoints (rank 0). `find_ckpt(cfg, log,
    before_epoch)` picks the rollback checkpoint (at P > 1 rank 0's read,
    broadcast); `forwarded()` names a signal the launcher forwarded, or
    None. `close()` restores the process to its state before `start()`."""

    def __init__(self, cfg, log=print, start_epoch: int = 0,
                 retry_nonce: int = 0, rank: int = 0, world: int = 1,
                 lead: bool = True, find_ckpt: Optional[Callable] = None,
                 forwarded: Optional[Callable[[], Optional[str]]] = None):
        self.cfg = cfg
        self.log = log
        self.start_epoch = start_epoch
        self.rank, self.lead = rank, lead
        spec = cfg.inject or os.environ.get("BNSGCN_FAULT", "")
        self.plan = FaultPlan.parse(spec, rank=rank)
        # ckpt-corrupt tears the file rank 0 writes, on rank 0 alone,
        # whichever rank the term names
        corrupt = set()
        if lead:
            for r in range(world):
                corrupt |= FaultPlan.parse(spec, r).faults.get(
                    "ckpt-corrupt", set())
        self.plan.faults.pop("ckpt-corrupt", None)
        if corrupt:
            self.plan.faults["ckpt-corrupt"] = corrupt
        if not self.plan.empty():
            log(f"[resilience] fault plan armed (rank {self.rank}): "
                + ",".join(f"{k}@E{e}" for k, eps in
                           sorted(self.plan.faults.items())
                           for e in sorted(eps)))
        self.retries = 0
        self.nonce = retry_nonce        # rollbacks so far: folds the sampling
                                        # and dropout keys; the checkpoints
                                        # carry it, so a resume re-applies it
        self.backoff_base = float(os.environ.get("BNSGCN_RETRY_BACKOFF_S",
                                                 1.0))
        self.backoff_cap = 30.0
        self.rollbacks: list[dict] = []
        self._find_ckpt = find_ckpt or ckpt.latest_valid_checkpoint
        self._forwarded = forwarded
        self._sleep = time.sleep
        self._snapshot = None
        self._signals = PreemptSignals(action="checkpoint")
        self.watchdog = Watchdog(log)

    # -- lifecycle --

    def start(self):
        """Install the signal handlers (main thread only) and start the
        watchdog."""
        self._signals.install()
        self.watchdog.start()
        return self

    def close(self):
        self.watchdog.stop()
        if self.watchdog.is_alive():
            self.watchdog.join(timeout=2.0)
        self._signals.restore()

    # -- preemption --

    @property
    def preempt_requested(self) -> Optional[str]:
        """The signal that asked this rank to stop: its own, or one its
        launcher forwarded."""
        own = self._signals.requested
        if own is None and self._forwarded is not None:
            return self._forwarded()
        return own

    # -- divergence rollback --

    def set_initial_snapshot(self, model, opt):
        """Host copies of the fresh (or resumed) model and Adam state: the
        rollback target before the first valid checkpoint (this rank's own,
        its shard under a feat axis)."""
        from bnsgcn_tpu_torch.trainer import host_state
        self._snapshot = host_state(model, opt)

    def note_progress(self, epoch: int):
        """A periodic checkpoint landed at `epoch`, past the last rollback:
        that divergence is healed and the retry budget resets (the nonce
        never does: the streams must stay distinct)."""
        if (self.retries and self.rollbacks
                and epoch > self.rollbacks[-1]["epoch"]):
            self.retries = 0

    def rollback(self, epoch: int, loss_f: float, model, opt,
                 cut: Optional[Callable] = None) -> tuple[int, int]:
        """Restore the last good state after a non-finite loss or norm
        probe, in place: the parameters, SyncBatchNorm's statistics and Adam
        from the newest valid checkpoint before `epoch` (`cut`: a feat
        shard's StepFns.shard_state), else the initial snapshot. Returns
        (the epoch to restart at, the new retry nonce). Raises
        DivergenceError with the report once the retries are exhausted."""
        from bnsgcn_tpu_torch.trainer import load_host_state, restore_payload
        self.retries += 1
        limit = max(int(self.cfg.resil_retries), 0)
        found = self._find_ckpt(self.cfg, log=self.log, before_epoch=epoch)
        if self.retries > limit:
            raise DivergenceError(self._report(epoch, loss_f, found))
        backoff = min(self.backoff_cap,
                      self.backoff_base * (2 ** (self.retries - 1)))
        if backoff > 0:
            self.log(f"[resilience] backing off {backoff:.1f}s before retry "
                     f"{self.retries}/{limit}")
            self._sleep(backoff)
        if found is not None:
            path, payload = found
            restore_payload(payload, model, opt, cut)
            restart = int(payload["epoch"]) + 1
            src = os.path.basename(path)
        else:
            if self._snapshot is None:
                raise DivergenceError(self._report(epoch, loss_f, None))
            load_host_state(self._snapshot, model, opt)
            restart = self.start_epoch
            src = "<initial state>"
        self.nonce += 1
        self.rollbacks.append({"epoch": epoch, "restart": restart,
                               "source": src, "nonce": self.nonce})
        self.log(
            f"[resilience] non-finite training state at epoch {epoch} "
            f"(loss={loss_f}): rolled back to {src}, restarting at epoch "
            f"{restart} with retry-nonce {self.nonce} folded into the "
            f"sampling/dropout keys (retry {self.retries}/{limit})")
        return restart, self.nonce

    def _report(self, epoch: int, loss_f: float, found) -> str:
        lines = [
            f"divergence unrecovered after {self.retries - 1} rollback "
            f"retr{'y' if self.retries == 2 else 'ies'} "
            f"(--resil-retries {self.cfg.resil_retries}):",
            f"  epoch {epoch}: loss={loss_f}",
            f"  last valid checkpoint: "
            f"{found[0] if found else '<none found>'}",
            f"  rollback history: {self.rollbacks or '<none>'}",
            "  likely causes: lr too high for this sampling rate, bad input "
            "features, or fp8/int8 wire overflow — see README 'Fault "
            "tolerance'",
        ]
        report = "\n".join(lines)
        rp = os.path.join(self.cfg.ckpt_path,
                          f"divergence_report_E{epoch}.txt")
        if self.lead:
            try:
                os.makedirs(self.cfg.ckpt_path, exist_ok=True)
                with open(rp, "w") as f:
                    f.write(report + "\n")
            except OSError:
                return report
        return report + f"\n  report written to {rp}"

    # -- fault injection --

    def fire_injections(self, epoch: int) -> dict:
        """Apply this epoch's scheduled faults at the step boundary. Returns
        {'nan': bool}: the caller poisons the parameters (it owns them);
        `sigterm` raises the real signal through the installed handler,
        `hang` blocks the main thread so the watchdog fires for real, and
        `ckpt-corrupt` tears the newest periodic checkpoint."""
        out = {"nan": self.plan.pop("nan", epoch)}
        if self.plan.pop("sigterm", epoch):
            self.log(f"[inject] sigterm@E{epoch}")
            signal.raise_signal(signal.SIGTERM)
        if self.plan.pop("ckpt-corrupt", epoch):
            latest = ckpt.latest_checkpoint(self.cfg)
            if latest:
                corrupt_file(latest)
                self.log(f"[inject] ckpt-corrupt@E{epoch}: tore {latest}")
            else:
                self.log(f"[inject] ckpt-corrupt@E{epoch}: no checkpoint yet")
        if self.plan.pop("hang", epoch):
            self.log(f"[inject] hang@E{epoch}: blocking the step (watchdog "
                     f"deadline {self.watchdog.deadline_s():.1f}s)")
            while True:                 # the watchdog ends the process
                time.sleep(3600)
        if out["nan"]:
            self.log(f"[inject] nan@E{epoch}: poisoning params")
        return out


def corrupt_file(path: str, keep_bytes: int = 64):
    """A torn write: truncate to the first `keep_bytes` bytes and flip
    them; the file keeps its header's shape but fails verification."""
    with open(path, "r+b") as f:
        head = bytearray(f.read(keep_bytes))
        for i in range(len(head)):
            head[i] ^= 0xFF
        f.seek(0)
        f.write(head)
        f.truncate(len(head))


def collective_timed_out(e: BaseException) -> bool:
    """Whether a step's exception is a collective that timed out waiting
    for a peer (gloo's and NCCL's wording): a hung step, not a fault of
    this rank."""
    text = str(e).lower()
    return "timed out" in text or "timeout" in text
