"""Fault tolerance of a training run (counterpart of bnsgcn_tpu/resilience.py),
in every rank of a P-rank (R x P x T) launch:

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
  nonces). A second signal kills at once. With `--obs on` SIGUSR1 asks for
  a post-mortem capture (stacks and metrics) at the next boundary.
* **Hung-step watchdog**: a thread with a deadline from the rolling mean
  epoch time; on expiry it dumps every thread's stack, the live arrays and,
  with a coordinator, the peers' liveness table to stderr (and a post-mortem
  file with `--obs on`) and exits 77.
* **Fault injection**: `--inject nan@E12,sigterm@E20:r1,hang@E8,
  ckpt-corrupt@E10,ranklost@E3:r1` (or $BNSGCN_FAULT) fires each fault at
  the named epoch's step boundary. `r<k>` is the JAX package's rank: the
  coordination rank (parallel/coord.py), which is a whole launch of the
  port, or 0 without a coordinator. A term that fires in a launch fires on
  every rank of it, as a JAX process poisons, stops, hangs or loses all of
  its parts at once; `ckpt-corrupt` fires on the launch's rank 0 alone.

Within a launch (run.train_loop, parallel/mesh.launch): the loss is already
all-reduced, so a non-finite loss is every rank's verdict; the preemption
flag and the norm probe's verdict go through one two-element MAX all-reduce
after each step, so every rank acts on them at the same boundary. Without a
coordinator that is the verdict: rank 0 picks the rollback checkpoint,
reads it once and broadcasts it, and alone writes checkpoints and the
report. With one (`--coord tcp|file`, what `auto` picks for more than one
launch), the launch's rank 0 contributes that state to `agree_step`, the
JAX package's out-of-band verdict, and relays the agreed decision to its
launch (`CoordLink`): coordination rank 0 decides a rollback
(`plan_rollback`) or, under `--elastic on`, a resize when a peer's
heartbeats stop (`plan_resize`) or a lost rank rejoins (`plan_grow`); every
launch restores the agreed source and acks it (`coord_restore`), and a
launch that cannot makes every launch exit 78.

`--resilience off` builds none of this: no handler, no thread, no extra
collective; the loop is the plain loop.

Timing knobs are environment variables, as in the JAX package:
  BNSGCN_WATCHDOG_GRACE_S   deadline before the first step completes (600)
  BNSGCN_WATCHDOG_FACTOR    deadline = max(MIN, FACTOR * rolling mean) (20)
  BNSGCN_WATCHDOG_MIN_S     deadline floor after the first step (300)
  BNSGCN_RETRY_BACKOFF_S    rollback backoff base, doubled per retry (1.0,
                            at most 30 s)
  BNSGCN_COORD_TIMEOUT_S    per-exchange coordinator deadline (120)
  BNSGCN_COORD_AGREE_EVERY  agree every K step boundaries, latching local
                            verdicts in between (1)
  BNSGCN_ELASTIC_DEAD_S     alive-beat age that proves a peer dead (6)
  BNSGCN_ELASTIC_MAX_RESIZES  resize budget per run before abort (8)
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

from bnsgcn_tpu_torch import checkpoint as ckpt
from bnsgcn_tpu_torch import obs as obs_mod
from bnsgcn_tpu_torch.config import ConfigError
from bnsgcn_tpu_torch.parallel.coord import CoordAbort, CoordError

# distinct exit codes, so a requeue wrapper can tell the states apart
EXIT_PREEMPTED = 75   # resumable checkpoint written; relaunch with --resume
EXIT_DIVERGED = 76    # rollback retries exhausted; report printed
EXIT_WATCHDOG = 77    # hung step: stacks and live arrays dumped to stderr
EXIT_COORD_ABORT = 78  # the launches agreed to abort: one cannot restore
                       # the chosen checkpoint (rollback, resize or resume
                       # ack) — needs triage, not a blind requeue

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


class CheckpointUnavailable(Exception):
    """A rank could not obtain the agreed restore source (no usable file,
    no snapshot). Internal to coord_restore: it is reported through the
    coordinator's ack so that every launch aborts together."""


class RankLostExit(Exception):
    """Raised by fire_injections when this launch's `ranklost` fault fires:
    every rank of the launch unwinds without the coordinator's goodbye (no
    fin barrier, no last agree) and the CLI exits 0 with no RESULT line. To
    the peers it is a preempted worker whose alive-beats stopped: the
    heartbeat silence the elastic resize must detect."""

    exit_code = 0

    def __init__(self, epoch: int):
        self.epoch = epoch
        super().__init__(f"rank lost (injected) at epoch {epoch}")

    def __reduce__(self):
        return RankLostExit, (self.epoch,)


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
    is what the owner promises to do at its `boundary` before exiting 75.
    `profile=True` (the telemetry bus on) also claims SIGUSR1, the
    on-demand capture: its handler only sets a flag, which the owner takes
    at its boundary (`take_profile_request`) and answers with a post-mortem
    snapshot, training on."""

    def __init__(self, action: str = "checkpoint",
                 boundary: str = "step boundary", profile: bool = False):
        self.action = action
        self.boundary = boundary
        self.profile = profile and hasattr(signal, "SIGUSR1")
        self._requested: Optional[str] = None
        self._profile_requested = False
        self._old_handlers: dict = {}

    def install(self):
        """In the main thread only (a handler cannot be set elsewhere)."""
        if threading.current_thread() is threading.main_thread():
            sigs = [(signal.SIGTERM, self._on_signal),
                    (signal.SIGINT, self._on_signal)]
            if self.profile:
                sigs.append((signal.SIGUSR1, self._on_profile))
            for sig, handler in sigs:
                try:
                    self._old_handlers[sig] = signal.signal(sig, handler)
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

    def _on_profile(self, signum, frame):
        # a flag only: the boundary does the capture
        self._profile_requested = True
        sys.stderr.write(
            "\n[obs] SIGUSR1 received: will capture stacks + metrics at the "
            "next step boundary\n")

    def take_profile_request(self) -> bool:
        """True exactly once per SIGUSR1: the owner consumes the flag."""
        if self._profile_requested:
            self._profile_requested = False
            return True
        return False

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
        `nan@E12,sigterm@E20:r1,hang@E8,ckpt-corrupt@E10`; `r<rank>` is the
        coordination rank (the JAX package's process; 0 without a
        coordinator), and a term without it fires on every rank. Every term
        is validated even when it targets another rank. A malformed term
        raises ValueError; `ranklost` without an explicit `:r<rank>` a
        ConfigError (losing every rank is not a resize)."""
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
            if kind == "ranklost" and not rsep:
                raise ConfigError(
                    f"--inject term {term!r}: ranklost needs an explicit "
                    f":r<rank> target (losing every rank is not a resize); "
                    f"use ranklost@E<epoch>:r<rank>")
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


def _parse_serve_term(term: str) -> tuple[str, int, Optional[tuple]]:
    """Validate one serving-fault term, `kind@<N>[:p<part>.r<replica>]`,
    and return (kind, N, target): target is (part, replica) or None.
    servekill and servehang need the target (wedging every backend is not
    a failover test); servedrop may stay fleet-wide."""
    kind, sep, rest = term.partition("@")
    nth, tsep, tgt = rest.partition(":")
    if not sep or not nth.isdigit():
        raise ValueError(
            f"bad --inject term {term!r}: expected "
            f"kind@<N>[:p<part>.r<replica>] "
            f"(serve kinds: {', '.join(SERVE_FAULT_KINDS)})")
    target = None
    if tsep:
        m = re.fullmatch(r"p(\d+)\.r(\d+)", tgt)
        if not m:
            raise ValueError(
                f"bad --inject term {term!r}: backend target must be "
                f"p<part>.r<replica> (e.g. servekill@5:p0.r1)")
        target = (int(m.group(1)), int(m.group(2)))
    if kind in ("servekill", "servehang") and target is None:
        raise ConfigError(
            f"--inject term {term!r}: {kind} needs an explicit "
            f":p<part>.r<replica> target (wedging every backend is not a "
            f"failover test); use {kind}@<N>:p<part>.r<replica>")
    return kind, int(nth), target


@dataclass
class ServeFaultPlan:
    """The serving-fault terms of an --inject spec that target ONE backend
    (part, replica): kind -> the data-path request ordinals it fires at,
    each once. Training terms are left to FaultPlan; both parsers validate
    every term of a mixed spec."""

    faults: dict = field(default_factory=dict)   # kind -> set of ordinals

    @staticmethod
    def parse(spec: str, part: int = -1, replica: int = 0
              ) -> "ServeFaultPlan":
        plan = ServeFaultPlan()
        for term in filter(None, (t.strip() for t in spec.split(","))):
            if term.partition("@")[0] not in SERVE_FAULT_KINDS:
                continue                # a training term: FaultPlan's
            kind, nth, target = _parse_serve_term(term)
            if target is not None and target != (part, replica):
                continue                # valid, targets another backend
            plan.faults.setdefault(kind, set()).add(nth)
        return plan

    def pop(self, kind: str, count: int) -> bool:
        """True exactly once when `kind` is scheduled at request `count`."""
        ns = self.faults.get(kind)
        if ns and count in ns:
            ns.discard(count)
            return True
        return False

    def empty(self) -> bool:
        return not any(self.faults.values())


def check_inject(spec: str) -> None:
    """Validate an --inject spec before any rank starts: a malformed term,
    or `ranklost` without its rank, raises a ConfigError (the CLI exits
    2)."""
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
    import torch    # here: the serving router imports this module torch-free
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
    the interpreter's exit. With a coordinator (a launch's rank 0) it also
    sends the alive-beat every ALIVE_BEAT_S, so peers can tell a dead
    launch from a slow step, and its dump prints the peers' liveness; with
    a post-mortem directory (`--obs on`) the dump is also a file, and the
    bus gets a `watchdog_fire` event."""

    POLL_S = 0.25
    ROLLING = 20
    ALIVE_BEAT_S = 2.0

    def __init__(self, log=print, coord=None, postmortem_dir=None, obs=None):
        super().__init__(name="bnsgcn-watchdog", daemon=True)
        self.log = log
        self.coord = coord
        self.postmortem_dir = postmortem_dir
        self.obs = obs
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
        last_alive, wait = 0.0, 0.0
        # the first pass at once: a launch lost within its first poll would
        # otherwise have no alive-beat on record, and peers never impute a
        # launch that never beat dead (a start-up race must time out)
        while not self._halt.wait(wait):
            wait = self.POLL_S
            with self._lock:
                epoch, last_beat = self._epoch, self._last_beat
                paused = self._paused > 0
            if self.coord is not None:
                # from this thread: the process is up even while the main
                # thread is stuck in a collective or a coordinator wait
                now = time.monotonic()
                if now - last_alive >= self.ALIVE_BEAT_S:
                    last_alive = now
                    try:
                        self.coord.heartbeat(epoch, self.coord.ALIVE_KEY)
                    except Exception:
                        pass        # best effort; never kills the watchdog
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
            if self.coord is not None:
                # a hung collective names the launch that stalled it
                try:
                    self.coord.log_liveness(
                        write=lambda m: sys.stderr.write(m + "\n"))
                except Exception:
                    pass
            dump_path = ""
            if self.postmortem_dir:
                dump_path = obs_mod.write_postmortem(
                    self.postmortem_dir, f"watchdog_E{epoch}",
                    text=(f"watchdog: no step-boundary heartbeat for "
                          f"{idle:.1f}s (deadline {deadline:.1f}s, last "
                          f"epoch {epoch}); exiting {EXIT_WATCHDOG}"),
                    registry=(self.obs.registry
                              if self.obs is not None else None))
                if dump_path:
                    sys.stderr.write(
                        f"[watchdog] post-mortem dump: {dump_path}\n")
            if self.obs is not None:
                try:
                    self.obs.emit_bounded("watchdog_fire", epoch=epoch,
                                          idle_s=round(idle, 1),
                                          deadline_s=round(deadline, 1),
                                          dump=dump_path or None)
                except Exception:
                    pass
            sys.stderr.flush()
        except Exception:
            pass    # dumping must never mask the exit itself


# ----------------------------------------------------------------------------
# the manager train_loop threads its loop through
# ----------------------------------------------------------------------------

class CoordLink:
    """A launch's access to the rank coordinator. The launch's rank 0 holds
    the Coordinator (`coord`; None on its other ranks); `call(fn)` runs
    fn(coord) there and hands its result, or the coordination error it
    raised, to every rank of the launch over `comm` (the launch's group; None
    when the launch is one process), which then returns or raises alike.
    `share(fn)` hands fn()'s result, or its error's text, from rank 0 of
    `state_comm` (the launch's group by default; the world's when the
    launches share one, as node launches do: their state comes from global
    rank 0, as a JAX pod's from process 0) to its ranks, without raising."""

    def __init__(self, coord, comm=None, state_comm=None):
        self.coord, self.comm, self.state_comm = coord, comm, state_comm
        self.relay_s = 0.0      # the last relay's seconds (host clock)

    @property
    def lead(self) -> bool:
        return self.coord is not None

    def _relay(self, out):
        if self.comm is None:
            return out
        t0 = time.perf_counter()
        got = self.comm.broadcast_object(out if self.lead else None)
        self.relay_s = time.perf_counter() - t0
        return got

    def call(self, fn):
        out = None
        if self.lead:
            try:
                out = ("ok", fn(self.coord))
            except CoordError as e:
                out = ("err", e)
            except Exception as e:
                self._relay(("fail", f"{type(e).__name__}: {e}"))
                raise
        kind, v = self._relay(out)
        if kind == "err":
            raise v
        if kind == "fail":
            raise RuntimeError(f"the launch's rank 0 failed: {v}")
        return v

    def share(self, fn) -> tuple:
        """(True, fn()) or (False, the error's text), on every rank."""
        comm = self.state_comm if self.state_comm is not None else self.comm
        out = None
        if comm is None or comm.rank == 0:
            try:
                out = (True, fn())
            except Exception as e:
                out = (False, f"{type(e).__name__}: {e}")
        return out if comm is None else comm.broadcast_object(out)


class ResilienceManager:
    """One per rank and run (`--resilience on`): the signal handlers, the
    watchdog, the fault plan and the rollback state. `rank` is the rank the
    fault plan targets (the coordination rank, 0 without a coordinator),
    `lead` whether this rank writes checkpoints and the report (global rank
    0 of coordination rank 0's launch), `launch_lead` whether it is its
    launch's rank 0 (it tears a checkpoint for `ckpt-corrupt`). `find_ckpt
    (cfg, log, before_epoch)` picks the uncoordinated rollback's checkpoint
    (at P > 1 rank 0's read, broadcast); `forwarded()` names a signal the
    launcher forwarded, or None. `link` (a CoordLink) is the coordinator,
    None without one; `obs` the telemetry bus (the launch's rank 0 alone
    holds one). `close()` restores the process to its state before
    `start()`."""

    def __init__(self, cfg, log=print, start_epoch: int = 0,
                 retry_nonce: int = 0, rank: int = 0, lead: bool = True,
                 launch_lead: Optional[bool] = None,
                 find_ckpt: Optional[Callable] = None,
                 forwarded: Optional[Callable[[], Optional[str]]] = None,
                 link: Optional[CoordLink] = None, obs=None,
                 resize_nonce: int = 0):
        self.cfg = cfg
        self.log = log
        self.start_epoch = start_epoch
        self.rank, self.lead = rank, lead
        self.launch_lead = lead if launch_lead is None else launch_lead
        self.link = link
        self.coord = link.coord if link is not None else None
        # coordination rank 0's launch rank 0: the one that decides
        self.decides = self.coord is not None and self.coord.rank == 0
        self.obs = obs
        self.postmortem_dir = (obs_mod.postmortem_dir(cfg)
                               if obs is not None else None)
        spec = cfg.inject or os.environ.get("BNSGCN_FAULT", "")
        self.plan = FaultPlan.parse(spec, rank=rank)
        if not self.launch_lead:
            # ckpt-corrupt tears the newest file once, on the launch's
            # rank 0
            self.plan.faults.pop("ckpt-corrupt", None)
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
        # the elastic world size (--elastic on, with a coordinator): a lost
        # launch is a resize verdict, not a CoordTimeout (77)
        self.elastic = (getattr(cfg, "elastic", "off") == "on"
                        and link is not None)
        self.resize_nonce = resize_nonce    # restore-carrying resizes so
                                            # far: folds the keys under a
                                            # domain of its own
        self.resizes = 0
        self.max_resizes = int(os.environ.get(
            "BNSGCN_ELASTIC_MAX_RESIZES", 8))
        self._find_ckpt = find_ckpt or ckpt.latest_valid_checkpoint
        self._forwarded = forwarded
        self._sleep = time.sleep
        self._snapshot = None
        self._pending_payload = None    # the decider's: the payload
                                        # plan_rollback just validated, so
                                        # coord_restore never re-reads it
        self._signals = PreemptSignals(action="checkpoint",
                                       profile=obs is not None)
        self.watchdog = Watchdog(log, coord=self.coord,
                                 postmortem_dir=self.postmortem_dir, obs=obs)

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

    # -- preemption / on-demand capture --

    @property
    def preempt_requested(self) -> Optional[str]:
        """The signal that asked this rank to stop: its own, or one its
        launcher forwarded."""
        own = self._signals.requested
        if own is None and self._forwarded is not None:
            return self._forwarded()
        return own

    def take_profile_request(self) -> bool:
        """True once per SIGUSR1 (`--obs on` only)."""
        return self._signals.take_profile_request()

    def _emit(self, kind: str, **fields):
        if self.obs is not None:
            self.obs.emit(kind, **fields)

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
        DivergenceError with the report once the retries are exhausted.
        The twin of plan_rollback / coord_restore (the coordinated split of
        the same policy): change one, change both."""
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
        self._emit("rollback", epoch=int(epoch), restart=int(restart),
                   source=src, nonce=int(self.nonce), loss=float(loss_f),
                   retry=self.retries, limit=limit)
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
        written = True
        if self.lead:
            try:
                os.makedirs(self.cfg.ckpt_path, exist_ok=True)
                with open(rp, "w") as f:
                    f.write(report + "\n")
            except OSError:
                written = False
        if written:
            report += f"\n  report written to {rp}"
        pm = ""
        if self.postmortem_dir:
            pm = obs_mod.write_postmortem(
                self.postmortem_dir, f"divergence_E{epoch}", text=report,
                registry=self.obs.registry)
            if pm:
                report += f"\n  post-mortem dump: {pm}"
        self._emit("divergence_abort", epoch=int(epoch),
                   loss=float(loss_f), retries=self.retries - 1,
                   dump=pm or None)
        return report

    # -- the coordinated verdicts (a coordinator runs) --

    def agree_step(self, epoch: int, state: str, loss_f: float = 0.0,
                   summary: Optional[dict] = None,
                   final: bool = False) -> dict:
        """One step-boundary verdict exchange, on every rank of the launch:
        the launch's rank 0 contributes `state` ('ok' | 'diverged' |
        'preempted', already the launch's) and relays the agreed decision.
        Coordination rank 0 reduces worst-wins and owns a rollback's
        checkpoint, restart epoch, retry nonce and backoff (plan_rollback),
        under --elastic on a lost peer's resize (plan_resize) and a rejoin
        (plan_grow); every other rank records the rollback from the
        decision. `summary` (the bus on) rides the verdict: coordination
        rank 0 merges every launch's into one `epoch_ranks` event. `final`
        marks the last step boundary (the agree cadence always exchanges
        there)."""
        decision = self.link.call(lambda coord: self._agree(
            coord, epoch, state, loss_f, summary, final))
        act = decision["decision"]
        if act == "resize":
            self.resize_nonce = int(decision.get("nonce", self.resize_nonce))
        if act == "rollback" and not self.decides:
            self.nonce = int(decision["nonce"])
            self.rollbacks.append({
                "epoch": int(decision["epoch"]),
                "restart": int(decision["restart"]),
                "source": decision["source"], "nonce": self.nonce})
        return decision

    def _agree(self, coord, epoch, state, loss_f, summary, final) -> dict:
        """agree_step's half on the launch's rank 0 (bnsgcn_tpu/resilience.py
        :730): the exchange, the events and the lines."""
        decide = None
        if coord.rank == 0:
            def decide(name, states):
                if name == "resize":
                    return self.plan_resize(epoch, states, loss_f)
                if name == "rollback":
                    return self.plan_rollback(epoch, loss_f, states)
                if name == "preempt":
                    who = [r for r, s in states.items() if s == "preempted"]
                    return {"decision": "preempt", "ranks": who}
                if name == "abort":
                    return {"decision": "abort", "why": "peer",
                            "report": f"a rank reported abort: {states}"}
                if self.elastic:
                    # a clean boundary is the only admission point
                    for r, tok in coord.poll_rejoin():
                        return self.plan_grow(epoch, r, tok)
                return {"decision": "ok"}
        decision = coord.agree(epoch, state, decide, info=summary,
                               final=final)
        if (self.obs is not None and coord.rank == 0
                and not decision.get("deferred") and coord.last_infos):
            self.obs.emit("epoch_ranks", epoch=int(epoch),
                          decision=decision.get("decision", "ok"),
                          ranks={str(r): i for r, i in
                                 sorted(coord.last_infos.items())})
        if (decision.get("decision", "ok") != "ok"
                and not decision.get("deferred")):
            self._emit("coord_decision", epoch=int(epoch),
                       decision=decision["decision"], local_state=state)
        if decision["decision"] == "resize":
            if coord.rank in [int(r) for r in decision.get("lost", [])]:
                raise CoordAbort(
                    f"rank {coord.rank} was declared lost by the "
                    f"resize verdict while still alive — its alive-beats "
                    f"stalled past {coord.dead_after_s:.1f}s (raise "
                    f"$BNSGCN_ELASTIC_DEAD_S if the host is just slow)")
            if coord.rank != 0:
                self.log(
                    f"[resilience] agreed resize (decided by rank 0): world "
                    f"{decision['old_world']} -> {decision['world']} "
                    f"({decision['trigger']}), restart "
                    f"{decision['restart']} from {decision['source']}, "
                    f"resize-nonce {int(decision.get('nonce', 0))}")
            self._emit("resize", epoch=int(decision["epoch"]),
                       old_world=int(decision["old_world"]),
                       world=int(decision["world"]),
                       members=[int(r) for r in decision["members"]],
                       lost=[int(r) for r in decision.get("lost", [])],
                       slots=[int(s) for s in decision.get("slots", [])],
                       trigger=str(decision["trigger"]),
                       nonce=int(decision.get("nonce", 0)),
                       restart=int(decision["restart"]),
                       source=str(decision["source"]))
        if decision["decision"] == "rollback" and coord.rank != 0:
            self._emit("rollback", epoch=int(decision["epoch"]),
                       restart=int(decision["restart"]),
                       source=decision["source"],
                       nonce=int(decision["nonce"]), agreed=True)
            self.log(
                f"[resilience] agreed rollback (decided by rank 0): epoch "
                f"{decision['epoch']} -> restart {decision['restart']} from "
                f"{decision['source']}, retry-nonce {decision['nonce']}")
        return decision

    def plan_rollback(self, epoch: int, loss_f: float,
                      states: Optional[dict] = None) -> dict:
        """Coordination rank 0's half of a coordinated rollback (its
        launch's rank 0, reading its own checkpoint directory): the newest
        valid checkpoint before `epoch` (or the initial snapshot), the
        retry and nonce accounting, and the decision every launch restores
        with; exhausted retries give an 'abort' decision carrying the
        report, so that every launch raises DivergenceError (76). The
        backoff is slept by every rank in coord_restore, after the
        decision is out. The twin of `rollback`."""
        self.retries += 1
        limit = max(int(self.cfg.resil_retries), 0)
        found = ckpt.latest_valid_checkpoint(self.cfg, log=self.log,
                                             before_epoch=epoch)
        if self.retries > limit:
            return {"decision": "abort", "why": "divergence",
                    "report": self._report(epoch, loss_f, found)}
        if found is not None:
            path, self._pending_payload = found
            restart = int(self._pending_payload["epoch"]) + 1
            src = os.path.basename(path)
        else:
            if self._snapshot is None:
                return {"decision": "abort", "why": "divergence",
                        "report": self._report(epoch, loss_f, None)}
            self._pending_payload = None
            restart = self.start_epoch
            src = "<initial state>"
        self.nonce += 1
        self.rollbacks.append({"epoch": epoch, "restart": restart,
                               "source": src, "nonce": self.nonce})
        self._emit("rollback", epoch=int(epoch), restart=int(restart),
                   source=src, nonce=int(self.nonce), loss=float(loss_f),
                   retry=self.retries, limit=limit, agreed=True)
        diverged = sorted(r for r, s in (states or {}).items()
                          if s == "diverged")
        self.log(
            f"[resilience] non-finite training state at epoch {epoch} on "
            f"rank(s) {diverged or [self.rank]} (loss={loss_f}): agreed "
            f"rollback to {src}, restarting all ranks at epoch {restart} "
            f"with retry-nonce {self.nonce} (retry {self.retries}/{limit})")
        return {"decision": "rollback", "epoch": int(epoch),
                "restart": int(restart), "nonce": int(self.nonce),
                "source": src, "retry": self.retries, "limit": limit,
                "backoff_s": min(self.backoff_cap,
                                 self.backoff_base * (2 ** (self.retries - 1)))}

    def _pick_restore(self, epoch: int) -> tuple[int, str]:
        """The newest valid checkpoint before `epoch`'s boundary (or the
        initial snapshot): the restore a resize carries; sets
        `_pending_payload` as plan_rollback does."""
        found = ckpt.latest_valid_checkpoint(self.cfg, log=self.log,
                                             before_epoch=epoch)
        if found is not None:
            path, self._pending_payload = found
            return (int(self._pending_payload["epoch"]) + 1,
                    os.path.basename(path))
        self._pending_payload = None
        return self.start_epoch, "<initial state>"

    def plan_resize(self, epoch: int, states: dict,
                    loss_f: float = 0.0) -> dict:
        """Coordination rank 0's shrink verdict: the launches imputed
        'lost' leave the member set, every survivor restores the newest
        valid checkpoint (or the initial snapshot) and folds its keys under
        a new resize nonce, and the P parts map onto the survivors
        (plan_slots: contiguous blocks, no re-partition). An agreed abort
        when the survivors are fewer than --elastic-min-world or the resize
        budget is spent."""
        from bnsgcn_tpu_torch.parallel.mesh import plan_slots
        coord = self.coord
        lost = sorted(int(r) for r, s in states.items() if s == "lost")
        survivors = [r for r in coord.members if r not in lost]
        self.resizes += 1
        if self.resizes > self.max_resizes:
            return {"decision": "abort", "why": "peer",
                    "report": f"resize budget exhausted "
                              f"({self.max_resizes} per run, "
                              f"$BNSGCN_ELASTIC_MAX_RESIZES): rank(s) "
                              f"{lost} lost at epoch {epoch}"}
        if len(survivors) < max(coord.min_world, 1):
            return {"decision": "abort", "why": "peer",
                    "report": f"rank(s) {lost} lost at epoch {epoch} but "
                              f"only {len(survivors)} survivor(s) remain "
                              f"(--elastic-min-world {coord.min_world})"}
        restart, src = self._pick_restore(epoch)
        self.resize_nonce += 1
        n_parts = int(getattr(self.cfg, "n_partitions", len(survivors)))
        slots = [survivors[s] for s in plan_slots(n_parts, len(survivors))]
        self.log(
            f"[resilience] rank(s) {lost} lost at epoch {epoch}: agreed "
            f"resize, world {len(coord.members)} -> {len(survivors)} "
            f"(survivors {survivors}), all survivors restart at epoch "
            f"{restart} from {src} with resize-nonce {self.resize_nonce} "
            f"folded into the sampling/dropout keys")
        return {"decision": "resize", "trigger": "ranklost",
                "epoch": int(epoch), "old_world": len(coord.members),
                "world": len(survivors), "members": survivors,
                "lost": lost, "slots": slots, "restart": int(restart),
                "source": src, "retry_nonce": int(self.nonce),
                "nonce": int(self.resize_nonce), "backoff_s": 0.0}

    def plan_grow(self, epoch: int, rank: int, token: str) -> dict:
        """Coordination rank 0's grow verdict: `rank`'s replacement joins
        the member set again; every member (the joiner too, from its grant)
        restores the newest valid checkpoint and replays from it with the
        folds unchanged (no new resize nonce), so the outcome does not
        depend on when the rejoin happened. The grant also carries the
        schedule position, so the joiner's next exchange is in step."""
        from bnsgcn_tpu_torch.parallel.mesh import plan_slots
        coord = self.coord
        members = sorted(set(coord.members) | {int(rank)})
        restart, src = self._pick_restore(epoch)
        n_parts = int(getattr(self.cfg, "n_partitions", len(members)))
        slots = [members[s] for s in plan_slots(n_parts, len(members))]
        decision = {"decision": "resize", "trigger": "rejoin",
                    "epoch": int(epoch), "old_world": len(coord.members),
                    "world": len(members), "members": members,
                    "lost": [], "joined": [int(rank)], "slots": slots,
                    "restart": int(restart), "source": src,
                    "retry_nonce": int(self.nonce),
                    "nonce": int(self.resize_nonce), "backoff_s": 0.0}
        grant = dict(decision)
        # agree() already advanced both counters for this exchange: where
        # every survivor stands when it acts on the decision
        grant["seq"] = coord._seq
        grant["agree_calls"] = coord._agree_calls
        coord.grant_rejoin(int(rank), token, grant)
        self.log(
            f"[resilience] rank {rank} rejoined at epoch {epoch}: agreed "
            f"resize, world {len(coord.members)} -> {len(members)}, "
            f"all members restart at epoch {restart} from {src} (folds "
            f"unchanged — the replay rejoins the same trajectory)")
        return decision

    def coord_restore(self, decision: dict, model, opt,
                      cut: Optional[Callable] = None,
                      ack_name: str = "rollback") -> None:
        """Every rank's half of a coordinated rollback or resize: sleep the
        agreed backoff, restore the decision's source in place (a file of
        the launch's own checkpoint directory, read by its rank 0 and handed
        to its ranks; the decider reuses the payload plan_rollback
        validated; '<initial state>' each rank's own snapshot), then ack
        through the coordinator. A launch that cannot restore fails the ack
        and every rank of every launch raises CoordAbort (78)."""
        from bnsgcn_tpu_torch.trainer import load_host_state, restore_payload
        backoff = float(decision.get("backoff_s", 0.0))
        if backoff > 0:
            self.log(f"[resilience] backing off {backoff:.1f}s before "
                     f"agreed retry {decision.get('retry')}"
                     f"/{decision.get('limit')}")
            self._sleep(backoff)
        src = decision["source"]
        ok, err = True, ""
        try:
            if src == "<initial state>":
                if self._snapshot is None:
                    raise CheckpointUnavailable("no initial snapshot")
                load_host_state(self._snapshot, model, opt)
            else:
                def read():
                    payload = self._pending_payload
                    if payload is None:
                        payload = ckpt.read_blob(
                            os.path.join(self.cfg.ckpt_path, src))
                    return payload
                got, payload = self.link.share(read)
                if not got:
                    raise CheckpointUnavailable(payload)
                restore_payload(payload, model, opt, cut)
        except (ckpt.CheckpointCorrupt, CheckpointUnavailable,
                OSError) as ex:
            ok, err = False, f"{type(ex).__name__}: {ex}"
            self.log(f"[resilience] rank {self.rank} cannot restore "
                     f"{src}: {err}")
        finally:
            self._pending_payload = None
        all_ok, fails = self.link.call(
            lambda coord: coord.gather_ok(ack_name, ok, err))
        if not all_ok:
            raise CoordAbort(
                f"coordinated {ack_name} failed — rank(s) could not restore "
                f"{src!r}: "
                + "; ".join(f"rank {r}: {d}" for r, d in sorted(fails.items())))

    @staticmethod
    def raise_abort(decision: dict):
        """An agreed 'abort' decision's exception (and so exit code), the
        same on every rank."""
        if decision.get("why") == "divergence":
            raise DivergenceError(decision.get("report",
                                               "divergence abort (agreed)"))
        raise CoordAbort(decision.get("report",
                                      "coordinated abort (agreed)"))

    # -- fault injection --

    def fire_injections(self, epoch: int) -> dict:
        """Apply this epoch's scheduled faults at the step boundary. Returns
        {'nan': bool}: the caller poisons the parameters (it owns them);
        `sigterm` raises the real signal through the installed handler,
        `hang` blocks the main thread so the watchdog fires for real,
        `ckpt-corrupt` tears the newest periodic checkpoint, and `ranklost`
        raises RankLostExit."""
        out = {"nan": self.plan.pop("nan", epoch)}
        if self.plan.pop("sigterm", epoch):
            self.log(f"[inject] sigterm@E{epoch}")
            self._emit("inject", kind_injected="sigterm", epoch=int(epoch))
            signal.raise_signal(signal.SIGTERM)
        if self.plan.pop("ckpt-corrupt", epoch):
            latest = ckpt.latest_checkpoint(self.cfg)
            if latest:
                corrupt_file(latest)
                self.log(f"[inject] ckpt-corrupt@E{epoch}: tore {latest}")
            else:
                self.log(f"[inject] ckpt-corrupt@E{epoch}: no checkpoint yet")
        if self.plan.pop("ranklost", epoch):
            self.log(f"[inject] ranklost@E{epoch}: dropping this rank with "
                     f"no coordinator goodbye — peers must detect the "
                     f"heartbeat silence")
            self._emit("inject", kind_injected="ranklost", epoch=int(epoch))
            raise RankLostExit(epoch)
        if self.plan.pop("hang", epoch):
            self.log(f"[inject] hang@E{epoch}: blocking the step (watchdog "
                     f"deadline {self.watchdog.deadline_s():.1f}s)")
            while True:                 # the watchdog ends the process
                time.sleep(3600)
        if out["nan"]:
            self.log(f"[inject] nan@E{epoch}: poisoning params")
            self._emit("inject", kind_injected="nan", epoch=int(epoch))
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
