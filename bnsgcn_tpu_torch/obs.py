"""The telemetry bus (counterpart of bnsgcn_tpu/obs.py, the same code and
the same log format): structured run metrics and a post-mortem trail.

* **Registry**: process-wide counters, gauges and fixed-log-bucket
  streaming histograms (p50/p99 without storing samples: a quantile is the
  geometric midpoint of the bucket that holds it, so its relative error is
  bounded and the memory is constant).
* **EventLog**: a rank-tagged JSONL event log (`--obs-log PATH` or
  $BNSGCN_OBS_LOG; coordination ranks > 0 write `PATH.r<rank>`), bounded in
  size with one rotation (`PATH.1`). Every line is flushed as written, so
  the log keeps the event that preceded an os._exit (the watchdog's 77).
* **Post-mortem capture**: `write_postmortem` writes every thread's stack
  and a registry snapshot under `--obs-dir` (default
  `{ckpt_path}/postmortem`), for the watchdog's and the divergence abort's
  exits and a SIGUSR1 request.

In a run (run.py) the log is written by the process that holds the rank
coordinator, or would: a launch's local rank 0 (the process itself at
P=1), tagged with its coordination rank. `--obs off` builds none of this
(make_obs returns None; every call site checks) and trains bitwise as
`on`: the bus reads host values the loop already has and adds no device
work. tools/obs_report.py renders a log.
"""

from __future__ import annotations

import faulthandler
import json
import math
import os
import sys
import threading
import time
from typing import Optional

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "EventLog", "Obs",
    "make_obs", "postmortem_dir", "write_postmortem", "load_events",
    "rank_log_path", "EVENT_KINDS",
]


# The closed vocabulary of event kinds, the JAX package's tuple word for
# word (tests pin it equal), so a reader of either package's logs knows
# every kind. The port emits the training and resilience kinds of the paths
# it runs; 'trace', 'overlap' and 'profile' come from the JAX package's
# profiler windows, 'tune_decision' and 'strict_exec' from its tuner and
# guard, 'serve_header', 'serve_drain', 'delta' and 'serve_compact' from
# its server (serve.py), and the serving fleet's, continual, bench and
# analysis kinds from its other subsystems, not ported yet.
EVENT_KINDS = (
    # training lifecycle (run.py)
    "run_header", "epoch", "epoch_ranks", "eval", "trace", "overlap",
    "halo_refresh", "reorder", "layout_build", "tune_decision", "run_end",
    # resilience (resilience.py: injections, rollback consensus, exits;
    # 'resize' = the elastic shrink/grow verdict: old/new world, part->slot
    # map, trigger, resize nonce)
    "inject", "rollback", "divergence_abort", "coord_decision",
    "watchdog_fire", "preempt", "resize", "profile_request", "profile",
    # serving (serve.py; serve_router.py / serve_backend.py for the
    # partition-sharded fleet)
    "serve_header", "serve_drain", "delta", "serve_fleet", "serve_compact",
    # serving-fleet self-healing (serve_router.py): 'serve_health' = one
    # backend's up/suspect/down/quarantined transition with the probe
    # evidence; 'failover' = a read answered by a non-primary replica, a
    # degraded answer, or a WAL replay — the router's recovery actions
    "serve_health", "failover",
    # continual training on an evolving graph (continual.py ingestion/
    # promotion cycle; serve.py emits 'promote' at the adoption boundary)
    "continual_cycle", "artifact_update", "promote",
    # benchmarking (bench.py)
    "bench_header", "bench_variant", "bench_end",
    # strict-execution guard (strict.py, --strict-exec)
    "strict_exec",
    # jaxpr-level static preflight (analysis/ir, `-m bnsgcn_tpu.analysis ir`)
    "ir_audit",
    # protocol model-checking preflight (analysis/proto,
    # `-m bnsgcn_tpu.analysis proto`)
    "proto_audit",
    # predictive cost-model audit (analysis/perf, `-m bnsgcn_tpu.analysis
    # perf`)
    "perf_audit",
)


# ----------------------------------------------------------------------------
# metrics: counters, gauges, streaming histograms
# ----------------------------------------------------------------------------

class Counter:
    """Monotonic count; thread-safe via the owning Registry's lock discipline
    (increments are a single int add under the GIL — atomic enough for
    telemetry; the registry snapshot takes the lock for consistency)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1):
        self.value += int(n)


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)


class Histogram:
    """Fixed-log-bucket streaming histogram: p50/p99 without sample storage.

    Bucket i holds values in [lo * growth^(i-1), lo * growth^i); bucket 0 is
    the underflow (< lo, including 0/negatives), the last the overflow. A
    quantile is the geometric midpoint of the bucket the target count falls
    in, so the relative error is bounded by sqrt(growth) - 1 (~4.4% at the
    default growth 2^(1/8)) — tests/test_obs.py pins known-quantile inputs.
    Memory is the bucket array, constant for the life of the run."""

    __slots__ = ("lo", "growth", "_log_g", "n", "counts", "count", "total",
                 "vmin", "vmax")

    def __init__(self, lo: float = 1e-4, growth: float = 2 ** 0.125,
                 n_buckets: int = 256):
        self.lo = float(lo)
        self.growth = float(growth)
        self._log_g = math.log(growth)
        self.n = int(n_buckets)
        self.counts = [0] * (self.n + 2)    # [underflow, n buckets, overflow]
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _idx(self, v: float) -> int:
        if v < self.lo:
            return 0
        i = 1 + int(math.log(v / self.lo) / self._log_g)
        return min(i, self.n + 1)

    def observe(self, v: float):
        v = float(v)
        if not math.isfinite(v):
            return      # a NaN/inf measurement is dropped, never a crash —
                        # the bus's contract is that telemetry cannot kill
                        # the subsystem feeding it (int(nan) would raise)
        self.counts[self._idx(v)] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def _bucket_mid(self, i: int) -> float:
        if i <= 0:
            return min(self.lo, self.vmin)
        if i >= self.n + 1:
            return max(self.lo * self.growth ** self.n, self.vmax)
        # geometric midpoint of [lo*g^(i-1), lo*g^i)
        return self.lo * self.growth ** (i - 0.5)

    def percentile(self, q: float) -> float:
        """Value at quantile q in [0, 100]; 0.0 for an empty histogram."""
        if self.count == 0:
            return 0.0
        target = max(q / 100.0 * self.count, 1.0)
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                # clamp into the observed range: a single-bucket histogram
                # must not report a midpoint outside [vmin, vmax]
                return float(min(max(self._bucket_mid(i), self.vmin),
                                 self.vmax))
        return float(self.vmax)

    def snapshot(self) -> dict:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p90": 0.0, "p99": 0.0}
        return {"count": self.count, "sum": round(self.total, 6),
                "min": round(self.vmin, 6), "max": round(self.vmax, 6),
                "p50": round(self.percentile(50), 6),
                "p90": round(self.percentile(90), 6),
                "p99": round(self.percentile(99), 6)}


class Registry:
    """Process-wide named metrics. Names are '/'-joined paths (e.g.
    'serve/latency_ms/A'); creation is idempotent and thread-safe, so any
    subsystem can grab its instruments without coordination."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}   # guarded-by: self._lock
        self._gauges: dict[str, Gauge] = {}       # guarded-by: self._lock
        self._hists: dict[str, Histogram] = {}    # guarded-by: self._lock

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str, **kw) -> Histogram:
        with self._lock:
            hit = self._hists.get(name)
            if hit is None:
                hit = self._hists[name] = Histogram(**kw)
            return hit

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: round(g.value, 6)
                           for k, g in self._gauges.items()},
                "histograms": {k: h.snapshot()
                               for k, h in self._hists.items()},
            }


# ----------------------------------------------------------------------------
# the structured JSONL event log
# ----------------------------------------------------------------------------

def _sanitize(v):
    """Strict-JSON-safe copy: non-finite floats (the NaN loss a rollback
    event exists to record) become their string form instead of the bare
    `NaN` token Python's json would emit — every line must parse under a
    strict reader, not just under json.loads."""
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    if isinstance(v, dict):
        return {k: _sanitize(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_sanitize(x) for x in v]
    return v

class EventLog:
    """Rank-tagged JSONL writer, size-bounded with one-deep rotation.

    Each `emit` appends one line `{"ts", "kind", "rank", ...fields}` and
    flushes — the log must survive os._exit (watchdog 77) with the
    triggering event on disk. When the file would exceed `max_bytes`
    (default $BNSGCN_OBS_MAX_MB = 64 MB) it rotates to `<path>.1`
    (overwriting the previous rotation), bounding total disk at ~2x the
    limit for the run's lifetime. Write failures disable the log with one
    stderr note — telemetry must never kill the run it observes."""

    def __init__(self, path: str, rank: int = 0,
                 max_bytes: Optional[int] = None):
        self.path = path
        self.rank = int(rank)
        if max_bytes is None:
            try:
                max_bytes = float(os.environ.get("BNSGCN_OBS_MAX_MB",
                                                 64)) * 2 ** 20
            except ValueError:
                # a typo'd env var must degrade, not crash-loop the run the
                # bus exists to observe (same contract as the open guard)
                sys.stderr.write("[obs] bad $BNSGCN_OBS_MAX_MB "
                                 f"{os.environ['BNSGCN_OBS_MAX_MB']!r}; "
                                 "using 64\n")
                max_bytes = 64 * 2 ** 20
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._f = None          # guarded-by: self._lock
        self._size = 0          # guarded-by: self._lock
        self._dead = False      # guarded-by: self._lock
        try:
            self._open_locked()
        except OSError as ex:
            # an unwritable $BNSGCN_OBS_LOG must degrade to a no-log run,
            # not crash-loop every requeued relaunch before training starts
            self._dead = True
            sys.stderr.write(f"[obs] cannot open event log {path}: "
                             f"{type(ex).__name__}: {ex}; telemetry log "
                             f"disabled for this run\n")

    def _open_locked(self):
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        self._f = open(self.path, "a")
        self._size = self._f.tell()

    def emit(self, kind: str, **fields) -> Optional[dict]:
        rec = {"ts": round(time.time(), 3), "kind": kind, "rank": self.rank}
        rec.update(fields)
        rec = _sanitize(rec)
        line = json.dumps(rec, default=str) + "\n"
        with self._lock:
            self._write_locked(line)
        return rec

    def emit_bounded(self, kind: str, timeout_s: float = 2.0, **fields):
        """Best-effort emit that gives up when the writer lock cannot be
        acquired within `timeout_s`. For exit paths — the watchdog's 77
        fires exactly when a wedged disk may have the MAIN thread stalled
        inside emit() holding the lock; a blocking acquire here would
        deadlock the escape hatch it is reporting."""
        rec = _sanitize({"ts": round(time.time(), 3), "kind": kind,
                         "rank": self.rank, **fields})
        line = json.dumps(rec, default=str) + "\n"
        if not self._lock.acquire(timeout=timeout_s):
            return
        try:
            self._write_locked(line)
        finally:
            self._lock.release()

    def _write_locked(self, line: str):
        if self._dead:
            return
        try:
            if self._size + len(line) > self.max_bytes and self._size > 0:
                self._f.close()
                os.replace(self.path, self.path + ".1")
                self._open_locked()
            self._f.write(line)
            self._f.flush()
            self._size += len(line)
        except (OSError, ValueError) as ex:
            self._dead = True
            sys.stderr.write(f"[obs] event log {self.path} disabled: "
                             f"{type(ex).__name__}: {ex}\n")

    def close(self):
        with self._lock:
            if self._f is not None and not self._dead:
                try:
                    self._f.close()
                except OSError:
                    pass
            self._f = None
            self._dead = True


def load_events(path: str, rotated: bool = True) -> list[dict]:
    """Parse a JSONL event log (optionally prepending its `.1` rotation),
    skipping torn lines — a reader must work on the log of a crashed run."""
    out: list[dict] = []
    paths = ([path + ".1"] if rotated and os.path.exists(path + ".1")
             else []) + [path]
    for p in paths:
        try:
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue        # torn final line of a killed run
        except OSError:
            continue
    return out


# ----------------------------------------------------------------------------
# the facade run.py and resilience.py thread through
# ----------------------------------------------------------------------------

class Obs:
    """One per run: a registry plus an optional event log. Without a log
    path the registry still works (serve's `stats`/`metrics` ops) and
    `emit` is a no-op — so default runs pay nothing but a dict lookup."""

    def __init__(self, path: str = "", rank: int = 0):
        self.rank = int(rank)
        self.registry = Registry()
        self.log_path = path or ""
        self.events = EventLog(path, rank=rank) if path else None

    def emit(self, kind: str, **fields):
        if self.events is not None:
            self.events.emit(kind, **fields)

    def emit_bounded(self, kind: str, **fields):
        """Never-blocking variant for exit paths (watchdog): skips the
        event rather than wait on a lock a stalled writer may hold."""
        if self.events is not None:
            self.events.emit_bounded(kind, **fields)

    def snapshot(self) -> dict:
        return self.registry.snapshot()

    def close(self):
        if self.events is not None:
            self.events.close()


def rank_log_path(path: str, rank: int) -> str:
    """Per-rank event-log file: rank 0 owns the bare path, every other rank
    writes `<path>.r<rank>` — two coordinated processes handed the same
    --obs-log must never interleave writes into one file."""
    return path if rank == 0 or not path else f"{path}.r{rank}"


def make_obs(cfg, rank: int = 0, log=print) -> Optional[Obs]:
    """Obs for this run, or None under `--obs off` (every call site guards —
    off constructs nothing: no registry, no file, no signal handler)."""
    if getattr(cfg, "obs", "on") != "on":
        return None
    path = cfg.obs_log or os.environ.get("BNSGCN_OBS_LOG", "")
    path = rank_log_path(path, rank)
    obs = Obs(path, rank=rank)
    if path:
        log(f"[obs] event log -> {path}")
    return obs


# ----------------------------------------------------------------------------
# post-mortem capture (watchdog 77, divergence 76, SIGUSR1 snapshots)
# ----------------------------------------------------------------------------

def postmortem_dir(cfg) -> str:
    """Where exits 75/76/77/78 leave their files: `--obs-dir`, default
    `{ckpt_path}/postmortem`."""
    return getattr(cfg, "obs_dir", "") or os.path.join(cfg.ckpt_path,
                                                       "postmortem")


def write_postmortem(dirpath: str, tag: str, text: str = "",
                     registry: Optional[Registry] = None,
                     stacks: bool = True) -> str:
    """Write `<tag>_<pid>.txt` (free text + all-thread stacks) and, when a
    registry is given, `<tag>_<pid>_metrics.json` (its snapshot) under
    `dirpath`. Returns the text file's path, or "" when the write failed
    (disk full — the exact condition post-mortems target): callers must
    not advertise a breadcrumb that does not exist. Never raises; the
    degraded fallback is the stderr dump the caller already made."""
    try:
        os.makedirs(dirpath, exist_ok=True)
        base = os.path.join(dirpath, f"{tag}_{os.getpid()}")
        path = base + ".txt"
        with open(path, "w") as f:
            if text:
                f.write(text.rstrip("\n") + "\n")
            if stacks:
                f.write("\n--- all-thread stacks ---\n")
                f.flush()
                faulthandler.dump_traceback(file=f, all_threads=True)
            f.flush()
            os.fsync(f.fileno())
    except OSError:
        return ""
    if registry is not None:
        try:
            with open(base + "_metrics.json", "w") as f:
                json.dump(registry.snapshot(), f, indent=1)
        except OSError:
            pass
    return path
