"""Closed-loop communication auto-tuner (`--tune {off,schedule,auto}`),
counterpart of bnsgcn_tpu/tune.py: the same grammar, policy and recovery,
held to it by tests/test_torch_tune.py.

BNS-GCN's five comm levers - BNS rate, halo strategy, wire codec,
`--halo-refresh K`, `--halo-mode` - are frozen at launch. This module moves
three of them (staleness K/mode, strategy, codec) at EPOCH BOUNDARIES,
driven by the per-epoch telemetry (loss trajectory, measured comm share,
wire MB):

* **`schedule`** - a declarative user schedule, e.g.
  ``K=4@0,K=2@30,K=1@60`` (grammar: comma-separated ``lever=value@epoch``;
  levers ``K``/``mode``/``strategy``/``wire`` alias the config fields
  ``halo_refresh``/``halo_mode``/``halo_exchange``/``halo_wire``). A pure
  function of the epoch - rank-symmetric, allowed everywhere.
* **`auto`** - the staleness axis as a feedback anneal: start coarse (K=4,
  or the launch point if it is already coarser - e.g. grad-only) while
  gradients are large, tighten one ladder rung (grad-only -> K=4 -> K=2 ->
  K=1) each time the loss flattens, and when the MEASURED comm share stays
  high, re-pick the halo strategy (`parallel/halo.retune_strategy`, the
  `--halo-exchange auto` byte estimate re-evaluated against observed cost)
  or anneal the wire codec native -> bf16. Within one launch the P rank
  processes read P clocks, so rank 0 decides and every rank applies its
  decision (run.py); across launches (more than one node, or a
  coordinator) `auto` is refused (ConfigError), as the JAX package refuses
  it outside one process.

Hysteresis is structural, not tuned: the staleness ladder only ever
TIGHTENS (monotone), the strategy re-pick and codec anneal fire at most
once per run, a flatness verdict must hold `AUTO_HOLD` consecutive epochs,
and every move starts an `AUTO_COOLDOWN`-epoch dwell - the controller
cannot flip-flop by construction.

Every applied move is a `tune_decision` lifecycle event carrying the
trigger metrics, and every move is STICKY: the Tuner records its decision
history, run.py round-trips it through checkpoint ``extra["tune"]``, and
after a rollback/resume the recorded decisions are REPLAYED by epoch
(reason ``replay``/``resume``) instead of re-derived - a healed run
executes the same schedule deterministically even though its
post-rollback metrics differ. Fresh (metric-driven) decisions happen only
past the furthest epoch the run has ever reached.

run.py owns the actuation: a decision rebuilds the step functions through
`trainer.build_step_fns` with the run's layout cache (the SpMM layout keys
do not depend on the halo levers, so a retune packs no layout twice),
invalidates the halo cache (the next epoch is a logged full refresh,
reason ``retune``), and re-arms `--strict-exec`'s per-variant build
allowance (`StrictExec.rearm`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional

from bnsgcn_tpu_torch.config import ConfigError

__all__ = ["Tuner", "AutoState", "decide", "parse_schedule",
           "startup_changes", "validate_mode", "bench_schedule",
           "reachable_lever_states"]

# schedule grammar lever aliases -> Config field names
LEVER_ALIASES = {
    "K": "halo_refresh", "k": "halo_refresh",
    "mode": "halo_mode",
    "strategy": "halo_exchange",
    "wire": "halo_wire",
}
# values a schedule (or auto) may set; halo_exchange excludes 'auto' on
# purpose - a retune picks a CONCRETE strategy, never re-delegates
VALID_VALUES = {
    "halo_mode": ("exchange", "grad-only"),
    "halo_exchange": ("padded", "shift", "ragged"),
    "halo_wire": ("native", "bf16", "fp8", "int8"),
}
TUNED_LEVERS = ("halo_refresh", "halo_mode", "halo_exchange", "halo_wire")

# --- auto-policy constants (see module docstring for the hysteresis story)
# staleness ladder, coarse -> fine; position only ever increases
STALENESS_LADDER = (("grad-only", 1), ("exchange", 4),
                    ("exchange", 2), ("exchange", 1))
AUTO_WINDOW = 5        # loss/comm samples a verdict needs
AUTO_HOLD = 2          # consecutive flat verdicts before tightening
AUTO_COOLDOWN = 3      # post-move dwell epochs (no further decisions)
# per-rung flatness thresholds: relative loss improvement PER EPOCH below
# which the current staleness level has extracted its value (coarser rungs
# tolerate less flatness - they should hand off while gradients still move)
TIGHTEN_RTOL = (0.03, 0.02, 0.005)
AUTO_COMM_FRAC = 0.30  # measured comm_s/step_s share that justifies
                       # strategy/codec moves
# the only codec move auto may take by itself: bf16 halos are the
# established near-lossless wire; fp8/int8 stay opt-in (quantization error
# is a per-model judgement the controller must not make)
WIRE_ANNEAL = {"native": "bf16"}


def _ladder_pos(levers: dict) -> int:
    if levers.get("halo_mode") == "grad-only":
        return 0
    k = int(levers.get("halo_refresh", 1))
    if k >= 4:
        return 1
    if k >= 2:
        return 2
    return 3


def parse_schedule(text: str) -> list:
    """``K=4@0,K=2@30,wire=bf16@30`` -> sorted ``[(epoch, {field: value})]``
    with same-epoch entries merged. Raises ConfigError on bad grammar, an
    unknown lever/value, or the same lever set twice at one epoch."""
    entries: dict[int, dict] = {}
    for raw in (text or "").split(","):
        item = raw.strip()
        if not item:
            continue
        try:
            lhs, ep_s = item.rsplit("@", 1)
            lever_s, val_s = lhs.split("=", 1)
            ep = int(ep_s)
        except ValueError:
            raise ConfigError(
                f"--tune-schedule entry {item!r}: expected lever=value@epoch "
                f"(e.g. K=4@0,K=2@30,K=1@60)") from None
        lever = LEVER_ALIASES.get(lever_s.strip())
        if lever is None:
            raise ConfigError(
                f"--tune-schedule entry {item!r}: unknown lever "
                f"{lever_s.strip()!r} (one of {sorted(set(LEVER_ALIASES))})")
        val_s = val_s.strip()
        if lever == "halo_refresh":
            try:
                val = int(val_s)
            except ValueError:
                raise ConfigError(
                    f"--tune-schedule entry {item!r}: K must be an integer") \
                    from None
            if val < 1:
                raise ConfigError(
                    f"--tune-schedule entry {item!r}: K must be >= 1")
        else:
            if val_s not in VALID_VALUES[lever]:
                raise ConfigError(
                    f"--tune-schedule entry {item!r}: {lever_s.strip()} must "
                    f"be one of {VALID_VALUES[lever]}")
            val = val_s
        if ep < 0:
            raise ConfigError(
                f"--tune-schedule entry {item!r}: epoch must be >= 0")
        at = entries.setdefault(ep, {})
        if lever in at:
            raise ConfigError(
                f"--tune-schedule sets {lever_s.strip()} twice at epoch {ep}")
        at[lever] = val
    return sorted(entries.items())


def validate_mode(cfg, multi_host: bool = False,
                  coordinated: bool = False) -> None:
    """Launch-time mode checks run.py applies before the first build."""
    if cfg.tune not in ("off", "schedule", "auto"):
        raise ConfigError(f"--tune must be off/schedule/auto, got {cfg.tune!r}")
    if cfg.tune == "schedule" and not (cfg.tune_schedule or "").strip():
        raise ConfigError("--tune schedule needs a --tune-schedule "
                          "(e.g. 'K=4@0,K=2@30,K=1@60')")
    if cfg.tune_schedule and cfg.tune != "schedule":
        raise ConfigError("--tune-schedule is only read under --tune schedule")
    prior = getattr(cfg, "tune_prior", "ladder")
    if prior not in ("ladder", "model"):
        raise ConfigError(f"--tune-prior must be ladder/model, got {prior!r}")
    if prior == "model" and cfg.tune != "auto":
        raise ConfigError("--tune-prior model only applies to --tune auto "
                          "(the schedule/off modes have no starting rung "
                          "to pick)")
    if cfg.tune == "auto" and (multi_host or coordinated):
        # rank-LOCAL step timings drive auto's decisions; two ranks reading
        # different clocks would retune into different compiled programs and
        # desync the SPMD collectives. The declarative schedule is a pure
        # function of the epoch and stays rank-symmetric everywhere.
        raise ConfigError(
            "--tune auto is single-process only (rank-local timings would "
            "desync the retuned programs across ranks); use --tune schedule "
            "for multi-rank runs")


def startup_changes(cfg, prior=None) -> tuple:
    """(changes, reason) to fold into cfg BEFORE the first build - the
    schedule's epoch-0 entries, or auto's staleness start. Empty changes
    mean the launch config already sits at the starting point.

    `prior` (only read under --tune auto) is a model-prior dict
    ({"halo_refresh": rung, "why": ...}) that REPLACES the default coarse
    K=4 launch rung. The fold never loosens - a user who launched coarser
    than the pick keeps their state, exactly like the default ladder
    start. The port has no model to compute one (--tune-prior model is
    refused by name), so run.py passes none."""
    if cfg.tune == "schedule":
        for ep, levers in parse_schedule(cfg.tune_schedule):
            if ep != 0:
                continue
            ch = {k: v for k, v in levers.items() if getattr(cfg, k) != v}
            return ch, "schedule@0"
        return {}, "schedule@0"
    if cfg.tune == "auto":
        target = STALENESS_LADDER[1][1]
        why = "auto-start: coarse staleness while gradients are large"
        if prior is not None:
            target = int(prior["halo_refresh"])
            why = f"auto-start: {prior.get('why', 'model prior')}"
        if (cfg.halo_mode == "exchange"
                and int(cfg.halo_refresh) < target):
            return {"halo_refresh": target}, why
        return {}, "auto-start"
    return {}, ""


def reachable_lever_states(cfg) -> list:
    """Every TUNED_LEVERS state a run under `cfg` can be retuned into, as a
    deduplicated list of {halo_exchange, halo_wire, halo_refresh, halo_mode}
    dicts with the effective launch state first.

    A retune swaps the step functions at an epoch boundary, so every state
    listed here is a configuration the run may execute.

    * ``off``      - the launch levers only.
    * ``schedule`` - the cumulative fold of ``parse_schedule`` entries onto
      the launch levers, in epoch order (exactly the states
      ``Tuner.on_epoch_end`` walks, including after rollback replay).
    * ``auto``     - a conservative SUPERSET: the startup fold, then every
      ladder rung at or past the starting position (the ladder is
      monotone), crossed with the one-shot strategy re-pick (any concrete
      strategy - the byte-estimate pick depends on the runtime n_b table,
      so all of VALID_VALUES is reachable in principle) and the one-shot
      wire anneal. Tracing a superset keeps the preflight sound when the
      controller's runtime choice cannot be known statically.

    ``halo_exchange='auto'`` is left as-is here; callers resolving it to a
    concrete strategy (run.py's select_halo_strategy) should fold the
    resolved value into `cfg` first."""
    launch = {k: getattr(cfg, k) for k in TUNED_LEVERS}
    launch["halo_refresh"] = int(launch["halo_refresh"])
    ch, _ = startup_changes(cfg)
    start = {**launch, **ch}
    states: list[dict] = []

    def add(st: dict):
        if st not in states:
            states.append(dict(st))

    add(launch)
    add(start)
    if cfg.tune == "schedule":
        cur = dict(start)
        for _ep, levers in parse_schedule(cfg.tune_schedule):
            cur.update(levers)
            add(cur)
    elif cfg.tune == "auto":
        strategies = {start["halo_exchange"]}
        if start["halo_exchange"] in VALID_VALUES["halo_exchange"]:
            strategies.update(VALID_VALUES["halo_exchange"])
        wires = {start["halo_wire"]}
        nxt = WIRE_ANNEAL.get(start["halo_wire"])
        if nxt is not None:
            wires.add(nxt)
        rungs = STALENESS_LADDER[_ladder_pos(start):]
        for strat in sorted(strategies):
            for wire in sorted(wires):
                for mode, k in rungs:
                    add({"halo_exchange": strat, "halo_wire": wire,
                         "halo_refresh": k, "halo_mode": mode})
    return states


def bench_schedule(n_epochs: int) -> list:
    """The fixed anneal of a short benchmark run: K=4 from epoch 0, K=2 at
    40%, K=1 at 70% of the run - the default coarse->fine staleness
    schedule at a benchmark's epoch counts (auto's loss feedback needs more
    epochs than such a run has)."""
    e2 = max(n_epochs * 2 // 5, 1)
    e1 = max(n_epochs * 7 // 10, e2 + 1)
    return [(0, {"halo_refresh": 4}), (e2, {"halo_refresh": 2}),
            (e1, {"halo_refresh": 1})]


@dataclass
class AutoState:
    """Mutable feedback-policy state. NOT serialized: applied decisions are
    what persistence replays; after a rollback/resume the metric windows
    refill from the replayed epochs before any fresh decision can fire."""
    losses: list = field(default_factory=list)      # last <= AUTO_WINDOW
    comm_fracs: list = field(default_factory=list)  # last <= AUTO_WINDOW
    flat: int = 0            # consecutive flat-loss verdicts
    cooldown: int = 0        # epochs left in the post-move dwell
    strategy_moved: bool = False   # one-shot flags: strategy re-pick and
    wire_moved: bool = False       # codec anneal each fire at most once

    def observe(self, metrics: dict) -> None:
        loss = metrics.get("loss")
        if loss is not None and math.isfinite(float(loss)):
            self.losses.append(float(loss))
            del self.losses[:-AUTO_WINDOW]
        step_s, comm_s = metrics.get("step_s"), metrics.get("comm_s")
        if comm_s is not None and step_s:
            self.comm_fracs.append(float(comm_s) / float(step_s))
            del self.comm_fracs[:-AUTO_WINDOW]


def _rel_improvement(losses: list) -> Optional[float]:
    """Relative loss improvement per epoch over the window; None until the
    window is full."""
    if len(losses) < AUTO_WINDOW:
        return None
    first, last = losses[0], losses[-1]
    return (first - last) / ((abs(first) + 1e-12) * (len(losses) - 1))


def decide(st: AutoState, levers: dict,
           strategy_alt: Optional[tuple] = None) -> Optional[tuple]:
    """The pure decision core of `--tune auto`. Reads the metric windows in
    `st` and the currently-applied `levers`, returns
    ``(changes, reason, trigger)`` for at most ONE lever move - or None.
    Mutates only `st`'s counters. `strategy_alt` is the precomputed
    ``(strategy, why)`` byte-estimate re-pick from
    `parallel.halo.retune_strategy` (None when the launch strategy already
    wins on bytes).

    Priority: staleness anneal > strategy re-pick > codec anneal. The
    hysteresis invariants (monotone ladder, one-shot strategy/codec moves,
    hold + cooldown) live here so unit tests can prove them on synthetic
    streams without a mesh."""
    if st.cooldown > 0:
        st.cooldown -= 1
        return None
    pos = _ladder_pos(levers)
    if pos + 1 < len(STALENESS_LADDER):
        imp = _rel_improvement(st.losses)
        if imp is not None:
            thr = TIGHTEN_RTOL[pos]
            st.flat = st.flat + 1 if imp < thr else 0
            if st.flat >= AUTO_HOLD:
                mode, k = STALENESS_LADDER[pos + 1]
                changes = {}
                if levers.get("halo_mode") != mode:
                    changes["halo_mode"] = mode
                if int(levers.get("halo_refresh", 1)) != k:
                    changes["halo_refresh"] = k
                st.flat, st.cooldown = 0, AUTO_COOLDOWN
                st.losses.clear()
                return (changes,
                        f"loss flat ({imp:+.4f}/epoch < {thr}): tighten "
                        f"staleness to mode={mode} K={k}",
                        {"rel_improvement": round(imp, 6), "threshold": thr})
    if len(st.comm_fracs) >= AUTO_WINDOW:
        cf = sorted(st.comm_fracs)[len(st.comm_fracs) // 2]
        if cf >= AUTO_COMM_FRAC:
            if (strategy_alt is not None and not st.strategy_moved
                    and strategy_alt[0] != levers.get("halo_exchange")):
                st.strategy_moved, st.cooldown = True, AUTO_COOLDOWN
                return ({"halo_exchange": strategy_alt[0]},
                        f"comm share {cf:.0%}: re-pick strategy "
                        f"({strategy_alt[1]})",
                        {"comm_frac": round(cf, 4),
                         "threshold": AUTO_COMM_FRAC})
            nxt = WIRE_ANNEAL.get(levers.get("halo_wire"))
            if nxt is not None and not st.wire_moved:
                st.wire_moved, st.cooldown = True, AUTO_COOLDOWN
                return ({"halo_wire": nxt},
                        f"comm share {cf:.0%}: anneal wire "
                        f"{levers.get('halo_wire')}->{nxt}",
                        {"comm_frac": round(cf, 4),
                         "threshold": AUTO_COMM_FRAC})
    return None


class Tuner:
    """Per-run controller state: current levers, sticky decision history,
    and the auto-policy feedback windows. Single-threaded - run.py drives
    it from the epoch loop only."""

    def __init__(self, cfg, levers: dict, log: Callable = print):
        self.mode = cfg.tune
        self.log = log
        # RESOLVED launch levers (post startup_changes, post `--halo-exchange
        # auto` resolution): the fold base every rewind/restore starts from
        self.base = {k: levers[k] for k in TUNED_LEVERS}
        self.levers = dict(self.base)
        self.schedule = (parse_schedule(cfg.tune_schedule)
                         if self.mode == "schedule" else [])
        self._sched_by_epoch = dict(self.schedule)
        self.history: list = []          # applied decisions, sticky
        self._by_epoch: dict[int, dict] = {}
        self.max_seen = -1               # furthest epoch already decided for
        self._auto = AutoState() if self.mode == "auto" else None
        self.strategy_alt: Optional[tuple] = None  # set by run.py (auto only)

    # -- history -----------------------------------------------------------
    def _record(self, epoch: int, changes: dict, reason: str,
                trigger: dict) -> dict:
        ent = {"epoch": int(epoch), "changes": dict(changes),
               "reason": reason, "trigger": dict(trigger or {})}
        self.history.append(ent)
        self._by_epoch[ent["epoch"]] = ent
        self.levers.update(changes)
        return ent

    def record_startup(self, changes: dict, reason: str) -> dict:
        """Sticky epoch-0 entry for the startup_changes() fold run.py applied
        before the first build (`self.base` already includes it - the fold
        is idempotent, which is what keeps rewind(0) correct)."""
        self.max_seen = max(self.max_seen, 0)
        return self._record(0, changes, reason, {})

    # -- epoch-boundary decision -------------------------------------------
    def on_epoch_end(self, epoch: int, metrics: dict) -> Optional[dict]:
        """Called after epoch `epoch` completes with its measured metrics;
        returns the decision (entry dict) taking effect at ``epoch + 1``, or
        None. Epochs at or below `max_seen` REPLAY the recorded history
        (deterministic recovery); fresh decisions only extend past it."""
        if self._auto is not None:
            self._auto.observe(metrics)     # windows warm up during replay too
        nxt = epoch + 1
        if nxt <= self.max_seen:
            ent = self._by_epoch.get(nxt)
            if ent is not None and ent["changes"]:
                self.levers.update(ent["changes"])
                return {**ent, "reason": "replay"}
            return None
        self.max_seen = nxt
        if self.mode == "schedule":
            want = self._sched_by_epoch.get(nxt)
            if want:
                changes = {k: v for k, v in want.items()
                           if self.levers.get(k) != v}
                if changes:
                    return self._record(nxt, changes, "schedule", {})
            return None
        out = decide(self._auto, self.levers, self.strategy_alt)
        if out is None or not out[0]:
            return None
        changes, reason, trigger = out
        return self._record(nxt, changes, reason, trigger)

    # -- recovery ----------------------------------------------------------
    def _fold(self, upto_epoch: int) -> dict:
        levers = dict(self.base)
        for ent in self.history:
            if ent["epoch"] <= upto_epoch:
                levers.update(ent["changes"])
        return levers

    def rewind(self, restart: int) -> Optional[dict]:
        """Rollback support: revert to the levers active when epoch
        `restart` originally ran. History PAST the restart point is kept -
        on_epoch_end replays it by epoch, so the healed run walks the same
        schedule. Returns the lever diff to actuate, or None."""
        target = self._fold(restart)
        diff = {k: v for k, v in target.items() if self.levers.get(k) != v}
        if self._auto is not None:
            # metric windows refill from the replayed epochs; the extra
            # cooldown keeps the first post-recovery fresh decision dwelled
            self._auto.losses.clear()
            self._auto.comm_fracs.clear()
            self._auto.flat, self._auto.cooldown = 0, AUTO_COOLDOWN
        if not diff:
            return None
        self.levers = target
        return diff

    def restore(self, start_epoch: int, state: Optional[dict]) -> \
            Optional[dict]:
        """Resume support: adopt the checkpointed controller state (or, for
        schedule mode, reconstruct it - the schedule is a pure function of
        the epoch) and return the lever diff the resumed run must actuate
        before its first step, or None."""
        applied = dict(self.levers)     # what run.py actually built with -
        # _record below mutates self.levers while reconstructing history;
        # rewind() must diff against the BUILT levers, so restore them first
        if self.mode == "schedule":
            for ep, want in self.schedule:
                if 0 < ep <= start_epoch:
                    ch = {k: v for k, v in want.items()
                          if self._fold(start_epoch).get(k) != v}
                    if ch:
                        self._record(ep, ch, "schedule", {})
            self.max_seen = max(self.max_seen, start_epoch)
        elif state:
            if state.get("mode") != self.mode:
                self.log(f"[tune] checkpoint carries tune state for mode "
                         f"{state.get('mode')!r}, this run is {self.mode!r}; "
                         f"ignoring it")
            else:
                self.history = [dict(e) for e in state.get("history", [])]
                self._by_epoch = {int(e["epoch"]): e for e in self.history}
                self.max_seen = int(state.get("max_seen", start_epoch))
        elif start_epoch > 0:
            # resumed from a checkpoint written without tune state (e.g. a
            # pre-tune run): anneal continues fresh from the launch levers
            self.log("[tune] resumed checkpoint has no controller state; "
                     "starting fresh from the launch levers")
            self.max_seen = max(self.max_seen, start_epoch)
        self.levers = applied
        return self.rewind(start_epoch)

    def state_dict(self) -> dict:
        """Checkpoint payload (``extra["tune"]``): the sticky decision
        history is all deterministic replay needs - AutoState's windows
        refill from the replayed epochs."""
        return {"mode": self.mode, "max_seen": self.max_seen,
                "history": [dict(e) for e in self.history]}
