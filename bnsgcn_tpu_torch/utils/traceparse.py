"""Profiler-trace parsing (counterpart of bnsgcn_tpu/utils/traceparse.py):
attribute collectives to the train step, for the traces torch.profiler
writes (`export_chrome_trace`).

The reference measures its Comm column as in-step wall-clock around each
send/recv (helper/timer/comm_timer.py:21-25). The port's own column times
each collective between two CUDA events (the host clock on the CPU), and
that span includes the wait for the slower peers. The trace gives the
in-step collective spans of every rank: run.py wraps each step in
`record_function("train_step")`, every rank writes its own window's trace
(`rank_<g>.json` in the trace directory), and after a barrier rank 0 reads
them all and keeps, at each collective position, the shortest span over
the ranks: a rank's span includes its wait for the others, so the minimum
~= the last arriver's span ~= the collective's own cost (min over lanes).

The collectives, by where they run:

* NCCL's device kernels (`ncclDevKernel_*` / `ncclKernel_*`: SendRecv,
  which carries the all-to-all, and AllReduce, AllGather, ReduceScatter) on
  the CUDA lanes;
* gloo's host ops (`gloo:all_to_all`, `gloo:send`, `gloo:recv`,
  `gloo:all_reduce`, `gloo:all_gather`) on the CPU lanes, where the
  exchange of ranks that share one card runs (staged through host
  memory). c10d's dispatch wrappers (`c10d::alltoall_base_`,
  `record_param_comms`) only launch them and are not counted.

A lane is one rank's host side or its device side (`_lane`): gloo runs a
rank's collectives on several worker threads, which are one lane. Events
are attributed per rank to the latest `train_step` span that started
before them; a host event past that span's end (the step boundary's
agreement, an evaluation) is `other`. `overlap_from_events` intersects the
exchange spans with the `interior_agg` / `frontier_agg` spans that
--overlap split records (trainer.py), lane by lane.
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import re

EXCHANGE_PAT = re.compile(
    r"^gloo:(all_?to_all|send|recv)\b|^nccl\w*?(SendRecv|AllToAll|Send|Recv)",
    re.I)
REDUCE_PAT = re.compile(
    r"^gloo:(all_?reduce|all_?gather|reduce_?scatter)\b"
    r"|^nccl\w*?(AllReduce|ReduceScatter|AllGather)", re.I)
HOST_PROGRAMS = ("train_step", "exchange_only")
# --overlap split's phases (trainer.py split_body: record_function spans)
INTERIOR_PAT = re.compile(r"interior_agg", re.I)
FRONTIER_PAT = re.compile(r"frontier_agg", re.I)
# torch.profiler event categories that run on the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")
RANK_FILE = re.compile(r"rank_(\d+)\.json(\.gz)?$")


def trace_file(trace_dir: str, rank: int) -> str:
    """Where rank `rank` writes its window's trace."""
    return os.path.join(trace_dir, f"rank_{rank}.json")


def load_trace_events(trace_dir):
    """(events of every rank's trace under trace_dir, their paths): each
    event tagged with its file's rank (`rank_<g>.json[.gz]`; another single
    *.json is rank 0). Raises FileNotFoundError when there is none."""
    paths = sorted(p for p in glob.glob(os.path.join(trace_dir, "*.json*"))
                   if RANK_FILE.search(os.path.basename(p)))
    if not paths:
        paths = sorted(glob.glob(os.path.join(trace_dir, "*.json*")),
                       key=os.path.getmtime)[-1:]
    if not paths:
        raise FileNotFoundError(f"no trace .json under {trace_dir}")
    events = []
    for p in paths:
        m = RANK_FILE.search(os.path.basename(p))
        rank = int(m.group(1)) if m else 0
        opener = gzip.open if p.endswith(".gz") else open
        with opener(p, "rt") as f:
            evs = json.load(f).get("traceEvents", [])
        for ev in evs:
            ev["rank"] = rank
        events += evs
    return events, paths


def _lane(ev):
    """(rank, 'device' | 'host')."""
    side = "device" if ev.get("cat") in DEVICE_CATS else "host"
    return (ev.get("rank", 0), side)


def _kind(ev):
    """'exchange', 'reduce' or None. A gpu_user_annotation is the card's
    projection of a host span (gloo's ops appear there too), never a
    collective of its own."""
    if ev.get("cat") == "gpu_user_annotation":
        return None
    name = ev.get("name", "")
    if EXCHANGE_PAT.search(name):
        return "exchange"
    if REDUCE_PAT.search(name):
        return "reduce"
    return None


def _launches(events):
    """{rank: [(start, end, program)]} of the host program spans, nested
    duplicates ~1 us apart deduped by a 100 us window."""
    raw = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") in DEVICE_CATS:
            continue
        name = ev.get("name", "")
        if name in HOST_PROGRAMS:
            ts = float(ev["ts"])
            raw.setdefault(ev.get("rank", 0), []).append(
                (ts, ts + float(ev.get("dur", 0.0)), name))
    out = {}
    for rank, spans in raw.items():
        kept = []
        for s in sorted(spans):
            if kept and kept[-1][2] == s[2] and s[0] - kept[-1][0] < 100:
                continue
            kept.append(s)
        out[rank] = kept
    return out


def attribute(events):
    """Collective events per host program, with per-lane alignment.

    Returns {program: {"exchange"|"reduce": {lane: [(ts, dur_us)...]},
    "launches": N, "sweeps": N}} plus an "other" bucket. Each rank's events
    go to its latest program launch that started before them (device work
    runs after its launch); a host event that starts past that launch's
    end belongs to no program. "launches" counts one rank's launches (the
    most of any rank: every rank runs every step); "sweeps" counts maximal
    consecutive runs of exchange_only launches."""
    launches = _launches(events)
    out = {p: {"exchange": {}, "reduce": {}, "launches": 0, "sweeps": 0}
           for p in HOST_PROGRAMS + ("other",)}
    for spans in launches.values():
        counts = {p: 0 for p in HOST_PROGRAMS}
        sweeps, prev = 0, None
        for _, _, prog in spans:
            counts[prog] += 1
            if prog == "exchange_only" and prev != "exchange_only":
                sweeps += 1
            prev = prog
        for p in HOST_PROGRAMS:
            out[p]["launches"] = max(out[p]["launches"], counts[p])
        out["exchange_only"]["sweeps"] = max(out["exchange_only"]["sweeps"],
                                             sweeps)
    starts = {r: [s[0] for s in spans] for r, spans in launches.items()}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = _kind(ev)
        if cat is None:
            continue
        lane = _lane(ev)
        ts = float(ev["ts"])
        spans = launches.get(lane[0], [])
        i = bisect.bisect_right(starts.get(lane[0], []), ts) - 1
        prog = "other"
        if i >= 0 and (lane[1] == "device" or ts <= spans[i][1]):
            prog = spans[i][2]
        out[prog][cat].setdefault(lane, []).append(
            (ts, float(ev.get("dur", 0.0))))
    for prog in out:
        for cat in ("exchange", "reduce"):
            for lane in out[prog][cat]:
                out[prog][cat][lane].sort()
    return out


def program_cost(bucket, cat="exchange"):
    """(raw_sum_us, min_over_lanes_us, events_per_lane, n_lanes)."""
    lanes = bucket[cat]
    if not lanes:
        return 0.0, 0.0, 0, 0
    raw = sum(d for evs in lanes.values() for _, d in evs)
    n = max(len(evs) for evs in lanes.values())
    min_est = sum(min(evs[k][1] for evs in lanes.values() if len(evs) > k)
                  for k in range(n))
    return raw, min_est, n, len(lanes)


def _ev_matches(ev, pat):
    """Scope match against the event name or any string arg value."""
    if pat.search(ev.get("name", "")):
        return True
    args = ev.get("args") or {}
    return any(isinstance(v, str) and pat.search(v) for v in args.values())


def _merged(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _intersect_us(a, b):
    """Total overlap time between two span lists (us)."""
    a, b = _merged(a), _merged(b)
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            tot += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def overlap_from_events(events):
    """--overlap split observability: did the halo collective run while the
    interior rows aggregated?

    Exchange spans come from the train_step attribution; interior and
    frontier spans are the phases' record_function spans, on the card
    their device projections (gpu_user_annotation) where the trace has
    them, else the host ones. Per-lane intersection of exchange x interior
    is the time the wire was hidden under independent compute. Returns per
    step and rank ms {n_steps, exchange_ms, interior_ms, frontier_ms,
    hidden_ms, overlapped}, or None when the trace carries no phase spans
    (a run without --overlap split)."""
    attr = attribute(events)
    steps = attr["train_step"]["launches"]
    ex_lanes = {lane: [(ts, ts + d) for ts, d in evs]
                for lane, evs in attr["train_step"]["exchange"].items()}
    scope_lanes = {"interior": {}, "frontier": {}}
    for ev in events:
        if ev.get("ph") != "X" or _kind(ev) is not None:
            continue
        for cat, pat in (("interior", INTERIOR_PAT),
                         ("frontier", FRONTIER_PAT)):
            if _ev_matches(ev, pat):
                ts = float(ev["ts"])
                scope_lanes[cat].setdefault(_lane(ev), []).append(
                    (ts, ts + float(ev.get("dur", 0.0))))
    if not scope_lanes["interior"] and not scope_lanes["frontier"]:
        return None
    # the phases' own time from one side: the card's where it has them
    side = ("device" if any(lane[1] == "device" for sl in
                            scope_lanes.values() for lane in sl) else "host")
    ranks = {lane[0] for lane in ex_lanes} | {
        lane[0] for sl in scope_lanes.values() for lane in sl}
    sums = {"exchange": sum(e - s for sp in ex_lanes.values()
                            for s, e in sp)}
    for cat in ("interior", "frontier"):
        sums[cat] = sum(e - s for lane, sp in scope_lanes[cat].items()
                        if lane[1] == side for s, e in sp)
    hidden = sum(_intersect_us(ex_lanes.get(lane, []), sp)
                 for lane, sp in scope_lanes["interior"].items())
    n = max(steps, 1) * max(len(ranks), 1)
    return {"n_steps": steps,
            "exchange_ms": sums["exchange"] / n / 1e3,
            "interior_ms": sums["interior"] / n / 1e3,
            "frontier_ms": sums["frontier"] / n / 1e3,
            "hidden_ms": hidden / n / 1e3,
            # 'overlapped' = a meaningful fraction (>5%) of the collective
            # time coincided with interior compute on the same lane
            "overlapped": (hidden > 0.05 * sums["exchange"]
                           if sums["exchange"] > 0 else False)}


def overlap_report(trace_dir):
    """overlap_from_events over the traces in `trace_dir`; None on any
    parse failure (callers log 'no overlap evidence', never crash)."""
    try:
        events, _ = load_trace_events(trace_dir)
        return overlap_from_events(events)
    except Exception:
        return None


def _replica_groups(ev):
    """A collective's groups from a `replica_groups={{0,1},{2,3}}` text in
    its name or string args, or from a "Process Group Ranks" list arg
    (c10d's record_param_comms); None when absent."""
    args = ev.get("args") or {}
    ranks = args.get("Process Group Ranks")
    if isinstance(ranks, str):
        try:
            ranks = json.loads(ranks)
        except ValueError:
            ranks = None
    if isinstance(ranks, list) and ranks:
        return [[int(r) for r in ranks]]
    texts = [ev.get("name", "")]
    texts += [v for v in args.values() if isinstance(v, str)]
    for s in texts:
        m = re.search(r"replica_groups=\{(\{[^{}]*\}(?:,\{[^{}]*\})*)\}", s)
        if m:
            return [[int(x) for x in grp.split(",") if x.strip()]
                    for grp in re.findall(r"\{([^{}]*)\}", m.group(1))]
    return None


def classify_axis(groups, n_parts: int, n_replicas: int = 1,
                  n_feat: int = 1) -> str:
    """Mesh axis a collective's groups reduce over, for the global rank
    order g = (r * n_parts + p) * n_feat + f (parallel/replicas.py, the
    JAX package's device order): one group of every rank -> the fused
    gradient reduce ('replicas x parts x feat', or the 2-D / 1-D labels);
    groups of n_feat consecutive ranks aligned to n_feat -> 'feat'; groups
    of n_parts ranks at stride n_feat -> 'parts'; groups of n_replicas
    ranks at stride P*T -> 'replicas'."""
    if not groups or not groups[0]:
        return "unknown"
    size = len(groups[0])
    if any(len(g) != size for g in groups):
        return "unknown"
    full = n_parts * n_replicas * n_feat
    if size == full:
        label = [n for n, on in (("replicas", n_replicas > 1), ("parts", True),
                                 ("feat", n_feat > 1)) if on]
        return " x ".join(label) if len(label) > 1 else "parts"
    if n_feat > 1 and size == n_feat and all(
            g == list(range(g[0], g[0] + n_feat)) and g[0] % n_feat == 0
            for g in groups):
        return "feat"
    if size == n_parts and all(
            all(b - a == n_feat for a, b in zip(g, g[1:]))
            and g[0] % (n_parts * n_feat) < n_feat
            for g in groups):
        return "parts"
    if n_replicas > 1 and size == n_replicas and all(
            all(b - a == n_parts * n_feat for a, b in zip(g, g[1:]))
            for g in groups):
        return "replicas"
    return "unknown"


def comm_by_axis(events, n_parts: int, n_replicas: int = 1, n_feat: int = 1):
    """Collective time grouped by mesh axis: {axis: {kind: us}}, each
    reduced with program_cost's min over lanes. The axis comes from the
    event's groups when the trace carries them, else from the kind: an
    exchange rides 'parts', a reduce the full mesh's label."""
    by_key = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        kind = _kind(ev)
        if kind is None:
            continue
        groups = _replica_groups(ev)
        if groups is not None:
            axis = classify_axis(groups, n_parts, n_replicas, n_feat)
        elif kind == "exchange":
            axis = "parts"
        else:
            label = [n for n, on in (("replicas", n_replicas > 1),
                                     ("parts", True), ("feat", n_feat > 1))
                     if on]
            axis = " x ".join(label) if len(label) > 1 else "parts"
        by_key.setdefault((axis, kind), {}).setdefault(_lane(ev), []).append(
            (float(ev["ts"]), float(ev.get("dur", 0.0))))
    out = {}
    for (axis, kind), lanes in by_key.items():
        for evs in lanes.values():
            evs.sort()
        _, est, _, _ = program_cost({kind: lanes}, kind)
        out.setdefault(axis, {})[kind] = est
    return out


def step_comm_from_events(events):
    """Per-train_step in-step (exchange_s, reduce_s, n_steps) over loaded
    events; None when the window holds no step or no exchange (a profiler
    that lost the collectives must not print a fabricated 0.0000)."""
    try:
        attr = attribute(events)
        steps = attr["train_step"]["launches"]
        if steps < 1:
            return None
        _, ex_us, ex_n, _ = program_cost(attr["train_step"], "exchange")
        _, rd_us, _, _ = program_cost(attr["train_step"], "reduce")
        if ex_n == 0:
            return None
        return ex_us / steps / 1e6, rd_us / steps / 1e6, steps
    except Exception:
        return None


def step_comm_per_epoch(trace_dir):
    """step_comm_from_events over the traces in `trace_dir`; None when they
    are missing or unreadable or hold no step."""
    try:
        events, _ = load_trace_events(trace_dir)
    except Exception:
        return None
    return step_comm_from_events(events)
