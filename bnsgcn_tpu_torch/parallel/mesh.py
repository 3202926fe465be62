"""The process model for P > 1 (counterpart of bnsgcn_tpu/parallel/mesh.py).

The JAX package lays parts on a ('parts',) mesh axis and runs one SPMD
program. Here each part is one process (a rank) with its own device, and the
collectives go through torch.distributed:

  * `launch` starts P ranks with the `spawn` start method (never `fork`: the
    parent may have CUDA up), gives each an explicit process-group timeout so
    a hang in a step's collectives fails instead of waiting forever, forwards
    rank log lines to the parent, and collects each rank's result. A rank
    that fails makes `launch` tear the other ranks down and raise.
  * `rank_device` is the device map, by a rank's local rank on its node:
    with nccl local rank l gets cuda:l; with gloo on CUDA cuda:(l %
    device_count), so several ranks may share one card; with --device cpu
    the ranks run on the CPU.
  * Across nodes (--n-nodes > 1) each node's launcher calls `launch` for
    its own global ranks, all joining one world of P at the rendezvous
    tcp://master_addr:(port + 1), which global rank 0 serves; before that
    the launchers meet at a `NodeStore` that node 0 serves at
    master_addr:port (the seed, the resume choice and the partition's
    readiness travel through it).
  * `Comm` is one rank's handle on its group: the halo exchange's
    collectives (the tiled all-to-all, the split-size all-to-all of the
    ragged strategy, the send/receive pairs of the shift strategy) and the
    all-reduce of the gradient reduce, each timed without stalling the
    stream (CUDA events on a card, the host clock on the CPU), and a
    barrier for the waits on work one rank does alone (set-up, rank 0's
    checkpoints and its final evaluation, and an evaluation that outlasted
    its log_every epochs), which runs over a gloo group of its own with the
    longer WAIT_TIMEOUT_S. A collective may be launched asynchronously: it
    returns a `Pending`, whose wait() ends its span, so an async exchange is
    timed from its launch to its wait's completion (the interior
    aggregation of --overlap split runs inside that span). Tensors go to
    the backend on their own device: nccl moves CUDA tensors card to card;
    gloo takes CUDA tensors in its collectives and stages them through host
    memory itself, but its point-to-point sends and receives take host
    memory only, so `send_recv` stages a CUDA tensor through host buffers
    itself, in the gloo branch. The backend is whatever the caller asked
    for, never switched.
  * Fault tolerance (resilience.py): with `forward_signals` the launcher
    hands its first SIGTERM/SIGINT to its ranks (a shared flag each reads
    at its step boundary, not a second signal: a signal sent to the whole
    process group reaches every rank once already) and kills them at the
    second; each rank writes its step-boundary beats into arrays the
    launcher shares with it, and `launch` maps
    the ranks' exits to one outcome: any 77 (a watchdog, a step
    collective that timed out on a hung peer, or the coordinator's
    timeout) raises RankExit 77 naming the rank whose beat is oldest, else
    any 78 (the launches agreed to abort) RankExit 78, else any 76 RankExit
    76, else 75 from every rank RankExit 75, else an injected rank loss on
    every rank RankExit 0; anything else RankFailed.
  * `plan_slots` / `slot_members`: the part -> slot map of an elastic
    resize (the JAX package's, host-side bookkeeping).
"""

from __future__ import annotations

import datetime
import json
import os
import queue as queue_mod
import signal
import socket
import sys
import threading
import time
import traceback
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist

from bnsgcn_tpu_torch import strict

from bnsgcn_tpu_torch.resilience import (EXIT_COORD_ABORT, EXIT_DIVERGED,
                                         EXIT_PREEMPTED, EXIT_WATCHDOG)

# a step's collectives: every rank runs the same work between two of them
PG_TIMEOUT_S = 60.0
# Comm.barrier: peers wait there for set-up, for rank 0's checkpoints and
# its final full-graph evaluation, and for a periodic one that outlasted
# its log_every epochs, which grow with the graph (and run on the CPU in
# the tests)
WAIT_TIMEOUT_S = 1800.0
# a launcher's wait to reach node 0's NodeStore
NODE_CONNECT_TIMEOUT_S = 120.0
# how long the launcher waits for the other ranks once one failed: a
# traceback's peers (1 s: they fail in its wake), a resumable or
# divergence exit's peers (they exit at the same step boundary)
FAIL_SETTLE_S = 1.0
EXIT_SETTLE_S = 60.0


def check_mesh_budget(n_parts: int, backend: str, device: str,
                      n_local: "int | None" = None, replicas: int = 1,
                      feat: int = 1) -> None:
    """One named config error when this node's `n_local` ranks (all R x P
    x T by default) do not fit its cards: nccl runs one rank per card and
    refuses two ranks on one (counterpart of bnsgcn_tpu/run.py
    check_mesh_budget, which names the axis to shrink)."""
    from bnsgcn_tpu_torch.config import ConfigError
    R, T = max(replicas, 1), max(feat, 1)
    need = R * n_parts * T
    n_local = need if n_local is None else n_local
    if need <= 1 or device == "cpu" or backend != "nccl":
        return
    have = torch.cuda.device_count()
    if n_local <= have:
        return
    if R > 1 or T > 1:
        fixes = []
        if T > 1 and R * n_parts <= have:
            fixes.append(f"--feat to <= {have // (R * n_parts)}")
        if R > 1 and n_parts * T <= have:
            fixes.append(f"--replicas to <= {have // (n_parts * T)}")
        if n_parts > have:
            fixes.append(f"--n-partitions to <= {have} (re-partition the "
                         f"graph)")
        if not fixes:
            fixes.append(f"some axis so replicas*parts*feat <= {have}")
        raise ConfigError(
            f"mesh does not fit: --replicas {R} x --n-partitions {n_parts} "
            f"x --feat {T} with --dist-backend nccl needs {need} CUDA "
            f"devices (one rank per card), have {have}; shrink "
            + " or ".join(fixes) + ", or pass --dist-backend gloo to run "
            "several ranks on one card")
    what, knob = ((f"--n-partitions {n_parts}", "--n-partitions")
                  if n_local == n_parts else
                  (f"{n_local} ranks on this node", "--parts-per-node"))
    raise ConfigError(
        f"mesh does not fit: {what} with --dist-backend nccl needs {n_local} "
        f"CUDA devices (one rank per card), have {have}; shrink {knob} to "
        f"<= {have}, or pass --dist-backend gloo to run several ranks on "
        f"one card")


def plan_slots(n_parts: int, n_slots: int) -> tuple[int, ...]:
    """Part -> slot assignment for an elastic world of `n_slots` workers
    hosting `n_parts` parts (bnsgcn_tpu/parallel/mesh.py:53): contiguous
    balanced blocks, the first `n_parts % n_slots` slots taking one extra
    part, so a resize re-hosts whole parts and never re-partitions.

    plan_slots(4, 2) -> (0, 0, 1, 1); plan_slots(5, 2) -> (0, 0, 0, 1, 1);
    plan_slots(P, P) is the identity (worker == part)."""
    if n_slots < 1:
        raise ValueError(f"plan_slots needs >= 1 slot, got {n_slots}")
    if n_parts < n_slots:
        raise ValueError(
            f"cannot spread {n_parts} parts over {n_slots} slots without "
            f"empty workers; shrink the world to <= {n_parts}")
    base, extra = divmod(n_parts, n_slots)
    out = []
    for slot in range(n_slots):
        out.extend([slot] * (base + (1 if slot < extra else 0)))
    return tuple(out)


def slot_members(slot_map: tuple[int, ...]) -> dict[int, list[int]]:
    """{slot: [the parts it hosts]}: the inverse view of `plan_slots`."""
    out: dict[int, list[int]] = {}
    for part, slot in enumerate(slot_map):
        out.setdefault(int(slot), []).append(part)
    return out


def rank_device(device: str, backend: str, local_rank: int) -> torch.device:
    if device == "cpu":
        return torch.device("cpu")
    if backend == "nccl":
        return torch.device("cuda", local_rank)
    return torch.device("cuda",
                        local_rank % max(torch.cuda.device_count(), 1))


class Pending:
    """A collective in flight: wait() waits for its works, runs `after` on
    the result (a staged receive's copy back to the card, a dequantize),
    closes its span (none for kind None: a collective awaited inside
    another's span) and returns the result; a second wait() returns it
    again. `keep` holds the buffers the backend still reads; `staged`: the
    launch lifted the --strict-exec guard (Comm._stage), put back here."""

    def __init__(self, comm: "Comm", kind: str, works: list, start, result,
                 after: "Callable | None" = None, keep=(),
                 staged: bool = False):
        self.comm, self.kind, self.works, self.start = comm, kind, works, start
        self.result, self.after, self.keep = result, after, keep
        self.staged = staged
        self.done = False

    def wait(self):
        if not self.done:
            for w in self.works:
                w.wait()
            if self.after is not None:
                self.result = self.after(self.result)
            if self.kind is not None:
                self.comm._close(self.kind, self.start)
            self.done, self.works, self.keep = True, [], ()
            if self.staged:
                strict.resume()
        return self.result


class Comm:
    """One rank's collectives over its group: the default group (every
    rank), or a subgroup (`sub`: one axis of an R x P x T run,
    parallel/replicas.py; `rank` and `world` are then the group's, and
    peers and sources are named by group rank). Each all-to-all,
    send/receive batch, all-reduce and all-gather is timed by kind
    ('exchange', 'reduce'; SyncBatchNorm's moment sums 'bn', the feat
    axis's sums and gathers 'feat') without a device synchronization:
    between two CUDA events on the current stream on a card (read by
    `seconds`, once the stream has passed them), on the host clock on the
    CPU. A span runs from the moment the rank's own inputs are ready (the
    launch) to the moment the result has landed (the wait), so it includes
    the wait for slower peers, and for an asynchronous launch whatever the
    rank ran before its wait. The epoch line reads the sums as Comm(s),
    Reduce(s) and, with a feat axis, Feat(s). `barrier` and
    `broadcast_object` run over the wait group where the Comm has one (the
    world's), else over its own group."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 wait_group=None, group=None, members=None, spans=None):
        self.rank, self.world, self.device = rank, world, device
        self.wait_group = wait_group
        # a subgroup's torch.distributed group and its global ranks in
        # group-rank order (None: the default group, rank = global rank)
        self.group, self.members = group, members
        self._spans = spans if spans is not None else {
            "exchange": [], "reduce": [], "bn": [], "feat": []}

    def sub(self, members: list, group) -> "Comm":
        """The Comm of a subgroup holding this rank (parallel/replicas.py's
        axes): `members` its global ranks, in group-rank order. Its spans
        add to this Comm's, so `seconds` reads every axis by kind."""
        return Comm(members.index(self.global_rank(self.rank)), len(members),
                    self.device, None, group, list(members), self._spans)

    def global_rank(self, rank: int) -> int:
        """The global rank of this group's rank `rank`."""
        return rank if self.members is None else self.members[rank]

    def reset_seconds(self):
        for spans in self._spans.values():
            spans.clear()

    def seconds(self) -> dict:
        """Seconds per kind since reset_seconds; on a card, waits for the
        last recorded event."""
        out = {}
        for kind, spans in self._spans.items():
            total = 0.0
            for span in spans:
                if isinstance(span, float):
                    total += span
                else:
                    start, end = span
                    end.synchronize()
                    total += start.elapsed_time(end) / 1e3
            out[kind] = total
        return out

    def _open(self):
        """A span's start: a CUDA event recorded now on a card, else the
        host clock."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            return start
        return time.perf_counter()

    def _close(self, kind: str, start) -> None:
        if self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._spans[kind].append((start, end))
        else:
            self._spans[kind].append(time.perf_counter() - start)

    def _timed(self, kind: str, op: Callable[[], None]) -> None:
        start = self._open()
        with strict.staged() if self.host_staged() else nullcontext():
            op()
        self._close(kind, start)

    def _stage(self) -> bool:
        """Whether this collective passes through host memory inside a
        --strict-exec step: the guard is lifted from its launch until it is
        waited, one audited fetch (strict.py)."""
        return self.host_staged() and strict.suspend()

    def host_staged(self) -> bool:
        """Whether point-to-point tensors must pass through host memory:
        gloo on a card (its send and receive read host pointers only)."""
        return (self.device.type == "cuda"
                and dist.get_backend() == dist.Backend.GLOO)

    def all_to_all(self, x: torch.Tensor,
                   kind: "str | None" = "exchange") -> Pending:
        """Tiled all-to-all over the leading axis, launched
        asynchronously: block j of `x` (rows [j*n/P, (j+1)*n/P)) goes to
        rank j; block q of the result came from rank q."""
        src = x.contiguous()
        out = torch.empty_like(src)
        start = self._open() if kind is not None else None
        staged = self._stage()
        work = dist.all_to_all_single(out, src, group=self.group,
                                      async_op=True)
        return Pending(self, kind, [work], start, out, keep=(src,),
                       staged=staged)

    def all_to_all_v(self, x: torch.Tensor, in_splits: list,
                     out_splits: list, kind: str = "exchange") -> Pending:
        """Split-size all-to-all, launched asynchronously: rows
        [sum(in_splits[:j]), +in_splits[j]) of `x` go to rank j; the result
        holds rank q's out_splits[q] rows in rank order."""
        src = x.contiguous()
        out = src.new_empty((int(sum(out_splits)),) + tuple(src.shape[1:]))
        start = self._open()
        staged = self._stage()
        work = dist.all_to_all_single(out, src, [int(v) for v in out_splits],
                                      [int(v) for v in in_splits],
                                      group=self.group, async_op=True)
        return Pending(self, kind, [work], start, out, keep=(src,),
                       staged=staged)

    def send_recv(self, sends: list, recvs: list,
                  kind: str = "exchange") -> Pending:
        """One batch of point-to-point transfers, launched asynchronously:
        `sends` [(peer, tensor)], `recvs` [(peer, tensor to fill)]; the
        Pending's result is the list of received tensors. Under gloo on a
        card the sends leave through host copies and the receives land in
        pinned host buffers, copied to their tensors on the card when
        waited."""
        start = self._open()
        stage = self.host_staged()
        staged = self._stage()
        ops, keep, landing = [], [], []
        for peer, t in sends:
            src = t.contiguous()
            if stage:
                src = src.to("cpu")
            keep.append(src)
            ops.append(dist.P2POp(dist.isend, src, self.global_rank(peer),
                                  self.group))
        for peer, t in recvs:
            dst = (torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                   if stage else t)
            landing.append((t, dst))
            ops.append(dist.P2POp(dist.irecv, dst, self.global_rank(peer),
                                  self.group))
        works = dist.batch_isend_irecv(ops) if ops else []

        def after(_):
            if stage:
                for t, dst in landing:
                    t.copy_(dst, non_blocking=True)
            return [t for t, _ in landing]

        return Pending(self, kind, list(works), start, None, after,
                       keep=(keep, landing), staged=staged)

    def all_reduce_(self, x: torch.Tensor, kind: str = "reduce"
                    ) -> torch.Tensor:
        """In-place SUM over the ranks."""
        self._timed(kind, lambda: dist.all_reduce(x, group=self.group))
        return x

    def all_gather(self, x: torch.Tensor, kind: str = "feat"
                   ) -> torch.Tensor:
        """[world, *x.shape]: row q holds rank q's x."""
        out = x.new_empty((self.world,) + tuple(x.shape))
        src = x.contiguous()
        # the list form: gloo has no all_gather_into_tensor
        self._timed(kind, lambda: dist.all_gather(list(out.unbind(0)), src,
                                                  group=self.group))
        return out

    def all_sum_ordered(self, x: torch.Tensor, kind: str = "bn"
                        ) -> torch.Tensor:
        """The SUM of x over the ranks, added in rank order 0, 1, ..., P-1
        on every rank, so the result is bitwise the same everywhere and
        whatever the backend's reduction order: one all-reduce of a [P,
        ...] f32 buffer holding x in this rank's row and zeros elsewhere
        (each element's sum is exact; bf16 rides in f32), then the rows,
        in x's dtype, added in order."""
        rows = torch.zeros((self.world,) + tuple(x.shape),
                           dtype=torch.float32, device=x.device)
        rows[self.rank] = x
        rows = self.all_reduce_(rows, kind).to(x.dtype)
        out = rows[0]
        for q in range(1, self.world):
            out = out + rows[q]
        return out

    def broadcast_(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s x (in place) on every rank of the group."""
        dist.broadcast(x, self.global_rank(src), group=self.group)
        return x

    def broadcast_object(self, obj, src: int = 0):
        """Rank `src`'s picklable object on every rank, over the wait group
        (its long timeout: the sender may first read a checkpoint)."""
        box = [obj]
        dist.broadcast_object_list(box, src=self.global_rank(src),
                                   group=self._waits())
        return box[0]

    def all_gather_object(self, obj) -> list:
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def agree_max(self, values: list) -> list:
        """The element-wise MAX of small ints over the ranks, over the wait
        group (host tensors, off the device's stream): every rank's verdict
        at one step boundary."""
        t = torch.tensor(values, dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._waits())
        return t.tolist()

    def barrier(self) -> None:
        """Wait for every rank, under the wait group's timeout: where peers
        wait for work one rank does alone."""
        dist.barrier(group=self._waits())

    def _waits(self):
        return self.wait_group if self.wait_group is not None else self.group


@dataclass
class RankContext:
    """What a rank's job receives: its rank, its device, its Comm and a log
    function whose lines the parent prints; `beat(epoch)` reports the
    rank's step-boundary beat to the launcher, `forwarded()` names a signal
    the launcher forwarded (None before one)."""
    rank: int
    device: torch.device
    comm: Comm
    log: Callable[[str], None]
    beat: Callable[[int], None] = lambda epoch: None
    forwarded: Callable[[], "str | None"] = lambda: None


class RankFailed(RuntimeError):
    """A rank raised or died; the message carries its traceback and its
    exit code."""


class RankExit(RankFailed):
    """The ranks ended on one of resilience.py's exit codes (`code`): 75,
    76 or 77. `exc` is the exception a rank raised for it (PreemptedError,
    DivergenceError, StepHung), None when a rank's watchdog ended it."""

    def __init__(self, code: int, message: str, exc=None):
        super().__init__(message)
        self.code, self.exc = code, exc


class NodeUnreachable(RuntimeError):
    """A launcher or a rank could not reach node 0 (its NodeStore, or the
    ranks' rendezvous) in time."""


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _loopback(addr: str) -> bool:
    return addr == "localhost" or addr.startswith("127.")


class NodeStore:
    """The launchers' meeting point in a --n-nodes > 1 run (the JAX
    package's broadcast_one_to_all and sync_global_devices): node 0 serves
    a TCPStore at addr:port, the others connect to it. `publish` sets a key
    to a JSON value, `fetch` waits for one. Every wait is bounded:
    NodeUnreachable names what did not come."""

    def __init__(self, addr: str, port: int, n_nodes: int, node_rank: int,
                 connect_timeout_s: "float | None" = None):
        self.addr, self.port, self.node_rank = addr, port, node_rank
        if connect_timeout_s is None:
            connect_timeout_s = NODE_CONNECT_TIMEOUT_S
        try:
            self.store = dist.TCPStore(
                addr, port, world_size=n_nodes, is_master=node_rank == 0,
                timeout=datetime.timedelta(seconds=connect_timeout_s),
                wait_for_workers=False)
        except (RuntimeError, OSError) as e:
            raise NodeUnreachable(
                f"node {node_rank}: the launchers' store at {addr}:{port} "
                f"({'could not serve' if node_rank == 0 else 'unreachable'}"
                f" within {connect_timeout_s:g} s: {e})") from e

    def publish(self, key: str, value) -> None:
        self.store.set(key, json.dumps(value))

    def fetch(self, key: str, timeout_s: "float | None" = None):
        timeout_s = WAIT_TIMEOUT_S if timeout_s is None else timeout_s
        try:
            self.store.wait([key], datetime.timedelta(seconds=timeout_s))
            return json.loads(self.store.get(key))
        except (RuntimeError, OSError) as e:
            raise NodeUnreachable(
                f"node {self.node_rank}: no {key!r} from node 0 at "
                f"{self.addr}:{self.port} within {timeout_s:g} s "
                f"({e})") from e


def _rank_entry(rank, local_rank, n_local, world, addr, port, backend,
                device, timeout_s, wait_timeout_s, fn, args, q, flag=None,
                beats=None):
    """A spawned rank: join the group (and the gloo group of Comm.barrier),
    run fn(ctx, *args), send the result (or the traceback) to the parent,
    leave the group. The ranks share the host's cores: each takes its
    share for its intra-op threads (on the CPU the world's, as every rank
    of a CPU world may run on this host; on a card this node's
    `n_local`'s): on a card the default pool of every rank spanning every
    core made the ranks' threads spin against each other in their host
    work (the initialization's draws, staged copies); an OMP_NUM_THREADS
    in the environment caps the share."""
    try:
        dev = rank_device(device, backend, local_rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        share = max(1, (os.cpu_count() or 1)
                    // (n_local if dev.type == "cuda" else world))
        torch.set_num_threads(min(share, int(
            os.environ.get("OMP_NUM_THREADS") or share)))
        if backend == "gloo" and _loopback(addr):
            # every rank of this world is on this host
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        try:
            dist.init_process_group(
                backend, init_method=f"tcp://{addr}:{port}",
                world_size=world, rank=rank,
                timeout=datetime.timedelta(seconds=timeout_s))
        except (RuntimeError, OSError) as e:
            raise NodeUnreachable(
                f"rank {rank} of {world}: no rendezvous at tcp://{addr}:"
                f"{port} within {timeout_s:g} s ({e})") from e
        try:
            wait_group = dist.new_group(
                backend="gloo",
                timeout=datetime.timedelta(seconds=wait_timeout_s))
            ctx = RankContext(
                rank, dev, Comm(rank, world, dev, wait_group),
                lambda m: q.put(("log", rank, str(m))),
                (lambda epoch: _beat(beats, local_rank, epoch))
                if beats is not None else (lambda epoch: None),
                lambda: (signal.Signals(flag.value).name
                         if flag is not None and flag.value else None))
            result = fn(ctx, *args)
        finally:
            dist.destroy_process_group()
        q.put(("ok", rank, result))
    except BaseException as e:
        code = getattr(e, "exit_code", None)
        if isinstance(code, int):
            # a resilience exit (resilience.py): the exception itself
            q.put(("exit", rank, (code, e)))
            raise SystemExit(code)
        q.put(("err", rank, traceback.format_exc()))
        raise SystemExit(1)


def _beat(beats, i: int, epoch: int) -> None:
    """A rank's step-boundary beat, written straight into the launcher's
    shared arrays (no queue: a rank that dies next must not lose it); the
    monotonic clock is the host's, the same in every process."""
    times, epochs = beats
    times[i] = time.monotonic()
    epochs[i] = epoch


class _Forward:
    """The launcher's SIGTERM/SIGINT handlers while its ranks run: the first
    signal sets `flag` (the ranks read it at their step boundary), a second
    kills the ranks and re-raises the signal in the launcher. With
    `profile` a SIGUSR1 goes on to the launch's first rank (its telemetry
    bus's on-demand capture)."""

    def __init__(self, flag, procs: dict, profile: bool = False):
        self.flag, self.procs, self.profile = flag, procs, profile
        self.old = {}

    def install(self):
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                self.old[sig] = signal.signal(sig, self._on_signal)
            if self.profile and hasattr(signal, "SIGUSR1"):
                self.old[signal.SIGUSR1] = signal.signal(signal.SIGUSR1,
                                                         self._on_profile)
        return self

    def _on_profile(self, signum, frame):
        first = self.procs[min(self.procs)]
        if first.pid is not None and first.is_alive():
            os.kill(first.pid, signal.SIGUSR1)

    def restore(self):
        for sig, old in self.old.items():
            signal.signal(sig, old)
        self.old.clear()

    def _on_signal(self, signum, frame):
        name = signal.Signals(signum).name
        if self.flag.value:
            for p in self.procs.values():
                if p.is_alive():
                    p.kill()
            self.restore()
            signal.signal(signum, signal.SIG_DFL)
            signal.raise_signal(signum)
            return
        self.flag.value = int(signum)
        sys.stderr.write(
            f"\n[resilience] {name} received by the launcher: forwarded to "
            f"its {len(self.procs)} rank(s), which checkpoint and exit "
            f"{EXIT_PREEMPTED} at their next step boundary (send again to "
            f"kill immediately)\n")


def _stall_line(beats: dict, ranks) -> str:
    """Which rank stalled a hung step: the one whose step-boundary beat
    (sent as it enters a step) is oldest, by epoch, then by age, with every
    rank's."""
    now = time.monotonic()

    def age(r):
        return now - beats[r][1] if r in beats else float("inf")

    oldest = min(ranks, key=lambda r: (beats[r][0], -age(r)) if r in beats
                 else (-1, 0.0))
    every = "; ".join(
        f"rank {r}: " + (f"epoch {beats[r][0]}, {age(r):.1f} s ago"
                         if r in beats else "no beat") for r in ranks)
    what = (f"epoch {beats[oldest][0]}, {age(oldest):.1f} s ago"
            if oldest in beats else "no beat yet")
    return (f"rank {oldest} stalled the step: its step-boundary beat is "
            f"the oldest ({what}; {every})")


def _verdict(outcomes: dict, results: dict, procs: dict, ranks,
             n_ranks: int, beats: dict):
    """The exception for the ranks' outcomes ({rank: ('exit', (code, exc))
    | ('err', traceback) | ('died', exit code)}): RankExit 77, 78, 76 or 75
    by resilience.py's rules, or 0 when every rank was lost by an injected
    `ranklost`, else RankFailed with every failure's report."""
    codes = {}
    for r, (kind, payload) in outcomes.items():
        if kind == "exit":
            codes[r] = payload
        elif kind == "died":
            codes[r] = (payload, None)
    hung = sorted(r for r, (c, _) in codes.items() if c == EXIT_WATCHDOG)
    if hung:
        exc = next((codes[r][1] for r in hung if codes[r][1] is not None),
                   None)
        how = "; ".join(f"rank {r}: " + (str(codes[r][1])
                                          if codes[r][1] is not None else
                                          "its watchdog fired")
                        for r in hung)
        return RankExit(EXIT_WATCHDOG, f"hung step ({how}); "
                        + _stall_line(beats, ranks), exc)
    for code in (EXIT_COORD_ABORT, EXIT_DIVERGED, EXIT_PREEMPTED, 0):
        got = sorted(r for r, (c, e) in codes.items()
                     if c == code and e is not None)
        if got and (code in (EXIT_COORD_ABORT, EXIT_DIVERGED)
                    or len(got) == len(ranks)):
            exc = codes[got[0]][1]
            return RankExit(code, str(exc), exc)
    reports = []
    for r in sorted(outcomes):
        kind, payload = outcomes[r]
        code = procs[r].exitcode
        tag = f" (exit code {code})" if code is not None else ""
        if kind == "err":
            reports.append(f"rank {r} of {n_ranks} failed{tag}:\n{payload}")
        elif kind == "died":
            reports.append(f"rank {r} of {n_ranks} died with exit code "
                           f"{payload} and no report")
        else:
            reports.append(f"rank {r} of {n_ranks} exited {payload[0]}: "
                           f"{payload[1]}")
    reports += [f"rank {r} of {n_ranks}: no outcome by then (torn down)"
                for r in ranks if r not in outcomes and r not in results]
    return RankFailed("\n".join(reports))


def launch(fn, n_ranks: int, rank_args: list, backend: str, device: str,
           log=print, timeout_s: float = PG_TIMEOUT_S,
           wait_timeout_s: float = WAIT_TIMEOUT_S,
           ranks: "range | None" = None, addr: str = "127.0.0.1",
           port: "int | None" = None, forward_signals: bool = False,
           forward_profile: bool = False) -> list:
    """Run fn(RankContext, *rank_args[i]) on spawned processes, one for
    each global rank in `ranks` (all n_ranks by default), in a world of
    n_ranks that meets at tcp://addr:port (a free local port by default;
    a node that starts only some of the ranks names the port every node
    uses), and return their results in `ranks` order. `timeout_s` bounds
    the rendezvous and each collective, `wait_timeout_s` each
    Comm.barrier. `fn` and the arguments are pickled (fn by import path).
    Log lines a rank sends come out through `log` as they arrive.
    `forward_signals` (the main thread only) hands the launcher's first
    SIGTERM/SIGINT to the ranks (RankContext.forwarded) and kills them at
    the second; `forward_profile` its SIGUSR1 to the first rank. When a
    rank raises or dies, `launch` waits for the others a little
    (FAIL_SETTLE_S; EXIT_SETTLE_S for a resilience exit), then terminates
    every rank it started and raises RankExit (resilience.py's codes: any
    77, else any 78, else any 76, else 75 from every rank, else 0 from
    every rank lost by an injected `ranklost`) or RankFailed."""
    ranks = range(n_ranks) if ranks is None else ranks
    if len(rank_args) != len(ranks):
        raise ValueError(f"{len(rank_args)} argument tuples for "
                         f"{len(ranks)} ranks")
    if port is None:
        if len(ranks) != n_ranks:
            raise ValueError("a launch of some of the ranks needs the port "
                             "every node meets at")
        port = _free_port()
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    flag = beats = None
    if forward_signals:
        flag = ctx.Value("i", 0, lock=False)
        beats = (ctx.RawArray("d", len(ranks)),
                 ctx.RawArray("q", [-1] * len(ranks)))
    procs = {r: ctx.Process(target=_rank_entry, daemon=True,
                            args=(r, i, len(ranks), n_ranks, addr, port,
                                  backend, device, timeout_s, wait_timeout_s,
                                  fn, rank_args[i], q, flag, beats))
             for i, r in enumerate(ranks)}
    results: dict = {}
    outcomes: dict = {}
    settle = None

    def take(kind, rank, payload):
        if kind == "log":
            log(payload)
        elif kind == "ok":
            results[rank] = payload
        else:
            # a report replaces a 'died' seen before it arrived
            outcomes[rank] = (kind, payload)

    fwd = (_Forward(flag, procs, forward_profile).install()
           if forward_signals else None)
    try:
        for p in procs.values():
            p.start()
        while len(results) + len(outcomes) < len(ranks):
            if settle is not None and time.monotonic() > settle:
                break
            try:
                take(*q.get(timeout=0.25))
            except queue_mod.Empty:
                for r, p in procs.items():
                    if (r not in results and r not in outcomes
                            and p.exitcode not in (None, 0)):
                        outcomes[r] = ("died", p.exitcode)
            if outcomes and settle is None:
                # the peers of a 75 or a 76 end at the same step boundary
                together = any(k == "exit" and v[0] != EXIT_WATCHDOG
                               for k, v in outcomes.values())
                settle = time.monotonic() + (
                    EXIT_SETTLE_S if together else FAIL_SETTLE_S)
        if outcomes or len(results) < len(ranks):
            while True:             # what the ranks sent before they ended
                try:
                    take(*q.get_nowait())
                except queue_mod.Empty:
                    break
            for r, p in procs.items():
                if r not in results and r not in outcomes:
                    p.join(timeout=0.1)
            seen = ({r: (beats[1][i], beats[0][i])
                     for i, r in enumerate(ranks) if beats[1][i] >= 0}
                    if beats is not None else {})
            raise _verdict(outcomes, results, procs, ranks, n_ranks, seen)
        for p in procs.values():
            p.join(timeout=timeout_s)
        return [results[r] for r in ranks]
    finally:
        if fwd is not None:
            fwd.restore()
        alive = [p for p in procs.values() if p.is_alive()]
        for p in alive:
            p.terminate()
        end = time.monotonic() + 5.0
        for p in alive:
            p.join(timeout=max(end - time.monotonic(), 0.01))
        for p in procs.values():
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        q.close()
