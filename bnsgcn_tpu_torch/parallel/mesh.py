"""The process model for P > 1 (counterpart of bnsgcn_tpu/parallel/mesh.py).

The JAX package lays parts on a ('parts',) mesh axis and runs one SPMD
program. Here each part is one process (a rank) with its own device, and the
collectives go through torch.distributed:

  * `launch` starts P ranks with the `spawn` start method (never `fork`: the
    parent may have CUDA up), gives each an explicit process-group timeout so
    a hang in a step's collectives fails instead of waiting forever, forwards
    rank log lines to the parent, and collects each rank's result. A rank
    that fails makes `launch` tear the other ranks down and raise.
  * `rank_device` is the device map: with nccl rank r gets cuda:r; with gloo
    on CUDA every rank uses cuda:(r % device_count), so several ranks may
    share one card; with --device cpu the ranks run on the CPU.
  * `Comm` is one rank's handle on its group: the all-to-all of the halo
    exchange and the all-reduce of the gradient reduce, each timed without
    stalling the stream (CUDA events on a card, the host clock on the CPU),
    and a barrier for the waits on work one rank does alone (set-up, rank
    0's evaluation), which runs over a gloo group of its own with the longer
    WAIT_TIMEOUT_S. Tensors go to the backend on their own device: nccl
    moves CUDA tensors card to card; gloo takes CUDA tensors too and stages
    them through host memory itself. The backend is whatever the caller
    asked for, never switched.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import socket
import time
import traceback
from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist

# a step's collectives: every rank runs the same work between two of them
PG_TIMEOUT_S = 60.0
# Comm.barrier: peers wait there for set-up and for rank 0's full-graph
# evaluation, which grow with the graph (and run on the CPU in the tests)
WAIT_TIMEOUT_S = 1800.0


def check_mesh_budget(n_parts: int, backend: str, device: str) -> None:
    """One named config error when P ranks do not fit the cards: nccl runs
    one rank per card and refuses two ranks on one (counterpart of
    bnsgcn_tpu/run.py check_mesh_budget)."""
    from bnsgcn_tpu_torch.config import ConfigError
    if n_parts <= 1 or device == "cpu":
        return
    have = torch.cuda.device_count()
    if backend == "nccl" and n_parts > have:
        raise ConfigError(
            f"mesh does not fit: --n-partitions {n_parts} with --dist-backend "
            f"nccl needs {n_parts} CUDA devices (one rank per card), have "
            f"{have}; shrink --n-partitions to <= {have}, or pass "
            f"--dist-backend gloo to run several ranks on one card")


def rank_device(device: str, backend: str, rank: int) -> torch.device:
    if device == "cpu":
        return torch.device("cpu")
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


class Comm:
    """One rank's collectives. Each all-to-all and all-reduce is timed by
    kind ('exchange', 'reduce') without a device synchronization: between
    two CUDA events on the current stream on a card (read by `seconds`,
    once the stream has passed them), on the host clock on the CPU. A span
    runs from the moment the rank's own inputs are ready to the moment the
    result has landed, so it includes the wait for slower peers. The epoch
    line reads the sums as Comm(s) and Reduce(s)."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 wait_group=None):
        self.rank, self.world, self.device = rank, world, device
        self.wait_group = wait_group
        self.reset_seconds()

    def reset_seconds(self):
        self._spans = {"exchange": [], "reduce": []}

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

    def _timed(self, kind: str, op: Callable[[], None]) -> None:
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            op()
            end.record()
            self._spans[kind].append((start, end))
        else:
            t0 = time.perf_counter()
            op()
            self._spans[kind].append(time.perf_counter() - t0)

    def all_to_all(self, x: torch.Tensor, kind: str = "exchange"
                   ) -> torch.Tensor:
        """Tiled all-to-all over the leading axis: block j of `x` (rows
        [j*n/P, (j+1)*n/P)) goes to rank j; block q of the result came from
        rank q."""
        src = x.contiguous()
        out = torch.empty_like(src)
        self._timed(kind, lambda: dist.all_to_all_single(out, src))
        return out

    def all_reduce_(self, x: torch.Tensor, kind: str = "reduce"
                    ) -> torch.Tensor:
        """In-place SUM over the ranks."""
        self._timed(kind, lambda: dist.all_reduce(x))
        return x

    def broadcast_(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        dist.broadcast(x, src)
        return x

    def all_gather_object(self, obj) -> list:
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        """Wait for every rank, under the wait group's timeout: where peers
        wait for work one rank does alone."""
        dist.barrier(group=self.wait_group)


@dataclass
class RankContext:
    """What a rank's job receives: its rank, its device, its Comm and a log
    function whose lines the parent prints."""
    rank: int
    device: torch.device
    comm: Comm
    log: Callable[[str], None]


class RankFailed(RuntimeError):
    """A rank raised or died; the message carries its traceback."""


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank, world, port, backend, device, timeout_s, wait_timeout_s,
                fn, args, q):
    """A spawned rank: join the group (and the gloo group of Comm.barrier),
    run fn(ctx, *args), send the result (or the traceback) to the parent,
    leave the group."""
    try:
        dev = rank_device(device, backend, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        if backend == "gloo":
            # every rank of this process model is on this host
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            wait_group = dist.new_group(
                backend="gloo",
                timeout=datetime.timedelta(seconds=wait_timeout_s))
            ctx = RankContext(rank, dev, Comm(rank, world, dev, wait_group),
                              lambda m: q.put(("log", rank, str(m))))
            result = fn(ctx, *args)
        finally:
            dist.destroy_process_group()
        q.put(("ok", rank, result))
    except BaseException:
        q.put(("err", rank, traceback.format_exc()))
        raise SystemExit(1)


def _failures(q, rank: int, tb: str, n_ranks: int,
              grace_s: float = 1.0) -> str:
    """The first failure's report plus those of ranks that fail within
    `grace_s` after it: a rank's error often breaks its peers' collectives
    at once, and whichever report lands first need not be the cause."""
    reports = [(rank, tb)]
    end = time.monotonic() + grace_s
    while time.monotonic() < end:
        try:
            kind, r, payload = q.get(timeout=max(end - time.monotonic(), 0.01))
        except queue_mod.Empty:
            break
        if kind == "err":
            reports.append((r, payload))
    return "\n".join(f"rank {r} of {n_ranks} failed:\n{t}"
                     for r, t in sorted(reports))


def launch(fn, n_ranks: int, rank_args: list, backend: str, device: str,
           log=print, timeout_s: float = PG_TIMEOUT_S,
           wait_timeout_s: float = WAIT_TIMEOUT_S) -> list:
    """Run fn(RankContext, *rank_args[r]) on n_ranks spawned processes and
    return their results in rank order. `timeout_s` bounds each collective,
    `wait_timeout_s` each Comm.barrier. `fn` and the arguments are pickled
    (fn by import path). Log lines a rank sends come out through `log` as
    they arrive. Raises RankFailed, after terminating every other rank, when
    a rank raises or dies."""
    if len(rank_args) != n_ranks:
        raise ValueError(f"{len(rank_args)} argument tuples for {n_ranks} ranks")
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(r, n_ranks, port, backend, device, timeout_s,
                               wait_timeout_s, fn, rank_args[r], q))
             for r in range(n_ranks)]
    results: list = [None] * n_ranks
    done: set = set()
    try:
        for p in procs:
            p.start()
        while len(done) < n_ranks:
            try:
                kind, rank, payload = q.get(timeout=0.5)
            except queue_mod.Empty:
                for r, p in enumerate(procs):
                    if r not in done and p.exitcode not in (None, 0):
                        raise RankFailed(f"rank {r} died with exit code "
                                         f"{p.exitcode} and no report")
                continue
            if kind == "log":
                log(payload)
            elif kind == "ok":
                results[rank] = payload
                done.add(rank)
            else:
                raise RankFailed(_failures(q, rank, payload, n_ranks))
        for p in procs:
            p.join(timeout=timeout_s)
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        q.close()
