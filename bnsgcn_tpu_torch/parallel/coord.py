"""Out-of-band rank coordination (counterpart of bnsgcn_tpu/parallel/coord.py:
the same key-value coordinator, the same wire format byte for byte, so a
coordinator of either package can serve the other's peers).

A rank that just received SIGTERM, whose loss went NaN or whose checkpoint
is torn must tell its peers without entering another collective, or a fault
on one rank hangs the others inside the next one. This module is that side
channel: a small key-value store that coordination rank 0 serves and every
coordination rank (0 included) talks to, carrying host-side control state
only, never tensors.

In the port a coordination rank is a *launch* (run.py): one node's launcher
and the gloo ranks it spawns (`--n-nodes N`: rank `--node-rank`, world N),
or, in the harness mode the JAX package's tests drive (`--coord-world W
--coord-rank r`), one of W independent launches that share no process
group. The launcher builds the Coordinator (rank 0's serves) for the
exchanges before its ranks start; its local rank 0 then continues the same
schedule through `handoff` / `Coordinator.adopt` and relays each decision
to the launch's other ranks over its own group.

Two transports, selected by `--coord`:

* **tcp** (what `auto` picks for a world > 1): rank 0 binds a threaded
  line-JSON KV server on `--coord-port`; clients open one short-lived
  connection per request. The server thread keeps answering while the
  process's main thread blocks elsewhere.
* **file**: a shared directory (`--coord-dir`, default
  `{ckpt_path}/.coord`): put = atomic rename, get = poll, liveness = mtime.

Every exchange has a bounded deadline (`$BNSGCN_COORD_TIMEOUT_S`, default
120 s) with exponential poll backoff. On expiry the coordinator prints the
peer-liveness table (who last heartbeat, at which epoch) and raises
`CoordTimeout`, which the CLI maps to the watchdog's exit 77; `CoordAbort`
(the ranks agreed to abort) maps to 78.

The collectives built on the store (`agree`, `broadcast`, `gather_ok`)
assume the same call order on every rank; a per-coordinator sequence number
isolates successive exchanges (a rollback revisits epochs, so epoch numbers
alone would collide). `--coord off`, and a world of 1, build none of this.
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import threading
import time
from typing import Callable, Optional

from bnsgcn_tpu_torch.config import ConfigError

__all__ = [
    "CoordError", "CoordTimeout", "CoordAbort", "CoordCancelled",
    "Coordinator", "TcpTransport", "FileTransport", "make_coordinator",
    "STATE_PRIORITY", "reduce_states",
    "LineJsonServer", "rpc_line_json", "probe_line_json",
]


class CoordError(Exception):
    """Base class for coordination failures."""


class CoordTimeout(CoordError):
    """A bounded exchange expired: a peer (or the rank-0 server) stopped
    responding. main.py maps this to the watchdog exit code (77); the peer
    liveness table was already printed by the raising coordinator."""

    exit_code = 77      # resilience.EXIT_WATCHDOG


class CoordAbort(CoordError):
    """The ranks agreed to abort (a peer cannot restore the chosen state,
    or a peer reported an unrecoverable fault). main.py maps this to
    EXIT_COORD_ABORT (78) — needs triage, not a blind requeue."""

    exit_code = 78      # resilience.EXIT_COORD_ABORT


class CoordCancelled(CoordError):
    """An in-flight pooled request was cancelled from another thread
    (LineJsonClient.cancel) — the hedged-read loser path. Distinct from
    CoordTimeout so callers never mistake a deliberate abort for a dead
    peer and mark the backend unhealthy."""


# local step-boundary states, worst-wins; the agreed decision is the reduce
# of every rank's contribution. 'diverged' outranks 'preempted': a preempt
# checkpoint written from NaN state would poison the resume, so the rollback
# happens first and the still-set preempt flag fires at the next boundary.
# 'lost' is never contributed locally — rank 0 imputes it (elastic mode)
# for a peer whose process is provably gone; it outranks 'diverged' because
# the RESIZE restores the agreed checkpoint anyway, healing the divergence
# with the same restore while the member set actually matches the verdict.
STATE_PRIORITY = {"ok": 0, "preempted": 1, "diverged": 2, "lost": 3,
                  "abort": 4}
_DECISION_OF = {"ok": "ok", "preempted": "preempt", "diverged": "rollback",
                "lost": "resize", "abort": "abort"}


def reduce_states(states: dict[int, str]) -> str:
    """Worst local state across ranks -> the agreed decision name."""
    worst = max(states.values(), key=lambda s: STATE_PRIORITY.get(s, 99))
    return _DECISION_OF.get(worst, "abort")


def _now() -> float:
    return time.time()


def _host() -> str:
    """Sanitized short hostname for the FileTransport run token (the token
    prefixes flat file names, so only filename-safe characters)."""
    h = socket.gethostname()
    return ("".join(c if c.isalnum() or c in ".-" else "-" for c in h)[:64]
            or "host")


def _token_is_dead(token: str) -> bool:
    """True when `token` was minted by a same-host process that no longer
    exists — a previous run's leftover `.boot`. Cross-host tokens can't be
    probed and are trusted as-is."""
    host, sep, rest = token.partition(":")
    if not sep or host != _host():
        return False
    try:
        pid = int(rest.split("-", 1)[0], 16)
    except ValueError:
        return True         # malformed = torn write, never adopt
    try:
        os.kill(pid, 0)
        return False
    except ProcessLookupError:
        return True
    except OSError:
        return False        # EPERM etc.: alive under another uid


# ----------------------------------------------------------------------------
# transports: a key-value store with put / blocking-get / liveness dump
# ----------------------------------------------------------------------------

class _KVStore:
    """In-memory store behind the rank-0 TCP server. Tracks the server-side
    receive time of every put so liveness ages are measured on one clock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: dict[str, tuple[str, float]] = {}  # guarded-by: self._lock

    def put(self, key: str, value: str):
        with self._lock:
            self._data[key] = (value, _now())

    def get(self, key: str) -> Optional[str]:
        with self._lock:
            hit = self._data.get(key)
        return hit[0] if hit else None

    def delete(self, key: str):
        with self._lock:
            self._data.pop(key, None)

    def dump(self, prefix: str) -> dict[str, tuple[str, float]]:
        now = _now()
        with self._lock:
            return {k: (v, now - t) for k, (v, t) in self._data.items()
                    if k.startswith(prefix)}


# the longest JSON line a peer reads: a serving backend's halo `resolve`
# answers carry whole feature rows and in-neighbour lists (several MB at
# Reddit's widths), past the JAX package's 1 MiB
LINE_LIMIT = 1 << 28


class _LineJsonHandler(socketserver.StreamRequestHandler):
    timeout = 10.0

    def handle(self):
        try:
            self.connection.setsockopt(socket.IPPROTO_TCP,
                                       socket.TCP_NODELAY, 1)
        except OSError:
            pass
        try:
            # persistent connections: keep answering request lines until the
            # client closes (one-shot clients send one line then FIN, so the
            # loop exits promptly; pooled clients amortize the TCP handshake
            # across many requests — the router -> backend forwarding path)
            while True:
                line = self.rfile.readline(LINE_LIMIT)
                if not line:
                    return
                req = json.loads(line)
                try:
                    resp = self.server.handle_fn(req)     # type: ignore[attr-defined]
                except Exception as ex:                   # noqa: BLE001
                    # a handler bug answers the one request with an error —
                    # it never takes the server (or its siblings) down
                    resp = {"ok": False, "err": f"{type(ex).__name__}: {ex}"}
                if resp is None:
                    # the handler opted to tear the connection without a
                    # response (serving-fault injection: 'servedrop')
                    return
                self.wfile.write(json.dumps(resp).encode() + b"\n")
                self.wfile.flush()
        except (OSError, ValueError, KeyError):
            pass        # a torn request never takes the server down


class LineJsonServer(socketserver.ThreadingTCPServer):
    """Threaded one-line-JSON-per-connection TCP server: each request is a
    single JSON line, dispatched to `handle_fn(dict) -> dict`, answered with
    one JSON line. The rank coordinator's transport (KV verdict store,
    below); the JAX package's online inference server runs on it too."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, port: int, handle_fn: Callable[[dict], dict],
                 addr: str = ""):
        super().__init__((addr, port), _LineJsonHandler)
        self.handle_fn = handle_fn
        self._thread = threading.Thread(target=self.serve_forever,
                                        name="bnsgcn-linejson-server",
                                        daemon=True)

    def start(self):
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        return self.server_address[1]

    def stop(self):
        self.shutdown()
        self.server_close()


def rpc_line_json(addr: str, port: int, req: dict, deadline: float,
                  what: str = "coordinator", retry_sent: bool = True) -> dict:
    """One request/response round trip against a LineJsonServer, retried
    with backoff until `deadline` (connect refusals during peer startup are
    expected — retrying makes client/server start order free).

    `retry_sent=False` never re-sends a request the server may already have
    received: once the payload went out, a torn/slow response raises
    instead of retrying, and the per-attempt read timeout stretches to the
    full remaining deadline. The KV coordinator's ops are idempotent so it
    keeps the resilient default; serve clients (add_edges, flush) are NOT —
    a silent re-send would ingest a delta twice or start a second flush."""
    delay = 0.05
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise CoordTimeout(
                f"{what} at {addr}:{port} unreachable "
                f"(op {req.get('op')!r} key {req.get('k', '')!r})")
        sent = False
        try:
            with socket.create_connection(
                    (addr, port),
                    timeout=min(max(remaining, 0.05), 5.0)) as s:
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                s.settimeout(max(remaining, 0.05) if not retry_sent
                             else min(max(remaining, 0.05), 10.0))
                s.sendall(json.dumps(req).encode() + b"\n")
                sent = True
                line = s.makefile("rb").readline(LINE_LIMIT)
            if line:
                return json.loads(line)
        except (OSError, ValueError) as ex:
            if sent and not retry_sent:
                err = CoordTimeout(
                    f"{what} at {addr}:{port} accepted op "
                    f"{req.get('op')!r} but the response was lost "
                    f"({type(ex).__name__}: {ex}); not re-sending a "
                    f"non-idempotent request — check server state before "
                    f"retrying")
                # the payload reached the wire: the server MAY have applied
                # it. Callers that queue failed writes for replay (the
                # router's failover WAL) must treat this as
                # delivered-unknown, never as safe-to-resend.
                err.request_sent = True
                raise err from ex
        if sent and not retry_sent:
            # connection closed with no response line: same at-most-once rule
            err = CoordTimeout(
                f"{what} at {addr}:{port} closed the connection after op "
                f"{req.get('op')!r} was sent; not re-sending a "
                f"non-idempotent request")
            err.request_sent = True
            raise err
        time.sleep(min(delay, max(deadline - time.monotonic(), 0)))
        delay = min(delay * 2, 1.0)


class LineJsonClient:
    """Pooled persistent connection to one LineJsonServer peer.

    Amortizes the per-request TCP handshake the one-shot `rpc_line_json`
    pays: the socket stays open across calls (the handler loop on the server
    side keeps answering lines until EOF). ONLY safe for idempotent requests
    — on a torn response the request is retried ONCE over a fresh
    connection, so a non-idempotent op could execute twice; route those
    through `rpc_line_json(..., retry_sent=False)` instead.

    Thread-safe: one in-flight request at a time per client (the line
    protocol has no request ids to demux interleaved responses)."""

    def __init__(self, addr: str, port: int, timeout_s: float = 30.0,
                 what: str = "peer"):
        self.addr, self.port = addr, port
        self.timeout_s = timeout_s
        self.what = what
        self._lock = threading.Lock()
        self._sock = None           # guarded-by: self._lock
        self._rfile = None          # guarded-by: self._lock
        self._cancelled = False     # set lock-FREE by cancel(); read by
                                    # the in-flight request holding _lock
        self._cancel_sock = None    # lock-FREE alias of _sock for cancel()
                                    # (atomic ref read; see cancel())
        self.bytes_out = 0          # guarded-by: self._lock
        self.bytes_in = 0           # guarded-by: self._lock

    def _connect_locked(self):
        s = socket.create_connection((self.addr, self.port),
                                     timeout=self.timeout_s)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.settimeout(self.timeout_s)
        self._sock, self._rfile = s, s.makefile("rb")
        self._cancel_sock = s

    def _close_locked(self):
        for f in (self._rfile, self._sock):
            if f is not None:
                try:
                    f.close()
                except OSError:
                    pass
        self._sock = self._rfile = self._cancel_sock = None

    def _round_trip_locked(self, payload: bytes) -> dict:
        if self._sock is None:
            self._connect_locked()
        self._sock.sendall(payload)
        self.bytes_out += len(payload)
        line = self._rfile.readline(LINE_LIMIT)
        if not line:
            raise OSError("connection closed by peer")
        self.bytes_in += len(line)
        return json.loads(line)

    def request(self, req: dict) -> dict:
        """One idempotent round trip; retries once on a fresh connection."""
        payload = json.dumps(req).encode() + b"\n"
        with self._lock:
            self._cancelled = False
            try:
                return self._round_trip_locked(payload)
            except (OSError, ValueError):
                if self._cancelled:
                    # deliberate abort from cancel(): do NOT retry — the
                    # caller (a hedged-read loser) wants out, and a retry
                    # would re-issue a request nobody is waiting for
                    self._close_locked()
                    raise CoordCancelled(
                        f"{self.what} at {self.addr}:{self.port} request "
                        f"(op {req.get('op')!r}) cancelled in flight")
                # stale pooled socket (idle-timeout FIN, peer restart):
                # retry exactly once over a fresh connection
                self._close_locked()
                try:
                    return self._round_trip_locked(payload)
                except (OSError, ValueError) as ex:
                    self._close_locked()
                    if self._cancelled:
                        raise CoordCancelled(
                            f"{self.what} at {self.addr}:{self.port} "
                            f"request (op {req.get('op')!r}) cancelled in "
                            f"flight") from ex
                    raise CoordTimeout(
                        f"{self.what} at {self.addr}:{self.port} "
                        f"unreachable (op {req.get('op')!r}): "
                        f"{type(ex).__name__}: {ex}") from ex

    def traffic(self) -> tuple[int, int]:
        """(bytes sent, bytes received) over this client's lifetime, the
        JSON lines with their newlines."""
        with self._lock:
            return self.bytes_out, self.bytes_in

    def cancel(self):
        """Abort the in-flight request from ANOTHER thread: shuts the
        pooled socket down so the blocked read fails now, and the victim
        raises CoordCancelled instead of retrying. Deliberately lock-free
        — the victim holds `_lock` for the whole round trip, so taking it
        here would deadlock until the timeout this call exists to beat.
        A no-op when nothing is in flight."""
        self._cancelled = True
        s = self._cancel_sock
        if s is not None:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def close(self):
        with self._lock:
            self._close_locked()


def probe_line_json(addr: str, port: int, timeout_s: float = 1.0,
                    what: str = "backend") -> dict:
    """One liveness probe against a LineJsonServer: a single fresh-socket
    ping with NO retry and NO backoff — the health checker's primitive.

    Deliberately not pooled and not `rpc_line_json` (which retries until a
    deadline): a probe must report THIS attempt's truth, because the
    caller's consecutive-failure counter is the retry policy. Returns
    `{"ok": True, "rtt_s": ...}` plus the server's ping payload, or
    `{"ok": False, "err": ...}` on any failure within `timeout_s`."""
    t0 = time.monotonic()
    try:
        with socket.create_connection((addr, port), timeout=timeout_s) as s:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.settimeout(timeout_s)
            s.sendall(b'{"op": "ping"}\n')
            line = s.makefile("rb").readline(LINE_LIMIT)
        resp = json.loads(line) if line else None
        if not (isinstance(resp, dict) and resp.get("ok")):
            return {"ok": False,
                    "err": f"{what} at {addr}:{port} answered {resp!r}"}
        resp["rtt_s"] = time.monotonic() - t0
        return resp
    except (OSError, ValueError) as ex:
        return {"ok": False,
                "err": f"{what} at {addr}:{port}: "
                       f"{type(ex).__name__}: {ex}"}


def _kv_handle(store: _KVStore, req: dict) -> dict:
    op = req.get("op")
    if op == "put":
        store.put(req["k"], req["v"])
        return {"ok": True}
    if op == "get":
        v = store.get(req["k"])
        return {"ok": v is not None, "v": v}
    if op == "del":
        store.delete(req["k"])
        return {"ok": True}
    if op == "dump":
        return {"ok": True, "items": store.dump(req.get("p", ""))}
    if op == "ping":
        return {"ok": True}
    return {"ok": False, "err": f"unknown op {op!r}"}


class TcpTransport:
    """Rank 0 hosts the KV server; every rank (rank 0 included — one code
    path) talks to it with one short-lived connection per request, retrying
    with backoff on connect failures so client startup order is free."""

    def __init__(self, addr: str, port: int, serve: bool):
        self.addr, self.port = addr, port
        self._server = None
        if serve:
            store = _KVStore()
            self._server = LineJsonServer(
                port, lambda req: _kv_handle(store, req)).start()
            self.port = self._server.port       # the bound one (port 0)

    def client(self) -> tuple:
        """The spec of a client of this store (`make_transport`)."""
        return ("tcp", self.addr, self.port)

    # -- one request/response round trip, retried until `deadline` --
    def _rpc(self, req: dict, deadline: float) -> dict:
        return rpc_line_json(self.addr, self.port, req, deadline)

    def put(self, key: str, value: str, deadline: float):
        self._rpc({"op": "put", "k": key, "v": value}, deadline)

    def try_get(self, key: str, deadline: float) -> Optional[str]:
        resp = self._rpc({"op": "get", "k": key}, deadline)
        return resp.get("v") if resp.get("ok") else None

    def delete(self, key: str, deadline: float):
        self._rpc({"op": "del", "k": key}, deadline)

    def dump(self, prefix: str, deadline: float) -> dict:
        resp = self._rpc({"op": "dump", "p": prefix}, deadline)
        return resp.get("items", {}) if resp.get("ok") else {}

    def close(self):
        if self._server is not None:
            self._server.stop()
            self._server = None


class FileTransport:
    """Shared-directory KV: put = write-tmp + atomic rename, get = read,
    liveness age = file mtime. Key slashes map to '@' so every key is one
    flat file. No server process — nothing to outlive or crash.

    Unlike the TCP store (in-memory, dies with the run) the directory
    OUTLIVES a run, and sequence numbers restart at 0 — a resumed run must
    never read the previous run's keys (e.g. adopt a stale 'preempt'
    decision at the same seq). So every run gets a fresh namespace: rank 0
    purges the directory and publishes a run token in `.boot`; peers adopt
    the token before their first exchange and every key is prefixed with
    it. A peer that races ahead of a RELAUNCHING rank 0 (a requeue
    wrapper's relaunch — the previous run's `.boot` AND its keys, under the same
    deterministic names, are still on disk) must not adopt the dead run's
    namespace: the token embeds the minting host+pid, and a peer rejects a
    same-host token whose process is gone, polling until the new rank 0
    purges and re-mints. A token is only PINNED once a get under it
    succeeds; every miss before that re-reads `.boot`. A token minted on
    another host cannot be pid-probed: there a relaunch must use a fresh
    --coord-dir."""

    BOOT = ".boot"

    def __init__(self, root: str, rank: int, token: Optional[str] = None):
        self.root = root
        self._rank = rank
        os.makedirs(root, exist_ok=True)
        self._clock = time.monotonic
        self._sleep = time.sleep
        self._token: Optional[str] = None
        self._pinned = False        # peers: token confirmed by a real get
        if token is not None:
            # another process of this rank already joined the run (the
            # launcher, handing its exchanges to its local rank 0): its
            # namespace, never a purge
            self._token, self._pinned = token, True
        elif rank == 0:
            for fn in os.listdir(root):
                try:
                    os.unlink(os.path.join(root, fn))
                except OSError:
                    pass        # a peer's in-flight tmp file — harmless
            self._token = f"{_host()}:{os.getpid():x}-{int(_now() * 1000):x}"
            self._pinned = True
            tmp = os.path.join(root, f"{self.BOOT}.tmp0")
            with open(tmp, "w") as f:
                f.write(self._token)
            os.replace(tmp, os.path.join(root, self.BOOT))

    def _ns(self, deadline: float) -> str:
        """This run's key namespace: rank 0 minted it; peers poll `.boot`,
        refusing a token whose same-host minting process is dead (the
        previous run's leftover) until the new rank 0 re-mints."""
        delay = 0.02
        while self._token is None:
            try:
                with open(os.path.join(self.root, self.BOOT)) as f:
                    tok = f.read().strip() or None
            except OSError:
                tok = None
            if tok is not None and not _token_is_dead(tok):
                self._token = tok
                break
            if self._clock() >= deadline:
                raise CoordTimeout(
                    f"rank {self._rank}: no {self.BOOT} run token in "
                    f"{self.root} (is rank 0 up?)")
            self._sleep(min(delay, max(deadline - self._clock(), 0)))
            delay = min(delay * 2, 0.5)
        return self._token

    def _path(self, key: str, deadline: float) -> str:
        return os.path.join(
            self.root, self._ns(deadline) + "@" + key.replace("/", "@"))

    def put(self, key: str, value: str, deadline: float):
        path = self._path(key, deadline)
        tmp = f"{path}.tmp.{self._rank}"
        with open(tmp, "w") as f:
            f.write(value)
        os.replace(tmp, path)

    def try_get(self, key: str, deadline: float) -> Optional[str]:
        try:
            with open(self._path(key, deadline)) as f:
                v = f.read()
            self._pinned = True     # a hit proves the token is this run's
            return v
        except OSError:
            if not self._pinned:
                # provisional token may be the previous run's leftover
                # .boot — drop it so the next poll re-reads what rank 0
                # has (re-)minted by then
                self._token = None
            return None

    def delete(self, key: str, deadline: float):
        try:
            os.unlink(self._path(key, deadline))
        except OSError:
            pass        # already gone / transient fs error — prune retries

    def dump(self, prefix: str, deadline: float) -> dict:
        ns = self._ns(deadline) + "@"
        pfx = ns + prefix.replace("/", "@")
        out = {}
        now = _now()
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for fn in names:
            if not fn.startswith(pfx) or fn.rpartition(".")[2].isdigit():
                continue        # skip in-flight .tmp.<rank> files
            path = os.path.join(self.root, fn)
            try:
                with open(path) as f:
                    v = f.read()
                age = now - os.path.getmtime(path)
            except OSError:
                continue
            out[fn[len(ns):].replace("@", "/")] = (v, age)
        return out

    def client(self) -> tuple:
        """The spec of a client of this store (`make_transport`): the run's
        namespace, which a peer reads from `.boot` before its first
        exchange."""
        return ("file", self.root, self._rank,
                self._ns(time.monotonic() + 120.0))

    def close(self):
        pass


def make_transport(spec: tuple):
    """A client transport from `TcpTransport.client()` or
    `FileTransport.client()`."""
    if spec[0] == "tcp":
        return TcpTransport(spec[1], spec[2], serve=False)
    return FileTransport(spec[1], spec[2], token=spec[3])


# ----------------------------------------------------------------------------
# the coordinator: collectives over the KV store
# ----------------------------------------------------------------------------

class Coordinator:
    """One per rank per run. All collectives are worst-case-bounded by
    `timeout_s` per phase; every raise path first prints peer liveness."""

    ALIVE_KEY = "wa"        # watchdog-thread heartbeat (process is alive)
    STEP_KEY = "hb"         # step-boundary heartbeat (training is advancing)
    PRUNE_HORIZON = 16      # collectives a spent exchange's keys survive.
                            # Peers lag rank 0 by at most the longest run of
                            # consecutive broadcasts (rank 0 returns without
                            # waiting on those; <= 4 anywhere in the code —
                            # every agree/gather_ok re-syncs), so 16 is
                            # comfortably past any legal drift.

    def __init__(self, rank: int, world: int, transport, timeout_s: float,
                 log=print):
        if world < 2:
            raise ValueError("Coordinator needs world >= 2 "
                             "(use --coord off for single-rank runs)")
        self.rank = int(rank)
        self.world = int(world)
        self.transport = transport
        self.timeout_s = float(timeout_s)
        self.log = log
        # every wait in this class goes through these two (tests run the
        # collectives under a virtual clock)
        self._clock = time.monotonic
        self._sleep = time.sleep
        self.last_infos: dict[int, dict] = {}   # rank 0: the piggybacked
                            # per-rank info payloads of the latest agree()
                            # (obs epoch summaries — merged into ONE
                            # cross-rank record with no extra collective)
        self._seq = 0       # collective counter: all ranks call collectives
                            # in lockstep, so equal seq == the same exchange
        self._spent: list[tuple[int, list[str]]] = []   # rank 0: (seq, keys)
                            # of completed exchanges, pruned past the horizon
        self._closed = False
        # elastic membership: the live rank ids, never renumbered (transport
        # keys keep the original rank numbers). A RESIZE verdict shrinks or
        # grows this set; `world` tracks len(members). Non-elastic runs never
        # change it, so members == range(world) and every loop below is
        # byte-identical to the historical range() form.
        self.members: tuple[int, ...] = tuple(range(self.world))
        self.elastic = False
        self.min_world = 1
        # a peer is provably dead once its alive-beat (the watchdog thread's
        # 2 s cadence, resilience._Watchdog.ALIVE_BEAT_S) is this stale
        self.dead_after_s = float(os.environ.get("BNSGCN_ELASTIC_DEAD_S",
                                                 6.0))
        self._peer_dead = self._liveness_dead
        self._lost: set[int] = set()    # rank 0: ranks resized away, still
                            # owed a rejoin beacon (el/lost/<r>)
        # agree cadence: exchange verdicts every K step boundaries; local
        # states latch worst-wins in between. All ranks read the same env
        # knob and count calls in lockstep, so the boundary schedule is
        # globally consistent and `_seq` never drifts.
        self.agree_every = max(1, int(os.environ.get(
            "BNSGCN_COORD_AGREE_EVERY", "1") or 1))
        self._agree_calls = 0
        self._latched = "ok"

    # -- plumbing --

    def _deadline(self, timeout_s: Optional[float] = None) -> float:
        return self._clock() + (self.timeout_s if timeout_s is None
                                else timeout_s)

    def _peers(self) -> list[int]:
        return [r for r in self.members if r != self.rank]

    def _get(self, key: str, deadline: float, what: str) -> str:
        """Blocking get with poll backoff; CoordTimeout (after a liveness
        dump) once the deadline passes. The initial poll is fine-grained
        (2 ms) because this sits on the healthy per-epoch agree path —
        every peer's first decision fetch almost always misses while rank 0
        gathers, and a 20 ms granularity there would tax fast full-graph
        epochs by a comparable amount; backoff caps at 50 ms so a pending
        key costs at most one extra poll interval of latency while an
        absent peer costs ~20 polls/s, not a busy loop burning a core."""
        delay = 0.002
        while True:
            try:
                v = self.transport.try_get(key, deadline)
            except CoordTimeout:
                v = None        # transport-level expiry: fall through to the
                                # descriptive raise (with liveness) below
            if v is not None:
                return v
            if self._clock() >= deadline:
                self.log_liveness()
                raise CoordTimeout(
                    f"rank {self.rank}: timed out waiting for {what} "
                    f"(key {key!r}; per-exchange bound {self.timeout_s:.1f}s)")
            self._sleep(min(delay, max(deadline - self._clock(), 0)))
            delay = min(delay * 2, 0.05)

    def _put(self, key: str, value: str, deadline: Optional[float] = None):
        self.transport.put(key, value,
                           deadline if deadline is not None
                           else self._deadline())

    def _retire(self, seq: int, keys: list[str]):
        """Rank 0, best-effort: remember a completed exchange's per-seq keys
        and delete the ones older than PRUNE_HORIZON, so a long run's KV
        store stays O(world), not O(epochs) — the agree() per epoch would
        otherwise grow rank 0's store (and the --coord file dir the
        liveness dump os.listdir's) for the run's whole lifetime."""
        if self.rank != 0:
            return
        self._spent.append((seq, keys))
        cutoff = seq - self.PRUNE_HORIZON
        deadline = self._deadline(min(5.0, self.timeout_s))
        keep = []
        for s, ks in self._spent:
            if s > cutoff:
                keep.append((s, ks))
                continue
            for k in ks:
                try:
                    self.transport.delete(k, deadline)
                except (CoordError, OSError):
                    pass        # a missed prune only leaks one tiny key
        self._spent = keep

    # -- heartbeats / liveness --

    def heartbeat(self, epoch: int, kind: str = "hb"):
        """Best-effort: a failed heartbeat must never take down the rank
        that is still healthy enough to send one."""
        key = f"{kind}/{self.rank}"
        try:
            self._put(key, json.dumps({"epoch": int(epoch), "t": _now()}),
                      self._deadline(min(5.0, self.timeout_s)))
        except (CoordError, OSError):
            # OSError: FileTransport.put hits the raw filesystem (ENOSPC,
            # a flaky NFS) — same best-effort contract as a dead server
            pass

    def liveness(self) -> dict[int, dict]:
        """{rank: {'epoch', 'step_age_s', 'alive_age_s'}} from the server's
        receive clock (file transport: mtimes). Missing entries mean the
        rank never reported."""
        out: dict[int, dict] = {r: {} for r in self.members}
        deadline = self._deadline(min(5.0, self.timeout_s))
        for kind, field in ((self.STEP_KEY, "step_age_s"),
                            (self.ALIVE_KEY, "alive_age_s")):
            try:
                items = self.transport.dump(f"{kind}/", deadline)
            except CoordError:
                continue
            for key, (v, age) in items.items():
                try:
                    r = int(key.rsplit("/", 1)[1])
                    out[r][field] = float(age)
                    if kind == self.STEP_KEY:
                        out[r]["epoch"] = int(json.loads(v).get("epoch", -1))
                except (ValueError, KeyError, IndexError):
                    continue
        return out

    def log_liveness(self, write=None):
        """Print the per-rank heartbeat table — the watchdog and every
        timeout path call this so a hung collective names its straggler."""
        write = write or (lambda s: self.log(s))
        try:
            live = self.liveness()
        except Exception:
            write("[coord] peer liveness unavailable (coordinator "
                  "unreachable)")
            return
        ages = {r: info.get("step_age_s", float("inf"))
                for r, info in live.items()}
        stalest, stale_age = max(ages.items(), key=lambda kv: kv[1])
        # only finger a rank when it is genuinely behind its peers (or
        # never reported while others did): everyone-fresh,
        # everyone-equally-old and nobody-reported-yet dumps should not
        # invent a culprit
        freshest = min(ages.values())
        if stale_age == float("inf"):
            if freshest == float("inf"):
                stalest = None      # startup failure before ANY heartbeat
        elif stale_age - freshest < 10.0:
            stalest = None
        write(f"[coord] peer liveness (world {self.world}, viewed from "
              f"rank {self.rank}):")
        for r in self.members:
            info = live.get(r, {})
            step = (f"step hb {info['step_age_s']:.1f}s ago "
                    f"(epoch {info.get('epoch', -1)})"
                    if "step_age_s" in info else "no step heartbeat")
            alive = (f"alive {info['alive_age_s']:.1f}s ago"
                     if "alive_age_s" in info else "no alive heartbeat")
            mark = "   <- stalled" if r == stalest else ""
            write(f"[coord]   rank {r}: {step}, {alive}{mark}")

    def _liveness_dead(self, ranks: list[int]) -> list[int]:
        """Subset of `ranks` whose process is provably gone: the alive-beat
        (the watchdog thread's, independent of step progress) is older than
        `dead_after_s`. A rank with NO alive beat on record is NOT imputed
        dead — a startup race must time out loudly, never resize."""
        try:
            live = self.liveness()
        except CoordError:
            return []
        out = []
        for r in ranks:
            age = live.get(r, {}).get("alive_age_s")
            if age is not None and age > self.dead_after_s:
                out.append(r)
        return out

    def _gather_elastic(self, keymap: dict[int, str], deadline: float,
                        what_fn) -> tuple[dict[int, str], list[int]]:
        """Interleaved gather with dead-peer imputation (elastic mode):
        poll every missing key round-robin; a rank whose process is provably
        gone is imputed 'lost' instead of awaited, so one dead peer costs
        ~`dead_after_s`, not the whole exchange window. An alive-but-silent
        rank still hits the standard CoordTimeout — a hung rank remains a
        77 (on a real cluster its own watchdog fires first, converting the hang
        into the very death this path absorbs)."""
        vals: dict[int, str] = {}
        lost: list[int] = []
        missing = dict(keymap)
        delay = 0.002
        check_every = min(1.0, self.dead_after_s / 2)
        next_check = self._clock() + check_every
        while missing:
            for r in sorted(missing):
                try:
                    v = self.transport.try_get(missing[r], deadline)
                except CoordTimeout:
                    v = None
                if v is not None:
                    vals[r] = v
                    del missing[r]
            if not missing:
                break
            now = self._clock()
            if now >= next_check:
                next_check = now + check_every
                for r in self._peer_dead(sorted(missing)):
                    self.log(f"[coord] rank {r} is gone (alive-beat older "
                             f"than {self.dead_after_s:.1f}s) — imputing "
                             f"'lost' instead of waiting on {what_fn(r)}")
                    lost.append(r)
                    del missing[r]
                continue
            if self._clock() >= deadline:
                self.log_liveness()
                r = sorted(missing)[0]
                raise CoordTimeout(
                    f"rank {self.rank}: timed out waiting for {what_fn(r)} "
                    f"(key {missing[r]!r}; per-exchange bound "
                    f"{self.timeout_s:.1f}s)")
            self._sleep(min(delay, max(deadline - self._clock(), 0)))
            delay = min(delay * 2, 0.05)
        return vals, lost

    # -- collectives (lockstep call order across ranks) --

    def agree(self, epoch: int, state: str,
              decide_fn: Optional[Callable[[str, dict], dict]] = None,
              info: Optional[dict] = None, final: bool = False) -> dict:
        """The per-step-boundary agreed verdict.

        Every rank contributes its local state; rank 0 reduces worst-wins
        and publishes one decision dict every rank returns. `decide_fn`
        (rank 0 only) maps (decision_name, {rank: state}) to the full
        decision payload — e.g. choosing the rollback checkpoint/nonce, or
        escalating to abort when retries are exhausted. Terminal decisions
        (anything but 'ok') are confirmed by every rank before rank 0
        returns, so a rank about to exit can never strand a peer that has
        not yet read the verdict.

        `info` piggybacks a small host-side payload (the obs epoch summary:
        loss, step ms) on the verdict this exchange already carries — rank 0
        exposes the gathered `{rank: info}` as `self.last_infos`, so a
        merged cross-rank record costs NO new collective. A rank that
        passes no info keeps the historical bare-string wire value.

        Cadence ($BNSGCN_COORD_AGREE_EVERY = K): only every K-th call (and
        a `final=True` call — the last step boundary, so a latched verdict
        can never die with the run) performs the exchange; in between the
        worst local state latches and an immediate `{'decision': 'ok',
        'deferred': True}` is returned. Verdict latency is therefore at
        most K step boundaries. K=1 (default) is exactly the historical
        every-boundary behavior.

        Elastic mode: a peer whose process is provably dead is imputed
        state 'lost' instead of timing out the exchange; worst-wins then
        maps it to a RESIZE decision (decide_fn supplies the payload)."""
        if (STATE_PRIORITY.get(state, 99)
                > STATE_PRIORITY.get(self._latched, 0)):
            self._latched = state
        calls = self._agree_calls
        self._agree_calls += 1
        if not final and (calls + 1) % self.agree_every != 0:
            return {"decision": "ok", "epoch": int(epoch), "deferred": True}
        state = self._latched
        self._latched = "ok"
        seq = self._seq
        self._seq += 1
        self.heartbeat(epoch, self.STEP_KEY)
        deadline = self._deadline()
        self._put(f"v/{seq}/{self.rank}",
                  state if info is None
                  else json.dumps({"s": state, "i": info}), deadline)
        if self.rank == 0:
            def _parse(v):
                if v.startswith("{"):
                    try:
                        d = json.loads(v)
                        return str(d.get("s", "abort")), d.get("i")
                    except ValueError:
                        return "abort", None
                return v, None

            states = {0: state}
            self.last_infos = {0: info} if info is not None else {}
            lost: list[int] = []
            if self.elastic:
                vals, lost = self._gather_elastic(
                    {r: f"v/{seq}/{r}" for r in self._peers()}, deadline,
                    lambda r: f"rank {r}'s epoch-{epoch} verdict")
                for r in sorted(vals):
                    s, i = _parse(vals[r])
                    states[r] = s
                    if i is not None:
                        self.last_infos[r] = i
                for r in lost:
                    states[r] = "lost"
            else:
                for r in self._peers():
                    s, i = _parse(self._get(
                        f"v/{seq}/{r}", deadline,
                        f"rank {r}'s epoch-{epoch} verdict"))
                    states[r] = s
                    if i is not None:
                        self.last_infos[r] = i
            name = reduce_states(states)
            decision = {"decision": name, "epoch": int(epoch),
                        "states": {str(r): s for r, s in states.items()}}
            if decide_fn is not None:
                decision = decide_fn(name, states)
                decision.setdefault("decision", name)
                decision.setdefault("epoch", int(epoch))
                # decide_fn may have done real checkpoint I/O past the
                # gather deadline — publish on a fresh window (the peers'
                # doubled fetch window below absorbs both)
                deadline = self._deadline()
            self._put(f"d/{seq}", json.dumps(decision), deadline)
        else:
            # the decision window must cover rank 0's gather of EVERY
            # verdict plus decide_fn's checkpoint I/O (plan_rollback reads
            # and checksums real files — multi-GB at papers100M scale), so
            # peers allow one extra timeout before calling rank 0 hung: a
            # healthy large-scale rollback is not a 77. Still bounded.
            decision = json.loads(self._get(
                f"d/{seq}", self._deadline(2 * self.timeout_s),
                f"rank 0's epoch-{epoch} decision"))
        terminal = decision.get("decision", "ok") != "ok"
        if terminal:
            # fresh window: a late-arriving decision (slow decide_fn) must
            # not leave the confirm with an already-expired deadline.
            # A RESIZE verdict's confirm set excludes the ranks it just
            # declared lost — their death is the verdict; waiting a full
            # deadline on each would stall every survivor.
            gone = {int(r) for r in decision.get("lost", [])}
            self._confirm(seq, self._deadline(),
                          ranks=[r for r in self.members if r not in gone])
        self._retire(seq, [f"v/{seq}/{r}" for r in self.members]
                     + [f"d/{seq}"]
                     + ([f"c/{seq}/{r}" for r in self.members]
                        if terminal else []))
        return decision

    def _confirm(self, seq: int, deadline: float,
                 ranks: Optional[list[int]] = None):
        """All (surviving) ranks acknowledge a terminal decision; rank 0
        waits (best effort — a peer that died before confirming must not
        block the survivors' orderly exit past the deadline). `ranks`
        narrows the wait set: a RESIZE must not spend a deadline waiting
        for the very rank whose death it just agreed on."""
        self._put(f"c/{seq}/{self.rank}", "1", deadline)
        if self.rank == 0:
            for r in (self.members if ranks is None else ranks):
                if r == 0:
                    continue
                try:
                    self._get(f"c/{seq}/{r}", deadline,
                              f"rank {r}'s decision confirmation")
                except CoordTimeout:
                    self.log(f"[coord] rank {r} never confirmed the "
                             f"decision (seq {seq}); proceeding")

    def broadcast(self, name: str, payload: Optional[dict] = None) -> dict:
        """Rank 0 publishes `payload`; every rank returns it."""
        seq = self._seq
        self._seq += 1
        deadline = self._deadline()
        if self.rank == 0:
            if payload is None:
                raise ValueError("rank 0 broadcast() needs a payload")
            self._put(f"b/{name}/{seq}", json.dumps(payload), deadline)
            self._retire(seq, [f"b/{name}/{seq}"])
            return payload
        # doubled window like agree()'s decision fetch: rank 0 may be
        # walking the checkpoint chain to compute the payload (resume-choice)
        return json.loads(self._get(f"b/{name}/{seq}",
                                    self._deadline(2 * self.timeout_s),
                                    f"rank 0's {name!r} broadcast"))

    def gather_ok(self, name: str, ok: bool, detail: str = ""
                  ) -> tuple[bool, dict[int, str]]:
        """All-ranks ack: returns (all_ok, {rank: failure detail}). Rank 0
        reduces and publishes, so every rank sees the same verdict and the
        same culprit list."""
        seq = self._seq
        self._seq += 1
        deadline = self._deadline()
        self._put(f"a/{name}/{seq}/{self.rank}",
                  json.dumps({"ok": bool(ok), "detail": detail}), deadline)
        if self.rank == 0:
            # doubled collection window: each peer's ack follows real work
            # (the resume/rollback ack IS a full checkpoint load+checksum),
            # and rank 0 — whose own payload was already validated —
            # arrives here first; a healthy-but-slow peer must not turn an
            # agreed resume into a spurious 77. Mirrors the peers' doubled
            # verdict fetch below.
            gather_dl = self._deadline(2 * self.timeout_s)
            fails: dict[int, str] = {}
            if self.elastic:
                vals, lost = self._gather_elastic(
                    {r: f"a/{name}/{seq}/{r}" for r in self._peers()},
                    gather_dl, lambda r: f"rank {r}'s {name!r} ack")
                vals[self.rank] = json.dumps({"ok": bool(ok),
                                              "detail": detail})
                for r in lost:
                    # a peer that died mid-ack: impute success so the
                    # survivors' exchange completes — the next agree
                    # boundary re-detects the death and resolves it as a
                    # RESIZE verdict instead of stranding this ack
                    self.log(f"[coord] rank {r} died before acking "
                             f"{name!r}; deferring the loss to the next "
                             f"agree boundary")
                for r in sorted(vals):
                    got = json.loads(vals[r])
                    if not got.get("ok"):
                        fails[r] = str(got.get("detail", ""))
            else:
                for r in self.members:
                    got = json.loads(self._get(
                        f"a/{name}/{seq}/{r}", gather_dl,
                        f"rank {r}'s {name!r} ack"))
                    if not got.get("ok"):
                        fails[r] = str(got.get("detail", ""))
            verdict = {"ok": not fails,
                       "fails": {str(r): d for r, d in fails.items()}}
            self._put(f"ad/{name}/{seq}", json.dumps(verdict), deadline)
        else:
            # doubled window like agree()'s decision fetch: rank 0 must
            # first gather EVERY rank's ack (each possibly slow — the
            # resume ack is a full checkpoint load) before publishing
            verdict = json.loads(self._get(
                f"ad/{name}/{seq}", self._deadline(2 * self.timeout_s),
                f"the {name!r} ack verdict"))
        if not verdict["ok"]:
            # a failed ack is terminal (the callers abort on it): confirm
            # like agree() does, so rank 0 cannot tear the server down
            # before every peer has read the verdict it is about to die on.
            # Fresh window: a late-arriving verdict must not leave the
            # confirm already expired (exit 77 masking the agreed 78).
            self._confirm(seq, self._deadline())
        self._retire(seq, [f"a/{name}/{seq}/{r}" for r in self.members]
                     + [f"ad/{name}/{seq}"]
                     + ([f"c/{seq}/{r}" for r in self.members]
                        if not verdict["ok"] else []))
        return (bool(verdict["ok"]),
                {int(r): d for r, d in verdict.get("fails", {}).items()})

    def finish(self):
        """Best-effort completion barrier before rank 0 tears down its KV
        server: ranks drift by up to one step boundary, so the first rank
        to finish must not strand a peer still fetching its last decision.
        Never raises — a peer that died near the end must not turn the
        survivors' clean exit into a failure."""
        try:
            deadline = self._deadline()
            self._put(f"fin/{self.rank}", "1", deadline)
            if self.rank == 0:
                for r in self._peers():
                    try:
                        self._get(f"fin/{r}", deadline,
                                  f"rank {r}'s completion")
                    except CoordTimeout:
                        self.log(f"[coord] rank {r} never reached "
                                 f"completion; closing anyway")
        except CoordError:
            pass

    # -- elastic membership: RESIZE verdicts and the rejoin handshake --
    #
    # Key namespaces OUTSIDE the seq-space collectives (so a joiner can talk
    # to the incumbent run before it holds a seq position):
    #   el/boot       rank 0's bootstrap facts (the seed) a replacement
    #                 needs before it can build anything
    #   el/lost/<r>   persistent beacon: rank r was resized away; its
    #                 replacement probes this to pick the rejoin path
    #   rj/req/<r>    joiner -> rank 0: ready to rejoin (carries a fresh
    #                 per-incarnation token)
    #   rj/ack/<r>    rank 0 -> joiner: the grow grant (echoes the token;
    #                 a stale grant from an earlier incarnation is ignored)

    def enable_elastic(self, min_world: int = 1):
        self.elastic = True
        self.min_world = max(1, int(min_world))

    def publish_boot(self, payload: dict):
        """Rank 0, elastic: persist the run's bootstrap facts for future
        replacement ranks (kept for the whole run — never retired)."""
        self._put("el/boot", json.dumps(dict(payload)))

    def boot_info(self) -> dict:
        return json.loads(self._get("el/boot", self._deadline(),
                                    "the elastic boot record"))

    def detect_rejoin(self) -> bool:
        """Replacement-rank startup probe: this rank was declared lost by an
        incumbent run iff rank 0 left an `el/lost/<rank>` beacon. One
        bounded probe ($BNSGCN_ELASTIC_JOIN_PROBE_S, default 5 s — that is
        only the connect-retry budget; a live server answers instantly).
        Relaunch replacements AFTER the shrink verdict lands (watch for the
        resize obs event), or raise the probe window."""
        probe = float(os.environ.get("BNSGCN_ELASTIC_JOIN_PROBE_S", 5.0))
        try:
            return self.transport.try_get(f"el/lost/{self.rank}",
                                          self._deadline(probe)) is not None
        except CoordError:
            return False

    def apply_resize(self, decision: dict):
        """Adopt an agreed RESIZE: update the member set; rank 0 marks the
        lost ranks (the beacon their replacements probe) and clears their
        stale rejoin keys. Survivors call this BEFORE the resize ack
        exchange so a grow's joiner is already in the gather set."""
        members = tuple(int(r) for r in decision["members"])
        gone = [r for r in self.members if r not in members]
        joined = [r for r in members if r not in self.members]
        self.members = members
        self.world = len(members)
        if self.rank == 0:
            self._lost.update(gone)
            self._lost.difference_update(joined)
            deadline = self._deadline(min(5.0, self.timeout_s))
            for r in gone:
                try:
                    self._put(f"el/lost/{r}", json.dumps({"seq": self._seq}),
                              deadline)
                    self.transport.delete(f"rj/req/{r}", deadline)
                    self.transport.delete(f"rj/ack/{r}", deadline)
                except (CoordError, OSError):
                    pass    # best-effort: a missed beacon only delays rejoin
            for r in joined:
                try:
                    # the grant (rj/ack) stays — the joiner may still be
                    # reading it; its token goes stale with the next req
                    self.transport.delete(f"el/lost/{r}", deadline)
                except (CoordError, OSError):
                    pass
        self.log(f"[coord] world resized to {self.world} "
                 f"(members {list(self.members)}"
                 + (f", lost {gone}" if gone else "")
                 + (f", rejoined {joined}" if joined else "") + ")")

    def poll_rejoin(self) -> list[tuple[int, str]]:
        """Rank 0, at an agree boundary: pending rejoin requests from lost
        ranks. A request for a rank still in `members` is a replacement
        racing an undetected death — ignored until the loss verdict lands
        (the stale-incumbent's silence resolves it within dead_after_s)."""
        if not self._lost:
            return []
        out = []
        deadline = self._deadline(min(5.0, self.timeout_s))
        for r in sorted(self._lost):
            try:
                v = self.transport.try_get(f"rj/req/{r}", deadline)
            except CoordError:
                continue
            if v is None:
                continue
            try:
                tok = str(json.loads(v).get("token", ""))
            except ValueError:
                continue
            if tok:
                out.append((r, tok))
        return out

    def grant_rejoin(self, rank: int, token: str, payload: dict):
        """Rank 0 (inside the grow decide): answer `rank`'s rejoin request.
        The grant echoes the joiner's token so only THIS incarnation of the
        replacement adopts it."""
        body = dict(payload)
        body["token"] = str(token)
        self._put(f"rj/ack/{rank}", json.dumps(body))
        try:
            self.transport.delete(f"rj/req/{rank}",
                                  self._deadline(min(5.0, self.timeout_s)))
        except (CoordError, OSError):
            pass

    def request_rejoin(self, token: str,
                       info: Optional[dict] = None) -> dict:
        """Replacement rank: announce readiness and block until rank 0's
        grant for THIS incarnation. Grants carrying any other token are
        stale (minted for an earlier, dead replacement) and are skipped —
        the wait continues until rank 0 answers the fresh request. Bounded
        by $BNSGCN_ELASTIC_JOIN_WAIT_S (default 2x the exchange timeout);
        the window must cover rank 0 reaching its next agree boundary."""
        self._put(f"rj/req/{self.rank}",
                  json.dumps({"token": str(token), "info": info or {}}))
        wait_s = float(os.environ.get("BNSGCN_ELASTIC_JOIN_WAIT_S",
                                      2 * self.timeout_s))
        deadline = self._deadline(wait_s)
        delay = 0.002
        while True:
            try:
                v = self.transport.try_get(f"rj/ack/{self.rank}", deadline)
            except CoordTimeout:
                v = None
            if v is not None:
                try:
                    grant = json.loads(v)
                except ValueError:
                    grant = {}
                if str(grant.get("token", "")) == str(token):
                    return grant
                # stale grant from a previous incarnation: keep waiting
            if self._clock() >= deadline:
                self.log_liveness()
                raise CoordTimeout(
                    f"rank {self.rank}: no rejoin grant within {wait_s:.1f}s "
                    f"(is the incumbent run still alive and elastic?)")
            self._sleep(min(delay, max(deadline - self._clock(), 0)))
            delay = min(delay * 2, 0.05)

    def adopt_grant(self, grant: dict):
        """Joiner: step into the incumbent run's collective schedule at the
        seq / agree-cadence position the grant names. After this, the very
        next collective call lands in lockstep with the survivors'."""
        self.members = tuple(int(r) for r in grant["members"])
        self.world = len(self.members)
        self._seq = int(grant["seq"])
        self._agree_calls = int(grant.get("agree_calls", 0))
        self._latched = "ok"

    # -- a second process of this coordination rank --

    def handoff(self) -> dict:
        """What another process of this coordination rank needs to carry on
        its exchanges (`Coordinator.adopt`): the store's client side and
        the schedule position. This process must make no exchange after it
        (a server it runs stays up for the other's)."""
        return {"rank": self.rank, "world": self.world,
                "timeout_s": self.timeout_s,
                "transport": self.transport.client(), "seq": self._seq,
                "agree_calls": self._agree_calls,
                "members": list(self.members), "elastic": self.elastic,
                "min_world": self.min_world, "lost": sorted(self._lost),
                "spent": [(s, list(ks)) for s, ks in self._spent]}

    @classmethod
    def adopt(cls, h: dict, log=print) -> "Coordinator":
        """The coordinator of a `handoff`: a client of the same store at
        the same place in the schedule."""
        c = cls(h["rank"], h["world"], make_transport(h["transport"]),
                h["timeout_s"], log)
        c._seq, c._agree_calls = int(h["seq"]), int(h["agree_calls"])
        c.members = tuple(int(r) for r in h["members"])
        c.world = len(c.members)
        c.elastic, c.min_world = bool(h["elastic"]), int(h["min_world"])
        c._lost = set(int(r) for r in h["lost"])
        c._spent = [(int(s), list(ks)) for s, ks in h["spent"]]
        return c

    def close(self):
        if not self._closed:
            self._closed = True
            try:
                self.transport.close()
            except Exception:
                pass


# ----------------------------------------------------------------------------
# construction from a Config
# ----------------------------------------------------------------------------

def resolve_rank_world(cfg) -> tuple[int, int]:
    """(rank, world) for coordination: explicit --coord-rank/--coord-world
    (the harness mode: independent launches coupled only through the
    coordinator); otherwise the launches of a multi-node run, --node-rank
    of --n-nodes (a launch of the port is the JAX package's process)."""
    if cfg.coord_world and cfg.coord_world > 1:
        if cfg.coord_rank < 0:
            # defaulting to 0 would make every misconfigured peer a serving
            # rank 0: EADDRINUSE on one host, a 2-minute split-brain
            # timeout across hosts — fail as a named config error instead
            raise ConfigError(
                "--coord-world > 1 needs an explicit --coord-rank per "
                "process (0..world-1)")
        if cfg.coord_rank >= cfg.coord_world:
            raise ConfigError(
                f"--coord-rank {cfg.coord_rank} out of range for "
                f"--coord-world {cfg.coord_world}")
        return int(cfg.coord_rank), int(cfg.coord_world)
    return int(cfg.node_rank), max(int(cfg.n_nodes), 1)


def coord_mode(cfg) -> str:
    """'tcp' | 'file' | 'off': `--coord auto` is tcp for a world > 1."""
    _, world = resolve_rank_world(cfg)
    mode = cfg.coord
    if mode == "auto":
        mode = "tcp" if world > 1 else "off"
    return "off" if world < 2 else mode


def make_coordinator(cfg, log=print, port: Optional[int] = None
                     ) -> tuple[Optional["Coordinator"], int, int]:
    """(coordinator | None, rank, world). None when coordination is off:
    `--coord off`, a single-rank run, or `--coord auto` resolving to off —
    all bit-identical to the uncoordinated code path. `port` replaces
    --coord-port (0: rank 0 binds a free one, its peers must be told)."""
    rank, world = resolve_rank_world(cfg)
    mode = coord_mode(cfg)
    if mode == "off":
        return None, rank, world
    timeout_s = float(os.environ.get("BNSGCN_COORD_TIMEOUT_S", 120.0))
    port = cfg.coord_port if port is None else port
    if mode == "tcp":
        addr = cfg.coord_addr or cfg.master_addr or "127.0.0.1"
        transport = TcpTransport(addr, port, serve=(rank == 0))
        where = f"at {addr}:{transport.port}"
    elif mode == "file":
        root = cfg.coord_dir or os.path.join(cfg.ckpt_path, ".coord")
        transport = FileTransport(root, rank)
        where = f"dir {root}"
    else:
        raise ValueError(f"unknown --coord mode {mode!r} "
                         "(tcp | file | auto | off)")
    log(f"[coord] rank {rank}/{world}: {mode} coordinator {where}, "
        f"per-exchange timeout {timeout_s:.0f}s")
    return Coordinator(rank, world, transport, timeout_s, log), rank, world
