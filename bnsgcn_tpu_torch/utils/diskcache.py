"""Versioned-pickle disk cache for host-side layout builds (the port's copy
of bnsgcn_tpu/utils/diskcache.py, the JAX package's --cache-dir).

A file holds (CACHE_VER, object). Writes are atomic: a per-PID `*.tmp`
file, then os.replace. A missing, stale (another version) or unreadable
file reads as None, so a bad cache costs a rebuild and never fails the run;
`sweep_stale_tmp` removes the torn `*.tmp` files of writers that died.
Only files this program wrote belong in the directory: unpickling runs
code.
"""

from __future__ import annotations

import os
import pickle
import time

CACHE_VER = 1               # bump when a cached layout's format changes


def try_load(path: str, log=print):
    """The object cached at `path`, or None (missing, stale or corrupt)."""
    if not os.path.exists(path):
        return None
    t0 = time.perf_counter()
    try:
        with open(path, "rb") as f:
            ver, obj = pickle.load(f)
    except Exception as ex:     # noqa: BLE001 - any unreadable file is a miss
        log(f"  cache read failed at {path} ({type(ex).__name__})")
        return None
    if ver != CACHE_VER:
        log(f"  stale cache version {ver} at {path}; ignoring")
        return None
    log(f"  loaded {os.path.basename(path)} in "
        f"{time.perf_counter() - t0:.1f}s")
    return obj


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True                 # exists, owned by someone else
    except OSError:
        return False
    return True


def sweep_stale_tmp(cache_dir: str, log=print, max_age_s: float = 3600.0,
                    grace_s: float = 600.0) -> int:
    """Remove the `*.tmp` files writers left mid-atomic_dump; returns how
    many. A file `{name}.{pid}.tmp` goes when its PID is dead here and it
    has not been written for `grace_s` (on a shared volume another host's
    live writer looks dead in this PID namespace, and a dump in progress
    keeps its mtime fresh), and any `*.tmp` goes after `max_age_s`."""
    removed = 0
    try:
        names = os.listdir(cache_dir)
    except OSError:
        return 0
    now = time.time()
    for fn in names:
        if not fn.endswith(".tmp"):
            continue
        path = os.path.join(cache_dir, fn)
        try:
            age = now - os.path.getmtime(path)
        except OSError:
            continue                # replaced under us
        stem = fn[:-len(".tmp")].rsplit(".", 1)
        pid_dead = (len(stem) == 2 and stem[1].isdigit()
                    and not _pid_alive(int(stem[1])))
        if (pid_dead and age > grace_s) or age > max_age_s:
            try:
                os.remove(path)
                removed += 1
            except OSError:
                pass
    if removed:
        log(f"  cache sweep: removed {removed} stale .tmp file(s) from "
            f"{cache_dir}")
    return removed


def atomic_dump(obj, path: str) -> None:
    """Write (CACHE_VER, obj) to `path` through a per-PID temporary file."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            pickle.dump((CACHE_VER, obj), f, protocol=4)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
