"""Checkpoints in the JAX package's format (counterpart of
bnsgcn_tpu/checkpoint.py:33-121, 216-313), so the two packages load each
other's files.

A file is the magic `BNSCKPT1`, the sha256 of the payload, then the payload:
msgpack as flax writes it (utils/msgpack_codec.py). It is written to
`<path>.tmp`, fsync'd and renamed over `path`, so a write cut short never
tears the published name; `read_blob` raises CheckpointCorrupt on a
zero-byte, torn or mismatching file. The payload is the JAX package's tree:
`params` in the layout of its `init_params` tree, `opt_state` in that of
its optax chain, `bn_state`, `epoch`, `best_acc`, `seed` and `extra`
(trainer.py maps the port's model and Adam onto the first two).

File names, scoped by graph name and sampling rate:
  {ckpt_path}/{graph_name}_p{rate:.2f}_{epoch}.ckpt   (periodic)
  {ckpt_path}/{graph_name}_p{rate:.2f}_final.ckpt     (best validation)
"""

from __future__ import annotations

import hashlib
import os
import struct
from typing import Any, Optional

from bnsgcn_tpu_torch.utils import msgpack_codec

_MAGIC = b"BNSCKPT1"
_HDR = len(_MAGIC) + 32


class CheckpointCorrupt(Exception):
    """A checkpoint file failed integrity verification (zero-byte, torn,
    checksum mismatch, or undecodable payload)."""


def write_blob(path: str, payload: dict):
    """Atomically write `payload` under the integrity header: magic +
    sha256(payload), fsync'd before the rename, the directory fsync'd
    after."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = msgpack_codec.packb(payload)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(hashlib.sha256(blob).digest())
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass                        # not supported on every filesystem


def read_blob(path: str) -> dict[str, Any]:
    """Read and verify a blob. Raises CheckpointCorrupt on a zero-byte, torn
    or checksum-failing file. A file without the magic is a pre-checksum
    checkpoint of the JAX package and loads unverified."""
    with open(path, "rb") as f:
        raw = f.read()
    if not raw:
        raise CheckpointCorrupt(f"{path}: zero-byte file")
    if raw.startswith(_MAGIC):
        if len(raw) <= _HDR:
            raise CheckpointCorrupt(f"{path}: truncated header "
                                    f"({len(raw)} bytes)")
        digest, blob = raw[len(_MAGIC):_HDR], raw[_HDR:]
        if hashlib.sha256(blob).digest() != digest:
            raise CheckpointCorrupt(
                f"{path}: payload checksum mismatch (torn or corrupt write)")
    else:
        blob = raw
    try:
        return msgpack_codec.unpackb(blob)
    except (ValueError, TypeError, KeyError, struct.error) as ex:
        raise CheckpointCorrupt(
            f"{path}: undecodable payload ({type(ex).__name__}: {ex})") from ex


def save_checkpoint(path: str, *, params: dict,
                    opt_state: Optional[dict] = None,
                    bn_state: Optional[dict] = None, epoch: int = 0,
                    best_acc: float = 0.0, seed: int = 0,
                    extra: Optional[dict] = None):
    """Write one checkpoint: numpy trees in the JAX package's layout
    (trainer.params_to_jax, trainer.opt_state_to_jax)."""
    write_blob(path, {
        "params": params,
        "opt_state": opt_state if opt_state is not None else {},
        "bn_state": bn_state if bn_state is not None else {},
        "epoch": int(epoch),
        "best_acc": float(best_acc),
        "seed": int(seed),
        "extra": extra or {},
    })


def load_or_error(path: str) -> tuple[Optional[dict], Optional[str]]:
    """(payload, None) when `path` loads and verifies, else (None, a one-line
    reason)."""
    try:
        return read_blob(path), None
    except CheckpointCorrupt as ex:
        return None, str(ex)
    except OSError as ex:
        return None, f"{path}: unreadable ({type(ex).__name__}: {ex})"


def _name(cfg) -> str:
    return cfg.graph_name or cfg.derive_graph_name()


def periodic_path(cfg, epoch: int) -> str:
    return os.path.join(cfg.ckpt_path,
                        f"{_name(cfg)}_p{cfg.sampling_rate:.2f}_{epoch}.ckpt")


def final_path(cfg) -> str:
    return os.path.join(cfg.ckpt_path,
                        f"{_name(cfg)}_p{cfg.sampling_rate:.2f}_final.ckpt")


def _periodic_ckpts(cfg) -> list[tuple[int, str]]:
    """(epoch, file name) of this run's periodic checkpoints, oldest first;
    `_final.ckpt` and other suffixes never match."""
    if not os.path.isdir(cfg.ckpt_path):
        return []
    prefix = f"{_name(cfg)}_p{cfg.sampling_rate:.2f}_"
    found = []
    for fn in os.listdir(cfg.ckpt_path):
        if fn.startswith(prefix) and fn.endswith(".ckpt"):
            try:
                found.append((int(fn[len(prefix):-len(".ckpt")]), fn))
            except ValueError:
                continue
    return sorted(found)


def prune_checkpoints(cfg, keep: int):
    """Delete all but the newest `keep` periodic checkpoints of this run
    (keep <= 0 keeps everything); the final checkpoint is never pruned."""
    if keep <= 0:
        return
    for _, fn in _periodic_ckpts(cfg)[:-keep]:
        try:
            os.remove(os.path.join(cfg.ckpt_path, fn))
        except OSError:
            pass                    # already gone


def latest_checkpoint(cfg) -> Optional[str]:
    """The newest periodic checkpoint's path, unverified (what
    `--inject ckpt-corrupt` tears); latest_valid_checkpoint for a file that
    will be loaded."""
    found = _periodic_ckpts(cfg)
    return os.path.join(cfg.ckpt_path, found[-1][1]) if found else None


def latest_valid_checkpoint(cfg, log=None, before_epoch: Optional[int] = None
                            ) -> Optional[tuple[str, dict]]:
    """(path, payload) of the newest periodic checkpoint that verifies,
    walking past corrupt, torn, zero-byte and unreadable files; None when
    there is none. `before_epoch` keeps only checkpoints of earlier epochs
    (a divergence rollback never restores a file a previous run left
    ahead of it)."""
    for ep, fn in reversed(_periodic_ckpts(cfg)):
        if before_epoch is not None and ep >= before_epoch:
            continue
        path = os.path.join(cfg.ckpt_path, fn)
        try:
            return path, read_blob(path)
        except CheckpointCorrupt as ex:
            if log:
                log(f"[resilience] skipping corrupt checkpoint: {ex}")
        except OSError as ex:
            if log:
                log(f"[resilience] skipping unreadable checkpoint "
                    f"{fn}: {ex}")
    return None


def resilience_extra(payload: dict) -> dict[str, int]:
    """The resilience counters a checkpoint's `extra` carries, 0 for a file
    without them: {"retry_nonce", "resize_nonce"} (the JAX package's
    elastic resizes; the port never resizes, so it writes retry_nonce
    alone, as the JAX package does without --elastic)."""
    extra = payload.get("extra") or {}
    return {"retry_nonce": int(extra.get("retry_nonce", 0)),
            "resize_nonce": int(extra.get("resize_nonce", 0))}


def final_best_payload(cfg, best_acc: float, log) -> Optional[dict]:
    """The final checkpoint's payload when it loads and carries the resumed
    best_acc (within 1e-9), else None: a final file of another run must not
    hand its parameters to this one, so the caller restarts best tracking."""
    fpath = final_path(cfg)
    payload, err = load_or_error(fpath)
    if payload is None:
        if err and os.path.exists(fpath):
            log(f"[resilience] final checkpoint unusable ({err}); "
                f"restarting best tracking")
        return None
    if abs(float(payload.get("best_acc", -1.0)) - best_acc) >= 1e-9:
        return None
    return payload
