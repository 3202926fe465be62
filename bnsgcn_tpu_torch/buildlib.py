"""Build-at-first-use for the port's native code: the host C++ partitioner
(native/) and the CUDA kernels (csrc/).

Every library is compiled from the sources in the checkout into BUILD_DIR
(listed in .gitignore) under a name that carries a hash of its sources and
its compile command, so a changed source can never load a stale library and
concurrent builders (test workers, parallel nvcc) never write the same file:
each compiles to a private temporary name and renames it into place.

CUDA sources build with nvcc straight into a shared library with a plain C
interface, loaded with ctypes: seconds per file, where a build that includes
PyTorch's headers takes minutes. A kernel's wrapper calls its C entry point
through a `Kernel`, which resolves the ctypes function once per process, so
a launch takes no lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels are built from csrc/ at first use")
    return nvcc


def _target(name: str, sources, cmd) -> str:
    h = hashlib.sha256(" ".join(cmd).encode())
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _command(kind: str, sources) -> list[str]:
    if kind == "cuda":
        return [find_nvcc(), *NVCC_FLAGS, *sources]
    if kind == "cxx":
        return [shutil.which("g++") or "g++", *CXX_FLAGS, *sources]
    raise ValueError(kind)


def build_many(specs, timeout: float = 600.0) -> dict[str, str]:
    """Compile every (name, kind, sources) not yet built, all at once (one
    compiler process per library, started together), and return
    {name: library path}. Raises RuntimeError with the compiler's output
    when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths, procs = {}, []
    for name, kind, sources in specs:
        sources = [os.path.abspath(s) for s in sources]
        cmd = _command(kind, sources)
        target = _target(name, sources, cmd)
        paths[name] = target
        if os.path.exists(target):
            continue
        tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.Popen(cmd + ["-o", tmp], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs.append((name, proc, tmp, target))
    failures = []
    t_end = time.monotonic() + timeout
    for name, proc, tmp, target in procs:
        try:
            out, _ = proc.communicate(timeout=max(t_end - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            failures.append(f"{name}: compiler timed out\n{out}")
            continue
        if proc.returncode != 0 or not os.path.exists(tmp):
            failures.append(f"{name}: exit {proc.returncode}\n{out}")
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("build failed:\n" + "\n".join(failures))
    return paths


class LaunchCount:
    """Launches of one CUDA kernel in this process, by phase ('fwd', 'bwd',
    'pre', ...). A kernel's wrapper adds one where it launches the kernel and
    nowhere else, so a run can show that its main path went through the
    kernel (chip_smoke.py resets, drives the path, and reads)."""

    def __init__(self):
        self.by_phase: dict[str, int] = {}

    def add(self, phase: str):
        self.by_phase[phase] = self.by_phase.get(phase, 0) + 1

    @property
    def total(self) -> int:
        return sum(self.by_phase.values())

    def reset(self):
        self.by_phase = {}


def load(name: str, kind: str, sources, declare=None) -> ctypes.CDLL:
    """Build (if needed) and load one library once per process; `declare`,
    if given, sets argtypes/restype on the fresh CDLL."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_many([(name, kind, sources)])[name]
            lib = ctypes.CDLL(path)
            if declare is not None:
                declare(lib)
            _loaded[name] = lib
        return lib


class Kernel:
    """One C entry point of a CUDA library (`int fn(...)`, 0 on success, -1
    for arguments it refuses, else a CUDA error code; `error_fn` names a
    code). The first call builds and loads the library under the lock;
    later calls go straight to the resolved ctypes function. -1 raises
    ValueError, any other non-zero code RuntimeError."""

    def __init__(self, lib_name: str, source: str, fn: str, argtypes,
                 error_fn: str):
        self.lib_name, self.source, self.fn = lib_name, source, fn
        self.argtypes, self.error_fn = list(argtypes), error_fn
        self._call = None
        self._error = None

    def load(self) -> ctypes.CDLL:
        """Build and load the library (once per process) and declare this
        entry point's types on it, whoever loaded the library first."""
        lib = load(self.lib_name, "cuda", [self.source])
        error = getattr(lib, self.error_fn)
        error.restype = ctypes.c_char_p
        error.argtypes = [ctypes.c_int]
        call = getattr(lib, self.fn)
        call.restype = ctypes.c_int
        call.argtypes = self.argtypes
        self._error, self._call = error, call
        return lib

    def __call__(self, *args):
        call = self._call
        if call is None:
            self.load()
            call = self._call
        rc = call(*args)
        if rc != 0:
            raise (ValueError if rc == -1 else RuntimeError)(
                f"{self.fn} launch failed: {self._error(rc).decode()}")


_raw_stream = None


def raw_stream(index: int) -> int:
    """The current CUDA stream of device `index` as a raw pointer (an int),
    read without building a torch.cuda.Stream (AttributeError from a torch
    built without CUDA)."""
    global _raw_stream
    if _raw_stream is None:
        import torch
        _raw_stream = torch._C._cuda_getCurrentRawStream
    return _raw_stream(index)
