"""ctypes binding for the native C++ partitioner (counterpart of
bnsgcn_tpu/native; partitioner.cpp here is a copy of that source).

Host code, not a GPU kernel: the hybrid SpMM's cluster_order runs it to
group rows into locality clusters. It is compiled with the system C++
compiler at first use into the port's build directory (buildlib.BUILD_DIR).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from bnsgcn_tpu_torch import buildlib

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "partitioner.cpp")
LIB_NAME = "bnspartition"


def _declare(lib):
    lib.bns_partition_v2.restype = ctypes.c_int
    lib.bns_partition_v2.argtypes = [
        ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]


def native_partition(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                     n_parts: int, obj: str = "vol", seed: int = 0,
                     refine_passes: int = 8, n_seeds: int = 3,
                     multilevel: bool = True) -> np.ndarray:
    """Partition ids [n_nodes] int32 of the graph (src, dst); best of
    `n_seeds` runs by the objective (directed comm volume for 'vol', edge cut
    for 'cut'). Raises RuntimeError when the library cannot be built or the
    partitioner reports an error."""
    lib = buildlib.load(LIB_NAME, "cxx", [SOURCE], _declare)
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    out = np.empty(n_nodes, dtype=np.int32)
    rc = lib.bns_partition_v2(
        n_nodes, src.shape[0], src, dst, np.int32(n_parts),
        np.int32(1 if obj == "cut" else 0), np.uint64(seed),
        np.int32(refine_passes), np.int32(n_seeds),
        np.int32(1 if multilevel else 0), out)
    if rc != 0:
        raise RuntimeError(f"native partitioner returned {rc}")
    return out
