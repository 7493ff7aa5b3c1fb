"""ctypes bindings for the native (C++) runtime components.

The reference keeps its runtime around the GPU in C++ (Merian) and C
(quakespasm); here the per-frame host hot path — acceleration-structure
build — is native too (native/mq_native.cc), with numpy as the always-
available fallback. The libraries are built from the committed sources
on first use if a compiler is present (``make -C native``).
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmq_native.so")


def build(target: str) -> str:
    """Path of ``native/<target>``, built by make if missing.

    A file lock serializes concurrent builds (test workers start
    together); the Makefile renames a finished library into place, so a
    process that finds the file never reads half of it.
    """
    path = os.path.join(_NATIVE_DIR, target)
    if os.path.exists(path):
        return path
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, target],
                check=True, capture_output=True, timeout=300,
            )
    return path


def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native library, or None."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("MQ_NO_NATIVE"):
        return None
    try:
        lib = ctypes.CDLL(build("libmq_native.so"))
    except (OSError, subprocess.SubprocessError):
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.c_int64
    lib.mq_morton_perm.argtypes = [f32p, f32p, f32p, u8p, u8p, i64, i32p]
    lib.mq_cluster_aabbs.argtypes = [f32p, f32p, f32p, u8p, i64, i64, f32p, f32p]
    lib.mq_version.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def morton_perm(v0, v1, v2, candidate, valid) -> np.ndarray | None:
    lib = load()
    if lib is None:
        return None
    T = v0.shape[0]
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    cand = np.ascontiguousarray(candidate, np.uint8)
    val = np.ascontiguousarray(valid, np.uint8)
    out = np.empty((T,), np.int32)
    lib.mq_morton_perm(
        _fp(v0), _fp(v1), _fp(v2), _u8(cand), _u8(val), T,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def cluster_aabbs(v0, v1, v2, candidate, cluster_size: int):
    lib = load()
    if lib is None:
        return None
    T = v0.shape[0]
    C = T // cluster_size
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    cand = np.ascontiguousarray(candidate, np.uint8)
    lo = np.empty((C, 3), np.float32)
    hi = np.empty((C, 3), np.float32)
    lib.mq_cluster_aabbs(
        _fp(v0), _fp(v1), _fp(v2), _u8(cand), T, cluster_size, _fp(lo), _fp(hi)
    )
    return lo, hi
