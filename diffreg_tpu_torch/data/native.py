"""ctypes bindings for the host pyramid library in ``native/src``.

The C++ (voxel-grid subsampling and fixed-K radius search) is compiled with
g++ at first use, with the flags of ``native/build.sh``, into the port's own
build directory. There is no fallback: a failed build raises, so the port
always builds its pyramid with the same code as the JAX package.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..utils.build import BUILD_DIR, REPO_DIR, PendingBuild, is_stale

_SOURCE = os.path.join(REPO_DIR, "native", "src", "diffreg_native.cpp")
_LIB_PATH = os.path.join(BUILD_DIR, "libdiffreg_native.so")
_LOCK = threading.Lock()
_LIB = None


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if is_stale(_LIB_PATH, [_SOURCE]):
            PendingBuild(["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                          "-fPIC", _SOURCE], _LIB_PATH).wait(timeout=300)
        lib = ctypes.CDLL(_LIB_PATH)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.grid_subsample.restype = ctypes.c_int32
        lib.grid_subsample.argtypes = [f32p, ctypes.c_int32, ctypes.c_float, f32p]
        lib.radius_search_knn.restype = None
        lib.radius_search_knn.argtypes = [
            f32p, ctypes.c_int32, f32p, ctypes.c_int32, ctypes.c_float,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
        _LIB = lib
        return _LIB


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def grid_subsample_native(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Voxel barycenters of ``points`` [N, 3] (float32)."""
    lib = _load()
    pts = np.ascontiguousarray(points, np.float32)
    out = np.empty_like(pts)
    n = lib.grid_subsample(_fptr(pts), np.int32(len(pts)), np.float32(voxel_size),
                           _fptr(out))
    return out[:n].copy()


def radius_neighbors_native(queries: np.ndarray, supports: np.ndarray,
                            radius: float, k: int) -> np.ndarray:
    """[Nq, k] int32 nearest-first neighbors within ``radius``, sentinel len(supports)."""
    lib = _load()
    q = np.ascontiguousarray(queries, np.float32)
    s = np.ascontiguousarray(supports, np.float32)
    out = np.empty((len(q), k), np.int32)
    lib.radius_search_knn(
        _fptr(q), np.int32(len(q)), _fptr(s), np.int32(len(s)), np.float32(radius),
        np.int32(k), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out
