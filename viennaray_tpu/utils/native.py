"""ctypes loader for the native host-acceleration library.

Compiles ``native/host_accel.cpp`` with g++ on first use (cached by source
mtime); every entry point has a numpy fallback, so the native path is a pure
accelerator — behavior is identical (tests compare both).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _source_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "native",
        "host_accel.cpp",
    )


def _cache_dir() -> str:
    d = os.environ.get(
        "VIENNARAY_TPU_NATIVE_DIR",
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
            ".build", "native",
        ),
    )
    os.makedirs(d, exist_ok=True)
    return d


def load() -> Optional[ctypes.CDLL]:
    """Compile (if stale) and load the native library; None on failure."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("VIENNARAY_TPU_NO_NATIVE"):
        return None
    src = _source_path()
    if not os.path.exists(src):
        return None
    so = os.path.join(_cache_dir(), "host_accel.so")
    try:
        if (
            not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(src)
        ):
            tmp = so + ".tmp"
            subprocess.run(
                [
                    "g++", "-O3", "-march=native", "-shared", "-fPIC",
                    "-std=c++17", src, "-o", tmp,
                ],
                check=True,
                capture_output=True,
                timeout=120,
            )
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.vr_build_neighborhood.restype = ctypes.c_int64
        lib.vr_build_neighborhood.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_double, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.vr_build_grid.restype = ctypes.c_int64
        lib.vr_build_grid.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_double),
            ctypes.c_double, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_void_p, ctypes.c_int64,
        ]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def build_neighborhood_native(points: np.ndarray, distance: float, dim: int):
    """Native neighborhood build; returns (neighbors (N, K) int32 padded -1,
    counts) or None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points[:, :3], np.float64)
    if pts.shape[1] < 3:
        pad = np.zeros((len(pts), 3 - pts.shape[1]))
        pts = np.hstack([pts, pad])
    n = len(pts)
    counts = np.zeros(n, np.int32)
    k_max = lib.vr_build_neighborhood(
        _dptr(pts), n, dim, float(distance), _iptr(counts), None, 0
    )
    k_max = max(int(k_max), 1)
    neighbors = np.full((n, k_max), -1, np.int32)
    lib.vr_build_neighborhood(
        _dptr(pts), n, dim, float(distance), _iptr(counts),
        neighbors.ctypes.data_as(ctypes.c_void_p), k_max,
    )
    return neighbors, counts


def build_grid_native(prim_lo, prim_hi, origin, cell_size, dims, dim: int):
    """Native grid insertion; returns (cells (C, K) int32 padded -1, counts)
    or None."""
    lib = load()
    if lib is None:
        return None
    prim_lo = np.ascontiguousarray(prim_lo, np.float64)
    prim_hi = np.ascontiguousarray(prim_hi, np.float64)
    origin = np.ascontiguousarray(origin, np.float64)
    dims_a = np.asarray(dims, np.int64)
    n = len(prim_lo)
    n_cells = int(dims_a.prod())
    counts = np.zeros(n_cells, np.int32)
    k_max = lib.vr_build_grid(
        _dptr(prim_lo), _dptr(prim_hi), n, dim, _dptr(origin),
        float(cell_size), dims_a.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)),
        _iptr(counts), None, 0,
    )
    k_max = max(int(k_max), 1)
    cells = np.full((n_cells, k_max), -1, np.int32)
    lib.vr_build_grid(
        _dptr(prim_lo), _dptr(prim_hi), n, dim, _dptr(origin),
        float(cell_size), dims_a.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)),
        _iptr(counts), cells.ctypes.data_as(ctypes.c_void_p), k_max,
    )
    return cells, counts
