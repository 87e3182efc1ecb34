"""ctypes driver for the independent scalar oracle (tests/oracle_ref.cpp).

The oracle is a from-scratch per-ray C++ implementation of the reference
trace semantics (see the .cpp header) sharing no code with viennaray_tpu.
This module only compiles/loads it and marshals numpy arrays.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False

BC = {"reflective": 0, "periodic": 1, "ignore": 2}
REFL = {"diffuse": 0, "specular": 1, "coned": 2}


def _load():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "oracle_ref.cpp")
    cache = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".build", "native",
    )
    os.makedirs(cache, exist_ok=True)
    so = os.path.join(cache, "oracle_ref.so")
    try:
        if (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(src)):
            tmp = so + ".tmp"
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src,
                 "-o", tmp],
                check=True, capture_output=True, timeout=180,
            )
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        d = ctypes.POINTER(ctypes.c_double)
        i64 = ctypes.POINTER(ctypes.c_int64)
        lib.vro_trace_disks.restype = ctypes.c_int64
        lib.vro_trace_disks.argtypes = [
            d, d, d, d, ctypes.c_int64, ctypes.c_int32,
            d, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_double, ctypes.c_int32, ctypes.c_double,
            ctypes.c_double, ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_int32, ctypes.c_double, d, i64,
        ]
        lib.vro_trace_tris.restype = ctypes.c_int64
        lib.vro_trace_tris.argtypes = [
            d, i64, ctypes.c_int64, d, ctypes.c_int32,
            d, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_double, ctypes.c_int32, ctypes.c_double,
            ctypes.c_double, ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double, d, i64,
        ]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


_COUNTER_KEYS = ["total_traces", "non_geometry_hits", "geometry_hits",
                 "boundary_hits", "reflections", "terminated", "scattered",
                 "_"]


def trace_disks_oracle(
    points, normals, radii, *, dim, disk_radius, num_rays, sticking,
    seed=7, cosine_exponent=1.0, reflection="diffuse", cone_angle=0.0,
    boundary=("reflective", "reflective"), source_direction="pos_ray",
    ray_axis=None, first_dir=None, second_dir=None,
    max_boundary_hits=1000, max_reflections=2**30, tnear=1e-4,
    use_wdist=False, mean_free_path=-1.0,
):
    """Run the disk oracle; returns (flux (N,), counters dict).

    Axes default to the standard layout: 2D source +y (ray_axis 1,
    first_dir 0, second_dir 2), 3D source +z (ray_axis 2, dirs 0/1) — the
    same mapping as rayUtil.hpp getTraceSettings for POS_Y / POS_Z.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("oracle library unavailable (g++ build failed)")

    pts = np.ascontiguousarray(np.asarray(points, np.float64).reshape(-1, 3))
    nrm = np.ascontiguousarray(np.asarray(normals, np.float64).reshape(-1, 3))
    n = len(pts)
    rad = np.ascontiguousarray(
        np.broadcast_to(np.asarray(radii, np.float64), (n,)).copy()
    )
    stk = np.ascontiguousarray(
        np.broadcast_to(np.asarray(sticking, np.float64), (n,)).copy()
    )
    if ray_axis is None:
        ray_axis = 1 if dim == 2 else 2
        first_dir = 0
        second_dir = 2 if dim == 2 else 1
    bbox = np.stack([pts.min(axis=0), pts.max(axis=0)]).astype(np.float64)
    bbox = np.ascontiguousarray(bbox)

    flux = np.zeros(n, np.float64)
    counters = np.zeros(8, np.int64)
    dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    rc = lib.vro_trace_disks(
        dptr(pts), dptr(nrm), dptr(rad), dptr(stk), n, dim,
        dptr(bbox), ray_axis, first_dir, second_dir,
        1,  # min_max: source at the max face
        -1.0,  # pos_neg: rays travel toward -ray_axis
        BC[boundary[0]], BC[boundary[1] if len(boundary) > 1 else boundary[0]],
        int(num_rays), float(cosine_exponent), REFL[reflection],
        float(cone_angle), float(disk_radius),
        int(seed) & 0xFFFFFFFFFFFFFFFF,
        int(max_boundary_hits), int(max_reflections), float(tnear),
        1 if use_wdist else 0, float(mean_free_path),
        dptr(flux), counters.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    assert rc == 0
    return flux, dict(zip(_COUNTER_KEYS, counters.tolist()))


def trace_tris_oracle(
    vertices, triangles, *, dim, grid_delta, num_rays, sticking,
    seed=7, cosine_exponent=1.0, reflection="diffuse", cone_angle=0.0,
    boundary=("reflective", "reflective"),
    ray_axis=None, first_dir=None, second_dir=None,
    max_boundary_hits=1000, max_reflections=2**30, tnear=1e-4,
    mean_free_path=-1.0,
):
    """Run the triangle oracle (single-hit deposit, backface kill);
    returns (flux (N_tris,), counters dict)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("oracle library unavailable (g++ build failed)")

    verts = np.ascontiguousarray(
        np.asarray(vertices, np.float64).reshape(-1, 3)
    )
    tris = np.ascontiguousarray(
        np.asarray(triangles, np.int64).reshape(-1, 3)
    )
    n = len(tris)
    stk = np.ascontiguousarray(
        np.broadcast_to(np.asarray(sticking, np.float64), (n,)).copy()
    )
    if ray_axis is None:
        ray_axis = 1 if dim == 2 else 2
        first_dir = 0
        second_dir = 2 if dim == 2 else 1
    bbox = np.stack([verts.min(axis=0), verts.max(axis=0)]).astype(np.float64)
    bbox = np.ascontiguousarray(bbox)

    flux = np.zeros(n, np.float64)
    counters = np.zeros(8, np.int64)
    dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    rc = lib.vro_trace_tris(
        dptr(verts), tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, dptr(stk), dim, dptr(bbox), ray_axis, first_dir, second_dir,
        1, -1.0,
        BC[boundary[0]], BC[boundary[1] if len(boundary) > 1 else boundary[0]],
        int(num_rays), float(cosine_exponent), REFL[reflection],
        float(cone_angle), float(grid_delta),
        int(seed) & 0xFFFFFFFFFFFFFFFF,
        int(max_boundary_hits), int(max_reflections), float(tnear),
        float(mean_free_path),
        dptr(flux), counters.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    assert rc == 0
    return flux, dict(zip(_COUNTER_KEYS, counters.tolist()))
