"""Uniform-grid acceleration structure (host build).

The accelerator replacement for Embree's BVH (SURVEY §7 design stance):
level-set-derived disk clouds are near-uniform at gridDelta spacing, so a
regular cell grid with a fixed max-prims-per-cell gives static shapes and
regular gathers — what the hardware wants. Each primitive is inserted into
every cell its (conservative) AABB overlaps; traversal is a batched 3-D DDA
(ops/grid_traverse.py).

Build runs once per geometry on the host in numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class UniformGrid:
    """Host-side grid: dense padded cell table.

    cells: (C, K) int32 prim ids padded with -1, C = nx*ny*nz (z-major last).
    origin: (3,) grid minimum corner; cell_size: scalar; dims: (nx, ny, nz).
    """

    def __init__(self, cells, counts, origin, cell_size, dims):
        self.cells = cells
        self.counts = counts
        self.origin = origin
        self.cell_size = cell_size
        self.dims = dims

    @property
    def max_per_cell(self) -> int:
        return self.cells.shape[1]


def build_grid(
    lo: np.ndarray,
    hi: np.ndarray,
    prim_lo: np.ndarray,
    prim_hi: np.ndarray,
    target_cell_size: float,
    dim: int = 3,
    max_cells: int = 4_000_000,
) -> UniformGrid:
    """Insert prims into all overlapped cells.

    lo/hi: (3,) scene bounds; prim_lo/prim_hi: (N, 3) per-prim AABBs.
    """
    lo = np.asarray(lo, np.float64).copy()
    hi = np.asarray(hi, np.float64).copy()
    n = len(prim_lo)

    extent = np.maximum(hi - lo, 1e-12)
    if dim == 2:
        extent[2] = 0.0

    cell = float(target_cell_size)
    dims = np.maximum(np.ceil(extent / cell).astype(np.int64), 1)
    if dim == 2:
        dims[2] = 1
    while int(np.prod(dims)) > max_cells:
        cell *= 1.5
        dims = np.maximum(np.ceil(extent / cell).astype(np.int64), 1)
        if dim == 2:
            dims[2] = 1

    inv = 1.0 / cell
    clo = np.clip(
        np.floor((prim_lo - lo) * inv).astype(np.int64), 0, dims - 1
    )
    chi = np.clip(
        np.floor((prim_hi - lo) * inv).astype(np.int64), 0, dims - 1
    )
    if dim == 2:
        clo[:, 2] = 0
        chi[:, 2] = 0

    from ..utils import native

    got = native.build_grid_native(prim_lo, prim_hi, lo, cell, dims, dim)
    if got is not None:
        cells_n, counts_n = got
        return UniformGrid(
            cells=cells_n,
            counts=counts_n,
            origin=lo.astype(np.float32),
            cell_size=np.float32(cell),
            dims=(int(dims[0]), int(dims[1]), int(dims[2])),
        )

    # enumerate (cell, prim) pairs
    spans = chi - clo + 1
    counts_per_prim = np.prod(spans, axis=1)
    total = int(counts_per_prim.sum())
    pair_cell = np.empty(total, np.int64)
    pair_prim = np.empty(total, np.int64)
    stride_y = dims[2]
    stride_x = dims[1] * dims[2]
    pos = 0
    for i in range(n):
        sx, sy, sz = spans[i]
        xs = np.arange(clo[i, 0], chi[i, 0] + 1)
        ys = np.arange(clo[i, 1], chi[i, 1] + 1)
        zs = np.arange(clo[i, 2], chi[i, 2] + 1)
        lin = (
            xs[:, None, None] * stride_x
            + ys[None, :, None] * stride_y
            + zs[None, None, :]
        ).ravel()
        cnt = len(lin)
        pair_cell[pos : pos + cnt] = lin
        pair_prim[pos : pos + cnt] = i
        pos += cnt

    c_total = int(np.prod(dims))
    order = np.argsort(pair_cell, kind="stable")
    pair_cell = pair_cell[order]
    pair_prim = pair_prim[order]
    cell_counts = np.bincount(pair_cell, minlength=c_total)
    k = max(1, int(cell_counts.max()) if total else 1)

    cells = np.full((c_total, k), -1, np.int32)
    # position within each cell's slot list
    slot = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(cell_counts)[:-1]]), cell_counts
    )
    cells[pair_cell, slot] = pair_prim.astype(np.int32)

    return UniformGrid(
        cells=cells,
        counts=cell_counts.astype(np.int32),
        origin=lo.astype(np.float32),
        cell_size=np.float32(cell),
        dims=(int(dims[0]), int(dims[1]), int(dims[2])),
    )


def build_disk_grid(points, normals, radii, dim=3, cell_scale=2.0):
    """Grid over a disk cloud: conservative per-disk AABB = center +- r.

    cell size ~ cell_scale * max_radius balances cells-visited against
    prims-per-cell for gridDelta-spaced clouds.
    """
    points = np.asarray(points, np.float64)
    radii = np.asarray(radii, np.float64).reshape(-1, 1)
    prim_lo = points - radii
    prim_hi = points + radii
    lo = prim_lo.min(axis=0)
    hi = prim_hi.max(axis=0)
    cell = cell_scale * float(radii.max())
    return build_grid(lo, hi, prim_lo, prim_hi, cell, dim=dim)


def build_triangle_grid(vertices, triangles, dim=3, cell_size=None):
    """Grid over a triangle mesh: per-triangle AABBs."""
    vertices = np.asarray(vertices, np.float64)
    triangles = np.asarray(triangles, np.int64)
    v = vertices[triangles]  # (N, 3, 3)
    prim_lo = v.min(axis=1)
    prim_hi = v.max(axis=1)
    lo = prim_lo.min(axis=0)
    hi = prim_hi.max(axis=0)
    if cell_size is None:
        # median triangle bbox diagonal as the natural scale
        diag = np.linalg.norm(prim_hi - prim_lo, axis=1)
        cell_size = max(float(np.median(diag)) * 2.0, 1e-6)
    return build_grid(lo, hi, prim_lo, prim_hi, cell_size, dim=dim)
