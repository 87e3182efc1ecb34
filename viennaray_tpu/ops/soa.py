"""Host-side struct-of-arrays packing of the primitives for the fused
nearest-hit kernel (ops/hit_kernel.py).

Primitives are grouped into chunks of ``CHUNK`` that are compact in space
(Morton order), and the chunks are ordered source-side-first along the trace
axis, so that the rays of a block find near hits early and skip the chunks
behind them. Each chunk carries an axis-aligned bounding box for that skip
test. Padding primitives sit far away with zero normals / edges, so they can
never be hit.
"""

from __future__ import annotations

import numpy as np

# primitives per chunk: the kernel's primitive tile and the granularity of
# its bounding-box skip test (a power of two, as Triton blocks require)
CHUNK = 64

# prims row layout (SoA): cx cy cz nx ny nz r2 ndc  -> (8, Npad)
PRIM_ROWS = 8


def _morton3(c):
    """Interleave 3 x 21-bit cell coordinates into a 63-bit Morton code —
    chunks of consecutive codes are spatially COMPACT blocks, so a ray's
    slab test prunes all but O(N^(1/3)) chunk AABBs for ANY direction
    (z-slab ordering only pruned well for near-vertical rays)."""
    c = c - c.min(axis=0, keepdims=True)
    c = np.clip(c, 0, (1 << 21) - 1).astype(np.uint64)

    def spread(v):
        v &= np.uint64(0x1FFFFF)
        v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
        return v

    return (
        spread(c[:, 0])
        | (spread(c[:, 1]) << np.uint64(1))
        | (spread(c[:, 2]) << np.uint64(2))
    )


def _block_order(centers, cell, pad_to, sort_axis):
    """Morton-compact blocks of ``pad_to`` prims, blocks iterated
    source-side-first (descending block-max along ``sort_axis`` so early
    chunks establish t_min for the skip test).

    Returns the permutation original -> packed order.
    """
    n = len(centers)
    if n == 0:
        return np.zeros((0,), np.int32)
    c = np.floor(centers / cell).astype(np.int64)
    order = np.argsort(_morton3(c), kind="stable")
    n_chunks = -(-n // pad_to)
    # order blocks by descending max coordinate along the trace axis
    block_key = np.full((n_chunks,), -np.inf)
    for b in range(n_chunks):
        seg = order[b * pad_to : (b + 1) * pad_to]
        block_key[b] = centers[seg, sort_axis].max()
    blocks = np.argsort(-block_key, kind="stable")
    out = np.concatenate(
        [order[b * pad_to : (b + 1) * pad_to] for b in blocks]
    )
    return out.astype(np.int32)


def pack_disk_prims(points, normals, radii, pad_to=CHUNK, sort_axis=2):
    """Host-side SoA packing: Morton-compact chunks, source-side-first.

    Returns (prims (8, Npad) f32, perm (Npad,) int32 sorted->original,
             chunk_bboxes (n_chunks, 8) f32 [xmin ymin zmin xmax ymax zmax 0 0]).
    """
    points = np.asarray(points, np.float32)
    normals = np.asarray(normals, np.float32)
    radii = np.asarray(radii, np.float32)
    n = len(points)

    if n > 0:
        cell = max(float(radii.max()) * 8.0, 1e-6)
        order = _block_order(points, cell, pad_to, sort_axis)
    else:
        order = np.zeros((0,), np.int32)

    pts_s = points[order]
    nrm_s = normals[order]
    rad_s = radii[order]

    npad = -(-max(n, 1) // pad_to) * pad_to
    out = np.zeros((PRIM_ROWS, npad), np.float32)
    out[0:3, :n] = pts_s.T
    out[3:6, :n] = nrm_s.T
    out[6, :n] = rad_s * rad_s
    out[7, :n] = np.sum(nrm_s * pts_s, axis=1)
    # padding prims: zero normal -> denom==0 -> never valid
    out[0:3, n:] = 1e18

    perm = np.zeros((npad,), np.int32)
    perm[:n] = order

    n_chunks = npad // pad_to
    bbs = np.full((n_chunks, 8), 1e18, np.float32)
    for ci in range(n_chunks):
        lo = ci * pad_to
        hi = min(lo + pad_to, n)
        if hi <= lo:
            continue
        p = pts_s[lo:hi]
        r = rad_s[lo:hi, None]
        bbs[ci, 0:3] = (p - r).min(axis=0)
        bbs[ci, 3:6] = (p + r).max(axis=0)
        bbs[ci, 6:8] = 0.0
    return out, perm, bbs


TRI_ROWS = 12


def pack_triangle_prims(vertices, triangles, normals=None, pad_to=CHUNK,
                        sort_axis=2):
    """SoA triangle packing: rows [v0(3) e1(3) e2(3) n(3)] -> (12, Npad),
    spatially sorted source-side-first like the disk packing. Rows 9-11 carry
    the STORED unit normals (user orientation may differ from cross(e1,e2));
    when ``normals`` is None they are computed from the edge cross product
    (the geometry builder's default, rayGeometryTriangle.hpp:57-75).

    Returns (prims (12, Npad), perm (Npad,) int32, chunk_bboxes (n_chunks, 8)).
    """
    vertices = np.asarray(vertices, np.float32)
    triangles = np.asarray(triangles, np.int64)
    n = len(triangles)
    v0 = vertices[triangles[:, 0]]
    v1 = vertices[triangles[:, 1]]
    v2 = vertices[triangles[:, 2]]
    if normals is None:
        cr = np.cross(v1 - v0, v2 - v0)
        ln = np.linalg.norm(cr, axis=1, keepdims=True)
        normals = cr / np.where(ln > 0, ln, 1.0)
    else:
        normals = np.asarray(normals, np.float32).reshape(-1, 3)

    if n > 0:
        centroid = (v0 + v1 + v2) / 3.0
        scale = max(float(np.abs(v1 - v0).max()), 1e-6) * 4.0
        order = _block_order(centroid, scale, pad_to, sort_axis)
    else:
        order = np.zeros((0,), np.int32)

    v0s, v1s, v2s = v0[order], v1[order], v2[order]
    npad = -(-max(n, 1) // pad_to) * pad_to
    out = np.zeros((TRI_ROWS, npad), np.float32)
    out[0:3, :n] = v0s.T
    out[3:6, :n] = (v1s - v0s).T
    out[6:9, :n] = (v2s - v0s).T
    out[9:12, :n] = normals[order].T
    out[0:3, n:] = 1e18  # far-away padding; zero edges -> det==0 -> invalid

    perm = np.zeros((npad,), np.int32)
    perm[:n] = order

    n_chunks = npad // pad_to
    bbs = np.full((n_chunks, 8), 1e18, np.float32)
    for ci in range(n_chunks):
        lo = ci * pad_to
        hi = min(lo + pad_to, n)
        if hi <= lo:
            continue
        allv = np.concatenate([v0s[lo:hi], v1s[lo:hi], v2s[lo:hi]])
        bbs[ci, 0:3] = allv.min(axis=0)
        bbs[ci, 3:6] = allv.max(axis=0)
        bbs[ci, 6:8] = 0.0
    return out, perm, bbs
