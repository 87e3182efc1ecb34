"""Test-geometry generators (ports of rayUtil.hpp fixtures)."""

from __future__ import annotations

import numpy as np

from ..config import get_trace_settings


def create_plane_grid(grid_delta: float, extent: float, direction=(0, 1, 2)):
    """Regular plane grid of points with constant normals
    (ref: rayUtil.hpp:324-351): the plane spans [-extent, extent] in
    direction[0] x direction[1], sits at 0 along direction[2], normal =
    +direction[2]. Iteration order matches the reference (direction[0] outer,
    direction[1] inner, inclusive of +extent)."""
    d0, d1, d2 = direction
    # replicate the reference's incremental loop (inclusive upper bound with
    # accumulated float steps)
    coords0 = []
    v = -float(extent)
    while v <= extent:
        coords0.append(v)
        v += grid_delta
    coords0 = np.array(coords0, np.float64)

    pts = []
    for a in coords0:
        b = -float(extent)
        while b <= extent:
            p = np.zeros(3)
            p[d0] = a
            p[d1] = b
            p[d2] = 0.0
            pts.append(p)
            b += grid_delta
    points = np.array(pts, np.float32)
    normal = np.zeros(3, np.float32)
    normal[d2] = 1.0
    normals = np.broadcast_to(normal, points.shape).copy()
    return points, normals


def create_source_grid(bbox, num_points: int, grid_delta: float, source_dir,
                       dim: int = 3):
    """Regular grid of source points on the source plane
    (ref: rayUtil.hpp:564-611 ``createSourceGrid``)."""
    ray_dir, first_dir, second_dir, min_max, _ = get_trace_settings(source_dir)
    bbox = np.asarray(bbox, np.float64)
    eps = 1e-4

    len1 = bbox[1][first_dir] - bbox[0][first_dir]
    len2 = bbox[1][second_dir] - bbox[0][second_dir]
    n1 = max(int(round(len1 / grid_delta)), 1)
    n2 = max(int(round(len2 / grid_delta)), 1)
    ratio = max(n1 // max(n2, 1), 1)
    n1 = int(np.sqrt(num_points * ratio))
    n2 = int(np.sqrt(num_points / ratio))
    d1 = (len1 - 2 * eps) / max(n1 - 1, 1)
    d2 = (len2 - 2 * eps) / max(n2 - 1, 1)

    grid = []
    uu = bbox[0][second_dir] + eps
    while uu <= bbox[1][second_dir] - eps:
        vv = bbox[0][first_dir] + eps
        while vv <= bbox[1][first_dir] - eps:
            p = np.zeros(3)
            p[ray_dir] = bbox[min_max][ray_dir]
            p[second_dir] = 0.0 if dim == 2 else uu
            p[first_dir] = vv
            grid.append(p)
            vv += d1
        uu += d2
    return np.array(grid, np.float32).reshape(-1, 3)


def create_trench_grid_2d(grid_delta=0.1, extent=5.0, trench_width=4.0,
                          trench_depth=4.0):
    """Synthetic 2D trench point cloud (x lateral, y vertical): flat top
    surfaces at y=0, vertical side walls, flat bottom. Mirrors the shape of the
    reference's checked-in examples/disk2D/trenchGrid2D.dat fixture."""
    pts, nrm = [], []
    half_w = trench_width / 2.0
    x = -extent
    while x <= extent + 1e-9:
        if abs(x) >= half_w:
            pts.append([x, 0.0, 0.0])
            nrm.append([0.0, 1.0, 0.0])
        x += grid_delta
    y = -grid_delta
    while y >= -trench_depth + 1e-9:
        pts.append([-half_w, y, 0.0])
        nrm.append([1.0, 0.0, 0.0])
        pts.append([half_w, y, 0.0])
        nrm.append([-1.0, 0.0, 0.0])
        y -= grid_delta
    x = -half_w
    while x <= half_w + 1e-9:
        pts.append([x, -trench_depth, 0.0])
        nrm.append([0.0, 1.0, 0.0])
        x += grid_delta
    return np.array(pts, np.float32), np.array(nrm, np.float32)


def create_trench_grid_3d(grid_delta=0.5, extent=5.0, trench_width=4.0,
                          trench_depth=4.0):
    """Synthetic 3D trench point cloud (trench running along y, z vertical)."""
    pts, nrm = [], []
    half_w = trench_width / 2.0
    xs = np.arange(-extent, extent + 1e-9, grid_delta)
    ys = np.arange(-extent, extent + 1e-9, grid_delta)
    for x in xs:
        for y in ys:
            if abs(x) >= half_w:
                pts.append([x, y, 0.0])
                nrm.append([0.0, 0.0, 1.0])
    zs = np.arange(-grid_delta, -trench_depth + 1e-9, -grid_delta)
    for z in zs:
        for y in ys:
            pts.append([-half_w, y, z])
            nrm.append([1.0, 0.0, 0.0])
            pts.append([half_w, y, z])
            nrm.append([-1.0, 0.0, 0.0])
    xs_in = np.arange(-half_w, half_w + 1e-9, grid_delta)
    for x in xs_in:
        for y in ys:
            pts.append([x, y, -trench_depth])
            nrm.append([0.0, 0.0, 1.0])
    return np.array(pts, np.float32), np.array(nrm, np.float32)


def create_trench_mesh_3d(grid_delta=0.5, extent=5.0, trench_width=4.0,
                          trench_depth=4.0):
    """Synthetic 3D trench TRIANGLE mesh (trench along y, z vertical).

    The triangle analog of ``create_trench_grid_3d``: top strips, vertical
    walls, and a bottom strip, each triangulated at ``grid_delta``
    resolution with windings chosen so normals = cross(v1-v0, v2-v0) point
    toward the source side (+z for top/bottom, into the trench for walls) —
    the mesh convention of rayGeometryTriangle.hpp:57-75.
    Returns (vertices (V, 3) f32, triangles (N, 3) i32).
    """
    verts = []
    tris = []
    vid = {}

    def vtx(p):
        key = (round(p[0], 9), round(p[1], 9), round(p[2], 9))
        if key not in vid:
            vid[key] = len(verts)
            verts.append(list(key))
        return vid[key]

    def patch(p00, du, dv, nu, nv):
        """Triangulate the quad patch p00 + u*du + v*dv, u<=nu, v<=nv,
        winding so normals follow cross(du, dv)."""
        du = np.asarray(du, np.float64)
        dv = np.asarray(dv, np.float64)
        p00 = np.asarray(p00, np.float64)
        for i in range(nu):
            for j in range(nv):
                a = vtx(p00 + i * du + j * dv)
                b = vtx(p00 + (i + 1) * du + j * dv)
                c = vtx(p00 + (i + 1) * du + (j + 1) * dv)
                d = vtx(p00 + i * du + (j + 1) * dv)
                tris.append([a, b, c])
                tris.append([a, c, d])

    half_w = trench_width / 2.0
    gd = grid_delta
    ny = max(1, int(round(2 * extent / gd)))
    n_strip = max(1, int(round((extent - half_w) / gd)))
    n_w = max(1, int(round(trench_width / gd)))
    n_d = max(1, int(round(trench_depth / gd)))
    # top strips (normal +z = cross(+x, +y))
    patch([-extent, -extent, 0.0], [gd, 0, 0], [0, gd, 0], n_strip, ny)
    patch([half_w, -extent, 0.0], [gd, 0, 0], [0, gd, 0], n_strip, ny)
    # left wall at x=-half_w (normal +x = cross(-z, +y)), z in [-depth, 0]
    patch([-half_w, -extent, 0.0], [0, 0, -gd], [0, gd, 0], n_d, ny)
    # right wall at x=+half_w (normal -x = cross(+z, +y)), z in [-depth, 0]
    patch([half_w, -extent, -trench_depth], [0, 0, gd], [0, gd, 0], n_d, ny)
    # bottom at z=-depth (normal +z)
    patch([-half_w, -extent, -trench_depth], [gd, 0, 0], [0, gd, 0],
          n_w, ny)
    return (np.asarray(verts, np.float32),
            np.asarray(tris, np.int32))


def create_trench_lines_2d(grid_delta=0.1, extent=5.0, trench_width=4.0,
                           trench_depth=4.0):
    """Synthetic 2D trench POLYLINE (x lateral, y vertical): the line-mesh
    analog of ``create_trench_grid_2d``, one connected polyline from the
    left shelf down the left wall, across the bottom, up the right wall and
    along the right shelf. Segments are ~``grid_delta`` long; traversal runs
    left to right so the left-hand normals (LineMesh convention, -dy, dx)
    point up on the shelves and bottom and into the trench on the walls.
    Returns (nodes (V, 3) f32 with z = 0, lines (V-1, 2) i32).
    """
    half_w = trench_width / 2.0

    def steps(a, b):
        n = max(1, int(round(abs(b - a) / grid_delta)))
        return np.linspace(a, b, n + 1)

    xs_l = steps(-extent, -half_w)
    ys_w = steps(0.0, -trench_depth)
    xs_b = steps(-half_w, half_w)
    xs_r = steps(half_w, extent)
    pts = (
        [(x, 0.0) for x in xs_l]
        + [(-half_w, y) for y in ys_w[1:]]
        + [(x, -trench_depth) for x in xs_b[1:]]
        + [(half_w, y) for y in ys_w[::-1][1:]]
        + [(x, 0.0) for x in xs_r[1:]]
    )
    nodes = np.zeros((len(pts), 3), np.float32)
    nodes[:, :2] = np.asarray(pts, np.float32)
    lines = np.stack(
        [np.arange(len(pts) - 1), np.arange(1, len(pts))], axis=1
    ).astype(np.int32)
    return nodes, lines
