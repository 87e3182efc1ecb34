"""Geometry tests: neighborhood (tests/pointNeighborhood), disk areas
(tests/diskAreas), line extrusion (tests/linesToTriangles)."""

import numpy as np

from viennaray_tpu.config import BoundaryCondition
from viennaray_tpu.geometry import disk_area, neighborhood
from viennaray_tpu.geometry.mesh import LineMesh, lines_to_triangles
from viennaray_tpu.geometry.triangle_geometry import TriangleGeometry
from viennaray_tpu.io import fixtures


def test_neighborhood_plane_grid_counts():
    """Corner points 3, edge points 5, inner points 8 neighbors at distance
    2*(gridDelta - eps) (ref: tests/pointNeighborhood/pointNeighborhood.cpp)."""
    grid_delta, extent, eps = 0.5, 3.0, 1e-6
    points, _ = fixtures.create_plane_grid(grid_delta, extent, (0, 1, 2))
    nbrs, counts = neighborhood.build_neighborhood(
        points, 2 * (grid_delta - eps), dim=3
    )
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    for idx in range(len(points)):
        p = points[idx]
        on_x = p[0] in (lo[0], hi[0])
        on_y = p[1] in (lo[1], hi[1])
        expected = 3 if (on_x and on_y) else (5 if (on_x or on_y) else 8)
        assert counts[idx] == expected, (idx, p, counts[idx])


def test_neighborhood_symmetric_unique():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1, 1, size=(300, 3)).astype(np.float32)
    nbrs, counts = neighborhood.build_neighborhood(pts, 0.4, dim=3)
    sets = [set(row[row >= 0].tolist()) for row in nbrs]
    for i, s in enumerate(sets):
        assert i not in s
        assert len(s) == counts[i]  # duplicate-free
        for j in s:
            assert i in sets[j]  # symmetric
    # brute-force cross-check (matching predicate, rayPointNeighborhood.hpp:287)
    d = pts[:, None, :] - pts[None, :, :]
    within = (np.abs(d) <= 0.4).all(-1) & (np.sum(d * d, -1) <= 0.16)
    np.fill_diagonal(within, False)
    for i in range(len(pts)):
        assert sets[i] == set(np.nonzero(within[i])[0].tolist())


def test_neighborhood_2d_ignores_z():
    pts = np.array(
        [[0, 0, 0], [0.3, 0, 5.0], [1.0, 0, 0]], np.float32
    )
    nbrs, counts = neighborhood.build_neighborhood(pts, 0.5, dim=2)
    # z ignored in 2D: points 0 and 1 are neighbors despite z gap
    assert 1 in set(nbrs[0].tolist())
    assert counts[2] == 0


def test_disk_areas_quarter_half_full():
    """Plane grid: corner disks pi r^2/4, edge pi r^2/2, inner pi r^2
    (ref: tests/diskAreas/diskAreas.cpp:64-97)."""
    grid_delta, extent = 1.0, 2.0
    points, normals = fixtures.create_plane_grid(grid_delta, extent, (0, 1, 2))
    from viennaray_tpu.config import DISK_FACTOR_3D

    r = grid_delta * DISK_FACTOR_3D
    bbox = np.stack([points.min(axis=0), points.max(axis=0)])
    areas = disk_area.disk_areas_3d(
        points, normals, np.full(len(points), r), bbox,
        boundary_dirs=(0, 1),
        boundary_conds=(BoundaryCondition.REFLECTIVE,) * 3,
    )
    whole = np.pi * r * r
    lo, hi = bbox[0], bbox[1]
    eps = 1e-5
    for idx, p in enumerate(points):
        on_x = abs(p[0] - lo[0]) < eps or abs(p[0] - hi[0]) < eps
        on_y = abs(p[1] - lo[1]) < eps or abs(p[1] - hi[1]) < eps
        if on_x and on_y:
            expected = whole / 4
        elif on_x or on_y:
            expected = whole / 2
        else:
            expected = whole
        np.testing.assert_allclose(areas[idx], expected, rtol=1e-5)


def test_disk_areas_tilted_disk_partial():
    """A 45-degree tilted disk centered on a wall loses exactly half its
    area; disk fully outside -> 0."""
    r = 1.0
    bbox = np.array([[0.0, 0.0, -5.0], [10.0, 10.0, 5.0]])
    n = np.array([[np.sin(np.pi / 4), 0.0, np.cos(np.pi / 4)]])
    pts = np.array([[0.0, 5.0, 0.0]])
    areas = disk_area.disk_areas_3d(
        pts, n, np.array([r]), bbox, (0, 1),
        (BoundaryCondition.REFLECTIVE,) * 3,
    )
    np.testing.assert_allclose(areas[0], np.pi / 2, rtol=1e-5)
    pts = np.array([[-5.0, 5.0, 0.0]])
    areas = disk_area.disk_areas_3d(
        pts, n, np.array([r]), bbox, (0, 1),
        (BoundaryCondition.REFLECTIVE,) * 3,
    )
    assert areas[0] == 0.0


def test_disk_areas_corner_overlap():
    """Disk centered exactly on a box corner with normal +z keeps a quarter:
    the two wall segments plus corner-overlap correction must combine to
    pi r^2 / 4."""
    r = 1.0
    bbox = np.array([[0.0, 0.0, -5.0], [10.0, 10.0, 5.0]])
    pts = np.array([[0.0, 0.0, 0.0]])
    n = np.array([[0.0, 0.0, 1.0]])
    areas = disk_area.disk_areas_3d(
        pts, n, np.array([r]), bbox, (0, 1),
        (BoundaryCondition.REFLECTIVE,) * 3,
    )
    np.testing.assert_allclose(areas[0], np.pi / 4, rtol=1e-5)


def test_disk_areas_2d_chord():
    """2D: area 2r minus the chord segment beyond the wall
    (ref: rayGeometryDisk.hpp:314-352)."""
    r = 0.7071
    bbox = np.array([[0.0, -5.0, 0.0], [10.0, 5.0, 0.0]])
    # disk at the wall with vertical normal: line segment along x, half cut
    pts = np.array([[0.0, 0.0, 0.0], [5.0, 0.0, 0.0]])
    n = np.array([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    areas = disk_area.disk_areas_2d(
        pts, n, np.full(2, r), bbox, (0, 2),
        (BoundaryCondition.REFLECTIVE,) * 3,
    )
    np.testing.assert_allclose(areas[0], r, rtol=1e-5)  # half cut
    np.testing.assert_allclose(areas[1], 2 * r, rtol=1e-5)  # interior


def test_lines_to_triangles():
    """Extrusion layout (ref: tests/linesToTriangles, rayMesh.hpp:133-175)."""
    nodes = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0]], np.float32)
    lines = np.array([[0, 1], [1, 2]], np.uint32)
    lm = LineMesh(nodes=nodes, lines=lines, grid_delta=0.5)
    tm = lines_to_triangles(lm)
    assert tm.nodes.shape == (6, 3)
    assert tm.triangles.shape == (4, 3)
    np.testing.assert_allclose(tm.nodes[0], [0, 0, 0.25])
    np.testing.assert_allclose(tm.nodes[1], [0, 0, -0.25])
    np.testing.assert_array_equal(tm.triangles[0], [0, 2, 1])
    np.testing.assert_array_equal(tm.triangles[1], [1, 2, 3])
    # line (0,1) runs +x, line normal (-dy, dx) = (0,1): extruded triangle
    # normals must match the line normal
    np.testing.assert_allclose(tm.normals[0], [0, 1, 0], atol=1e-6)
    np.testing.assert_allclose(tm.normals[1], [0, 1, 0], atol=1e-6)

    # 2D triangle areas alternate half edge lengths
    geo = TriangleGeometry.from_mesh(tm, dim=2)
    areas = np.asarray(geo.areas)
    np.testing.assert_allclose(areas[0], 0.5 * 1.0, rtol=1e-6)
    np.testing.assert_allclose(areas[1], 0.5 * 1.0, rtol=1e-6)


def test_line_mesh_drops_zero_length():
    nodes = np.array([[0, 0, 0], [0, 0, 0], [1, 0, 0]], np.float32)
    lines = np.array([[0, 1], [1, 2]], np.uint32)
    lm = LineMesh(nodes=nodes, lines=lines, grid_delta=0.5)
    assert len(lm.lines) == 1


def test_trench_lines_2d_polyline():
    """The line2d fixture is one connected polyline whose left-hand normals
    point up on the shelves and bottom and into the trench on the walls."""
    import viennaray_tpu as vrt
    from viennaray_tpu.io import fixtures

    nodes, lines = fixtures.create_trench_lines_2d(grid_delta=0.5)
    assert nodes.shape[1] == 3 and (nodes[:, 2] == 0).all()
    assert (lines[1:, 0] == lines[:-1, 1]).all()
    mesh = vrt.LineMesh(nodes=nodes, lines=lines, grid_delta=0.5)
    mid = 0.5 * (nodes[lines[:, 0]] + nodes[lines[:, 1]])
    n = mesh.normals
    flat = np.isclose(n[:, 1], 1.0)
    wall = ~flat
    assert flat.sum() + wall.sum() == len(lines)
    # wall normals point toward the trench axis x = 0
    assert (np.sign(n[wall, 0]) == -np.sign(mid[wall, 0])).all()
    np.testing.assert_allclose(
        np.linalg.norm(nodes[lines[:, 1]] - nodes[lines[:, 0]], axis=1),
        0.5, rtol=1e-5)
