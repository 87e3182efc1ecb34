"""TracingData container (mirror tests/tracingData) + file IO round trips."""

import os

import numpy as np

from viennaray_tpu.data import DataLog, MergeType, TracingData
from viennaray_tpu.io import dat, vtk
from viennaray_tpu.io.fixtures import create_plane_grid, create_source_grid


def test_tracing_data_channels():
    td = TracingData()
    td.set_number_of_vector_data(2)
    td.set_vector_data(0, 5, 0.0, "flux")
    td.set_vector_data(1, np.arange(3.0), label="energy")
    assert td.get_vector_data("flux").shape == (5,)
    np.testing.assert_array_equal(td.get_vector_data("energy"), [0, 1, 2])
    assert td.get_vector_data_index("energy") == 1
    td.set_vector_merge_type(1, MergeType.APPEND)
    assert td.get_vector_merge_type(1) == MergeType.APPEND

    td.accumulate_vector(0, np.ones(5))
    td.accumulate_vector(0, np.ones(5))
    np.testing.assert_array_equal(td.get_vector_data(0), 2 * np.ones(5))
    td.accumulate_vector(1, np.array([7.0]))
    assert len(td.get_vector_data(1)) == 4  # APPEND semantics

    td.set_number_of_scalar_data(1)
    td.set_scalar_data(0, 3.5, "count")
    assert td.get_scalar_data("count") == 3.5


def test_data_log_merge():
    a, b = DataLog(), DataLog()
    a.data = [np.ones(4)]
    b.data = [2 * np.ones(4)]
    a.merge(b)
    np.testing.assert_array_equal(a.data[0], 3 * np.ones(4))


def test_dat_grid_roundtrip(tmp_path):
    grid_delta = 0.25
    pts, nrm = create_plane_grid(grid_delta, 1.0, (0, 1, 2))
    p = tmp_path / "grid.dat"
    with open(p, "w") as f:
        f.write(f"{len(pts)}\n{grid_delta}\n")
        for q in pts:
            f.write(f"{q[0]} {q[1]} {q[2]}\n")
        for q in nrm:
            f.write(f"{q[0]} {q[1]} {q[2]}\n")
    gd, pts2, nrm2 = dat.read_grid_from_file(str(p))
    assert gd == grid_delta
    np.testing.assert_allclose(pts2, pts)
    np.testing.assert_allclose(nrm2, nrm)


def test_dat_mesh_reader(tmp_path):
    p = tmp_path / "mesh.dat"
    with open(p, "w") as f:
        f.write("grid_delta 0.5\nn_nodes 3\nn_elements 1\n")
        f.write("n 0 0 0\nn 1 0 0\nn 0 1 0\n")
        f.write("e 0 1 2\n")
    gd, nodes, elems = dat.read_mesh_from_file(str(p), 3)
    assert gd == 0.5
    assert nodes.shape == (3, 3)
    np.testing.assert_array_equal(elems, [[0, 1, 2]])


def test_reference_dat_fixtures_readable(tmp_path):
    """The in-repo 2D trench fixture, written in the reference's grid-file
    layout (numPoints, gridDelta, points, normals), parses back cleanly."""
    from viennaray_tpu.io import fixtures

    pts0, nrm0 = fixtures.create_trench_grid_2d(grid_delta=0.1)
    ref = tmp_path / "trenchGrid2D.dat"
    with open(ref, "w") as f:
        f.write(f"{len(pts0)} 0.1\n")
        for q in np.concatenate([pts0, nrm0]):
            f.write(" ".join(repr(float(x)) for x in q) + "\n")
    gd, pts, nrm = dat.read_grid_from_file(str(ref))
    assert gd > 0 and len(pts) == len(nrm) > 100
    np.testing.assert_array_equal(pts, pts0)
    norms = np.linalg.norm(nrm, axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-4)


def test_vtk_writers(tmp_path):
    pts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    flux = np.array([1.0, 2.0, 1e-9])
    f1 = tmp_path / "out.vtk"
    vtk.write_vtk(str(f1), pts, flux)
    text = f1.read_text()
    assert "POINTS 3 float" in text
    assert "SCALARS flux float" in text
    # tiny values are zeroed (ref: rayUtil.hpp:445)
    assert "1e-09" not in text

    f2 = tmp_path / "out.vtp"
    vtk.write_vtp(str(f2), pts, np.array([[0, 1, 2]]), flux, dim=3)
    text = f2.read_text()
    assert 'NumberOfPolys="1"' in text
    assert "PointData" in text


def test_create_source_grid():
    """(ref: tests/createSourceGrid)"""
    bbox = np.array([[-1.0, -1.0, 0.0], [1.0, 1.0, 1.0]])
    grid = create_source_grid(bbox, 100, 0.2, 4, dim=3)  # POS_Z
    assert len(grid) > 0
    np.testing.assert_allclose(grid[:, 2], 1.0)
    assert (np.abs(grid[:, :2]) <= 1.0).all()
