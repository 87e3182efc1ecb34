"""Tests that need the card: the compiled nearest-hit kernel against the
brute force. They skip elsewhere; on a GPU machine run them with
``python -m pytest tests/test_gpu.py -m gpu`` (without the CPU pin of
tests/conftest.py: ``VIENNARAY_TEST_GPU=1``)."""

import numpy as np
import pytest

import viennaray_tpu as vrt
from viennaray_tpu.io import fixtures
from viennaray_tpu.ops import hit_kernel, intersect


@pytest.mark.gpu
def test_compiled_disk_kernel_matches_brute_force(gpu):
    import jax

    pts, nrm = fixtures.create_trench_grid_3d(grid_delta=0.25)
    geo = vrt.DiskGeometry.build(pts, nrm, 0.25, dim=3)
    rng = np.random.default_rng(0)
    org = jax.device_put(
        (rng.random((4096, 3)) * [10, 10, 6] - [5, 5, 4]).astype(np.float32),
        gpu)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d = jax.device_put(d / np.linalg.norm(d, axis=1, keepdims=True), gpu)
    tk, ik, hk = hit_kernel.nearest_hit(
        org, d, geo.prims_soa, geo.soa_perm, geo.soa_chunk_bbs, kind="disk")
    tb, ib, hb = intersect.disk_nearest_hit(
        org, d, geo.points, geo.normals, geo.radii, 1e-4)
    both = np.asarray(hk) & np.asarray(hb)
    assert (np.asarray(hk) == np.asarray(hb)).mean() >= 0.999
    assert (np.asarray(ik)[both] == np.asarray(ib)[both]).mean() >= 0.999
