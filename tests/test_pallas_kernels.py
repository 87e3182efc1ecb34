"""The fused nearest-hit kernel (ops/hit_kernel.py, Pallas through Triton)
on the CPU via interpret mode, against the XLA brute force.

The compiled kernel runs on the GPU (chip_smoke.py checks it there at the
benchmark widths); these keep its arithmetic, padding, chunk skip and tie
rule from regressing in CPU-only runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import viennaray_tpu as vrt
from viennaray_tpu.io import fixtures
from viennaray_tpu.ops import hit_kernel, intersect, soa


def _rays(n, z, lo=-1.5, hi=1.5, seed=0):
    key = jax.random.PRNGKey(seed)
    org = jax.random.uniform(key, (n, 3), minval=lo, maxval=hi).astype(
        jnp.float32
    )
    org = org.at[:, 2].set(z)
    th = jax.random.uniform(jax.random.PRNGKey(seed + 1), (n,)) * 0.6
    d = jnp.stack(
        [jnp.sin(th) * 0.4, jnp.cos(th) * 0.4, -jnp.ones(n)], axis=1
    )
    return org, d / jnp.linalg.norm(d, axis=1, keepdims=True)


def _random_rays(geo, n, seed=0):
    """Origins in the geometry's box (lifted above it), directions uniform
    on the sphere."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(geo.bbox, np.float64)
    hi = hi.copy()
    hi[2] += 1.0
    org = lo + (hi - lo) * rng.random((n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(org, jnp.float32), jnp.asarray(d, jnp.float32)


def _kernel(geo, kind, org, d):
    return hit_kernel.nearest_hit(
        org, d, geo.prims_soa, geo.soa_perm, geo.soa_chunk_bbs, kind=kind,
        interpret=True,
    )


def _brute(geo, kind, org, d):
    if kind == "disk":
        return intersect.disk_nearest_hit(
            org, d, geo.points, geo.normals, geo.radii, 1e-4)
    return intersect.triangle_nearest_hit(
        org, d, geo.vertices, geo.triangles, 1e-4)


def _geometry(kind, gd):
    if kind == "disk":
        pts, nrm = fixtures.create_trench_grid_3d(
            grid_delta=gd, extent=3.0, trench_width=2.0, trench_depth=2.0)
        return vrt.DiskGeometry.build(pts, nrm, gd, dim=3)
    verts, tris = fixtures.create_trench_mesh_3d(
        grid_delta=gd, extent=3.0, trench_width=2.0, trench_depth=2.0)
    return vrt.TriangleGeometry.build(verts, tris, gd, dim=3)


def _assert_matches(a, b):
    tk, ik, hk = (np.asarray(x) for x in a)
    tb, ib, hb = (np.asarray(x) for x in b)
    np.testing.assert_array_equal(hk, hb)
    np.testing.assert_array_equal(ik[hb], ib[hb])
    np.testing.assert_allclose(tk[hb], tb[hb], rtol=1e-5)
    assert (ik[~hb] == 0).all()  # a miss reports prim 0, as the brute force


def test_pallas_disk_kernel_interpret_matches_xla():
    pts, nrm = fixtures.create_plane_grid(0.5, 1.5, (0, 1, 2))
    geo = vrt.DiskGeometry.build(pts, nrm, 0.5, dim=3)
    org, d = _rays(512, 0.6)
    _assert_matches(_kernel(geo, "disk", org, d),
                    _brute(geo, "disk", org, d))


def test_pallas_triangle_kernel_interpret_matches_xla():
    n = 4
    xs = np.linspace(-1.5, 1.5, n + 1)
    vv, uu = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack(
        [uu.ravel(), vv.ravel(), np.zeros((n + 1) ** 2)], axis=1
    ).astype(np.float32)
    tris = []
    for i in range(n):
        for j in range(n):
            a = i * (n + 1) + j
            tris.append([a, a + 1, a + n + 1])
            tris.append([a + 1, a + n + 2, a + n + 1])
    tris = np.array(tris, np.int32)
    geo = vrt.TriangleGeometry.build(verts, tris, 0.75, dim=3)
    org, d = _rays(512, 0.6)
    _assert_matches(_kernel(geo, "triangle", org, d),
                    _brute(geo, "triangle", org, d))


@pytest.mark.parametrize("kind", ["disk", "triangle"])
@pytest.mark.parametrize("n_rays,gd", [(1000, 0.4), (333, 0.55)])
def test_kernel_ragged_counts_match_brute_force(kind, n_rays, gd):
    """Ray counts that are no multiple of the block, prim counts that are
    no multiple of the chunk (padding on both sides), many chunks."""
    geo = _geometry(kind, gd)
    assert geo.num_primitives % soa.CHUNK != 0
    assert geo.soa_chunk_bbs.shape[0] > 2
    org, d = _random_rays(geo, n_rays)
    out = _kernel(geo, kind, org, d)
    assert out[0].shape == (n_rays,)
    assert np.asarray(out[2]).sum() > n_rays // 10
    _assert_matches(out, _brute(geo, kind, org, d))


def test_kernel_chunk_skip_keeps_nearest_hit():
    """Coherent downward rays over a trench: most chunks fail the block's
    slab test once the top surface is hit; the result must not change. A
    disabled skip (every box infinite) gives the same answer."""
    geo = _geometry("disk", 0.25)
    org, d = _rays(512, 1.0, lo=-2.5, hi=2.5)
    skip = _kernel(geo, "disk", org, d)
    open_boxes = jnp.concatenate(
        [jnp.full((geo.soa_chunk_bbs.shape[0], 3), -3e38),
         jnp.full((geo.soa_chunk_bbs.shape[0], 3), 3e38),
         jnp.zeros((geo.soa_chunk_bbs.shape[0], 2))], axis=1)
    full = hit_kernel.nearest_hit(
        org, d, geo.prims_soa, geo.soa_perm, open_boxes, kind="disk",
        interpret=True)
    for a, b in zip(skip, full):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _assert_matches(skip, _brute(geo, "disk", org, d))


@pytest.mark.parametrize("kind", ["disk", "triangle"])
def test_kernel_ties_go_to_lowest_prim_index(kind):
    """Every prim duplicated: each hit has two equal candidates, and the
    kernel must pick the lower original index, as the brute force does,
    whatever order the packing put them in."""
    if kind == "disk":
        pts, nrm = fixtures.create_plane_grid(0.5, 1.5, (0, 1, 2))
        pts = np.concatenate([pts[::-1], pts])
        nrm = np.concatenate([nrm, nrm])
        geo = vrt.DiskGeometry.build(pts, nrm, 0.5, dim=3)
        org, d = _rays(256, 0.6)
    else:
        verts, tris = fixtures.create_trench_mesh_3d(
            grid_delta=0.5, extent=2.0, trench_width=2.0, trench_depth=1.0)
        tris = np.concatenate([tris[::-1], tris])
        geo = vrt.TriangleGeometry.build(verts, tris, 0.5, dim=3)
        org, d = _rays(256, 0.6, lo=-1.8, hi=1.8)
    out = _kernel(geo, kind, org, d)
    hit = np.asarray(out[2])
    assert hit.sum() > 50
    half = geo.num_primitives // 2
    assert (np.asarray(out[1])[hit] < half).all()
    _assert_matches(out, _brute(geo, kind, org, d))


def test_kernel_choice_is_xla_off_the_gpu():
    """The package never picks the kernel (or interpret mode) by itself
    off the GPU."""
    for choose in (hit_kernel.disk_kernel, hit_kernel.triangle_kernel):
        assert choose(3000) == "xla"


def test_soa_packing_covers_every_prim_once():
    pts, nrm = fixtures.create_trench_grid_3d(grid_delta=0.5)
    prims, perm, bbs = soa.pack_disk_prims(
        pts, nrm, np.full(len(pts), 0.2, np.float32))
    n = len(pts)
    assert prims.shape[1] % soa.CHUNK == 0
    assert bbs.shape[0] == prims.shape[1] // soa.CHUNK
    assert sorted(perm[:n].tolist()) == list(range(n))
    # each real prim lies inside its chunk's box
    for c in range(bbs.shape[0]):
        lanes = np.arange(c * soa.CHUNK, min((c + 1) * soa.CHUNK, n))
        if lanes.size:
            p = prims[0:3, lanes].T
            assert (p >= bbs[c, 0:3] - 1e-6).all()
            assert (p <= bbs[c, 3:6] + 1e-6).all()
