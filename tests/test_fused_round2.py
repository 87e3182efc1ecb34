"""Trace scenarios through the fused nearest-hit kernel (ops/hit_kernel.py,
interpret mode on the CPU) against the XLA brute force: triangle pipeline,
coned-cosine reflection, gas-phase scattering, and both disk flux
models.

Parity strategy: ``trace_batch`` is called EAGERLY (unjitted) so the kernel
choice (patched per test through the choice functions) re-evaluates per
call. Only the nearest-hit implementation differs between the two runs, on
the same RNG stream, so the flux and counters must agree up to the last
bits of the hit time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import viennaray_tpu as vrt
from viennaray_tpu.config import (
    BoundaryCondition,
    ReflectionKind,
    TraceConfig,
    TraceDirection,
)
from viennaray_tpu.io import fixtures
from viennaray_tpu.config import adjust_bounding_box, get_trace_settings
from viennaray_tpu.ops import hit_kernel, sampling, vec
from viennaray_tpu.physics import reflection
from viennaray_tpu.physics.source import RandomSource
from viennaray_tpu.trace.kernel import trace_batch


def _use_kernel(monkeypatch, on: bool):
    """Route nearest-hit through the kernel in interpret mode (on) or the
    XLA path (off) for disks and triangles."""
    mode = "interpret" if on else "xla"
    for name in ("disk_kernel", "triangle_kernel"):
        monkeypatch.setattr(hit_kernel, name, lambda n: mode)


def _assert_same_trace(f_a, c_a, f_b, c_b, tol=1e-5):
    assert f_a.sum() > 0
    rel = np.linalg.norm(f_a - f_b) / np.linalg.norm(f_b)
    assert rel < tol, rel
    assert int(c_a.geometry_hits) == int(c_b.geometry_hits)
    assert int(c_a.boundary_hits) == int(c_b.boundary_hits)
    assert int(c_a.particle_hits) == int(c_b.particle_hits)


def _trace_once(geometry, geo_type, config, particle, seed=3, R=2048):
    """Eager (unjitted) trace so the fused-vs-unfused env toggle takes
    effect per call (jit would cache the first path)."""
    ray_dir, first_dir, second_dir, min_max, pos_neg = get_trace_settings(
        config.source_direction
    )
    margin = (
        geometry.disk_radius if geo_type == "disk" else geometry.grid_delta
    )
    bbox = adjust_bounding_box(
        np.asarray(geometry.bbox), config.source_direction, margin,
        config.dim,
    )
    source = RandomSource(
        bbox=jnp.asarray(bbox, jnp.float32),
        cosine_power=particle.cosine_exponent,
        ray_dir=ray_dir,
        first_dir=first_dir,
        second_dir=second_dir,
        min_max=min_max,
        pos_neg=float(pos_neg),
        dim=config.dim,
    )
    key = jax.random.PRNGKey(seed)
    idx = jnp.arange(R, dtype=jnp.int32)
    valid = jnp.ones((R,), bool)
    flux, counters = trace_batch(
        geometry, source, particle, jnp.asarray(bbox, jnp.float32), key,
        idx, valid, config, geo_type,
    )
    return np.asarray(flux), counters


def _trench_tri():
    """Small 2D trench polyline extruded to triangles (the reference's
    LineMesh -> convertLinesToTriangles path, rayTraceTriangle.hpp:76-81)."""
    seg = 0.15
    pts = []
    # top-left shelf, left wall down, bottom, right wall up, top-right shelf
    for x in np.arange(-2.0, -1.0 + 1e-9, seg):
        pts.append([x, 0.0])
    for y in np.arange(0.0 - seg, -1.5 - 1e-9, -seg):
        pts.append([-1.0, y])
    for x in np.arange(-1.0 + seg, 1.0 - 1e-9, seg):
        pts.append([x, -1.5])
    for y in np.arange(-1.5, 0.0 + 1e-9, seg):
        pts.append([1.0, y])
    for x in np.arange(1.0 + seg, 2.0 + 1e-9, seg):
        pts.append([x, 0.0])
    nodes = np.array(
        [[p[0], p[1], 0.0] for p in pts], np.float32
    )
    n = len(nodes)
    lines = np.stack(
        [np.arange(n - 1), np.arange(1, n)], axis=1
    ).astype(np.uint32)
    mesh = vrt.LineMesh(nodes=nodes, lines=lines, grid_delta=seg)
    return vrt.TriangleGeometry.from_line_mesh(mesh)


@pytest.fixture
def cfg2d():
    return TraceConfig(
        dim=2,
        source_direction=TraceDirection.POS_Y,
        boundary_conditions=(
            BoundaryCondition.PERIODIC,
            BoundaryCondition.PERIODIC,
            BoundaryCondition.PERIODIC,
        ),
        rng_seed=5,
        use_random_seed=False,
    )


def test_triangle_fused_matches_unfused(monkeypatch, cfg2d):
    """Triangle trace through the kernel == the XLA path (single-hit
    deposit, backface kill; rayTraceKernel.hpp:243-307)."""
    geo = _trench_tri()
    p = vrt.DiffuseParticle(0.2)
    _use_kernel(monkeypatch, False)
    f_ref, c_ref = _trace_once(geo, "triangle", cfg2d, p)
    _use_kernel(monkeypatch, True)
    f_k, c_k = _trace_once(geo, "triangle", cfg2d, p)
    _assert_same_trace(f_k, c_k, f_ref, c_ref)


def test_disk_neighbor_flux_model_fused_matches_unfused(monkeypatch, cfg2d):
    """Neighbor-list deposits behind the kernel's hits == behind the brute
    force's (the CPU reference contract, rayTraceKernel.hpp:255-300)."""
    pts, nrm = fixtures.create_trench_grid_2d(grid_delta=0.1)
    geo = vrt.DiskGeometry.build(pts, nrm, 0.1, dim=2)
    p = vrt.DiffuseParticle(0.1)
    _use_kernel(monkeypatch, False)
    f_ref, c_ref = _trace_once(geo, "disk", cfg2d, p)
    _use_kernel(monkeypatch, True)
    f_k, c_k = _trace_once(geo, "disk", cfg2d, p)
    _assert_same_trace(f_k, c_k, f_ref, c_ref)


def test_gas_scattering_fused_matches_unfused(monkeypatch, cfg2d):
    """mean_free_path > 0 (rayTraceKernel.hpp:179-203): scattering uses the
    kernel's hit distance as the free path."""
    pts, nrm = fixtures.create_trench_grid_2d(grid_delta=0.1)
    geo = vrt.DiskGeometry.build(pts, nrm, 0.1, dim=2)
    p = vrt.DiffuseParticle(0.3).replace(mean_free_path=5.0)
    _use_kernel(monkeypatch, False)
    f_ref, c_ref = _trace_once(geo, "disk", cfg2d, p)
    assert int(c_ref.particle_hits) > 0  # scattering actually happened
    _use_kernel(monkeypatch, True)
    f_k, c_k = _trace_once(geo, "disk", cfg2d, p)
    _assert_same_trace(f_k, c_k, f_ref, c_ref)


def test_coned_cosine_fused_matches_unfused(monkeypatch, cfg2d):
    """CONED_COSINE reflection (rayReflection.hpp:54-122) behind the
    kernel's hits."""
    pts, nrm = fixtures.create_trench_grid_2d(grid_delta=0.1)
    geo = vrt.DiskGeometry.build(pts, nrm, 0.1, dim=2)
    p = vrt.SpecularParticle(0.5, 100.0).replace(
        reflection_kind=int(ReflectionKind.CONED_COSINE),
        cone_angle=jnp.asarray(np.pi / 6, jnp.float32),
    )
    _use_kernel(monkeypatch, False)
    f_ref, c_ref = _trace_once(geo, "disk", cfg2d, p)
    _use_kernel(monkeypatch, True)
    f_k, c_k = _trace_once(geo, "disk", cfg2d, p)
    # near-specular paths carry last-bit differences of the hit time
    # (the two implementations sum the plane equation in another order)
    # into later hit points, so the flux agrees to f32 op-order noise
    _assert_same_trace(f_k, c_k, f_ref, c_ref, tol=5e-3)


def test_coned_cosine_reflection_arithmetic_exact():
    """reflection.coned_cosine reproduces the reference combine
    d = sinT (cosP t + sinP b) + cosT w (rayReflection.hpp:86-120) for the
    theta/phi drawn from its own key schedule, on a flat plane."""
    R = 256
    key = jax.random.PRNGKey(9)
    dirn = jnp.tile(jnp.asarray([[0.3, 0.1, -0.9486833]], jnp.float32),
                    (R, 1))
    dirn = dirn / jnp.linalg.norm(dirn, axis=1, keepdims=True)
    n = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (R, 1))
    cone = jnp.float32(np.pi / 5)
    got = reflection.coned_cosine(key, dirn, n, cone)

    k_theta, k_phi, _ = jax.random.split(key, 3)
    theta = sampling.coned_cosine_theta(k_theta, (R,), cone)
    phi = 2.0 * jnp.pi * jax.random.uniform(k_phi, (R,))
    wvec = vec.normalize(vec.reflect_specular(dirn, n), eps=1e-12)
    t_b, b_b = vec.frisvad_basis(wvec)
    st_ = jnp.sin(theta)[:, None]
    ct_ = jnp.cos(theta)[:, None]
    d_exp = st_ * (
        jnp.cos(phi)[:, None] * t_b + jnp.sin(phi)[:, None] * b_b
    ) + ct_ * wvec
    dp = jnp.sum(d_exp * n, axis=-1, keepdims=True)
    d_exp = jnp.where(dp <= 0.0, d_exp - 2.0 * dp * n, d_exp)
    d_exp = vec.normalize(d_exp, eps=1e-12)
    np.testing.assert_allclose(np.asarray(got), np.asarray(d_exp), atol=2e-6)
    # every direction leaves the surface within the cone around w
    assert (np.asarray(got)[:, 2] > 0).all()
    cos_to_w = np.sum(np.asarray(got) * np.asarray(wvec), axis=1)
    assert (cos_to_w >= np.cos(np.pi / 5) - 1e-5).mean() > 0.95


def test_window_flux_model_optin(monkeypatch, cfg2d):
    """flux_model='window' selects the GPU candidate-window deposits
    (GeneralPipelineDisk.cu:51-59,86-93) — more deposits than neighbor mode
    on curved geometry."""
    pts, nrm = fixtures.create_trench_grid_2d(grid_delta=0.1)
    geo = vrt.DiskGeometry.build(pts, nrm, 0.1, dim=2)
    p = vrt.DiffuseParticle(0.1)
    _use_kernel(monkeypatch, True)
    import dataclasses

    cfg_w = dataclasses.replace(cfg2d, flux_model="window")
    f_nb, _ = _trace_once(geo, "disk", cfg2d, p)
    f_w, _ = _trace_once(geo, "disk", cfg_w, p)
    assert f_w.sum() > 0 and f_nb.sum() > 0
    assert not np.array_equal(f_w, f_nb)


def test_flux_model_validation():
    with pytest.raises(ValueError):
        TraceConfig(flux_model="bogus")


def test_light_geometry_build_runs_fused(monkeypatch, cfg2d):
    """pack_neighbors=False / accel=False (the Embree-scale build) still
    traces through the kernel and matches the full build's flux."""
    pts, nrm = fixtures.create_trench_grid_2d(grid_delta=0.1)
    full = vrt.DiskGeometry.build(pts, nrm, 0.1, dim=2)
    light = vrt.DiskGeometry.build(
        pts, nrm, 0.1, dim=2, accel=False, pack_neighbors=False
    )
    assert light.neighbor_pack is None and light.grid is None
    p = vrt.DiffuseParticle(0.1)
    _use_kernel(monkeypatch, True)
    f_full, _ = _trace_once(full, "disk", cfg2d, p, R=1024)
    f_light, _ = _trace_once(light, "disk", cfg2d, p, R=1024)
    np.testing.assert_array_equal(f_full, f_light)
