"""Statistical parity against the independent scalar oracle.

The oracle (tests/oracle_ref.cpp, driven by tests/oracle_ref.py) is a
from-scratch per-ray C++ implementation of the reference trace semantics
(rayTraceKernel.hpp:118-341) sharing no code with viennaray_tpu. Flux is
compared at matched ray counts: the oracle runs twice with different seeds to
measure its own Monte-Carlo noise, and the cross-implementation distance must
sit inside that noise band — a shared misreading of the semantics (deposit
rules, neighbor multi-hit, roulette, boundary handling) would show up as a
systematic offset well above it. Event-rate accounting (geometry hits,
boundary hits, reflections per ray) is compared as well.
"""

import numpy as np
import pytest

import viennaray_tpu as vrt
from viennaray_tpu.io import fixtures

from oracle_ref import available, trace_disks_oracle

pytestmark = pytest.mark.skipif(
    not available(), reason="oracle build unavailable"
)

BATCH = 32768


def _rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)


def _run_tracer(pts, nrm, *, dim, grid_delta, sticking, num_rays, boundary,
             reflection="diffuse", use_wdist=False, seed=42):
    t = vrt.TraceDisk(dim=dim)
    t.set_geometry(pts.astype(np.float32), nrm.astype(np.float32), grid_delta)
    bc = {
        "reflective": vrt.BoundaryCondition.REFLECTIVE,
        "periodic": vrt.BoundaryCondition.PERIODIC,
        "ignore": vrt.BoundaryCondition.IGNORE,
    }
    conds = [bc[b] for b in boundary]
    while len(conds) < dim:
        conds.append(conds[-1])
    t.set_boundary_conditions(conds[:dim])
    if reflection == "specular":
        t.set_particle_type(vrt.SpecularParticle(sticking, 1.0, "flux"))
    else:
        t.set_particle_type(vrt.DiffuseParticle(sticking, "flux"))
    t.set_source_direction(
        vrt.TraceDirection.POS_Z if dim == 3 else vrt.TraceDirection.POS_Y
    )
    t.set_number_of_rays_fixed(num_rays)
    t.set_rng_seed(seed)
    t.set_ray_batch_size(BATCH)
    t.set_use_wdist(use_wdist)
    flux = t.apply()
    return np.asarray(flux, np.float64), t.get_ray_trace_info()


def _parity_case(pts, nrm, *, dim, grid_delta, sticking, boundary,
                 rays_oracle, rays_traced, reflection="diffuse",
                 use_wdist=False, noise_cap=0.05):
    disk_radius = grid_delta * vrt.config.disk_factor(dim)
    kw = dict(
        dim=dim, disk_radius=disk_radius, sticking=sticking,
        boundary=boundary, reflection=reflection, use_wdist=use_wdist,
    )
    o1, c1 = trace_disks_oracle(
        pts, nrm, disk_radius, num_rays=rays_oracle, seed=101, **kw
    )
    o2, c2 = trace_disks_oracle(
        pts, nrm, disk_radius, num_rays=rays_oracle, seed=202, **kw
    )
    tf, info = _run_tracer(
        pts, nrm, dim=dim, grid_delta=grid_delta, sticking=sticking,
        num_rays=rays_traced, boundary=boundary, reflection=reflection,
        use_wdist=use_wdist,
    )

    # per-ray normalization so different ray counts compare directly
    o1n = o1 / rays_oracle
    o2n = o2 / rays_oracle
    tn = tf / info.num_rays

    noise = _rel_l2(o1n, o2n)  # ~ sqrt(2) x one-run MC noise
    cross = _rel_l2(o1n, tn)
    assert noise < noise_cap, f"oracle self-noise too high: {noise:.4f}"
    # with rays_traced >= rays_oracle, E[cross] <= noise; 1.45x headroom
    assert cross < max(1.45 * noise, 0.004), (
        f"flux parity violated: cross={cross:.4f} vs self-noise={noise:.4f}"
    )

    # event accounting per ray (ref counters, rayUtil.hpp:65-76)
    geo_o = (c1["geometry_hits"] + c2["geometry_hits"]) / (2 * rays_oracle)
    geo_t = info.geometry_hits / info.num_rays
    assert abs(geo_t - geo_o) / geo_o < 0.02
    bd_o = (c1["boundary_hits"] + c2["boundary_hits"]) / (2 * rays_oracle)
    bd_t = info.boundary_hits / info.num_rays
    assert abs(bd_t - bd_o) / max(bd_o, 0.05) < 0.05
    refl_o = (c1["reflections"] + c2["reflections"]) / (2 * rays_oracle)
    refl_t = info.reflections / info.num_rays
    assert abs(refl_t - refl_o) / max(refl_o, 0.05) < 0.02
    return cross, noise


def test_parity_trench2d_reflective():
    """2D trench, diffuse sticking 0.2, reflective walls (trace2D analog)."""
    pts, nrm = fixtures.create_trench_grid_2d()
    _parity_case(
        pts, nrm, dim=2, grid_delta=0.1, sticking=0.2,
        boundary=("reflective", "reflective"),
        rays_oracle=120_000, rays_traced=131_072,
    )


def test_parity_trench2d_periodic_low_sticking():
    """2D trench, sticking 0.1, periodic walls (disk2D example config)."""
    pts, nrm = fixtures.create_trench_grid_2d()
    _parity_case(
        pts, nrm, dim=2, grid_delta=0.1, sticking=0.1,
        boundary=("periodic", "periodic"),
        rays_oracle=100_000, rays_traced=131_072,
    )


def test_parity_trench3d_periodic():
    """3D trench, diffuse sticking 0.2, periodic walls (disk3D analog)."""
    pts, nrm = fixtures.create_trench_grid_3d()
    _parity_case(
        pts, nrm, dim=3, grid_delta=0.5, sticking=0.2,
        boundary=("periodic", "periodic"),
        rays_oracle=120_000, rays_traced=131_072, noise_cap=0.08,
    )


def test_parity_trench2d_specular():
    """Specular ion-like reflection, sticking 0.5."""
    pts, nrm = fixtures.create_trench_grid_2d()
    _parity_case(
        pts, nrm, dim=2, grid_delta=0.1, sticking=0.5,
        boundary=("reflective", "reflective"),
        rays_oracle=100_000, rays_traced=131_072, reflection="specular",
    )


def test_parity_trench2d_wdist():
    """1/distance-weighted multi-hit deposits (VIENNARAY_USE_WDIST path)."""
    pts, nrm = fixtures.create_trench_grid_2d()
    _parity_case(
        pts, nrm, dim=2, grid_delta=0.1, sticking=0.3,
        boundary=("reflective", "reflective"),
        rays_oracle=80_000, rays_traced=131_072, use_wdist=True,
    )


def test_parity_trench2d_coned_cosine():
    """Coned-cosine ion lobe (rayReflection.hpp:54-122), sticking 0.5,
    cone pi/6 — the ion bench physics, previously uncovered by the oracle."""
    import jax.numpy as jnp

    from viennaray_tpu.config import ReflectionKind

    pts, nrm = fixtures.create_trench_grid_2d()
    disk_radius = 0.1 * vrt.config.disk_factor(2)
    kw = dict(
        dim=2, disk_radius=disk_radius, sticking=0.5,
        boundary=("reflective", "reflective"), reflection="coned",
        cone_angle=np.pi / 6, cosine_exponent=1.0,
    )
    o1, c1 = trace_disks_oracle(pts, nrm, disk_radius, num_rays=100_000,
                                seed=101, **kw)
    o2, c2 = trace_disks_oracle(pts, nrm, disk_radius, num_rays=100_000,
                                seed=202, **kw)

    ion = vrt.SpecularParticle(0.5, 1.0, "flux").replace(
        reflection_kind=int(ReflectionKind.CONED_COSINE),
        cone_angle=jnp.asarray(np.pi / 6, jnp.float32),
    )
    t = vrt.TraceDisk(dim=2)
    t.set_geometry(pts.astype(np.float32), nrm.astype(np.float32), 0.1)
    t.set_boundary_conditions([vrt.BoundaryCondition.REFLECTIVE] * 2)
    t.set_particle_type(ion)
    t.set_source_direction(vrt.TraceDirection.POS_Y)
    t.set_number_of_rays_fixed(131_072)
    t.set_rng_seed(42)
    t.set_ray_batch_size(BATCH)
    tf = np.asarray(t.apply(), np.float64)
    info = t.get_ray_trace_info()

    o1n, o2n, tn = o1 / 100_000, o2 / 100_000, tf / info.num_rays
    noise = _rel_l2(o1n, o2n)
    cross = _rel_l2(o1n, tn)
    assert noise < 0.05, f"oracle self-noise too high: {noise:.4f}"
    assert cross < max(1.45 * noise, 0.004), (
        f"coned-cosine parity violated: cross={cross:.4f} noise={noise:.4f}"
    )
    geo_o = (c1["geometry_hits"] + c2["geometry_hits"]) / (2 * 100_000)
    geo_t = info.geometry_hits / info.num_rays
    assert abs(geo_t - geo_o) / geo_o < 0.02


def test_parity_trench2d_gas_scattering():
    """Gas-phase lambda scattering (rayTraceKernel.hpp:179-203): the
    mean_free_path hook, previously plumbed but never exercised."""
    pts, nrm = fixtures.create_trench_grid_2d()
    disk_radius = 0.1 * vrt.config.disk_factor(2)
    kw = dict(
        dim=2, disk_radius=disk_radius, sticking=0.3,
        boundary=("reflective", "reflective"), reflection="diffuse",
        mean_free_path=2.0,
    )
    o1, c1 = trace_disks_oracle(pts, nrm, disk_radius, num_rays=100_000,
                                seed=101, **kw)
    o2, c2 = trace_disks_oracle(pts, nrm, disk_radius, num_rays=100_000,
                                seed=202, **kw)
    assert c1["scattered"] > 0  # scattering actually fires

    t = vrt.TraceDisk(dim=2)
    t.set_geometry(pts.astype(np.float32), nrm.astype(np.float32), 0.1)
    t.set_boundary_conditions([vrt.BoundaryCondition.REFLECTIVE] * 2)
    t.set_particle_type(
        vrt.DiffuseParticle(0.3, "flux").replace(mean_free_path=2.0)
    )
    t.set_source_direction(vrt.TraceDirection.POS_Y)
    t.set_number_of_rays_fixed(131_072)
    t.set_rng_seed(42)
    t.set_ray_batch_size(BATCH)
    tf = np.asarray(t.apply(), np.float64)
    info = t.get_ray_trace_info()
    assert info.particle_hits > 0  # tracer-side scatter events

    o1n, o2n, tn = o1 / 100_000, o2 / 100_000, tf / info.num_rays
    noise = _rel_l2(o1n, o2n)
    cross = _rel_l2(o1n, tn)
    assert noise < 0.05, f"oracle self-noise too high: {noise:.4f}"
    assert cross < max(1.45 * noise, 0.004), (
        f"gas-scatter parity violated: cross={cross:.4f} noise={noise:.4f}"
    )
    # scatter-rate accounting: events per ray must agree
    sc_o = (c1["scattered"] + c2["scattered"]) / (2 * 100_000)
    sc_t = info.particle_hits / info.num_rays
    assert abs(sc_t - sc_o) / max(sc_o, 1e-9) < 0.05
    geo_o = (c1["geometry_hits"] + c2["geometry_hits"]) / (2 * 100_000)
    geo_t = info.geometry_hits / info.num_rays
    assert abs(geo_t - geo_o) / geo_o < 0.03


def test_parity_trench3d_triangles():
    """Triangle mesh semantics (single closest-hit deposit + backface
    kill, rayTraceKernel.hpp:243-248,301-307) against the independent
    triangle oracle — the tri3d bench config's physics."""
    from oracle_ref import trace_tris_oracle

    verts, tris = fixtures.create_trench_mesh_3d(grid_delta=0.5)
    kw = dict(
        dim=3, grid_delta=0.5, sticking=0.2,
        boundary=("periodic", "periodic"), reflection="diffuse",
    )
    # 1440 triangles with single-hit deposits collect ~6x fewer deposits
    # per prim than the disk cases (no neighbor multi-hit), so more rays
    # are needed for the same noise band
    o1, c1 = trace_tris_oracle(verts, tris, num_rays=200_000, seed=101, **kw)
    o2, c2 = trace_tris_oracle(verts, tris, num_rays=200_000, seed=202, **kw)

    t = vrt.TraceTriangle(dim=3)
    t.set_geometry(verts, tris, 0.5)
    t.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 3)
    t.set_particle_type(vrt.DiffuseParticle(0.2, "flux"))
    t.set_number_of_rays_fixed(262_144)
    t.set_rng_seed(42)
    t.set_ray_batch_size(BATCH)
    tf = np.asarray(t.apply(), np.float64)
    info = t.get_ray_trace_info()

    o1n, o2n, tn = o1 / 200_000, o2 / 200_000, tf / info.num_rays
    noise = _rel_l2(o1n, o2n)
    cross = _rel_l2(o1n, tn)
    assert noise < 0.11, f"oracle self-noise too high: {noise:.4f}"
    assert cross < max(1.45 * noise, 0.004), (
        f"triangle parity violated: cross={cross:.4f} noise={noise:.4f}"
    )
    geo_o = (c1["geometry_hits"] + c2["geometry_hits"]) / (2 * 200_000)
    geo_t = info.geometry_hits / info.num_rays
    assert abs(geo_t - geo_o) / geo_o < 0.02
    refl_o = (c1["reflections"] + c2["reflections"]) / (2 * 200_000)
    refl_t = info.reflections / info.num_rays
    assert abs(refl_t - refl_o) / max(refl_o, 0.05) < 0.02


def test_parity_fused_interpret_direct(monkeypatch):
    """Oracle vs the trace with the nearest-hit kernel (interpret mode,
    small ray count): closes the oracle -> brute force -> kernel chain
    without the brute-force intermediary. The kernel wrapper is wrapped to
    count calls, asserting the kernel path actually engaged."""
    from viennaray_tpu.ops import hit_kernel

    calls = []
    real = hit_kernel.nearest_hit

    def counted(*a, **k):
        calls.append(k.get("kind"))
        return real(*a, **k)

    monkeypatch.setattr(hit_kernel, "nearest_hit", counted)
    monkeypatch.setattr(hit_kernel, "disk_kernel", lambda n: "interpret")
    # 2-stage ladder: fewer distinct kernel shapes (compile time), physics
    # unchanged (streams differ; comparison is statistical)
    monkeypatch.setenv("VIENNARAY_TPU_STAGE_SHRINK", "16")
    # grid_delta 0.12 -> a geometry shape no other test traces, so the
    # jit cache cannot serve an executable traced without the kernel
    pts, nrm = fixtures.create_trench_grid_2d(grid_delta=0.12)
    disk_radius = 0.12 * vrt.config.disk_factor(2)
    kw = dict(
        dim=2, disk_radius=disk_radius, sticking=0.25,
        boundary=("reflective", "reflective"), reflection="diffuse",
    )
    # oracle noise measured at the traced ray count (8192) for a fair
    # band; one large run pins the mean
    o1, c1 = trace_disks_oracle(pts, nrm, disk_radius,
                                num_rays=200_000, seed=101, **kw)
    s1, _ = trace_disks_oracle(pts, nrm, disk_radius,
                               num_rays=8192, seed=303, **kw)
    s2, _ = trace_disks_oracle(pts, nrm, disk_radius,
                               num_rays=8192, seed=404, **kw)

    t = vrt.TraceDisk(dim=2)
    t.set_geometry(pts.astype(np.float32), nrm.astype(np.float32), 0.12)
    t.set_boundary_conditions([vrt.BoundaryCondition.REFLECTIVE] * 2)
    t.set_particle_type(vrt.DiffuseParticle(0.25, "flux"))
    t.set_source_direction(vrt.TraceDirection.POS_Y)
    t.set_number_of_rays_fixed(8192)
    t.set_rng_seed(42)
    t.set_ray_batch_size(8192)
    tf = np.asarray(t.apply(), np.float64)
    info = t.get_ray_trace_info()
    assert "disk" in calls, "nearest-hit kernel did not engage"

    o1n = o1 / 200_000
    tn = tf / info.num_rays
    # small-run MC noise band vs the pinned oracle mean
    noise_small = max(_rel_l2(o1n, s1 / 8192), _rel_l2(o1n, s2 / 8192))
    cross = _rel_l2(o1n, tn)
    assert cross < 1.45 * noise_small, (
        f"kernel-direct parity violated: cross={cross:.4f} "
        f"noise={noise_small:.4f}"
    )
    geo_o = c1["geometry_hits"] / 200_000
    geo_t = info.geometry_hits / info.num_rays
    assert abs(geo_t - geo_o) / geo_o < 0.05
