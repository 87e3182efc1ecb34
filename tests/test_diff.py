"""Gradient tests: flux gradients vs finite differences (BASELINE.md target;
net-new capability vs the reference)."""

import jax
import jax.numpy as jnp
import numpy as np

import viennaray_tpu as vrt
from viennaray_tpu.config import (
    TraceConfig,
    adjust_bounding_box,
    get_trace_settings,
)
from viennaray_tpu.diff.trace_grad import trace_flux
from viennaray_tpu.io import fixtures
from viennaray_tpu.physics.source import RandomSource


def _setup(sticking=0.3):
    """A concave 2D trench: multi-bounce happens inside the cavity, so flux
    genuinely depends on sticking (on a convex plane d flux/d s is exactly 0
    because reflected rays never land again)."""
    grid_delta = 0.1
    pts, nrm = fixtures.create_trench_grid_2d(grid_delta=grid_delta)
    geometry = vrt.DiskGeometry.build(pts, nrm, grid_delta, dim=2)
    particle = vrt.DiffuseParticle(sticking, "flux")
    config = TraceConfig(
        dim=2,
        num_rays_fixed=2048,
        rng_seed=11,
        use_random_seed=False,
        ray_batch_size=2048,
        roulette=False,
        source_direction=vrt.TraceDirection.POS_Y,
        boundary_conditions=(vrt.BoundaryCondition.REFLECTIVE,) * 3,
    )
    bbox = adjust_bounding_box(
        np.asarray(geometry.bbox), config.source_direction,
        geometry.disk_radius, 2,
    )
    s = get_trace_settings(config.source_direction)
    source = RandomSource(
        bbox=jnp.asarray(bbox, jnp.float32),
        cosine_power=particle.cosine_exponent,
        ray_dir=s[0], first_dir=s[1], second_dir=s[2], min_max=s[3],
        pos_neg=float(s[4]), dim=2, num_points=geometry.num_primitives,
    )
    return geometry, source, particle, jnp.asarray(bbox, jnp.float32), config


def test_grad_sticking_matches_finite_difference():
    """d sum(flux) / d sticking vs central differences with a SHARED RNG key
    (the path is identical under small sticking perturbations, so FD is exact
    up to f32 noise)."""
    geometry, source, particle, bbox, config = _setup()
    key = jax.random.PRNGKey(11)
    R = config.num_rays_fixed
    ray_indices = jnp.arange(R, dtype=jnp.int32)
    valid = jnp.ones((R,), bool)

    def total_flux(s):
        p = particle.replace(sticking=jnp.asarray(s, jnp.float32))
        f = trace_flux(
            geometry, source, p, bbox, key, ray_indices, valid, config,
            "disk", num_bounces=8,
        )
        return jnp.sum(f)

    fn = jax.jit(total_flux)
    grad = jax.jit(jax.grad(total_flux))(0.3)
    eps = 3e-3
    fd = (float(fn(0.3 + eps)) - float(fn(0.3 - eps))) / (2 * eps)
    assert np.isfinite(float(grad))
    # more sticking -> fewer bounces -> less recorded flux: negative gradient
    assert float(grad) < 0
    # flux(s) is polynomial in s under a shared key (paths identical), so AD
    # must equal central differences up to f32 noise (measured 0.003%)
    np.testing.assert_allclose(float(grad), fd, rtol=5e-3)


def test_grad_material_table_matches_fd():
    """d flux / d material_sticking[m] through the per-material gather
    (the GPU per-material sticking map, rayParticle.hpp:213)."""
    geometry, source, particle, bbox, config = _setup()
    # two materials: left half 0, right half 1
    mats = (np.asarray(geometry.points)[:, 0] > 0).astype(np.int32)
    geometry = geometry.replace(material_ids=jnp.asarray(mats))
    key = jax.random.PRNGKey(11)
    R = config.num_rays_fixed
    ray_indices = jnp.arange(R, dtype=jnp.int32)
    valid = jnp.ones((R,), bool)

    def total_flux(table):
        p = particle.replace(material_sticking=table)
        f = trace_flux(
            geometry, source, p, bbox, key, ray_indices, valid, config,
            "disk", num_bounces=8,
        )
        return jnp.sum(f)

    table0 = jnp.asarray([0.2, 0.5], jnp.float32)
    fn = jax.jit(total_flux)
    grad = np.asarray(jax.jit(jax.grad(total_flux))(table0))
    eps = 3e-3
    for m in range(2):
        e = jnp.zeros(2).at[m].set(eps)
        fd = (float(fn(table0 + e)) - float(fn(table0 - e))) / (2 * eps)
        assert grad[m] < 0
        np.testing.assert_allclose(grad[m], fd, rtol=5e-3)


def test_grad_points_wdist_matches_fd():
    """d flux / d point positions through the smooth 1/distance multi-hit
    weighting channel (VIENNARAY_USE_WDIST, rayTraceKernel.hpp:258-296).

    Scope of the contract (SURVEY §7 design stance): gradients are exact for
    the SMOOTH channel; discrete path changes are straight-through. A rigid
    shift of the whole geometry flips visibility for many rays at once (FD
    diverges — measured), so the FD check perturbs ONE interior point, where
    at eps = 3e-3 * gridDelta-scale no ray crosses a rim for this seed and
    AD matches central differences to 0.002% (measured)."""
    geometry, source, particle, bbox, config = _setup()
    config = config.__class__(**{**config.__dict__, "use_wdist": True})
    key = jax.random.PRNGKey(7)
    R = config.num_rays_fixed
    ray_indices = jnp.arange(R, dtype=jnp.int32)
    valid = jnp.ones((R,), bool)
    pts = np.asarray(geometry.points)
    # an interior trench-bottom point
    bot = np.where(
        (np.abs(pts[:, 1] - pts[:, 1].min()) < 1e-6)
        & (np.abs(pts[:, 0]) < 0.5)
    )[0]
    pi = int(bot[len(bot) // 2])
    # a fixed random per-prim loss weighting makes the loss sensitive to
    # WHERE weight lands, not just how much of it
    lw = jax.random.uniform(jax.random.PRNGKey(3),
                            (geometry.num_primitives,))

    def loss(du):
        g = geometry.replace(points=geometry.points.at[pi, 0].add(du))
        f = trace_flux(
            g, source, particle, bbox, key, ray_indices, valid, config,
            "disk", num_bounces=4,
        )
        return jnp.sum(f * lw)

    fn = jax.jit(loss)
    grad = float(jax.jit(jax.grad(loss))(jnp.float32(0.0)))
    assert np.isfinite(grad) and grad != 0.0
    eps = 3e-3
    fd = (float(fn(jnp.float32(eps))) - float(fn(jnp.float32(-eps)))) / (
        2 * eps
    )
    np.testing.assert_allclose(grad, fd, rtol=0.01)


def test_diff_flux_matches_nondiff_flux(monkeypatch):
    """With roulette off and enough bounces, the scan path and the while_loop
    path produce identical flux for the same key. Runs at the no-compaction
    width (<= 512): compaction permutes lanes and with them the lane-indexed
    randomness, which the fixed-length scan path never does."""
    geometry, source, particle, bbox, config = _setup(sticking=0.9)
    config = config.__class__(**{**config.__dict__, "num_rays_fixed": 512,
                                 "ray_batch_size": 512})
    from viennaray_tpu.trace.kernel import trace_batch

    key = jax.random.PRNGKey(4)
    R = config.num_rays_fixed
    ray_indices = jnp.arange(R, dtype=jnp.int32)
    valid = jnp.ones((R,), bool)
    f_while, _ = jax.jit(
        lambda: trace_batch(
            geometry, source, particle, bbox, key, ray_indices, valid,
            config, "disk",
        )
    )()
    f_scan = jax.jit(
        lambda: trace_flux(
            geometry, source, particle, bbox, key, ray_indices, valid,
            config, "disk", num_bounces=64,
        )
    )()
    np.testing.assert_allclose(
        np.asarray(f_while), np.asarray(f_scan), rtol=1e-6
    )


def test_grad_wrt_points_finite():
    """Geometry gradients exist and are finite (straight-through for
    visibility; smooth for hit positions)."""
    geometry, source, particle, bbox, config = _setup()
    key = jax.random.PRNGKey(2)
    R = 1024
    ray_indices = jnp.arange(R, dtype=jnp.int32)
    valid = jnp.ones((R,), bool)

    def loss(points):
        g = geometry.replace(points=points)
        f = trace_flux(
            g, source, particle, bbox, key, ray_indices, valid, config,
            "disk", num_bounces=4,
        )
        return jnp.sum(f * f)

    grad = jax.jit(jax.grad(loss))(geometry.points)
    assert np.isfinite(np.asarray(grad)).all()


def test_grad_normals_matches_fd():
    """d flux / d normals through the smooth channels (plane-intersection t
    and the 1/distance multi-hit weighting; PARITY's normals-gradient claim,
    previously untested).

    Validated in float64 tracing mode (the dtype-polymorphic unfused path —
    the analog of the reference's NumericType=double instantiation) at an
    ASYMMETRIC interior point: at the trench-center point the symmetric
    neighbor selection ties sit exactly at the perturbation origin, so the
    function has a kink at 0 and central FD measures the average of the two
    one-sided slopes (AD correctly returns one side; verified by one-sided
    differences). Off-center, FD converges (checked at eps 1e-5..1e-7) and
    AD matches to <0.1%."""
    jax.config.update("jax_enable_x64", True)
    try:
        geometry, source, particle, bbox, config = _setup()
        config = config.__class__(**{**config.__dict__, "use_wdist": True})
        cast = lambda t: jax.tree.map(
            lambda a: a.astype(jnp.float64)
            if hasattr(a, "dtype") and a.dtype == jnp.float32
            else a,
            t,
        )
        geometry, source, particle = (
            cast(geometry), cast(source), cast(particle),
        )
        bbox = bbox.astype(jnp.float64)
        key = jax.random.PRNGKey(7)
        R = config.num_rays_fixed
        ray_indices = jnp.arange(R, dtype=jnp.int32)
        valid = jnp.ones((R,), bool)
        pts = np.asarray(geometry.points)
        bot = np.where(
            (np.abs(pts[:, 1] - pts[:, 1].min()) < 1e-6)
            & (np.abs(pts[:, 0] + 0.5) < 0.2)
        )[0]
        pi = int(bot[0])
        lw = jax.random.uniform(
            jax.random.PRNGKey(5), (geometry.num_primitives,),
            dtype=jnp.float64,
        )

        def loss(du):
            # tilt the normal in-plane; NOT renormalized so FD and AD
            # differentiate the identical function
            g = geometry.replace(
                normals=geometry.normals.at[pi, 0].add(du)
            )
            f = trace_flux(
                g, source, particle, bbox, key, ray_indices, valid, config,
                "disk", num_bounces=4,
            )
            return jnp.sum(f * lw)

        fn = jax.jit(loss)
        grad = float(jax.jit(jax.grad(loss))(jnp.float64(0.0)))
        assert np.isfinite(grad) and grad != 0.0
        # Selection ties can sit exactly at du=0 (grid geometry), making the
        # loss piecewise-smooth with a kink at the origin; AD then returns
        # one of the two one-sided derivatives (the straight-through
        # contract). Validate against BOTH one-sided differences and accept
        # a match with either.
        eps = 1e-6
        f0 = float(fn(jnp.float64(0.0)))
        fwd = (float(fn(jnp.float64(eps))) - f0) / eps
        bwd = (f0 - float(fn(jnp.float64(-eps)))) / eps
        err = min(
            abs(grad - fwd) / max(abs(fwd), 1e-12),
            abs(grad - bwd) / max(abs(bwd), 1e-12),
        )
        assert err < 1e-3, (grad, fwd, bwd)
    finally:
        jax.config.update("jax_enable_x64", False)


def test_grad_sticking_batched_driver():
    """The batched gradient driver accumulates value_and_grad over
    mega-batches — the gradient analog of the tracer's launch-clamp loop —
    and matches the single-batch gradient when the batch covers all rays."""
    from viennaray_tpu.diff.trace_grad import flux_and_grad_sticking_batched

    geometry, source, particle, bbox, config = _setup()
    key = jax.random.PRNGKey(11)
    R = config.num_rays_fixed

    f1, g1 = flux_and_grad_sticking_batched(
        geometry, source, particle, bbox, key, R, config, "disk",
        num_bounces=4,
    )
    # two mega-batches must give the same total as one (linear in batches)
    cfg2 = config.__class__(
        **{**config.__dict__, "ray_batch_size": R // 2}
    )
    f2, g2 = flux_and_grad_sticking_batched(
        geometry, source, particle, bbox, key, R, cfg2, "disk",
        num_bounces=4,
    )
    assert np.isfinite(g1) and np.isfinite(g2)
    assert f1.shape == f2.shape == (geometry.num_primitives,)
    # different batch split -> different RNG per batch; totals agree
    # statistically, not bitwise
    rel = abs(g2 - g1) / max(abs(g1), 1e-9)
    assert rel < 0.35, (g1, g2)


def test_grad_through_hit_kernel_matches_brute_force(monkeypatch):
    """The differentiable trace with the nearest-hit kernel (interpret mode;
    hit selection on stop_gradient inputs, hit time recomputed from the
    selected prim) gives the flux and the sticking and point gradients of
    the brute-force path, whose min() routes the same gradient."""
    from viennaray_tpu.ops import hit_kernel

    geometry, source, particle, bbox, config = _setup()
    # 1/distance-weighted deposits make the flux depend on hit positions
    config = config.__class__(**{**config.__dict__, "use_wdist": True})
    key = jax.random.PRNGKey(5)
    R = 1024
    ray_indices = jnp.arange(R, dtype=jnp.int32)
    valid = jnp.ones((R,), bool)

    def grads():
        def loss(s, pts):
            f = trace_flux(
                geometry.replace(points=pts), source,
                particle.replace(sticking=s), bbox, key, ray_indices, valid,
                config, "disk", num_bounces=6,
            )
            return jnp.sum(f * jnp.linspace(0.5, 1.5, f.shape[0]))

        return jax.value_and_grad(loss, argnums=(0, 1))(
            particle.sticking, geometry.points)

    v_ref, (gs_ref, gp_ref) = grads()
    monkeypatch.setattr(hit_kernel, "disk_kernel", lambda n: "interpret")
    v_k, (gs_k, gp_k) = grads()
    np.testing.assert_allclose(float(v_k), float(v_ref), rtol=1e-5)
    np.testing.assert_allclose(float(gs_k), float(gs_ref), rtol=1e-4)
    assert np.abs(np.asarray(gp_ref)).max() > 0
    np.testing.assert_allclose(np.asarray(gp_k), np.asarray(gp_ref),
                               rtol=1e-3, atol=1e-3 * np.abs(
                                   np.asarray(gp_ref)).max())
