#!/usr/bin/env python
"""Gradient benchmark: d sum(flux)/d sticking at 1e7 rays (BASELINE config
5's "gradient of a large-ray-count flux"), accumulated over mega-batches by
diff/trace_grad.flux_and_grad_sticking_batched, on the flagship trench.

Prints one JSON line with rays/s (fwd+bwd), the gradient and the device.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def setup(grid_delta=0.25, total_rays=10_000_000, batch=524288):
    """(geometry, source, particle, bbox, config) of the gradient
    benchmark: the flagship 3D disk trench, diffuse sticking 0.1, periodic,
    roulette off."""
    import jax.numpy as jnp

    import viennaray_tpu as vrt
    from viennaray_tpu.config import (
        TraceConfig, adjust_bounding_box, get_trace_settings,
    )
    from viennaray_tpu.io import fixtures
    from viennaray_tpu.physics.source import RandomSource

    pts, nrm = fixtures.create_trench_grid_3d(
        grid_delta=grid_delta, extent=5.0, trench_width=4.0, trench_depth=4.0
    )
    geometry = vrt.DiskGeometry.build(pts, nrm, grid_delta, dim=3)
    particle = vrt.DiffuseParticle(0.1, "flux")
    config = TraceConfig(
        dim=3, num_rays_fixed=total_rays,
        source_direction=vrt.TraceDirection.POS_Z,
        boundary_conditions=(vrt.BoundaryCondition.PERIODIC,) * 3,
        ray_batch_size=batch, rng_seed=5, use_random_seed=False,
        roulette=False,
    )
    bbox = adjust_bounding_box(
        np.asarray(geometry.bbox), config.source_direction,
        geometry.disk_radius, 3,
    )
    s = get_trace_settings(config.source_direction)
    source = RandomSource(
        bbox=jnp.asarray(bbox, jnp.float32),
        cosine_power=particle.cosine_exponent,
        ray_dir=s[0], first_dir=s[1], second_dir=s[2], min_max=s[3],
        pos_neg=float(s[4]), dim=3, num_points=geometry.num_primitives,
    )
    return geometry, source, particle, jnp.asarray(bbox, jnp.float32), config


def main():
    import jax

    from viennaray_tpu.config import TraceConfig
    from viennaray_tpu.diff.trace_grad import flux_and_grad_sticking_batched

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"grad_bench needs a GPU, found {dev.platform}")
    total_rays = int(os.environ.get("GRAD_BENCH_RAYS", 10_000_000))
    batch = int(os.environ.get("GRAD_BENCH_BATCH", 524288))
    num_bounces = int(os.environ.get("GRAD_BENCH_BOUNCES", 8))
    geometry, source, particle, bbox, config = setup(0.25, total_rays, batch)
    key = jax.random.PRNGKey(13)

    # warm one batch (compile)
    warm_cfg = TraceConfig(**{**config.__dict__, "num_rays_fixed": batch})
    flux_and_grad_sticking_batched(
        geometry, source, particle, bbox, key, batch, warm_cfg, "disk",
        num_bounces=num_bounces,
    )

    t0 = time.perf_counter()
    flux, grad = flux_and_grad_sticking_batched(
        geometry, source, particle, bbox, key, total_rays, config,
        "disk", num_bounces=num_bounces,
    )
    dt = time.perf_counter() - t0
    print(json.dumps({
        "config": "grad_1e7",
        "total_rays": total_rays,
        "num_bounces": num_bounces,
        "rays_per_s_fwd_bwd": total_rays / dt,
        "seconds": dt,
        "d_flux_d_sticking": grad,
        "flux_sum": float(flux.sum()),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
