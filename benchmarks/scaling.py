#!/usr/bin/env python
"""Device-scaling harness: rays/s across a 1..N-device ray mesh.

Each device count runs in its own child process; the parent stays off JAX
(so no process but the child holds a card). On a GPU host child n sees the
first n cards (CUDA_VISIBLE_DEVICES); with ``--cpu`` the children use a
virtual CPU mesh (``xla_force_host_platform_device_count``), which checks
the MECHANICS — shard_map trace + psum flux, per-shard RNG, flux agreement
across device counts — not device scaling.

    python benchmarks/scaling.py [--cpu] [N ...]   (default 1 2 4)

Prints one JSON line per N and a summary line.
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

WORKER = r"""
import json, os, sys, time
import numpy as np
import jax
if os.environ.get("VRT_SCALING_CPU") == "1":
    jax.config.update("jax_platforms", "cpu")
dev = jax.devices()[0]
sys.path.insert(0, %(repo)r)
import jax.numpy as jnp
import viennaray_tpu as vrt
from viennaray_tpu.config import (TraceConfig, adjust_bounding_box,
                                  get_trace_settings)
from viennaray_tpu.io import fixtures
from viennaray_tpu.parallel.mesh import make_ray_mesh, trace_sharded
from viennaray_tpu.physics.source import RandomSource

n_dev = len(jax.devices())
pts, nrm = fixtures.create_trench_grid_3d(
    grid_delta=0.5, extent=3.0, trench_width=2.0, trench_depth=2.0)
geometry = vrt.DiskGeometry.build(pts, nrm, 0.5, dim=3)
particle = vrt.DiffuseParticle(0.1, "flux")
total_rays = int(os.environ.get("VRT_SCALING_RAYS", 262144))
config = TraceConfig(
    dim=3, num_rays_fixed=total_rays,
    source_direction=vrt.TraceDirection.POS_Z,
    boundary_conditions=(vrt.BoundaryCondition.PERIODIC,) * 3,
    ray_batch_size=8192,  # FIXED across device counts (RNG contract)
    rng_seed=7, use_random_seed=False, max_bounces=600,
)
bbox = adjust_bounding_box(np.asarray(geometry.bbox),
                           config.source_direction, geometry.disk_radius, 3)
s = get_trace_settings(config.source_direction)
source = RandomSource(
    bbox=jnp.asarray(bbox, jnp.float32),
    cosine_power=particle.cosine_exponent,
    ray_dir=s[0], first_dir=s[1], second_dir=s[2], min_max=s[3],
    pos_neg=float(s[4]), dim=3, num_points=geometry.num_primitives)
mesh = make_ray_mesh()
key = jax.random.PRNGKey(11)
args = (geometry, source, particle, jnp.asarray(bbox, jnp.float32),
        config, "disk", key, total_rays, mesh)
flux, totals = trace_sharded(*args)  # warm / compile
t0 = time.perf_counter()
flux, totals = trace_sharded(*args)
host = np.asarray(flux)
dt = time.perf_counter() - t0
print(json.dumps({
    "devices": n_dev,
    "rays_per_s": total_rays / dt,
    "seconds": dt,
    "total_rays": total_rays,
    "flux_checksum": float(host.sum()),
    "device": {"platform": dev.platform, "kind": dev.device_kind},
}))
"""


def main():
    args = sys.argv[1:]
    cpu = "--cpu" in args
    counts = [int(x) for x in args if x != "--cpu"] or [1, 2, 4]
    rows = []
    for n in counts:
        env = dict(os.environ)
        if cpu:
            env["XLA_FLAGS"] = (
                env.get("XLA_FLAGS", "")
                + f" --xla_force_host_platform_device_count={n}"
            ).strip()
            env["VRT_SCALING_CPU"] = "1"
        else:
            env["CUDA_VISIBLE_DEVICES"] = ",".join(str(i) for i in range(n))
        env.setdefault("VRT_SCALING_RAYS", "262144")
        out = subprocess.run(
            [sys.executable, "-c", WORKER % {"repo": REPO}],
            env=env, capture_output=True, text=True, cwd=REPO,
        )
        line = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
        if not line:
            print(f"devices={n}: FAILED\n{out.stderr[-2000:]}", file=sys.stderr)
            continue
        row = json.loads(line)
        rows.append(row)
        print(line, flush=True)
    if rows:
        base = rows[0]
        for r in rows:
            r["efficiency_vs_1dev"] = (
                r["rays_per_s"] / (base["rays_per_s"] * r["devices"])
            )
        checks = [r["flux_checksum"] for r in rows]
        spread = (max(checks) - min(checks)) / max(abs(max(checks)), 1e-9)
        # cross-device-count flux agreement is up to f32 psum reduction
        # order (see parallel/mesh.py RNG contract); bitwise holds per count
        consistent = spread < 1e-5
        print(json.dumps({
            "efficiency_vs_1dev": [r["efficiency_vs_1dev"] for r in rows],
            "flux_consistent_across_device_counts": consistent,
            "flux_rel_spread": spread,
        }))


if __name__ == "__main__":
    main()
