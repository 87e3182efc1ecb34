#!/usr/bin/env python
"""Generate the golden normalized flux for bench.py's flagship config.

Runs the EXACT bench configuration (3D disk trench, grid_delta 0.25,
DiffuseParticle sticking=0.1, periodic boundaries, 2000 rays/point, seed 42
— mirroring the reference's examples/disk3D/disk3D.cpp:33-52) on the CPU
backend, where the trace takes the XLA brute-force path with a different
batch size (so a different RNG stream assignment) from the GPU run that
bench.py times. bench.py and chip_smoke.py compare their normalized flux
against this file with a Monte-Carlo-sized rel-L2 tolerance, so the
benchmark certifies physics, not just speed.

Run: python benchmarks/make_bench_golden.py   (CPU, ~10-20 min on 2 vCPU)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

import viennaray_tpu as vrt
from viennaray_tpu.io import fixtures

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def build_tracer():
    """Identical setup to bench.py main() (keep in sync)."""
    pts, nrm = fixtures.create_trench_grid_3d(
        grid_delta=0.25, extent=5.0, trench_width=4.0, trench_depth=4.0
    )
    t = vrt.TraceDisk(dim=3)
    t.set_geometry(pts, nrm, 0.25)
    t.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 3)
    t.set_particle_type(vrt.DiffuseParticle(0.1, "flux"))
    t.set_number_of_rays_per_point(2000)
    t.set_rng_seed(42)
    # CPU golden generation runs the brute-force path whose intersection
    # intermediates scale with batch x prims (the default 2^20 batch
    # allocates ~151 GB); physics is batch-size independent up to RNG
    # stream assignment, which is exactly what makes this an independent
    # schedule from the GPU run
    t.set_ray_batch_size(1 << 18)
    return t, len(pts)


def main():
    os.makedirs(OUT, exist_ok=True)
    t, n_pts = build_tracer()
    t0 = time.perf_counter()
    flux = t.apply()
    norm = np.asarray(t.normalize_flux(flux), np.float32)
    elapsed = time.perf_counter() - t0
    info = t.get_ray_trace_info()
    np.save(os.path.join(OUT, "bench_disk3d.npy"), norm)
    meta = {
        "config": "bench.py flagship (3D disk trench, gd=0.25, sticking 0.1, "
        "2000 rays/pt, seed 42)",
        "backend": jax.default_backend(),
        "path": "XLA brute force (CPU)",
        "num_points": n_pts,
        "num_rays": info.num_rays,
        "geometry_hits": info.geometry_hits,
        "mean": float(norm.mean()),
        "max": float(norm.max()),
        "gen_seconds": round(elapsed, 1),
        "recorded": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    with open(os.path.join(OUT, "bench_disk3d.json"), "w") as f:
        json.dump(meta, f, indent=2)
    print(json.dumps(meta, indent=2), flush=True)


if __name__ == "__main__":
    main()
