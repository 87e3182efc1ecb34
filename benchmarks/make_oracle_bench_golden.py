#!/usr/bin/env python
"""Oracle-certify the flagship bench config.

Runs the independent scalar C++ oracle (tests/oracle_ref.cpp — a
from-scratch implementation of the reference trace semantics,
rayTraceKernel.hpp:118-341, sharing no code with viennaray_tpu) on the EXACT
bench.py geometry and physics (3D disk trench, grid_delta 0.25, ~3k disks,
DiffuseParticle sticking=0.1, periodic boundaries, 2000 rays/point), then
normalizes its flux with the tracer's own normalization contract and saves
it as a SECOND bench golden. bench.py and chip_smoke.py compare the GPU flux
against both:

- bench_disk3d.npy         — this repo's CPU path (independent RNG
                             schedule, same codebase)
- bench_disk3d_oracle.npy  — the C++ oracle (independent codebase AND RNG)

so a semantics misreading shared by the repo's own paths cannot pass
silently.

Run: python benchmarks/make_oracle_bench_golden.py   (~10-45 min, 1 core)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(
    0,
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "tests"),
)

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

import viennaray_tpu as vrt
from viennaray_tpu.io import fixtures
from oracle_ref import available, trace_disks_oracle

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def main():
    assert available(), "oracle build unavailable (g++ failed)"
    os.makedirs(OUT, exist_ok=True)
    grid_delta = 0.25
    pts, nrm = fixtures.create_trench_grid_3d(
        grid_delta=grid_delta, extent=5.0, trench_width=4.0, trench_depth=4.0
    )
    n = len(pts)
    rays_per_point = 2000
    num_rays = rays_per_point * n

    # tracer mirroring bench.py, used ONLY for the normalization contract
    # (areas + source area + total-ray factor) — a tiny apply populates the
    # clipped disk areas and the source without tracing the 6M rays
    t = vrt.TraceDisk(dim=3)
    t.set_geometry(pts, nrm, grid_delta)
    t.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 3)
    t.set_particle_type(vrt.DiffuseParticle(0.1, "flux"))
    t.set_number_of_rays_fixed(512)
    t.set_rng_seed(1)
    t.apply()
    t.set_number_of_rays_fixed(0)  # back to per-point mode: the SOURCE
    t.set_number_of_rays_per_point(rays_per_point)  # normalization factor

    disk_radius = t.geometry.disk_radius
    t0 = time.perf_counter()
    flux, counters = trace_disks_oracle(
        pts, nrm, np.full(n, disk_radius), dim=3, disk_radius=disk_radius,
        num_rays=num_rays, sticking=0.1, seed=43, cosine_exponent=1.0,
        reflection="diffuse", boundary=("periodic", "periodic"),
    )
    elapsed = time.perf_counter() - t0

    norm = np.asarray(t.normalize_flux(flux), np.float64)
    np.save(os.path.join(OUT, "bench_disk3d_oracle.npy"),
            norm.astype(np.float32))

    meta = {
        "config": "bench.py flagship (3D disk trench, gd=0.25, sticking 0.1, "
        "2000 rays/pt), traced by the independent C++ oracle (seed 43)",
        "generator": "tests/oracle_ref.cpp (scalar, std::mt19937_64)",
        "num_points": n,
        "num_rays": num_rays,
        "counters": counters,
        "mean": float(norm.mean()),
        "max": float(norm.max()),
        "gen_seconds": round(elapsed, 1),
        "recorded": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    repo_golden = os.path.join(OUT, "bench_disk3d.npy")
    if os.path.exists(repo_golden):
        repo = np.asarray(np.load(repo_golden), np.float64)
        meta["rel_l2_vs_repo_cpu_golden"] = float(
            np.linalg.norm(norm - repo) / max(np.linalg.norm(repo), 1e-12)
        )
    with open(os.path.join(OUT, "bench_disk3d_oracle.json"), "w") as f:
        json.dump(meta, f, indent=2)
    print(json.dumps(meta, indent=2), flush=True)


if __name__ == "__main__":
    main()
