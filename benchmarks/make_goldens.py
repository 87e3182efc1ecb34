#!/usr/bin/env python
"""Generate the golden flux files.

The Embree reference cannot be built here (no network for its CPM
dependencies — BASELINE.md), so these goldens freeze OUR validated flux
fields (which pass the analytic view-factor and uniform-flux contracts) as
regression anchors:

- trace2d / disk2d_trench / disk3d_trench (the BASELINE.json configs, small
  ray counts): any kernel change that shifts physics beyond Monte Carlo
  noise trips tests/test_goldens.py, which also checks them bitwise on the
  generating CPU type;
- tri3d / line2d / ion (the perf_sweep.py configurations at fewer rays per
  point): chip_smoke.py compares the GPU run at the sweep size against
  them. Each is the mean of two runs with different seeds; ``noise`` in the
  manifest is the rel-L2 distance between those two runs.

Run on CPU: python benchmarks/make_goldens.py [--only NAME ...]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

import viennaray_tpu as vrt
from viennaray_tpu.io import fixtures

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

# perf_sweep configurations with a CPU golden: name -> rays per point
SWEEP_GOLDENS = {"tri3d": 100, "line2d": 200, "ion": 200}
SWEEP_BATCH = 1 << 16


def config_trace2d():
    """BASELINE config 1: flat 2D line geometry, sticking 1.0."""
    xs = np.arange(-2.0, 2.0 + 1e-9, 0.1)
    pts = np.stack([xs, np.zeros_like(xs), np.zeros_like(xs)], 1).astype(np.float32)
    nrm = np.tile([0.0, 1.0, 0.0], (len(xs), 1)).astype(np.float32)
    t = vrt.TraceDisk(dim=2)
    t.set_geometry(pts, nrm, 0.1)
    t.set_boundary_conditions([vrt.BoundaryCondition.REFLECTIVE] * 2)
    t.set_particle_type(vrt.DiffuseParticle(1.0, "flux"))
    t.set_source_direction(vrt.TraceDirection.POS_Y)
    t.set_number_of_rays_fixed(100_000)
    t.set_rng_seed(12345)
    t.set_ray_batch_size(16384)
    return t


def config_disk2d_trench():
    """BASELINE config 2: 2D trench, sticking 0.1, multi-bounce."""
    gd = 0.1
    pts, nrm = fixtures.create_trench_grid_2d(grid_delta=gd)
    t = vrt.TraceDisk(dim=2)
    t.set_geometry(pts, nrm, gd)
    t.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 2)
    t.set_particle_type(vrt.DiffuseParticle(0.1, "flux"))
    t.set_source_direction(vrt.TraceDirection.POS_Y)
    t.set_number_of_rays_fixed(200_000)
    t.set_rng_seed(12345)
    t.set_ray_batch_size(16384)
    return t


def config_disk3d_trench():
    """BASELINE config 3 (scaled down for golden): 3D trench, smoothing."""
    pts, nrm = fixtures.create_trench_grid_3d(grid_delta=0.5)
    t = vrt.TraceDisk(dim=3)
    t.set_geometry(pts, nrm, 0.5)
    t.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 3)
    t.set_particle_type(vrt.SpecularParticle(0.5, 2.0, "flux"))
    t.set_number_of_rays_fixed(200_000)
    t.set_rng_seed(12345)
    t.set_ray_batch_size(16384)
    return t


def _cpu_fingerprint():
    """Same host fingerprint as viennaray_tpu/__init__: XLA:CPU codegen
    (FMA contraction etc.) can differ across microarchs, so the BITWISE
    golden check only applies on the generation host type."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    import hashlib

                    return hashlib.sha1(line.encode()).hexdigest()[:12]
    except OSError:
        pass
    return "generic"


def sweep_golden(name, seeds=(42, 7)):
    """(mean normalized flux, noise, meta) of a perf_sweep configuration at
    SWEEP_GOLDENS[name] rays per point, from two seeds."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import perf_sweep

    norms = []
    for seed in seeds:
        t = perf_sweep.make(name, SWEEP_GOLDENS[name], seed=seed)
        t.set_ray_batch_size(SWEEP_BATCH)
        norms.append(np.asarray(t.normalize_flux(t.apply()), np.float64))
    a, b = norms
    noise = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    mean = 0.5 * (a + b)
    info = t.get_ray_trace_info()
    return mean, {
        "num_rays": info.num_rays, "runs": len(seeds), "noise": noise,
        "mean": float(mean.mean()), "max": float(mean.max()),
    }


def main(out_dir=None, quick=False, only=None):
    out = out_dir or OUT
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "manifest.json")
    old = {}
    if only and os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
    # Golden trajectories depend on compaction order (RNG consumption is
    # per-slot, not per-ray), so the defaults that shape the ladder are
    # recorded here: a default flip that silently invalidates the goldens
    # becomes detectable instead of inferred.
    manifest = {
        "_cpu_fingerprint": _cpu_fingerprint(),
        "_defaults": {
            "compact_sort": os.environ.get(
                "VIENNARAY_TPU_COMPACT_SORT", "spatial"
            ),
            "source_sort": os.environ.get("VIENNARAY_TPU_SOURCE_SORT", "1"),
            "stage_shrink": os.environ.get("VIENNARAY_TPU_STAGE_SHRINK", "2"),
            "batch_size": 16384,  # set per-config below
            "f64_accum": os.environ.get("VIENNARAY_TPU_F64_ACCUM", "1"),
        },
    }
    for name, make in [
        ("trace2d", config_trace2d),
        ("disk2d_trench", config_disk2d_trench),
        ("disk3d_trench", config_disk3d_trench),
    ]:
        if only and name not in only:
            manifest[name] = old[name]
            continue
        t = make()
        if quick:
            # CI in-job mode: 8x fewer rays so the
            # generate-then-reproduce bitwise leg fits a CI budget; the
            # recorded num_rays drives the verifying trace via the manifest
            t.set_number_of_rays_fixed(t._num_rays_fixed // 8)
        flux = t.apply()
        norm = t.normalize_flux(flux)
        if name == "disk3d_trench":
            norm = t.smooth_flux(norm, 1)
        np.save(os.path.join(out, f"{name}.npy"), norm.astype(np.float32))
        info = t.get_ray_trace_info()
        manifest[name] = {
            "num_rays": info.num_rays,
            "geometry_hits": info.geometry_hits,
            "mean": float(np.mean(norm)),
            "max": float(np.max(norm)),
        }
        print(name, manifest[name], flush=True)
    for name in SWEEP_GOLDENS:
        if quick or (only and name not in only):
            if name in old:
                manifest[name] = old[name]
            continue
        norm, manifest[name] = sweep_golden(name)
        np.save(os.path.join(out, f"{name}.npy"), norm.astype(np.float32))
        print(name, manifest[name], flush=True)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="output dir (default in-repo)")
    ap.add_argument(
        "--quick", action="store_true",
        help="8x fewer rays, no sweep goldens (CI generate-then-reproduce "
        "leg)",
    )
    ap.add_argument("--only", nargs="*", default=None,
                    help="regenerate only these goldens")
    a = ap.parse_args()
    main(out_dir=a.out, quick=a.quick, only=a.only)
