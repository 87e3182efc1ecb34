#!/usr/bin/env python
"""BASELINE capacity target: 1e8-ray 3D trench flux with checkpointing.

One device here; the same script scales to several by swapping the tracer
loop for parallel.mesh.trace_sharded (rays axis) — see examples/sharded_trace.
The checkpoint goes to chiprun_out/ in the checkout.
"""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import viennaray_tpu as vrt
from viennaray_tpu.io import fixtures
from viennaray_tpu.utils.checkpoint import save_checkpoint

TOTAL = int(os.environ.get("CAP_RAYS", 100_000_000))
CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "chiprun_out", "capacity_ckpt.npz")
os.makedirs(os.path.dirname(CKPT), exist_ok=True)
CHUNK = 10_000_000

pts, nrm = fixtures.create_trench_grid_3d(grid_delta=0.25)
t = vrt.TraceDisk(dim=3)
t.set_geometry(pts, nrm, 0.25)
t.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 3)
t.set_particle_type(vrt.DiffuseParticle(0.1, "flux"))
t.set_rng_seed(2024)
t.set_number_of_rays_fixed(CHUNK)

t0 = time.perf_counter()
done = 0
while done < TOTAL:
    t.apply()  # accumulates into local data with per-run seed bump
    done += CHUNK
    save_checkpoint(CKPT, t, {"rays_done": done})
    el = time.perf_counter() - t0
    print(f"{done:.2e} rays, {el:.1f}s, {done/el:.3e} rays/s", flush=True)

flux = t.get_local_data().get_vector_data("flux")
norm = t.normalize_flux(np.asarray(flux) / (TOTAL / CHUNK))  # per-run normalization scale
print("DONE total", TOTAL, "mean flux", float(np.mean(norm)),
      "finite", bool(np.isfinite(norm).all()), flush=True)
