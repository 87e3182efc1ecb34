#!/usr/bin/env python
"""Capture a jax.profiler device trace of a trace run and print a per-op
time summary.

    python benchmarks/profile_trace.py [outdir] [grid_delta] [rays_per_point]

Defaults: outdir chiprun_out/profile, the 18k-disk config (grid delta 0.1,
50 rays/pt); ``0.25 2000`` profiles the flagship. Writes the raw trace
(xplane + trace.json.gz, viewable in Perfetto / TensorBoard) and prints the
top ops by accumulated duration. benchmarks/kernel_ab.py ``layers`` sums the
same device time by named scope.
"""

import collections
import glob
import gzip
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "chiprun_out", "profile")
    # optional: grid_delta + rays/point (default = the 18k-disk config;
    # `0.25 2000` profiles the flagship bench config)
    grid_delta = float(sys.argv[2]) if len(sys.argv) > 2 else 0.1
    rays_pp = int(sys.argv[3]) if len(sys.argv) > 3 else 50
    import jax

    import viennaray_tpu as vrt
    from viennaray_tpu.io import fixtures

    pts, nrm = fixtures.create_trench_grid_3d(
        grid_delta=grid_delta, extent=5.0, trench_width=4.0, trench_depth=4.0
    )
    t = vrt.TraceDisk(dim=3)
    t.set_geometry(pts, nrm, grid_delta)
    t.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 3)
    t.set_particle_type(vrt.DiffuseParticle(0.1, "flux"))
    t.set_number_of_rays_per_point(rays_pp)
    t.set_rng_seed(42)
    t.apply()  # warm (compile outside the trace)
    with jax.profiler.trace(outdir):
        np.asarray(t.apply())  # host copy: the window ends with the work

    traces = sorted(glob.glob(os.path.join(
        outdir, "plugins", "profile", "*", "*.trace.json.gz")))
    if not traces:
        print("no trace written", file=sys.stderr)
        return
    with gzip.open(traces[-1]) as f:
        data = json.load(f)
    agg = collections.Counter()
    cnt = collections.Counter()
    for e in data.get("traceEvents", []):
        if e.get("ph") == "X" and "dur" in e:
            agg[e.get("name", "?")] += e["dur"]
            cnt[e.get("name", "?")] += 1
    print(f"trace: {traces[-1]}")
    for name, dur in agg.most_common(20):
        print(f"{dur / 1e6:9.3f}s  x{cnt[name]:<6} {name[:90]}")


if __name__ == "__main__":
    main()
