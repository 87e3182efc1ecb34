#!/usr/bin/env python
"""Flagship benchmark: 3D disk trench flux trace on one GPU.

Config mirrors the reference's examples/disk3D (trench geometry, diffuse
particle sticking=0.1, periodic boundaries, 2000 rays/point,
examples/disk3D/disk3D.cpp:33-52) — the reference's own headline timing
printout ("Tracing time: X s").

Prints the device (JAX platform, kind, count; nvidia-smi name and power
limit) and then ONE JSON line:
  {"metric": ..., "value": rays/s, "unit": "rays/s", "ok": bool, ...}
``ok`` requires finite, positive flux within rel-L2 0.05 of both disk3d
goldens. Fails when JAX finds no GPU.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "benchmarks"))


def main():
    import jax

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print("device", json.dumps(device), flush=True)
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {device}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print("nvidia-smi:", card, flush=True)

    import perf_sweep

    rays_per_point = int(os.environ.get("BENCH_RAYS_PER_POINT", 2000))
    tracer = perf_sweep.make("disk3d", rays_per_point)
    # warmup: identical static config (compiles outside the timed runs)
    tracer.apply()

    reps = int(os.environ.get("BENCH_REPS", 3))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        flux = np.asarray(tracer.apply())
        times.append(time.perf_counter() - t0)
    elapsed = float(np.median(times))
    info = tracer.get_ray_trace_info()
    rays_per_s = info.num_rays / elapsed

    # physics certification: the normalized flux must match two independent
    # goldens — the repo's own CPU path (benchmarks/make_bench_golden.py)
    # and the scalar C++ oracle (tests/oracle_ref.cpp) — within a
    # Monte-Carlo-sized rel-L2 tolerance (two independent 2000-rays/pt runs
    # differ by ~1-2%)
    norm = np.asarray(tracer.normalize_flux(flux), np.float64)
    golden_dir = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "benchmarks", "golden",
    )
    parity = {}
    for name in ("bench_disk3d", "bench_disk3d_oracle"):
        g = np.asarray(np.load(os.path.join(golden_dir, f"{name}.npy")),
                       np.float64)
        parity[name] = float(np.linalg.norm(norm - g) / np.linalg.norm(g))
    ok = bool(
        np.isfinite(norm).all()
        and norm.max() > 0
        and all(v < 0.05 for v in parity.values())
    )
    print(json.dumps({
        "metric": "rays/s (3D disk trench, sticking 0.1, "
                  f"{rays_per_point} rays/pt, {tracer.geometry.num_primitives}"
                  " disks)",
        "value": rays_per_s,
        "unit": "rays/s",
        "ok": ok,
        "seconds": times,
        "batch": tracer._ray_batch_size,
        "golden_rel_l2": parity,
        "device": device,
        "card": card,
    }))


if __name__ == "__main__":
    main()
