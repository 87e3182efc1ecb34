#!/usr/bin/env python
"""The fused nearest-hit kernel against plain XLA on the GPU.

- end to end: apply() rays/s of each configuration with the kernel, then
  with the XLA path (brute force, or the grid DDA at or above
  ``grid_min_prims``), switched through the choice functions of
  ops/hit_kernel.py;
- deposit: the sorted deposit (ops/deposit.py) and XLA's scatter-add at
  trace shapes, and whether repeated runs of each agree bitwise;
- layers: a profiler trace of one flagship apply, device time summed by the
  trace's named scopes (intersect, neighbors, deposit, reflect, resort,
  compact; "other" is the remaining elementwise glue; "unmapped" are
  device events that match no instruction of the batch).

Usage: python benchmarks/kernel_ab.py [deposit] [ab [config ...]] [layers]
(default: all three, ab over disk3d tri3d disk18k)
Prints JSON lines naming the device; traces go to chiprun_out/.
"""

import collections
import glob
import json
import os
import re
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))

SCOPES = ("intersect", "neighbors", "deposit", "reflect", "resort",
          "compact")


def _device():
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _set_kernel(mode):
    """Route disks and triangles to ``mode`` ("triton" or "xla") and drop
    compiled traces so the next apply recompiles."""
    import jax

    from viennaray_tpu.ops import hit_kernel

    for name in ("disk_kernel", "triangle_kernel"):
        setattr(hit_kernel, name, lambda n, m=mode: m)
    jax.clear_caches()


def ab(names=("disk3d", "tri3d", "disk18k"), n_rays=1 << 21,
       reps=3):
    import perf_sweep

    for name in names:
        for mode in ("triton", "xla"):
            _set_kernel(mode)
            t = perf_sweep.make(name)
            t.set_number_of_rays_fixed(n_rays)
            t0 = time.perf_counter()
            t.apply()  # compile
            compile_s = time.perf_counter() - t0
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                np.asarray(t.apply())
                ts.append(time.perf_counter() - t0)
            info = t.get_ray_trace_info()
            print(json.dumps({
                "ab": name, "nearest_hit": mode, "num_rays": info.num_rays,
                "prims": int(t.geometry.num_primitives),
                "rays_per_s": info.num_rays / float(np.median(ts)),
                "seconds": ts, "first_apply_s": compile_s,
                "device": _device(),
            }), flush=True)


def _time(fn, *args, reps=5):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def deposit(k=12):
    import jax
    import jax.numpy as jnp

    from viennaray_tpu.ops import deposit as dep

    rng = np.random.default_rng(0)
    scatter = jax.jit(
        lambda i, w, n: jnp.zeros((n,), w.dtype).at[i].add(w),
        static_argnums=2)
    sort = jax.jit(dep.flux_deposit, static_argnums=2)
    for rays, n in [(1 << 14, 2993), (1 << 17, 2993), (1 << 20, 2993),
                    (1 << 20, 9000), (1 << 20, 18180)]:
        e = rays * k
        ids = jnp.asarray(rng.integers(0, n, e).astype(np.int32))
        w = jnp.asarray(rng.random(e).astype(np.float32))
        row = {"deposit_entries": e, "prims": n,
               "sorted_s": _time(sort, ids, w, n),
               "scatter_s": _time(scatter, ids, w, n)}
        a = np.asarray(scatter(ids, w, n))
        row["scatter_bitwise_repeat"] = all(
            np.array_equal(a, np.asarray(scatter(ids, w, n)))
            for _ in range(5))
        b = np.asarray(sort(ids, w, n))
        row["sorted_bitwise_repeat"] = all(
            np.array_equal(b, np.asarray(sort(ids, w, n))) for _ in range(5))
        ref = np.zeros(n)
        np.add.at(ref, np.asarray(ids), np.asarray(w, np.float64))
        row["sorted_max_rel_err"] = float(np.max(np.abs(b - ref)) / ref.max())
        row["scatter_max_rel_err"] = float(
            np.max(np.abs(a - ref)) / ref.max())
        row["device"] = _device()
        print(json.dumps(row), flush=True)


def layers(name="disk3d", out=os.path.join(ROOT, "chiprun_out", "trace"),
           device_plane="gpu"):
    """Device time of one apply by named scope."""
    import jax

    import perf_sweep

    _set_kernel("triton")
    t = perf_sweep.make(name)
    t.apply()
    # HLO instruction -> named scope, from the compiled batch's metadata
    scope_of = {}
    for ln in perf_sweep.compile_batch(t).as_text().splitlines():
        m = re.match(r"\s*(?:ROOT )?%?([\w.\-]+) = .*op_name=\"([^\"]*)\"",
                     ln)
        if m:
            scope = next((s for s in SCOPES if f"/{s}" in m.group(2)),
                         "other")
            scope_of[m.group(1).replace(".", "_").replace("-", "_")] = scope
    jax.profiler.start_trace(out)
    t0 = time.perf_counter()
    np.asarray(t.apply())
    wall = time.perf_counter() - t0
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(out, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    from jax.profiler import ProfileData

    prof = ProfileData.from_file(path)
    by_scope = collections.Counter()
    by_name = collections.Counter()
    busy = []
    for plane in prof.planes:
        if device_plane not in plane.name.lower():
            continue
        for line in plane.lines:
            for ev in line.events:
                names = [ev.name] + [str(v) for _, v in ev.stats]
                scope = next(
                    (scope_of[k] for k in (
                        x.replace(".", "_").replace("-", "_") for x in names)
                     if k in scope_of), "unmapped")
                by_scope[scope] += ev.duration_ns
                by_name[ev.name] += ev.duration_ns
                busy.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy.sort()
    union, end = 0, None
    for a, b in busy:
        if end is None or a > end:
            union += b - a
            end = b
        elif b > end:
            union += b - end
            end = b
    print(json.dumps({
        "layers": name, "wall_s": wall, "device_busy_s": union / 1e9,
        "by_scope_s": {k: v / 1e9 for k, v in by_scope.most_common()},
        "top_ops_s": {k: v / 1e9 for k, v in by_name.most_common(15)},
        "device": _device(),
    }), flush=True)


def main():
    import jax

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("kernel_ab needs a GPU")
    sections = {"ab": ab, "deposit": deposit, "layers": layers}
    args = sys.argv[1:] or ["deposit", "ab", "layers"]
    for i, what in enumerate(args):
        if what == "ab":
            names = []
            for x in args[i + 1:]:
                if x in sections:
                    break
                names.append(x)
            ab(*([tuple(names)] if names else []))
        elif what in sections:
            sections[what]()


if __name__ == "__main__":
    main()
