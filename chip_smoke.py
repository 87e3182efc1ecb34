#!/usr/bin/env python
"""Smoke test of the flux tracer on one GPU.

Drives the main path through the public entry points at the sizes the
benchmark configurations use, and checks every result:

- kernels: the fused nearest-hit kernel (ops/hit_kernel.py) compiled for the
  card against the XLA brute force at HIGHEST precision, 2^20 rays against
  the flagship disks, the tri3d mesh and 18,180 disks; median times of
  both;
- main path: flagship TraceDisk (2993 disks, 2000 rays/pt), warm apply then a
  timed one; normalized flux within rel-L2 0.05 of both disk3d goldens;
  compiled memory of one batch and the device's peak (flagship and tri3d);
- other kinds: TraceTriangle (tri3d), TraceLine (line2d, per-material
  sticking) and the coned-cosine ion at the sweep sizes, each against its
  CPU golden from benchmarks/make_goldens.py;
- determinism: the same seed twice gives bitwise-equal flux and counters;
- gradient: d sum(flux)/d sticking against a central finite difference.

``--four`` runs only the ray-sharded path on 4 GPUs against 1 GPU.

Run on a machine with the card: python chip_smoke.py [--four]
The last line of stdout is one JSON object; any failed phase exits non-zero
before it is printed.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
GOLDEN = os.path.join(ROOT, "benchmarks", "golden")


def log(*a):
    print(*a, flush=True)


def card_name_and_power():
    """``nvidia-smi`` name and power limit, from a child process that stays
    off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def device():
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def median_time(fn, reps=5):
    """Median wall time of ``fn()`` (which must block) over ``reps`` runs,
    after one warm call."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---- kernel phase ---------------------------------------------------------

def kernel_geometries(tiny=False):
    """(name, geometry, kind) at the benchmark widths (or tiny ones)."""
    import viennaray_tpu as vrt
    from viennaray_tpu.io import fixtures

    g = 2.0 if tiny else 1.0
    out = []
    pts, nrm = fixtures.create_trench_grid_3d(grid_delta=0.25 * g)
    out.append(("disk3d", vrt.DiskGeometry.build(pts, nrm, 0.25 * g), "disk"))
    verts, tris = fixtures.create_trench_mesh_3d(grid_delta=0.2 * g)
    out.append(("tri3d", vrt.TriangleGeometry.build(verts, tris, 0.2 * g),
                "triangle"))
    if not tiny:
        pts, nrm = fixtures.create_trench_grid_3d(grid_delta=0.1)
        out.append(("disk18k", vrt.DiskGeometry.build(pts, nrm, 0.1),
                    "disk"))
    return out


def random_rays(geometry, n, seed=0):
    """Origins uniform in the geometry's box, lifted 2 above its top,
    directions uniform on the sphere."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(geometry.bbox, np.float64)
    hi = hi.copy()
    hi[2] += 2.0
    org = lo + (hi - lo) * rng.random((n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org.astype(np.float32), d.astype(np.float32)


def brute_force(geometry, kind, org, dirn, t_near=1e-4):
    from viennaray_tpu.ops import intersect

    if kind == "disk":
        return intersect.disk_nearest_hit(
            org, dirn, geometry.points, geometry.normals, geometry.radii,
            t_near)
    return intersect.triangle_nearest_hit(
        org, dirn, geometry.vertices, geometry.triangles, t_near)


def phase_kernels(n_rays=1 << 20, tiny=False, interpret=False, reps=5):
    """Kernel vs brute force: prim ids and hit flags equal on >= 99.99% of
    the rays, and t within 1e-4 relative error on 99.99% of the rays both
    hit. The rest are grazing or edge hits: where coplanar disks overlap, a
    ray at the edge of one is a tie at equal t, and the brute force's
    expanded |o + t d - c|^2 rounds the edge test differently from the
    kernel's direct form. The brute force runs in 2^18-ray slices (its
    (R, 1024) tiles bound the slice)."""
    import jax
    import jax.numpy as jnp

    from viennaray_tpu.ops import hit_kernel

    rows = []
    for name, geo, kind in kernel_geometries(tiny):
        org_np, d_np = random_rays(geo, n_rays)
        org, dirn = jnp.asarray(org_np), jnp.asarray(d_np)

        def run_kernel():
            out = hit_kernel.nearest_hit(
                org, dirn, geo.prims_soa, geo.soa_perm, geo.soa_chunk_bbs,
                kind=kind, interpret=interpret)
            return jax.block_until_ready(out)

        sl = min(n_rays, 1 << 18)
        bf = jax.jit(lambda o, d: brute_force(geo, kind, o, d))

        def run_brute():
            outs = [bf(org[i:i + sl], dirn[i:i + sl])
                    for i in range(0, n_rays, sl)]
            outs = jax.block_until_ready(outs)
            return [np.concatenate([np.asarray(o[k]) for o in outs])
                    for k in range(3)]

        tk, ik, hk = (np.asarray(x) for x in run_kernel())
        tb, ib, hb = run_brute()
        both = hk & hb
        rel = (np.abs(tk[both] - tb[both])
               / np.maximum(np.abs(tb[both]), 1e-6))
        rel = rel if rel.size else np.zeros(1)
        row = {"geometry": name, "prims": int(geo.num_primitives),
               "rays": n_rays, "hits": int(hb.sum()),
               "id_equal": float((ik == ib).mean()),
               "id_equal_among_hits": float((ik[both] == ib[both]).mean()),
               "hit_equal": float((hk == hb).mean()),
               "t_rel_err_q9999": float(np.quantile(rel, 0.9999)),
               "t_rel_err_max": float(rel.max())}
        if not interpret:
            row["kernel_s"] = median_time(run_kernel, reps)
            row["xla_s"] = median_time(run_brute, reps)
        log("kernel", json.dumps(row))
        assert hb.sum() > 0.1 * n_rays, row
        assert row["id_equal"] >= 0.9999 and row["hit_equal"] >= 0.9999, row
        assert row["t_rel_err_q9999"] < 1e-4, row
        rows.append(row)
    return rows


# ---- main path ------------------------------------------------------------

def phase_flagship(rays_per_point=2000, check_golden=True):
    import jax

    import perf_sweep

    t = perf_sweep.make("disk3d", rays_per_point)
    mem = perf_sweep.compile_batch(t).memory_analysis()
    log("flagship batch memory_analysis:", mem)
    t0 = time.perf_counter()
    flux_warm = np.asarray(t.apply())
    log(f"flagship first apply (compile included) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    flux = np.asarray(t.apply(), np.float64)
    dt = time.perf_counter() - t0
    info = t.get_ray_trace_info()
    stats = jax.devices()[0].memory_stats() or {}
    norm = np.asarray(t.normalize_flux(flux), np.float64)
    row = {"num_rays": info.num_rays, "rays_per_s": info.num_rays / dt,
           "seconds": dt, "total_rays_traced": info.total_rays_traced,
           "geometry_hits": info.geometry_hits,
           "non_geometry_hits": info.non_geometry_hits,
           "boundary_hits": info.boundary_hits,
           "particle_hits": info.particle_hits,
           "reflections": info.reflections,
           "peak_bytes_in_use": stats.get("peak_bytes_in_use")}
    assert np.isfinite(norm).all() and norm.max() > 0, row
    if check_golden:
        for g in ("bench_disk3d", "bench_disk3d_oracle"):
            ref = np.load(os.path.join(GOLDEN, f"{g}.npy"))
            row[f"rel_l2_{g}"] = _rel_l2(norm, ref)
            assert row[f"rel_l2_{g}"] < 0.05, row
    log("flagship", json.dumps(row))

    # determinism: a fresh tracer with the same seed repeats the warm run
    t2 = perf_sweep.make("disk3d", rays_per_point)
    assert np.array_equal(np.asarray(t2.apply()), flux_warm), \
        "flagship flux not bitwise reproducible"
    return row


def phase_kinds(names=("tri3d", "line2d", "ion"), rays_per_point=None,
                check_golden=True):
    """Each kind at the sweep size: finite, non-negative, non-zero flux,
    rel-L2 to its CPU golden within 1.5x the golden's own Monte Carlo
    noise (the distance between its two independent CPU runs), and a
    bitwise repeat with the same seed."""
    import perf_sweep

    with open(os.path.join(GOLDEN, "manifest.json")) as f:
        manifest = json.load(f)
    rows = []
    for name in names:
        runs = []
        for k in range(2):
            t = perf_sweep.make(name, rays_per_point)
            if k == 0:
                t.enable_progress_bar()
            t0 = time.perf_counter()
            flux = np.asarray(t.apply(), np.float64)
            dt = time.perf_counter() - t0
            runs.append((flux, t.get_ray_trace_info(), dt))
        (flux, info, dt), (flux2, info2, dt2) = runs
        if name == "tri3d":
            log("tri3d batch memory_analysis:",
                perf_sweep.compile_batch(t).memory_analysis())
        norm = np.asarray(t.normalize_flux(flux), np.float64)
        row = {"config": name, "num_rays": info.num_rays,
               "first_apply_s": dt, "rays_per_s_second_apply":
               info.num_rays / dt2,
               "geometry_hits": info.geometry_hits,
               "bitwise_repeat": bool(np.array_equal(flux, flux2)),
               "counters_repeat": info.geometry_hits == info2.geometry_hits
               and info.total_rays_traced == info2.total_rays_traced}
        golden = manifest[name] if check_golden else None
        if golden is not None:
            ref = np.load(os.path.join(GOLDEN, f"{name}.npy"))
            row["rel_l2_golden"] = _rel_l2(norm, ref)
            row["tolerance"] = 1.5 * golden["noise"]
        log("kind", json.dumps(row))
        assert np.isfinite(flux).all() and flux.min() >= 0, row
        assert flux.sum() > 0, row
        assert row["bitwise_repeat"] and row["counters_repeat"], row
        if golden is not None:
            assert row["rel_l2_golden"] < row["tolerance"], row
        rows.append(row)
    return rows


# ---- gradient -------------------------------------------------------------

def phase_gradient(grid_delta=0.25, batch=524288, bounces=8):
    """d sum(flux)/d sticking (grad_bench.py's geometry and batch) against
    a central finite difference at the same seed. The flux is polynomial
    in sticking with roulette off, so they agree to float32 rounding."""
    import jax
    import jax.numpy as jnp

    import grad_bench
    from viennaray_tpu.diff.trace_grad import (
        flux_and_grad_sticking_batched, trace_flux)

    geometry, source, particle, bbox, config = grad_bench.setup(
        grid_delta, batch, batch)
    key = jax.random.PRNGKey(13)
    flux, grad = flux_and_grad_sticking_batched(
        geometry, source, particle, bbox, key, batch, config, "disk",
        num_bounces=bounces)
    idx = jnp.arange(batch, dtype=jnp.int32)

    @jax.jit
    def total(s):
        return jnp.sum(trace_flux(
            geometry, source, particle.replace(sticking=s), bbox,
            jax.random.fold_in(key, 0), idx, idx >= 0, config, "disk",
            bounces))

    eps = 1e-2
    s0 = float(particle.sticking)
    fd = (float(total(jnp.float32(s0 + eps)))
          - float(total(jnp.float32(s0 - eps)))) / (2 * eps)
    row = {"d_flux_d_sticking": grad, "finite_difference": fd,
           "rel": abs(grad - fd) / abs(fd), "flux_sum": float(flux.sum())}
    log("gradient", json.dumps(row))
    assert np.isfinite(flux).all() and np.isfinite(grad), row
    assert row["rel"] < 1e-2, row
    return row


# ---- four devices ---------------------------------------------------------

def phase_four(n_devices=4, per_shard=1 << 16, grid_delta=0.25):
    """trace_sharded on ``n_devices`` against one device: flux rel < 1e-6,
    equal counters, and a bitwise repeat of the sharded run."""
    import jax

    import grad_bench
    from viennaray_tpu.config import TraceConfig
    from viennaray_tpu.parallel.mesh import make_ray_mesh, trace_sharded

    assert len(jax.devices()) >= n_devices, jax.devices()
    geometry, source, particle, bbox, config = grad_bench.setup(
        grid_delta, per_shard * n_devices, per_shard)
    config = TraceConfig(**{**config.__dict__, "roulette": True})
    key = jax.random.PRNGKey(17)
    total = per_shard * n_devices
    run = lambda m: trace_sharded(geometry, source, particle, bbox, config,
                                  "disk", key, total, m)
    mesh_n = make_ray_mesh(jax.devices()[:n_devices])
    flux_n, tot_n = run(mesh_n)
    t0 = time.perf_counter()
    flux_r, tot_r = run(mesh_n)
    dt_n = time.perf_counter() - t0
    flux_1, tot_1 = run(make_ray_mesh(jax.devices()[:1]))
    t0 = time.perf_counter()
    run(make_ray_mesh(jax.devices()[:1]))
    dt_1 = time.perf_counter() - t0
    row = {"devices": n_devices, "rays": total,
           "prims": int(geometry.num_primitives),
           "rel": _rel_l2(flux_n, flux_1),
           "counters_equal": bool((tot_n == tot_1).all()),
           "repeat_bitwise": bool(np.array_equal(flux_n, flux_r)
                                  and (tot_n == tot_r).all()),
           "seconds_n": dt_n, "seconds_1": dt_1,
           "flux_sum": float(np.sum(flux_n))}
    log("sharded", json.dumps(row))
    assert np.sum(flux_n) > 0, row
    assert row["rel"] < 1e-6 and row["counters_equal"], row
    assert row["repeat_bitwise"], row
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the ray-sharded path on 4 GPUs vs 1")
    args = ap.parse_args()

    dev = device()
    log("device", json.dumps(dev))
    if dev["platform"] != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found {dev}")
    log("nvidia-smi:", card_name_and_power())

    phases = [phase_four] if args.four else [
        phase_kernels, phase_flagship, phase_kinds, phase_gradient]
    for phase in phases:
        t0 = time.perf_counter()
        phase()
        log(f"{phase.__name__} done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": dev}), flush=True)


if __name__ == "__main__":
    main()
