#!/usr/bin/env python
"""Throughput sweep over the benchmark configurations, on the GPU.

Configs (all geometry generated in-repo by viennaray_tpu/io/fixtures.py):
  disk2d   — 2D disk trench (grid delta 0.1, 180 disks), sticking 0.1
  line2d   — 2D trench polyline (900 segments), per-material sticking
             [0.5, 0.1] (the GPU line tracer's trenchLines example)
  disk3d   — flagship 3D disk trench (bench.py config), 2993 disks
  tri3d    — 3D triangle trench mesh (9000 triangles), sticking 0.1
  disk18k  — fine-grid 3D disk trench, 18180 disks
  disk1m   — 704k-disk 3D trench
  ion      — coned-cosine ion (cone pi/6, sticking 0.5) on the flagship

``make(name)`` builds the configured tracer; make_goldens.py and
chip_smoke.py build the same configurations through it. Each timed run is a
warm apply() followed by a timed one that ends in a host copy of the flux.

Usage: python benchmarks/perf_sweep.py [config ...]  (default: all)
Prints one JSON line per config, each naming the device.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _disk(dim, pts, nrm, grid_delta, particle, rays_per_point):
    import viennaray_tpu as vrt

    t = vrt.TraceDisk(dim=dim)
    t.set_geometry(pts, nrm, grid_delta)
    t.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * dim)
    t.set_particle_type(particle)
    if dim == 2:
        t.set_source_direction(vrt.TraceDirection.POS_Y)
    t.set_number_of_rays_per_point(rays_per_point)
    return t


def _trench3d(grid_delta):
    from viennaray_tpu.io import fixtures

    return fixtures.create_trench_grid_3d(
        grid_delta=grid_delta, extent=5.0, trench_width=4.0, trench_depth=4.0
    )


def make_disk2d(rays_per_point):
    import viennaray_tpu as vrt
    from viennaray_tpu.io import fixtures

    pts, nrm = fixtures.create_trench_grid_2d(grid_delta=0.1)
    return _disk(2, pts, nrm, 0.1, vrt.DiffuseParticle(0.1, "flux"),
                 rays_per_point)


def make_disk3d(rays_per_point):
    import viennaray_tpu as vrt

    pts, nrm = _trench3d(0.25)
    return _disk(3, pts, nrm, 0.25, vrt.DiffuseParticle(0.1, "flux"),
                 rays_per_point)


def make_disk18k(rays_per_point):
    import viennaray_tpu as vrt

    pts, nrm = _trench3d(0.1)
    return _disk(3, pts, nrm, 0.1, vrt.DiffuseParticle(0.1, "flux"),
                 rays_per_point)


def make_disk1m(rays_per_point):
    import viennaray_tpu as vrt
    from viennaray_tpu.geometry.disk_geometry import DiskGeometry

    gd = 0.016
    pts, nrm = _trench3d(gd)
    t = vrt.TraceDisk(dim=3)
    # skip the host-side neighbor pack (~600 MB) and the grid at this size
    t.geometry = DiskGeometry.build(
        pts, nrm, gd, dim=3, accel=False, pack_neighbors=False
    )
    t.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 3)
    t.set_particle_type(vrt.DiffuseParticle(0.1, "flux"))
    t.set_number_of_rays_per_point(rays_per_point)
    return t


def make_ion(rays_per_point):
    import jax.numpy as jnp

    import viennaray_tpu as vrt
    from viennaray_tpu.config import ReflectionKind

    pts, nrm = _trench3d(0.25)
    ion = vrt.SpecularParticle(0.5, 100.0, "flux").replace(
        reflection_kind=int(ReflectionKind.CONED_COSINE),
        cone_angle=jnp.asarray(np.pi / 6, jnp.float32),
    )
    return _disk(3, pts, nrm, 0.25, ion, rays_per_point)


def make_tri3d(rays_per_point):
    import viennaray_tpu as vrt
    from viennaray_tpu.geometry.mesh import TriangleMesh
    from viennaray_tpu.io import fixtures

    gd = 0.2
    verts, tris = fixtures.create_trench_mesh_3d(grid_delta=gd)
    t = vrt.TraceTriangle(dim=3)
    t.set_geometry(TriangleMesh(nodes=verts, triangles=tris, grid_delta=gd))
    t.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 3)
    t.set_particle_type(vrt.DiffuseParticle(0.1, "flux"))
    t.set_number_of_rays_per_point(rays_per_point)
    return t


def make_line2d(rays_per_point):
    import viennaray_tpu as vrt
    from viennaray_tpu.io import fixtures

    gd = 0.02
    nodes, lines = fixtures.create_trench_lines_2d(grid_delta=gd)
    mesh = vrt.LineMesh(nodes=nodes, lines=lines, grid_delta=gd)
    n = len(mesh.lines)
    material_ids = np.zeros((n,), np.int32)
    material_ids[n // 2:] = 1
    t = vrt.TraceLine()
    t.set_geometry(mesh, material_ids=material_ids)
    t.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 2)
    t.set_particle_type(
        vrt.DiffuseParticle(0.5, "flux", material_sticking=[0.5, 0.1])
    )
    t.set_source_direction(vrt.TraceDirection.POS_Y)
    t.set_number_of_rays_per_point(rays_per_point)
    return t


# name -> (make function, rays per point of the sweep)
CONFIGS = {
    "disk2d": (make_disk2d, 2000),
    "line2d": (make_line2d, 2000),
    "disk3d": (make_disk3d, 2000),
    "tri3d": (make_tri3d, 2000),
    "disk18k": (make_disk18k, 200),
    "disk1m": (make_disk1m, 4),
    "ion": (make_ion, 2000),
}


def make(name, rays_per_point=None, seed=42):
    """The configured tracer for ``name`` (sweep ray count by default)."""
    make_fn, rpp = CONFIGS[name]
    t = make_fn(rays_per_point or rpp)
    t.set_rng_seed(seed)
    return t


def compile_batch(tracer):
    """The compiled executable of one traced mega-batch of ``tracer``, as
    its apply() would run it (for memory_analysis() and the HLO text)."""
    import jax
    import jax.numpy as jnp

    from viennaray_tpu.config import get_trace_settings
    from viennaray_tpu.trace.kernel import EnvKnobs
    from viennaray_tpu.trace.tracer import TraceDisk, TraceLine, _traced_batch

    geo_type = ("disk" if isinstance(tracer, TraceDisk)
                else "line" if isinstance(tracer, TraceLine) else "triangle")
    geo = tracer.geometry
    if geo_type == "disk":
        settings = get_trace_settings(tracer._source_direction)
        geo = geo.with_areas((settings[1], settings[2]),
                             tracer._boundary_conditions)
    config, _, source, bbox, batch = tracer._trace_setup(geo, geo_type)
    idx = jnp.arange(batch, dtype=jnp.int32)
    zeros = jnp.zeros((geo.num_primitives,), jnp.float32)
    return _traced_batch.lower(
        geo, source, tracer._particle, bbox, jax.random.PRNGKey(0), idx,
        idx >= 0, zeros, zeros, config, geo_type, kahan=True,
        knobs=EnvKnobs.from_env(),
    ).compile()


def timed_apply(tracer):
    """Warm apply (compiles), then one timed apply; returns
    (flux as float64 numpy, seconds of the timed apply)."""
    tracer.apply()
    t0 = time.perf_counter()
    flux = np.asarray(tracer.apply(), np.float64)
    return flux, time.perf_counter() - t0


def run(name):
    t = make(name)
    flux, dt = timed_apply(t)
    info = t.get_ray_trace_info()
    return {
        "config": name,
        "rays_per_s": info.num_rays / dt,
        "seconds": dt,
        "num_rays": int(info.num_rays),
        "geometry_hits": int(info.geometry_hits),
        "total_traces": int(info.total_rays_traced),
        "flux_sum": float(flux.sum()),
    }


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"perf_sweep needs a GPU, found {dev.platform}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    for name in sys.argv[1:] or list(CONFIGS):
        print(json.dumps({**run(name), "device": device}), flush=True)


if __name__ == "__main__":
    main()
