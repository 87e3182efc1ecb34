"""2D native line-segment flux example (port of
gpu/examples/trenchLines.cpp): segments are traced as first-class primitives
(no triangle extrusion), with per-material sticking. Traces the in-repo 2D
trench polyline, or a reference-format line mesh given as the first
argument."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import numpy as np

import viennaray_tpu as vrt
from viennaray_tpu.io import dat, fixtures, vtk

def main(path=None):
    if path:
        grid_delta, nodes, elements = dat.read_mesh_from_file(path, 2)
    else:
        grid_delta = 0.02
        nodes, elements = fixtures.create_trench_lines_2d(grid_delta)

    mesh = vrt.LineMesh(nodes=nodes, lines=elements, grid_delta=grid_delta)

    # two materials with a sticking map (ref: trenchLines.cpp:28-37)
    n = len(mesh.lines)
    material_ids = np.zeros((n,), np.int32)
    material_ids[n // 2 :] = 1

    tracer = vrt.TraceLine()
    tracer.set_geometry(mesh, material_ids=material_ids)
    tracer.set_boundary_conditions(
        [vrt.BoundaryCondition.PERIODIC, vrt.BoundaryCondition.PERIODIC]
    )
    particle = vrt.DiffuseParticle(
        0.5, "particleFlux", material_sticking=[0.5, 0.1]
    )
    tracer.set_particle_type(particle)
    tracer.set_source_direction(vrt.TraceDirection.POS_Y)
    tracer.set_number_of_rays_per_point(5000)
    tracer.set_max_boundary_hits(10)

    t0 = time.perf_counter()
    tracer.apply()
    print(f"Tracing time: {time.perf_counter() - t0} s")

    flux = tracer.get_local_data().get_vector_data("particleFlux")
    flux = tracer.normalize_flux(flux, vrt.NormalizationType.SOURCE)

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "trenchLines_lineFlux.vtp")
    vtk.write_vtp(out, mesh.nodes, mesh.lines, flux, dim=2)
    print(f"wrote {out}; info: {tracer.get_ray_trace_info()}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
