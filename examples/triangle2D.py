"""2D line-mesh flux example (port of examples/triangle2D/triangle2D.cpp):
2D lines are extruded to triangles internally (rayTraceTriangle.hpp:76-81).
Traces the in-repo 2D trench polyline, or a reference-format line mesh given
as the first argument."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import os
import time

import viennaray_tpu as vrt
from viennaray_tpu.io import dat, fixtures, vtk


def main(path=None):
    if path:
        grid_delta, nodes, elements = dat.read_mesh_from_file(path, 2)
    else:
        grid_delta = 0.1
        nodes, elements = fixtures.create_trench_lines_2d(grid_delta)

    mesh = vrt.LineMesh(nodes=nodes, lines=elements, grid_delta=grid_delta)
    tracer = vrt.TraceTriangle(dim=2)
    tracer.set_geometry(mesh)
    tracer.set_boundary_conditions(
        [vrt.BoundaryCondition.PERIODIC, vrt.BoundaryCondition.PERIODIC]
    )
    tracer.set_particle_type(vrt.DiffuseParticle(0.1, "flux"))
    tracer.set_source_direction(vrt.TraceDirection.POS_Y)
    tracer.set_number_of_rays_per_point(2000)

    t0 = time.perf_counter()
    tracer.apply()
    print(f"Tracing time: {time.perf_counter() - t0} s")

    flux = tracer.get_local_data().get_vector_data("flux")
    flux = tracer.normalize_flux(flux, vrt.NormalizationType.SOURCE)
    # per-extruded-triangle flux maps back to lines pairwise
    vtk.write_vtp("lineResult2D.vtp", mesh.nodes, mesh.lines, flux, dim=2)
    print("wrote lineResult2D.vtp; info:", tracer.get_ray_trace_info())


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
