"""2D trench flux example (port of examples/disk2D/disk2D.cpp).

Traces the in-repo 2D trench fixture, or a reference-format grid file given
as the first argument; traces 2000 rays/point with a diffuse particle
(sticking 0.1) under periodic boundaries; writes trenchResult2D.vtk.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import os
import time

import viennaray_tpu as vrt
from viennaray_tpu.io import dat, fixtures, vtk

def main(path=None):
    if path:
        grid_delta, points, normals = dat.read_grid_from_file(path)
    else:
        points, normals = fixtures.create_trench_grid_2d(grid_delta=0.1)
        grid_delta = 0.1

    tracer = vrt.TraceDisk(dim=2)
    tracer.set_geometry(points, normals, grid_delta)
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
    flux = tracer.smooth_flux(flux, 1)
    vtk.write_vtk("trenchResult2D.vtk", points, flux, dim=2)
    print("wrote trenchResult2D.vtk; info:", tracer.get_ray_trace_info())


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
