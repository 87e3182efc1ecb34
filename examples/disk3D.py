"""3D trench flux example (port of examples/disk3D/disk3D.cpp): the in-repo
3D trench fixture, or a reference-format grid file given as the first
argument."""

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import time

import viennaray_tpu as vrt
from viennaray_tpu.io import dat, fixtures, vtk

def main(path=None):
    if path:
        grid_delta, points, normals = dat.read_grid_from_file(path)
    else:
        points, normals = fixtures.create_trench_grid_3d(grid_delta=0.25)
        grid_delta = 0.25

    tracer = vrt.TraceDisk(dim=3)
    tracer.set_geometry(points, normals, grid_delta)
    tracer.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 3)
    tracer.set_particle_type(vrt.DiffuseParticle(0.1, "flux"))
    tracer.set_number_of_rays_per_point(2000)

    t0 = time.perf_counter()
    tracer.apply()
    print(f"Tracing time: {time.perf_counter() - t0} s")

    flux = tracer.get_local_data().get_vector_data("flux")
    flux = tracer.normalize_flux(flux, vrt.NormalizationType.SOURCE)
    flux = tracer.smooth_flux(flux)
    vtk.write_vtk("trenchResult3D.vtk", points, flux, dim=3)
    print("wrote trenchResult3D.vtk; info:", tracer.get_ray_trace_info())


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
