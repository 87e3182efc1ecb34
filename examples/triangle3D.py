"""3D triangle-mesh flux example (port of examples/triangle3D/triangle3D.cpp):
the in-repo 3D trench mesh, or a reference-format mesh given as the first
argument."""

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import time

import viennaray_tpu as vrt
from viennaray_tpu.io import dat, fixtures, vtk


def main(path=None):
    if path:
        grid_delta, nodes, elements = dat.read_mesh_from_file(path, 3)
    else:
        grid_delta = 0.2
        nodes, elements = fixtures.create_trench_mesh_3d(grid_delta)

    mesh = vrt.TriangleMesh(nodes=nodes, triangles=elements,
                            grid_delta=grid_delta)
    tracer = vrt.TraceTriangle(dim=3)
    tracer.set_geometry(mesh)
    tracer.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 3)
    tracer.set_particle_type(vrt.DiffuseParticle(0.1, "flux"))
    tracer.set_number_of_rays_per_point(1000)

    t0 = time.perf_counter()
    tracer.apply()
    print(f"Tracing time: {time.perf_counter() - t0} s")

    flux = tracer.get_local_data().get_vector_data("flux")
    flux = tracer.normalize_flux(flux, vrt.NormalizationType.SOURCE)
    vtk.write_vtp("trenchResultTri3D.vtp", mesh.nodes, mesh.triangles, flux,
                  dim=3)
    print("wrote trenchResultTri3D.vtp; info:", tracer.get_ray_trace_info())


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
