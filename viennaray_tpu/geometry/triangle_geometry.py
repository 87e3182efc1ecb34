"""Device-resident triangle geometry.

Device analog of ``GeometryTriangle`` (rayGeometryTriangle.hpp): vertex
and index arrays in device memory with precomputed per-triangle normals and areas. 2D
line meshes are extruded to triangle pairs up front
(ref: rayTraceTriangle.hpp:76-81).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from ..utils import pytree as struct

from . import grid_accel
from .disk_geometry import GridData
from .mesh import LineMesh, TriangleMesh, compute_bounding_box, lines_to_triangles


@struct.dataclass
class TriangleGeometry:
    """vertices: (V, 3); triangles: (N, 3) int32; normals/areas per triangle.

    Areas: 3D = 0.5*|cross| ; 2D (extruded lines) = alternating half edge
    lengths so the two triangles of a segment each carry half the segment
    length (ref: rayGeometryTriangle.hpp:57-75,147-176).
    """

    vertices: jnp.ndarray
    triangles: jnp.ndarray
    normals: jnp.ndarray
    areas: jnp.ndarray
    material_ids: jnp.ndarray
    bbox: jnp.ndarray
    grid: "GridData" = None
    prims_soa: jnp.ndarray = None
    soa_perm: jnp.ndarray = None
    soa_chunk_bbs: jnp.ndarray = None
    dim: int = struct.field(pytree_node=False, default=3)
    grid_delta: float = struct.field(pytree_node=False, default=0.0)

    @property
    def num_primitives(self) -> int:
        return self.triangles.shape[0]

    @classmethod
    def build(
        cls,
        vertices,
        triangles,
        grid_delta: float,
        dim: int = 3,
        normals=None,
        material_ids=None,
        dtype=jnp.float32,
        accel: bool = True,
    ) -> "TriangleGeometry":
        vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
        triangles = np.asarray(triangles, np.int32).reshape(-1, 3)
        n = len(triangles)

        v0 = vertices[triangles[:, 0]]
        v1 = vertices[triangles[:, 1]]
        v2 = vertices[triangles[:, 2]]
        cr = np.cross(v1 - v0, v2 - v0)
        length = np.linalg.norm(cr, axis=1)
        safe = np.where(length > 0, length, 1.0)
        if normals is None:
            normals = cr / safe[:, None]
            normals[length == 0] = 0.0  # degenerate guard
            # (ref: rayGeometryTriangle.hpp:171-175)
        else:
            normals = np.asarray(normals, np.float32).reshape(-1, 3)

        if dim == 2:
            even = np.arange(n) % 2 == 0
            areas = np.where(
                even,
                0.5 * np.linalg.norm(v1 - v0, axis=1),
                0.5 * np.linalg.norm(v2 - v0, axis=1),
            )
        else:
            areas = 0.5 * length
        areas = np.where(length > 0, areas, 0.0)

        mat = (
            np.zeros((n,), np.int32)
            if material_ids is None
            else np.asarray(material_ids, np.int32)
        )
        bbox = compute_bounding_box(vertices)

        from ..ops.soa import pack_triangle_prims

        sort_axis = 2 if dim == 3 else 1
        soa, soa_perm, soa_bbs = pack_triangle_prims(
            vertices, triangles, normals=normals, sort_axis=sort_axis
        )

        grid = None
        if accel and n > 0:
            g = grid_accel.build_triangle_grid(vertices, triangles, dim=dim)
            grid = GridData(
                cells=jnp.asarray(g.cells),
                origin=jnp.asarray(g.origin, dtype),
                cell_size=jnp.asarray(g.cell_size, dtype),
                dims=g.dims,
            )

        return cls(
            vertices=jnp.asarray(vertices, dtype),
            triangles=jnp.asarray(triangles),
            normals=jnp.asarray(normals, dtype),
            areas=jnp.asarray(areas, dtype),
            material_ids=jnp.asarray(mat),
            bbox=jnp.asarray(bbox, dtype),
            grid=grid,
            prims_soa=jnp.asarray(soa),
            soa_perm=jnp.asarray(soa_perm),
            soa_chunk_bbs=jnp.asarray(soa_bbs),
            dim=dim,
            grid_delta=float(grid_delta),
        )

    @classmethod
    def from_mesh(cls, mesh: TriangleMesh, dim: int = 3) -> "TriangleGeometry":
        return cls.build(
            mesh.nodes,
            mesh.triangles,
            mesh.grid_delta,
            dim=dim,
            normals=mesh.normals,
        )

    @classmethod
    def from_line_mesh(cls, mesh: LineMesh) -> "TriangleGeometry":
        """2D path: extrude lines to triangles (ref: rayTraceTriangle.hpp:76-81)."""
        tri = lines_to_triangles(mesh)
        return cls.from_mesh(tri, dim=2)
