"""Device-resident oriented-disk geometry.

Device analog of ``GeometryDisk`` (rayGeometryDisk.hpp): instead of Embree
buffers, the point cloud lives as jnp arrays in device memory plus a padded neighbor
matrix (for the disk multi-hit semantics and flux smoothing) and precomputed
clipped areas. Built on the host once per geometry via ``DiskGeometry.build``.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np
from ..utils import pytree as struct

from ..config import BoundaryCondition, disk_factor
from . import disk_area, grid_accel, neighborhood
from .mesh import DiskMesh, compute_bounding_box


@struct.dataclass
class GridData:
    """Device-side uniform grid (built by geometry/grid_accel.py)."""

    cells: jnp.ndarray  # (C, K) int32 padded -1
    origin: jnp.ndarray  # (3,)
    cell_size: jnp.ndarray  # scalar
    dims: tuple = struct.field(pytree_node=False, default=(1, 1, 1))


@struct.dataclass
class DiskGeometry:
    """Oriented-disk point cloud on device.

    points: (N, 3); normals: (N, 3) unit; radii: (N,); material_ids: (N,) int32
    neighbors: (N, K) padded -1 (pairs within 2*radius,
      ref: rayGeometryDisk.hpp:97-98); areas: (N,) boundary-clipped.
    bbox: (2, 3) raw geometry bounds (pre source adjustment).
    """

    points: jnp.ndarray
    normals: jnp.ndarray
    radii: jnp.ndarray
    material_ids: jnp.ndarray
    neighbors: jnp.ndarray
    areas: jnp.ndarray
    bbox: jnp.ndarray
    grid: Optional[GridData] = None
    # SoA packing (8, Npad) for the fused nearest-hit kernel (ops/soa.py),
    # spatially sorted source-side-first; soa_perm maps sorted->original ids
    # and soa_chunk_bbs carries per-chunk AABBs for the slab-skip test
    prims_soa: Optional[jnp.ndarray] = None
    soa_perm: Optional[jnp.ndarray] = None
    soa_chunk_bbs: Optional[jnp.ndarray] = None
    # per-prim neighbor records (N, K*8): [center(3) normal(3) radius valid]*K
    # -> ONE contiguous gather per hit instead of K small ones
    neighbor_pack: Optional[jnp.ndarray] = None
    dim: int = struct.field(pytree_node=False, default=3)
    grid_delta: float = struct.field(pytree_node=False, default=0.0)
    disk_radius: float = struct.field(pytree_node=False, default=0.0)

    @property
    def num_primitives(self) -> int:
        return self.points.shape[0]

    @classmethod
    def build(
        cls,
        points,
        normals,
        grid_delta: float,
        dim: int = 3,
        disk_radius: Optional[float] = None,
        radii=None,
        material_ids=None,
        dtype=jnp.float32,
        accel: bool = True,
        pack_neighbors: bool = True,
    ) -> "DiskGeometry":
        """Host-side construction (ref: rayGeometryDisk.hpp:initGeometry).

        In 2D the z coordinate of points and normals is zeroed
        (ref: rayGeometryDisk.hpp:49-51,68-69).

        ``pack_neighbors=False`` skips the (N, K*8) packed neighbor records
        (~600 MB host RAM at 1M prims); the trace then gathers the neighbor
        fields separately. ``accel=False`` skips the uniform grid.
        """
        points = np.asarray(points, np.float32).reshape(-1, 3).copy()
        normals = np.asarray(normals, np.float32).reshape(-1, 3).copy()
        if dim == 2:
            points[:, 2] = 0.0
            normals[:, 2] = 0.0
        norms = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = normals / np.where(norms > 0, norms, 1.0)

        if disk_radius is None:
            disk_radius = float(grid_delta) * disk_factor(dim)
        n = len(points)
        radii_arr = (
            np.full((n,), disk_radius, np.float32)
            if radii is None
            else np.asarray(radii, np.float32)
        )
        mat = (
            np.zeros((n,), np.int32)
            if material_ids is None
            else np.asarray(material_ids, np.int32)
        )

        bbox = compute_bounding_box(points)
        if dim == 2:
            bbox[:, 2] = 0.0

        nbrs, _ = neighborhood.build_neighborhood(
            points, 2.0 * disk_radius, dim=dim
        )

        grid = None
        if accel and n > 0:
            g = grid_accel.build_disk_grid(points, normals, radii_arr, dim=dim)
            grid = GridData(
                cells=jnp.asarray(g.cells),
                origin=jnp.asarray(g.origin, dtype),
                cell_size=jnp.asarray(g.cell_size, dtype),
                dims=g.dims,
            )

        from ..ops.soa import pack_disk_prims

        sort_axis = 2 if dim == 3 else 1
        soa, soa_perm, soa_bbs = pack_disk_prims(
            points, normals, radii_arr, sort_axis=sort_axis
        )
        prims_soa = jnp.asarray(soa)

        pack = None
        if pack_neighbors:
            k = nbrs.shape[1]
            cl = np.clip(nbrs, 0, None)
            pack = np.zeros((n, k, 8), np.float32)
            pack[:, :, 0:3] = points[cl]
            pack[:, :, 3:6] = normals[cl]
            pack[:, :, 6] = radii_arr[cl]
            pack[:, :, 7] = (nbrs >= 0).astype(np.float32)

        return cls(
            points=jnp.asarray(points, dtype),
            normals=jnp.asarray(normals, dtype),
            radii=jnp.asarray(radii_arr, dtype),
            material_ids=jnp.asarray(mat),
            neighbors=jnp.asarray(nbrs),
            areas=jnp.zeros((n,), dtype),
            bbox=jnp.asarray(bbox, dtype),
            grid=grid,
            prims_soa=prims_soa,
            soa_perm=jnp.asarray(soa_perm),
            soa_chunk_bbs=jnp.asarray(soa_bbs),
            neighbor_pack=None if pack is None else jnp.asarray(
                pack.reshape(n, -1)
            ),
            dim=dim,
            grid_delta=float(grid_delta),
            disk_radius=float(disk_radius),
        )

    @classmethod
    def from_mesh(cls, mesh: DiskMesh, dim: int = 3) -> "DiskGeometry":
        radius = (
            None
            if mesh.radius == 0.0
            else float(mesh.radius)
        )
        return cls.build(
            mesh.nodes,
            mesh.normals,
            mesh.grid_delta,
            dim=dim,
            disk_radius=radius,
            radii=mesh.radii,
        )

    def with_areas(self, boundary_dirs, boundary_conds):
        """Compute boundary-clipped disk areas against the geometry's own
        bounding box (ref: rayGeometryDisk.hpp:computeDiskAreas uses
        ``this->getBoundingBox()``, i.e. the raw extents, not the
        source-adjusted box)."""
        pts = np.asarray(self.points, np.float64)
        nrm = np.asarray(self.normals, np.float64)
        rad = np.asarray(self.radii, np.float64)
        bbox = np.asarray(self.bbox, np.float64)
        if self.dim == 3:
            areas = disk_area.disk_areas_3d(
                pts, nrm, rad, bbox, boundary_dirs, boundary_conds
            )
        else:
            areas = disk_area.disk_areas_2d(
                pts, nrm, rad, bbox, boundary_dirs, boundary_conds
            )
        return self.replace(areas=jnp.asarray(areas, self.points.dtype))
