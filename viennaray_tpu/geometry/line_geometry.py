"""Device-resident 2D line-segment geometry.

Native segment primitives (parity with the GPU-only line tracer,
gpu/raygTraceLine.hpp + gpu/raygLineGeometry.hpp): segments are intersected
directly in 2D with the reference's endpoint-clipped cross-product test
(GeneralPipelineLine.cu:19-49) — no triangle extrusion. Areas are segment
lengths; smoothing is not implemented (matches raygTraceLine.hpp:26-28).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np
from ..utils import pytree as struct

from .mesh import LineMesh, compute_bounding_box


@struct.dataclass
class LineGeometry:
    """p0/p1: (N, 3) segment endpoints (z = 0); normals: (-dy, dx)
    normalized; areas: segment lengths."""

    p0: jnp.ndarray
    p1: jnp.ndarray
    normals: jnp.ndarray
    areas: jnp.ndarray
    material_ids: jnp.ndarray
    bbox: jnp.ndarray
    grid: Optional[object] = None  # reserved; line counts are small
    dim: int = struct.field(pytree_node=False, default=2)
    grid_delta: float = struct.field(pytree_node=False, default=0.0)

    @property
    def num_primitives(self) -> int:
        return self.p0.shape[0]

    # alias so the trace kernel can treat all geometries uniformly
    @property
    def points(self):
        return self.p0

    @classmethod
    def from_mesh(cls, mesh: LineMesh, material_ids=None,
                  dtype=jnp.float32) -> "LineGeometry":
        p0 = mesh.nodes[mesh.lines[:, 0]].astype(np.float32)
        p1 = mesh.nodes[mesh.lines[:, 1]].astype(np.float32)
        p0[:, 2] = 0.0
        p1[:, 2] = 0.0
        n = len(p0)
        lengths = np.linalg.norm((p1 - p0)[:, :2], axis=1)
        mat = (
            np.zeros((n,), np.int32)
            if material_ids is None
            else np.asarray(material_ids, np.int32)
        )
        bbox = compute_bounding_box(np.concatenate([p0, p1]))
        bbox[:, 2] = 0.0

        return cls(
            p0=jnp.asarray(p0, dtype),
            p1=jnp.asarray(p1, dtype),
            normals=jnp.asarray(mesh.normals, dtype),
            areas=jnp.asarray(lengths, dtype),
            material_ids=jnp.asarray(mat),
            bbox=jnp.asarray(bbox, dtype),
            grid_delta=float(mesh.grid_delta),
        )
