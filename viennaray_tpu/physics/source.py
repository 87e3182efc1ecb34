"""Batched ray sources.

Batched ports of the reference sources:

- ``RandomSource``  (ref: raySourceRandom.hpp) — uniform origins on the source
  plane, power-cosine directions (optionally tilted around a primary
  direction).
- ``GridSource``    (ref: raySourceGrid.hpp) — deterministic origins from a
  precomputed grid; identical direction distribution (the reference's
  ``tt = r2^(2/(p+1)); cos = sqrt(tt)`` equals ``r2^(1/(p+1))``).
- ``SurfaceSource`` (ref: gpu/raygTrace.hpp:267-297, gpu/raygSource.hpp:102-132)
  — emit from arbitrary surface points along their normals with per-point
  relative weights.

Sources are pytree dataclasses so their arrays flow as jit arguments (no
constant-baking) while axis bookkeeping stays static.

2D note: the reference samples the full 3D lobe and lets ``fillRayDirection<2>``
zero the z component and renormalize (rayUtil.hpp:210-215). We mirror that
exactly: the 2D direction distribution is the z-flattened renormalized 3D one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from ..utils import pytree as struct

from ..ops import sampling, vec


@struct.dataclass
class RandomSource:
    """Uniform plane origins + power-cosine directions (raySourceRandom.hpp)."""

    bbox: jnp.ndarray  # (2, 3) adjusted bounding box
    cosine_power: jnp.ndarray  # scalar
    basis: Optional[jnp.ndarray] = None  # (3, 3) ONB rows for tilted source
    ray_dir: int = struct.field(pytree_node=False, default=2)
    first_dir: int = struct.field(pytree_node=False, default=0)
    second_dir: int = struct.field(pytree_node=False, default=1)
    min_max: int = struct.field(pytree_node=False, default=1)
    pos_neg: float = struct.field(pytree_node=False, default=-1.0)
    dim: int = struct.field(pytree_node=False, default=3)
    num_points: int = struct.field(pytree_node=False, default=0)

    def source_area(self):
        """(ref: raySourceRandom.hpp:40-47)"""
        ext1 = self.bbox[1, self.first_dir] - self.bbox[0, self.first_dir]
        if self.dim == 2:
            return ext1
        ext2 = self.bbox[1, self.second_dir] - self.bbox[0, self.second_dir]
        return ext1 * ext2

    def _origins(self, key, n):
        k1, k2 = jax.random.split(key)
        r1 = jax.random.uniform(k1, (n,), dtype=self.bbox.dtype)
        lo1 = self.bbox[0, self.first_dir]
        hi1 = self.bbox[1, self.first_dir]
        origins = jnp.zeros((n, 3), dtype=self.bbox.dtype)
        origins = origins.at[:, self.ray_dir].set(
            self.bbox[self.min_max, self.ray_dir]
        )
        origins = origins.at[:, self.first_dir].set(lo1 + (hi1 - lo1) * r1)
        if self.dim == 3:
            r2 = jax.random.uniform(k2, (n,), dtype=self.bbox.dtype)
            lo2 = self.bbox[0, self.second_dir]
            hi2 = self.bbox[1, self.second_dir]
            origins = origins.at[:, self.second_dir].set(lo2 + (hi2 - lo2) * r2)
        return origins

    def _directions(self, key, n, dtype):
        lobe = sampling.power_cosine_direction(
            key, (n,), self.cosine_power, dtype=dtype
        )
        d = jnp.zeros((n, 3), dtype=dtype)
        # axis mapping (ref: raySourceRandom.hpp:81-83)
        d = d.at[:, self.ray_dir].set(self.pos_neg * lobe[:, 2])
        d = d.at[:, self.first_dir].set(lobe[:, 0])
        d = d.at[:, self.second_dir].set(lobe[:, 1])
        return d

    def _custom_directions(self, key, n, dtype):
        """Tilted lobe rotated by the primary-direction ONB, rejecting samples
        pointing away from the trace direction (ref: raySourceRandom.hpp:88-116)."""
        basis = self.basis

        def propose(k):
            lobe = sampling.power_cosine_direction(
                k, (n,), self.cosine_power, dtype=dtype
            )
            # reference maps (cosTheta, cosPhi sinTheta, sinPhi sinTheta) through
            # ONB rows: d = B0*l0 + B1*l1 + B2*l2
            l = jnp.stack([lobe[:, 2], lobe[:, 0], lobe[:, 1]], axis=-1)
            return jnp.matmul(l, basis, precision=jax.lax.Precision.HIGHEST)

        def accept(d):
            comp = d[:, self.ray_dir]
            return jnp.where(self.pos_neg < 0, comp <= 0.0, comp >= 0.0)

        init = jnp.zeros((n, 3), dtype=dtype)
        d, ok = sampling.masked_rejection(propose, accept, key, (n,), init)
        # lanes that never accepted fall back to the untilted lobe
        fallback = self._directions(jax.random.fold_in(key, 987654), n, dtype)
        return jnp.where(ok[:, None], d, fallback)

    def sample(self, key, ray_indices):
        n = ray_indices.shape[0]
        k_o, k_d = jax.random.split(key)
        origins = self._origins(k_o, n)
        dtype = self.bbox.dtype
        if self.basis is not None:
            dirs = self._custom_directions(k_d, n, dtype)
        else:
            dirs = self._directions(k_d, n, dtype)
        if self.dim == 2:
            dirs = vec.flatten_2d(dirs)
        weights = jnp.ones((n,), dtype=dtype)
        return origins, dirs, weights


@struct.dataclass
class GridSource:
    """Deterministic origins from a precomputed grid (raySourceGrid.hpp)."""

    bbox: jnp.ndarray  # (2, 3)
    grid: jnp.ndarray  # (N, 3) source points
    cosine_power: jnp.ndarray
    ray_dir: int = struct.field(pytree_node=False, default=2)
    first_dir: int = struct.field(pytree_node=False, default=0)
    second_dir: int = struct.field(pytree_node=False, default=1)
    pos_neg: float = struct.field(pytree_node=False, default=-1.0)
    dim: int = struct.field(pytree_node=False, default=3)

    @property
    def num_points(self):
        return self.grid.shape[0]

    def source_area(self):
        ext1 = self.bbox[1, self.first_dir] - self.bbox[0, self.first_dir]
        if self.dim == 2:
            return ext1
        ext2 = self.bbox[1, self.second_dir] - self.bbox[0, self.second_dir]
        return ext1 * ext2

    def sample(self, key, ray_indices):
        n = ray_indices.shape[0]
        dtype = self.grid.dtype
        origins = self.grid[ray_indices % self.grid.shape[0]]
        lobe = sampling.power_cosine_direction(
            key, (n,), self.cosine_power, dtype=dtype
        )
        d = jnp.zeros((n, 3), dtype=dtype)
        d = d.at[:, self.ray_dir].set(self.pos_neg * lobe[:, 2])
        d = d.at[:, self.first_dir].set(lobe[:, 0])
        d = d.at[:, self.second_dir].set(lobe[:, 1])
        if self.dim == 2:
            d = vec.flatten_2d(d)
        weights = jnp.ones((n,), dtype=dtype)
        return origins, dirs_out(d), weights


def dirs_out(d):
    return vec.normalize(d, eps=1e-12)


@struct.dataclass
class SurfaceSource:
    """Emit rays from surface points along per-point normals.

    Port of the GPU surface source (gpu/raygTrace.hpp:267-297,
    gpu/raygSource.hpp:102-132): origin = point + offset * normal, direction =
    power-cosine lobe rotated onto the normal; per-point relative weights give
    the initial ray weight.
    """

    points: jnp.ndarray  # (N, 3)
    normals: jnp.ndarray  # (N, 3)
    weights: jnp.ndarray  # (N,)
    cosine_power: jnp.ndarray
    offset: jnp.ndarray  # scalar offset along the normal
    area: jnp.ndarray  # user-provided source area
    dim: int = struct.field(pytree_node=False, default=3)

    @property
    def num_points(self):
        return self.points.shape[0]

    def source_area(self):
        return self.area

    def sample(self, key, ray_indices):
        n = ray_indices.shape[0]
        dtype = self.points.dtype
        pidx = ray_indices % self.points.shape[0]
        normals = self.normals[pidx]
        origins = self.points[pidx] + self.offset * normals
        lobe = sampling.power_cosine_direction(
            key, (n,), self.cosine_power, dtype=dtype
        )
        basis = vec.orthonormal_basis(normals)  # (n, 3, 3): rows u,v,w; u=normal
        d = (
            lobe[:, 2:3] * basis[:, 0]
            + lobe[:, 0:1] * basis[:, 1]
            + lobe[:, 1:2] * basis[:, 2]
        )
        if self.dim == 2:
            d = vec.flatten_2d(d)
        w = self.weights[pidx].astype(dtype)
        return origins, vec.normalize(d, eps=1e-12), w
