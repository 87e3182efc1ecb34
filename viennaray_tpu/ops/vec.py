"""Batched 3-vector math on ``(..., 3)`` arrays.

Batched replacement for the reference's scalar ``Vec3D`` helpers
(ViennaCore vcVectorType.hpp, used throughout the reference). Every function
is shape-polymorphic over leading batch axes and safe under jit/vmap.
"""

from __future__ import annotations

import jax.numpy as jnp


def dot(a, b):
    """Row-wise dot product of (..., 3) arrays -> (...)."""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def norm2(a):
    return jnp.sum(a * a, axis=-1)


def norm(a):
    return jnp.sqrt(norm2(a))


def normalize(a, eps: float = 0.0):
    n = norm(a)[..., None]
    if eps:
        n = jnp.maximum(n, eps)
    return a / n


def scale_add(direction, origin, t):
    """origin + t * direction, t broadcast over the last axis."""
    return origin + t[..., None] * direction


def reflect_specular(ray_dir, normal):
    """Specular reflection d' = 2 (n . -d) n + d... expressed as the reference
    does: dirOldInv = -d; d' = 2 (n . dirOldInv) n - dirOldInv
    (ref: rayReflection.hpp:13-29)."""
    inv = -ray_dir
    return 2.0 * dot(normal, inv)[..., None] * normal - inv


def orthonormal_basis(vec):
    """Deterministic orthonormal basis {u, v, w} with u = normalize(vec).

    Batched port of the reference's ``getOrthonormalBasis``
    (rayUtil.hpp:287-321): helper axis chosen by comparing |x| vs |z|.
    Returns (..., 3, 3) where [..., 0, :] = u, [..., 1, :] = v, [..., 2, :] = w.
    """
    u = normalize(vec)
    ux, uy, uz = u[..., 0], u[..., 1], u[..., 2]
    cond = jnp.abs(ux) > jnp.abs(uz)
    h = jnp.where(
        cond[..., None],
        jnp.stack([-uy, ux, jnp.zeros_like(ux)], axis=-1),
        jnp.stack([jnp.zeros_like(ux), -uz, uy], axis=-1),
    )
    v = normalize(h)
    w = cross(u, v)
    return jnp.stack([u, v, w], axis=-2)


def frisvad_basis(w):
    """Fast ONB (t, b) around unit vector w (Frisvad construction), matching
    the coned-cosine reflection's basis (ref: rayReflection.hpp:72-83)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    degenerate = wz < -0.999999
    a = 1.0 / jnp.where(degenerate, 1.0, 1.0 + wz)
    bx = -wx * wy * a
    by = 1.0 - wy * wy * a
    t = jnp.stack([1.0 - wx * wx * a, bx, -wx], axis=-1)
    b = jnp.stack([bx, by, -wy], axis=-1)
    t_deg = jnp.broadcast_to(jnp.array([0.0, -1.0, 0.0], dtype=w.dtype), t.shape)
    b_deg = jnp.broadcast_to(jnp.array([-1.0, 0.0, 0.0], dtype=w.dtype), b.shape)
    t = jnp.where(degenerate[..., None], t_deg, t)
    b = jnp.where(degenerate[..., None], b_deg, b)
    return t, b


def flatten_2d(direction):
    """Zero the z component and renormalize (2D mode ray directions,
    ref: rayUtil.hpp:210-215)."""
    d = direction.at[..., 2].set(0.0)
    n = norm(d)[..., None]
    return d / jnp.where(n > 0, n, 1.0)
