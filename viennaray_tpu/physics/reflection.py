"""Batched surface reflection models.

Batched port of rayReflection.hpp: every function maps a batch of
(ray_dir, normal) pairs to new unit directions, fully vectorized, keyed by a
single PRNG key (internally split).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import sampling, vec


def specular(ray_dir, normal, dim: int = 3):
    """Mirror reflection (ref: rayReflection.hpp:13-29)."""
    d = vec.reflect_specular(ray_dir, normal)
    if dim == 2:
        d = vec.flatten_2d(d)
    return d


def diffuse(key, normal, dim: int = 3):
    """Cosine-weighted diffuse reflection: normalize(sphere_point + normal).

    In 2D the z component is zeroed before normalization
    (ref: rayReflection.hpp:32-50).
    """
    rnd = sampling.unit_sphere(key, normal.shape[:-1], dtype=normal.dtype)
    d = rnd + normal
    if dim == 2:
        d = d.at[..., 2].set(0.0)
    return vec.normalize(d, eps=1e-12)


def coned_cosine(key, ray_dir, normal, max_cone_angle, dim: int = 3):
    """Specular lobe with max cone angle (ref: rayReflection.hpp:52-120).

    Limits: angle <= 0 -> specular; angle >= pi/2 -> diffuse. Those limits are
    taken branch-free via jnp.where so a per-primitive angle array also works.
    """
    max_cone_angle = jnp.asarray(max_cone_angle, dtype=ray_dir.dtype)
    k_theta, k_phi, k_diff = jax.random.split(key, 3)

    # specular direction w and Frisvad ONB (ref: rayReflection.hpp:66-83)
    w = vec.normalize(vec.reflect_specular(ray_dir, normal), eps=1e-12)
    t, b = vec.frisvad_basis(w)

    batch_shape = ray_dir.shape[:-1]
    theta = sampling.coned_cosine_theta(
        k_theta, batch_shape, jnp.clip(max_cone_angle, 1e-6, jnp.pi / 2 - 1e-6),
        dtype=ray_dir.dtype,
    )
    sin_t = jnp.sin(theta)[..., None]
    cos_t = jnp.cos(theta)[..., None]
    phi = (2.0 * jnp.pi) * jax.random.uniform(
        k_phi, batch_shape, dtype=ray_dir.dtype
    )
    sin_p = jnp.sin(phi)[..., None]
    cos_p = jnp.cos(phi)[..., None]

    d = sin_t * (cos_p * t + sin_p * b) + cos_t * w

    # hemisphere fix-up: flip if pointing into the surface
    # (ref: rayReflection.hpp:108-111)
    dp = vec.dot(d, normal)[..., None]
    d = jnp.where(dp <= 0.0, d - 2.0 * dp * normal, d)

    if dim == 2:
        d = d.at[..., 2].set(0.0)
    d = vec.normalize(d, eps=1e-12)

    # limit cases (ref: rayReflection.hpp:60-63)
    d_spec = specular(ray_dir, normal, dim)
    d_diff = diffuse(k_diff, normal, dim)
    angle = jnp.broadcast_to(max_cone_angle, batch_shape)[..., None]
    d = jnp.where(angle <= 0.0, d_spec, d)
    d = jnp.where(angle >= jnp.pi / 2, d_diff, d)
    return d
