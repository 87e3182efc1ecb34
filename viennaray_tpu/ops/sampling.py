"""Batched random sampling primitives.

Batched equivalents of the reference's per-ray samplers:

- ``unit_sphere``       (ref: rayUtil.hpp:266-283, Marsaglia rejection) — here
  via the exact polar method (identical distribution, no rejection, fully
  vectorized).
- ``power_cosine_direction`` (ref: raySourceRandom.hpp:70-86)
- ``masked_rejection``  — the wavefront analog of per-ray ``do {} while``
  accept-reject loops: a batch-level ``lax.while_loop`` that re-samples only
  not-yet-accepted lanes. Exact (no acceptance bias), terminates when every
  lane has accepted or after ``max_iters``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import vec


def unit_sphere(key, shape, dtype=jnp.float32):
    """Uniform points on the unit sphere, shape (+ (3,)).

    Polar method: z = 1 - 2 u1, phi = 2 pi u2 — same distribution as the
    reference's Marsaglia sampler (rayUtil.hpp:266-283) without rejection.
    """
    k1, k2 = jax.random.split(key)
    z = 1.0 - 2.0 * jax.random.uniform(k1, shape, dtype=dtype)
    phi = (2.0 * jnp.pi) * jax.random.uniform(k2, shape, dtype=dtype)
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def power_cosine_direction(key, shape, cosine_power, dtype=jnp.float32):
    """Sample directions from the power-cosine lobe around +z.

    cos(theta) = r2^(1/(p+1)), phi uniform — matches SourceRandom::getDirection
    (raySourceRandom.hpp:70-86). Returns (..., 3) with z = cos(theta) >= 0.
    """
    k1, k2 = jax.random.split(key)
    r1 = jax.random.uniform(k1, shape, dtype=dtype)
    r2 = jax.random.uniform(k2, shape, dtype=dtype)
    ee = 1.0 / (cosine_power + 1.0)
    cos_theta = jnp.power(r2, ee)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    phi = (2.0 * jnp.pi) * r1
    return jnp.stack(
        [jnp.cos(phi) * sin_theta, jnp.sin(phi) * sin_theta, cos_theta], axis=-1
    )


def masked_rejection(propose, accept, key, batch_shape, init_value, max_iters=64):
    """Batch-level accept-reject.

    propose(key) -> candidate array with leading ``batch_shape``;
    accept(candidate) -> bool array of ``batch_shape``.

    Lanes that have accepted keep their value; others re-propose each round
    with a fresh fold_in'd key. Mirrors the per-ray ``do {} while`` rejection
    loops of the reference (e.g. raySourceRandom.hpp:92-113,
    rayReflection.hpp:87-94) in wavefront form.
    """

    def cond(state):
        i, _, done, _ = state
        return jnp.logical_and(i < max_iters, jnp.logical_not(jnp.all(done)))

    def body(state):
        i, value, done, k = state
        k_round = jax.random.fold_in(k, i)
        cand = propose(k_round)
        ok = accept(cand)
        take = jnp.logical_and(ok, jnp.logical_not(done))
        ndim_extra = cand.ndim - len(batch_shape)
        take_b = take.reshape(take.shape + (1,) * ndim_extra)
        value = jnp.where(take_b, cand, value)
        done = jnp.logical_or(done, ok)
        return (i + 1, value, done, k)

    done0 = jnp.zeros(batch_shape, dtype=bool)
    _, value, done, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), init_value, done0, key)
    )
    return value, done


def coned_cosine_theta(key, batch_shape, max_cone_angle, dtype=jnp.float32):
    """Sample polar angle for the coned-cosine lobe by accept-reject.

    u = sqrt(r); s = sqrt(1-u); theta = maxAngle * s; accept when
    r2 * theta * u <= cos(pi/2 * s) * sin(theta)
    (ref: rayReflection.hpp:86-94).
    """
    half_pi = jnp.asarray(jnp.pi / 2, dtype)

    def propose(k):
        k1, k2 = jax.random.split(k)
        u = jnp.sqrt(jax.random.uniform(k1, batch_shape, dtype=dtype))
        s = jnp.sqrt(jnp.maximum(1.0 - u, 0.0))
        theta = max_cone_angle * s
        r2 = jax.random.uniform(k2, batch_shape, dtype=dtype)
        ok = r2 * theta * u <= jnp.cos(half_pi * s) * jnp.sin(theta)
        return jnp.stack([theta, ok.astype(dtype)], axis=-1)

    def accept(cand):
        return cand[..., 1] > 0.5

    init = jnp.zeros(batch_shape + (2,), dtype=dtype)
    value, _ = masked_rejection(propose, accept, key, batch_shape, init)
    return value[..., 0]
