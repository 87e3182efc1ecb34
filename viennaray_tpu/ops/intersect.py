"""Batched ray/primitive intersection.

Plain-XLA replacement for Embree BVH traversal (rayTraceKernel.hpp:163-167)
and the OptiX analytic primitive programs (gpu/pipelines/*.cu): all active
rays test primitives in parallel as chunked ``[rays, prims]`` tiles. The inner
products ``dot(n_j, org_i)``, ``dot(n_j, dir_i)``, ``dot(c_j, org_i)``,
``dot(c_j, dir_i)`` are (R,3)x(3,P) matmuls; the remaining work is
elementwise. A ``fori_loop`` over prim chunks bounds the live tile and
maintains a running (t_min, argmin) — the wavefront analog of "find the
closest hit". This is the reference the fused kernel (ops/hit_kernel.py) is
checked against, and the path on backends without that kernel.

Semantics mirrored from the reference:
- disks are double-sided planes clipped to the radius (backface handling
  happens in the trace loop, rayTraceKernel.hpp:225-248);
- hits require t > t_near (ref tnear = 1e-4, rayUtil.hpp:230);
- the neighbor re-test ``check_local_intersection`` is front-face-only with
  an epsilon parallel guard (ref: rayTraceKernel.hpp:462-507).
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

# numpy scalar, NOT jnp: a module-level jnp constant would
# initialize the XLA backend at import time, breaking
# jax.distributed.initialize() (must run before any backend use)
BIG = np.float32(3.4e38)


def _mm(a, b):
    """f32-accurate matmul: a default-precision f32 product may run in
    bf16 or TF32 on an accelerator, far too coarse for hit tests (disk radii
    ~1e-1 vs a coordinate error ~1e-2); HIGHEST asks for full f32."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def disk_nearest_hit(org, direction, points, normals, radii, t_near, chunk=1024):
    """Closest disk hit per ray.

    org, direction: (R, 3); points/normals: (N, 3); radii: (N,).
    Returns (t (R,), prim (R,) int32, hit (R,) bool).
    """
    R = org.shape[0]
    N = points.shape[0]
    pad = (-N) % chunk
    if pad:
        # pad far away but small enough that squared terms stay finite in f32
        points = jnp.pad(points, ((0, pad), (0, 0)), constant_values=1e18)
        normals = jnp.pad(normals, ((0, pad), (0, 0)))
        radii = jnp.pad(radii, (0, pad))
    n_dot_c = jnp.sum(normals * points, axis=1)  # (N',)
    c2 = jnp.sum(points * points, axis=1)  # (N',)

    org2 = jnp.sum(org * org, axis=1)  # (R,)
    dir_dot_org = jnp.sum(direction * org, axis=1)  # (R,)

    def per_chunk(start):
        p = jax.lax.dynamic_slice_in_dim(points, start, chunk)
        n = jax.lax.dynamic_slice_in_dim(normals, start, chunk)
        r_ = jax.lax.dynamic_slice_in_dim(radii, start, chunk)
        ndc = jax.lax.dynamic_slice_in_dim(n_dot_c, start, chunk)
        cc2 = jax.lax.dynamic_slice_in_dim(c2, start, chunk)

        denom = _mm(direction, n.T)  # (R, P)
        n_dot_o = _mm(org, n.T)  # (R, P)
        t = (ndc[None, :] - n_dot_o) / jnp.where(denom == 0, 1e-30, denom)

        o_dot_c = _mm(org, p.T)  # (R, P)
        d_dot_c = _mm(direction, p.T)  # (R, P)
        dist2 = (
            org2[:, None]
            - 2.0 * o_dot_c
            + cc2[None, :]
            + 2.0 * t * (dir_dot_org[:, None] - d_dot_c)
            + t * t
        )
        valid = (denom != 0) & (t > t_near) & (dist2 < r_[None, :] * r_[None, :])
        return t, valid

    num_chunks = (points.shape[0]) // chunk
    t_min = jnp.full((R,), BIG, dtype=org.dtype)
    arg_min = jnp.zeros((R,), jnp.int32)

    def body(i, carry):
        t_m, a_m = carry
        start = i * chunk
        t_c, valid = per_chunk(start)
        t_c = jnp.where(valid, t_c, BIG)
        idx_c = jnp.argmin(t_c, axis=1).astype(jnp.int32)
        t_best = jnp.take_along_axis(t_c, idx_c[:, None].astype(jnp.int32), axis=1)[:, 0]
        take = t_best < t_m
        return (
            jnp.where(take, t_best, t_m),
            jnp.where(take, start + idx_c, a_m),
        )

    t_min, arg_min = jax.lax.fori_loop(0, num_chunks, body, (t_min, arg_min))
    hit = t_min < BIG
    return t_min, arg_min, hit


def triangle_nearest_hit(org, direction, vertices, triangles, t_near, chunk=1024):
    """Closest triangle hit per ray (Moller-Trumbore, double-sided — Embree
    reports both facings; backface kill happens in the trace loop,
    rayTraceKernel.hpp:243-248).

    Returns (t (R,), prim (R,) int32, hit (R,) bool).
    """
    R = org.shape[0]
    N = triangles.shape[0]
    v0 = vertices[triangles[:, 0]]
    e1 = vertices[triangles[:, 1]] - v0
    e2 = vertices[triangles[:, 2]] - v0
    pad = (-N) % chunk
    if pad:
        v0 = jnp.pad(v0, ((0, pad), (0, 0)), constant_values=1e18)
        e1 = jnp.pad(e1, ((0, pad), (0, 0)))
        e2 = jnp.pad(e2, ((0, pad), (0, 0)))

    eps = jnp.float32(1e-9)

    def per_chunk(start):
        a0 = jax.lax.dynamic_slice_in_dim(v0, start, chunk)
        a1 = jax.lax.dynamic_slice_in_dim(e1, start, chunk)
        a2 = jax.lax.dynamic_slice_in_dim(e2, start, chunk)

        # Moller-Trumbore per (ray, tri) pair; cross products expand to
        # matmul-friendly contractions
        # h = dir x e2  -> (R, P, 3)
        d = direction[:, None, :]
        h = jnp.cross(jnp.broadcast_to(d, (R, chunk, 3)), a2[None, :, :])
        det = jnp.sum(h * a1[None, :, :], axis=-1)  # (R, P)
        inv_det = 1.0 / jnp.where(jnp.abs(det) < eps, 1e-30, det)
        s = org[:, None, :] - a0[None, :, :]  # (R, P, 3)
        u = jnp.sum(s * h, axis=-1) * inv_det
        q = jnp.cross(s, jnp.broadcast_to(a1[None, :, :], (R, chunk, 3)))
        v = jnp.sum(q * d, axis=-1) * inv_det
        t = jnp.sum(q * a2[None, :, :], axis=-1) * inv_det
        valid = (
            (jnp.abs(det) >= eps)
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > t_near)
        )
        return t, valid

    num_chunks = v0.shape[0] // chunk
    t_min = jnp.full((R,), BIG, dtype=org.dtype)
    arg_min = jnp.zeros((R,), jnp.int32)

    def body(i, carry):
        t_m, a_m = carry
        start = i * chunk
        t_c, valid = per_chunk(start)
        t_c = jnp.where(valid, t_c, BIG)
        idx_c = jnp.argmin(t_c, axis=1).astype(jnp.int32)
        t_best = jnp.take_along_axis(t_c, idx_c[:, None], axis=1)[:, 0]
        take = t_best < t_m
        return (
            jnp.where(take, t_best, t_m),
            jnp.where(take, start + idx_c, a_m),
        )

    t_min, arg_min = jax.lax.fori_loop(0, num_chunks, body, (t_min, arg_min))
    hit = t_min < BIG
    return t_min, arg_min, hit


def line_nearest_hit(org, direction, p0, p1, t_near, chunk=1024):
    """Closest 2D segment hit per ray (ref: GeneralPipelineLine.cu:19-49).

    denom = dx*ly - dy*lx;  t = ((p0-o)_x*ly - (p0-o)_y*lx)/denom;
    s = ((p0-o)_x*dy - (p0-o)_y*dx)/denom; valid when t > t_near and
    s in (1e-5, 1 - 1e-5) — the reference's endpoint clip.
    Returns (t (R,), prim (R,) int32, hit (R,) bool).
    """
    R = org.shape[0]
    N = p0.shape[0]
    pad = (-N) % chunk
    if pad:
        p0 = jnp.pad(p0, ((0, pad), (0, 0)), constant_values=1e18)
        p1 = jnp.pad(p1, ((0, pad), (0, 0)), constant_values=1e18)
    ld = p1 - p0  # (N', 3) segment direction

    eps_s = jnp.float32(1e-5)

    def per_chunk(start):
        a0 = jax.lax.dynamic_slice_in_dim(p0, start, chunk)
        d0 = jax.lax.dynamic_slice_in_dim(ld, start, chunk)
        lx = d0[None, :, 0]
        ly = d0[None, :, 1]
        dx = direction[:, 0:1]
        dy = direction[:, 1:2]
        denom = dx * ly - dy * lx  # (R, P)
        inv = 1.0 / jnp.where(denom == 0, 1e-30, denom)
        wx = a0[None, :, 0] - org[:, 0:1]
        wy = a0[None, :, 1] - org[:, 1:2]
        t = (wx * ly - wy * lx) * inv
        s = (wx * dy - wy * dx) * inv
        valid = (
            (denom != 0)
            & (t > t_near)
            & (s > eps_s)
            & (s < 1.0 - eps_s)
        )
        return t, valid

    num_chunks = p0.shape[0] // chunk
    t_min = jnp.full((R,), BIG, dtype=org.dtype)
    arg_min = jnp.zeros((R,), jnp.int32)

    def body(i, carry):
        t_m, a_m = carry
        t_c, valid = per_chunk(i * chunk)
        t_c = jnp.where(valid, t_c, BIG)
        idx_c = jnp.argmin(t_c, axis=1).astype(jnp.int32)
        t_best = jnp.take_along_axis(t_c, idx_c[:, None], axis=1)[:, 0]
        take = t_best < t_m
        return (
            jnp.where(take, t_best, t_m),
            jnp.where(take, i * chunk + idx_c, a_m),
        )

    t_min, arg_min = jax.lax.fori_loop(0, num_chunks, body, (t_min, arg_min))
    hit = t_min < BIG
    return t_min, arg_min, hit


@jax.named_scope("neighbors")
def check_neighbors_packed(org, direction, rec):
    """Neighbor re-test over a pre-packed record gather.

    rec: (R, K, 8) rows [center(3) normal(3) radius valid] gathered in ONE
    contiguous fetch instead of four per-array gathers. Semantics
    identical to ``check_local_intersection``.
    Returns (valid (R, K) bool, distance (R, K)).
    """
    centers = rec[:, :, 0:3]
    normals = rec[:, :, 3:6]
    radii = rec[:, :, 6]
    pad_ok = rec[:, :, 7] > 0.5
    valid, dist = check_local_intersection(org, direction, centers, normals,
                                           radii)
    return valid & pad_ok, dist


def check_local_intersection(org, direction, centers, normals, radii):
    """Neighbor-disk re-test (ref: rayTraceKernel.hpp:462-507).

    org, direction: (R, 3); centers/normals: (R, K, 3); radii: (R, K).
    Front-face-only: dot(n, dir) must be < -eps (eps = 1e-6); plane t > 0
    (NOT t_near — the reference uses a strict 0 here); in-plane distance
    strictly < radius. Returns (valid (R, K) bool, distance (R, K)).
    """
    eps = jnp.float32(1e-6)
    d = direction[:, None, :]
    o = org[:, None, :]
    prod = jnp.sum(normals * d, axis=-1)  # (R, K)
    front = prod <= 0.0
    not_parallel = jnp.abs(prod) >= eps
    ddneg = jnp.sum(centers * normals, axis=-1)
    t = (ddneg - jnp.sum(normals * o, axis=-1)) / jnp.where(
        prod == 0, 1e-30, prod
    )
    hitp = o + t[..., None] * d
    diff = hitp - centers
    dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
    valid = front & not_parallel & (t > 0.0) & (dist < radii)
    return valid, dist


@jax.named_scope("deposit")
def disk_window_deposit(org, direction, points, normals, radii, tlim, wdep,
                        t_near, chunk=1024):
    """Candidate-window flux deposits (GPU ``flux_model="window"`` contract,
    GeneralPipelineDisk.cu:51-59,86-93): every disk the ray intersects with
    t_near < t <= tlim receives the ray's pre-sticking weight — no facing
    test, no adjacency. ``tlim`` is per ray (t_hit + tau for colliding rays,
    -BIG otherwise); ``wdep`` the masked deposit weight.

    Returns (N,) per-prim deposits for this bounce.
    """
    N = points.shape[0]
    pad = (-N) % chunk
    if pad:
        points = jnp.pad(points, ((0, pad), (0, 0)), constant_values=1e18)
        normals = jnp.pad(normals, ((0, pad), (0, 0)))
        radii = jnp.pad(radii, (0, pad))
    n_dot_c = jnp.sum(normals * points, axis=1)
    c2 = jnp.sum(points * points, axis=1)
    org2 = jnp.sum(org * org, axis=1)
    dir_dot_org = jnp.sum(direction * org, axis=1)

    def body(i, acc):
        start = i * chunk
        p = jax.lax.dynamic_slice_in_dim(points, start, chunk)
        n = jax.lax.dynamic_slice_in_dim(normals, start, chunk)
        r_ = jax.lax.dynamic_slice_in_dim(radii, start, chunk)
        ndc = jax.lax.dynamic_slice_in_dim(n_dot_c, start, chunk)
        cc2 = jax.lax.dynamic_slice_in_dim(c2, start, chunk)

        denom = _mm(direction, n.T)
        n_dot_o = _mm(org, n.T)
        t = (ndc[None, :] - n_dot_o) / jnp.where(denom == 0, 1e-30, denom)
        o_dot_c = _mm(org, p.T)
        d_dot_c = _mm(direction, p.T)
        dist2 = (
            org2[:, None]
            - 2.0 * o_dot_c
            + cc2[None, :]
            + 2.0 * t * (dir_dot_org[:, None] - d_dot_c)
            + t * t
        )
        dep = (
            (denom != 0)
            & (t > t_near)
            & (dist2 < r_[None, :] * r_[None, :])
            & (t <= tlim[:, None])
        )
        contrib = _mm(wdep[None, :], dep.astype(wdep.dtype))[0]
        return jax.lax.dynamic_update_slice_in_dim(
            acc, jax.lax.dynamic_slice_in_dim(acc, start, chunk) + contrib,
            start, 0,
        )

    acc = jnp.zeros((points.shape[0],), wdep.dtype)
    acc = jax.lax.fori_loop(0, points.shape[0] // chunk, body, acc)
    return acc[:N]
