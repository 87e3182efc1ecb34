"""Fused nearest-hit kernel for the GPU: Pallas through Triton.

The XLA brute force (ops/intersect.py) tests every (ray, primitive) pair in
(R, 1024) tiles that round-trip through device memory. This kernel keeps the
pair tile in registers: a block of ``BLOCK_R`` rays walks the primitives in
chunks of ``soa.CHUNK`` (struct-of-arrays rows from ops/soa.py), keeps a
running (t_min, prim) per ray, and writes only those two (R,) results.

Before testing a chunk, the block slab-tests its rays against the chunk's
bounding box and skips the chunk when no ray can reach it nearer than its
current hit. Chunks are ordered source-side-first and rays arrive sorted by
position, so the rays of a block tend to find their hit early.

Ties between equal hit times go to the lowest original primitive index, as
in the brute force: the kernel carries original ids (``perm``) and takes the
smaller one on a tie.

Which implementation the trace uses is decided per geometry kind by
``disk_kernel`` / ``triangle_kernel``: the compiled kernel on the GPU, the
XLA path elsewhere. Tests patch those functions to run the kernel in
interpret mode on the CPU. 2D line segments always take the XLA brute
force: a line kernel was faster alone but not end to end (PERF.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# numpy scalars, NOT jnp: a module-level jnp constant would initialize the
# XLA backend at import time, breaking jax.distributed.initialize()
BIG = np.float32(3.4e38)
_NO_ID = np.int32(2**31 - 1)

# rays per kernel block, and warps per block
BLOCK_R = 64
NUM_WARPS = 4

# kernel choice for each geometry kind: "triton" (compiled for the GPU),
# "xla" (brute force or grid DDA), or "interpret" (tests only)


def disk_kernel(n_prims: int) -> str:
    """Nearest-hit implementation for ``n_prims`` disks."""
    return "triton" if jax.default_backend() == "gpu" else "xla"


def triangle_kernel(n_prims: int) -> str:
    """Nearest-hit implementation for ``n_prims`` triangles."""
    return "triton" if jax.default_backend() == "gpu" else "xla"


def _pair_t(kind, p, ox, oy, oz, dx, dy, dz, t_near):
    """Hit times of a (BLOCK_R, 1) ray column against a (1, chunk) prim row
    set ``p`` (list of SoA rows); BIG where there is no hit."""
    if kind == "disk":
        cx, cy, cz, nx, ny, nz, r2, ndc = p
        denom = dx * nx + dy * ny + dz * nz
        ok = denom != 0.0
        t = (ndc - (ox * nx + oy * ny + oz * nz)) / jnp.where(ok, denom, 1.0)
        hx = ox + t * dx - cx
        hy = oy + t * dy - cy
        hz = oz + t * dz - cz
        valid = ok & (t > t_near) & (hx * hx + hy * hy + hz * hz < r2)
    else:  # triangle
        ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z = p
        # Moller-Trumbore, double-sided
        hx = dy * e2z - dz * e2y
        hy = dz * e2x - dx * e2z
        hz = dx * e2y - dy * e2x
        det = hx * e1x + hy * e1y + hz * e1z
        ok = jnp.abs(det) >= 1e-9
        inv = 1.0 / jnp.where(ok, det, 1.0)
        sx = ox - ax
        sy = oy - ay
        sz = oz - az
        u = (sx * hx + sy * hy + sz * hz) * inv
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        v = (qx * dx + qy * dy + qz * dz) * inv
        t = (qx * e2x + qy * e2y + qz * e2z) * inv
        valid = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_near)
    return jnp.where(valid, t, BIG)


def _kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, prims_ref,
            perm_ref, bb_ref, t_ref, id_ref, *, kind, chunk, n_chunks,
            n_rows, t_near, skip):
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    inv_x = 1.0 / jnp.where(dx == 0.0, 1e-30, dx)
    inv_y = 1.0 / jnp.where(dy == 0.0, 1e-30, dy)
    inv_z = 1.0 / jnp.where(dz == 0.0, 1e-30, dz)
    col = lambda a: a[:, None]

    def test_chunk(i, carry):
        tmin, idx = carry
        sl = pl.ds(i * chunk, chunk)
        p = [prims_ref[r, sl][None, :] for r in range(n_rows)]
        tt = _pair_t(kind, p, col(ox), col(oy), col(oz), col(dx), col(dy),
                     col(dz), t_near)
        cmin = jnp.min(tt, axis=1)
        cid = jnp.min(
            jnp.where(tt == cmin[:, None], perm_ref[sl][None, :], _NO_ID),
            axis=1,
        )
        take = (cmin < tmin) | ((cmin == tmin) & (cid < idx))
        return jnp.where(take, cmin, tmin), jnp.where(take, cid, idx)

    def body(i, carry):
        if not skip:
            return test_chunk(i, carry)
        tmin = carry[0]
        # slab test: can any ray of the block reach the chunk's box nearer
        # than its current hit?
        t0x = (bb_ref[i, 0] - ox) * inv_x
        t1x = (bb_ref[i, 3] - ox) * inv_x
        t0y = (bb_ref[i, 1] - oy) * inv_y
        t1y = (bb_ref[i, 4] - oy) * inv_y
        t0z = (bb_ref[i, 2] - oz) * inv_z
        t1z = (bb_ref[i, 5] - oz) * inv_z
        tlo = jnp.maximum(
            jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y)),
            jnp.minimum(t0z, t1z),
        )
        thi = jnp.minimum(
            jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y)),
            jnp.maximum(t0z, t1z),
        )
        reach = (thi >= tlo) & (thi > 0.0) & (tlo < tmin)
        need = jnp.max(reach.astype(jnp.int32)) > 0
        return jax.lax.cond(
            need, lambda c: test_chunk(i, c), lambda c: c, carry
        )

    init = (
        jnp.full(ox.shape, BIG, jnp.float32),
        jnp.zeros(ox.shape, jnp.int32),
    )
    tmin, idx = jax.lax.fori_loop(0, n_chunks, body, init)
    t_ref[...] = tmin
    id_ref[...] = idx


@functools.partial(
    jax.jit, static_argnames=("kind", "t_near", "interpret")
)
def nearest_hit(org, dirn, prims, perm, chunk_bbs, *, kind, t_near=1e-4,
                interpret=False):
    """Closest hit per ray with the fused kernel.

    org, dirn: (R, 3) float32, any R. prims: (rows, Npad) SoA from
    ops/soa.py; perm: (Npad,) packed -> original prim id; chunk_bbs:
    (Npad / CHUNK, 8) chunk boxes. ``kind``: "disk" or "triangle".
    Returns (t (R,), prim (R,) int32 original id, hit (R,) bool); prim is 0
    on a miss, as in the brute force.
    """
    R = org.shape[0]
    n_chunks = chunk_bbs.shape[0]
    chunk = prims.shape[1] // n_chunks
    rp = -(-max(R, 1) // BLOCK_R) * BLOCK_R
    pad = ((0, rp - R), (0, 0))
    org = jnp.pad(org.astype(jnp.float32), pad)
    dirn = jnp.pad(dirn.astype(jnp.float32), pad)
    cols = [org[:, k] for k in range(3)] + [dirn[:, k] for k in range(3)]
    kernel = functools.partial(
        _kernel, kind=kind, chunk=chunk, n_chunks=n_chunks,
        n_rows={"disk": 8, "triangle": 9}[kind],
        t_near=float(t_near), skip=n_chunks > 1,
    )
    ray_spec = pl.BlockSpec((BLOCK_R,), lambda i: (i,))
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)
    t, ids = pl.pallas_call(
        kernel,
        grid=(rp // BLOCK_R,),
        in_specs=[ray_spec] * 6 + [whole(prims), whole(perm),
                                   whole(chunk_bbs)],
        out_specs=[ray_spec, ray_spec],
        out_shape=[
            jax.ShapeDtypeStruct((rp,), jnp.float32),
            jax.ShapeDtypeStruct((rp,), jnp.int32),
        ],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        backend="triton",
        interpret=interpret,
        name=f"{kind}_nearest_hit",
    )(*cols, prims, perm, chunk_bbs)
    t = t[:R]
    return t, ids[:R], t < BIG
