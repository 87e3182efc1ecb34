"""Multi-chip ray sharding.

The reference's only parallelism is OpenMP threads over rays with per-thread
flux copies merged post-hoc (rayTraceKernel.hpp:87-117, 343-407) and
single-GPU launch grids. The replacement here (SURVEY §2.9, §5.8):

- a 1-D ``jax.sharding.Mesh`` over axis ``"rays"``;
- ``jax.shard_map``-wrapped trace step: each device traces its ray sub-batch
  against replicated geometry (small — point clouds fit device memory easily);
- per-shard RNG streams via ``fold_in(batch_key, axis_index)``;
- flux and counters reduced with ``psum`` across devices — the collective analog of
  the reference's thread-local merge.

For multi-host runs call ``initialize_distributed()`` first
(``jax.distributed.initialize``); the mesh then spans all processes' devices
and the same code runs unchanged.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import TraceConfig
from ..trace.kernel import BatchCounters, trace_batch


def initialize_distributed(**kwargs):
    """Multi-host bootstrap (net-new vs the reference, SURVEY §2.9)."""
    jax.distributed.initialize(**kwargs)


def make_ray_mesh(devices=None) -> Mesh:
    """1-D device mesh over the ray axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), ("rays",))


def trace_batch_sharded(
    geometry,
    source,
    particle,
    bbox,
    batch_key,
    ray_indices,
    valid,
    config: TraceConfig,
    geo_type: str,
    mesh: Mesh,
    differentiable: bool = False,
    num_bounces: Optional[int] = None,
    sub_batch_start=0,
):
    """Trace one global mega-batch sharded over the mesh's ``rays`` axis.

    ray_indices/valid: (R_global,) with R_global divisible by mesh size.
    Returns replicated (flux (N,), counters) — flux is psum-reduced, the
    deterministic-collective analog of the reference's thread merge.

    RNG contract: ``batch_key`` is the run's BASE key and
    ``sub_batch_start`` the global index of this mega-batch's first
    device-sized sub-batch; shard s uses fold_in(base, start + s). Each
    shard therefore reproduces exactly the stream a single-device run with
    the same ``ray_batch_size`` would use for that sub-batch, so flux is
    invariant across device counts up to f32 reduction order (and bitwise
    reproducible for a fixed count) — the tests/rngSeed analog.
    """

    def shard_fn(ray_idx_local, valid_local):
        shard = jax.lax.axis_index("rays")
        key = jax.random.fold_in(batch_key, sub_batch_start + shard)
        flux, counters = trace_batch(
            geometry, source, particle, bbox, key, ray_idx_local, valid_local,
            config, geo_type, differentiable=differentiable,
            num_bounces=num_bounces,
        )
        flux = jax.lax.psum(flux, "rays")
        counters = jax.tree.map(lambda c: jax.lax.psum(c, "rays"), counters)
        return flux, counters

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("rays"), P("rays")),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(ray_indices, valid)


def trace_sharded(
    geometry,
    source,
    particle,
    bbox,
    config: TraceConfig,
    geo_type: str,
    base_key,
    total_rays: int,
    mesh: Mesh,
):
    """Full sharded trace: loops global mega-batches of
    ``config.ray_batch_size * mesh_size`` rays and accumulates flux.

    Determinism: fixed (seed, ray_batch_size, device count) => bitwise
    reproducible flux (psum reduction order is fixed; the deposit within a
    shard sums in an order fixed by the data, ops/deposit.py).
    """
    n_dev = mesh.devices.size
    per_batch = config.ray_batch_size * n_dev
    num_batches = max(1, -(-total_rays // per_batch))

    jitted = jax.jit(
        partial(
            trace_batch_sharded,
            config=config,
            geo_type=geo_type,
            mesh=mesh,
        ),
        static_argnames=(),
    )

    if jax.process_count() > 1:
        # Multi-host: inputs built per-process are host-local; hand jit
        # plain numpy leaves (identical on every process by construction)
        # so it can lay them out over the GLOBAL mesh — committed
        # single-process jnp arrays would fail the cross-process sharding
        # check. The replicated-consistency contract is the standard
        # jax.distributed pattern (same build inputs on every host).
        np_leaves = lambda t: jax.tree.map(np.asarray, t)
        geometry, source, particle, bbox, base_key = (
            np_leaves((geometry, source, particle, bbox, base_key))
        )

    def _host(x):
        """Local copy of a (replicated) global output."""
        if getattr(x, "is_fully_addressable", True):
            return np.asarray(x)
        return np.asarray(x.addressable_data(0))

    flux = None
    totals = np.zeros(len(BatchCounters._fields), np.int64)
    for b in range(num_batches):
        ray_indices = np.arange(b * per_batch, (b + 1) * per_batch,
                                 dtype=np.int32)
        valid = ray_indices < total_rays
        # base key + global sub-batch start: shard s of mega-batch b runs
        # the stream of single-device batch (b*n_dev + s) — see
        # trace_batch_sharded's RNG contract
        f, counters = jitted(
            geometry, source, particle, bbox, base_key, ray_indices, valid,
            sub_batch_start=jnp.int32(b * n_dev),
        )
        flux = f if flux is None else flux + f
        totals += np.array([int(_host(c)) for c in counters], np.int64)
    return _host(flux), totals
