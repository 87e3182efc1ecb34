"""Deterministic flux deposit: a histogram of ray weights into prim bins.

The flux must be bitwise reproducible for a fixed seed and exact to float32
on every backend. A scatter-add gives neither on the GPU, where colliding
updates land through atomics in run-dependent order (two runs of the same
scatter-add differ in the last bits on the H100, PERF.md). Here the entries
are stably sorted by prim id and summed per prim with a segmented scan,
whose order is fixed by the data; each prim's total is then written once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.named_scope("deposit")
def flux_deposit(ids, weights, n_prims):
    """(n_prims,) sums of ``weights`` (E,) by prim id ``ids`` (E,) in
    [0, n_prims)."""
    ids_s, w_s = jax.lax.sort((ids, weights), num_keys=1, is_stable=True)
    boundary = ids_s[1:] != ids_s[:-1]
    first = jnp.concatenate([jnp.ones((1,), bool), boundary])
    last = jnp.concatenate([boundary, jnp.ones((1,), bool)])

    def combine(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, va + vb)

    _, run = jax.lax.associative_scan(combine, (first, w_s))
    # each prim's total sits at the last entry of its run; every other entry
    # is sent out of bounds and dropped, so no two writes collide
    target = jnp.where(last, ids_s, n_prims)
    return jnp.zeros((n_prims,), weights.dtype).at[target].set(
        run, mode="drop"
    )
