"""The deterministic flux deposit (ops/deposit.py) against a float64
np.add.at."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from viennaray_tpu.ops import deposit


def _case(n, e=40_000, seed=0):
    rng = np.random.default_rng(seed + n)
    ids = rng.integers(0, n, e).astype(np.int32)
    ids[:3] = [0, n - 1, n - 1]  # both ends of the range, one repeat
    w = rng.random(e).astype(np.float32)
    ref = np.zeros(n)
    np.add.at(ref, ids, w.astype(np.float64))
    return jnp.asarray(ids), jnp.asarray(w), ref


@pytest.mark.parametrize("n", [100, 8192, 8193, 18180, 70000])
def test_flux_deposit_matches_float64_add_at(n):
    ids, w, ref = _case(n)
    got = np.asarray(jax.jit(deposit.flux_deposit, static_argnums=2)(
        ids, w, n))
    assert got.shape == (n,)
    assert np.abs(got - ref).max() <= 1e-6 * ref.max()


def test_flux_deposit_bitwise_repeatable_and_order_free():
    """The same entries give the same bits; a permutation of the entries
    changes nothing but float rounding of in-segment sums (stable sort keeps
    each prim's entries in arrival order)."""
    ids, w, ref = _case(18180, e=100_000)
    f = jax.jit(deposit.flux_deposit, static_argnums=2)
    a = np.asarray(f(ids, w, 18180))
    b = np.asarray(f(ids, w, 18180))
    np.testing.assert_array_equal(a, b)
    perm = np.random.default_rng(3).permutation(ids.shape[0])
    c = np.asarray(f(ids[perm], w[perm], 18180))
    np.testing.assert_allclose(c, a, rtol=1e-5, atol=1e-6 * ref.max())


def test_flux_deposit_empty_bins_and_single_prim():
    ids = jnp.asarray([3, 3, 7], jnp.int32)
    w = jnp.asarray([1.0, 2.0, 4.0], jnp.float32)
    got = np.asarray(deposit.flux_deposit(ids, w, 10))
    np.testing.assert_array_equal(
        got, [0, 0, 0, 3.0, 0, 0, 0, 4.0, 0, 0])
    one = np.asarray(deposit.flux_deposit(
        jnp.zeros((5,), jnp.int32), jnp.ones((5,), jnp.float32), 1))
    np.testing.assert_array_equal(one, [5.0])


def test_flux_deposit_sums_in_prim_order_not_arrival_order():
    """The deposit never scatters with colliding indices: its jaxpr holds
    one sort and one scatter whose targets are unique per prim."""
    jaxpr = str(jax.make_jaxpr(deposit.flux_deposit, static_argnums=2)(
        jnp.zeros((1000,), jnp.int32), jnp.zeros((1000,)), 100))
    assert "sort" in jaxpr and "scatter-add" not in jaxpr
    assert "dot_general" not in jaxpr
