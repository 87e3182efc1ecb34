"""The in-repo pytree dataclass (viennaray_tpu/utils/pytree.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import viennaray_tpu as vrt
from viennaray_tpu.utils import pytree


@pytree.dataclass
class _Thing:
    a: jnp.ndarray
    b: jnp.ndarray = None
    tag: str = pytree.field(pytree_node=False, default="x")


def test_children_and_static_fields():
    t = _Thing(jnp.ones(3), jnp.zeros(2), tag="y")
    leaves, treedef = jax.tree_util.tree_flatten(t)
    assert len(leaves) == 2
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.tag == "y"
    # static fields are part of the structure
    other = _Thing(jnp.ones(3), jnp.zeros(2), tag="z")
    assert jax.tree_util.tree_structure(other) != treedef
    # None children flatten to nothing
    assert len(jax.tree_util.tree_leaves(_Thing(jnp.ones(3)))) == 1


def test_replace_and_frozen():
    t = _Thing(jnp.ones(3))
    u = t.replace(a=jnp.zeros(3), tag="q")
    assert u.tag == "q" and float(u.a.sum()) == 0.0
    assert float(t.a.sum()) == 3.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.a = jnp.zeros(3)


def test_jit_grad_and_tree_map_through_dataclass():
    @jax.jit
    def f(t):
        return jnp.sum(t.a * 2.0) if t.tag == "x" else 0.0

    t = _Thing(jnp.arange(3.0))
    assert float(f(t)) == 6.0
    g = jax.grad(lambda t: f(t))(t)
    np.testing.assert_array_equal(np.asarray(g.a), [2.0, 2.0, 2.0])
    doubled = jax.tree.map(lambda x: 2 * x, t)
    assert doubled.tag == "x"


def test_package_types_are_pytrees():
    p = vrt.DiffuseParticle(0.3)
    leaves = jax.tree_util.tree_leaves(p)
    assert any(np.asarray(x).size == 1 and float(x) == np.float32(0.3)
               for x in leaves)
    q = jax.jit(lambda p: p.replace(sticking=p.sticking * 2))(p)
    assert abs(float(q.sticking) - 0.6) < 1e-6
    assert q.name == p.name
