"""Frozen dataclasses that are JAX pytrees.

``@dataclass`` turns a class into a frozen ``dataclasses.dataclass`` and
registers it with ``jax.tree_util.register_dataclass``: fields declared with
``field(pytree_node=False)`` are static metadata (part of the tree
structure, hence of a jit cache key); every other field is a child. Instances
get ``.replace(**changes)``.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """``dataclasses.field`` that records whether the field is a pytree
    child (``pytree_node=True``) or static metadata."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Frozen dataclass registered as a pytree (see the module docstring)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    data = [f.name for f in fields if f.metadata.get("pytree_node", True)]
    meta = [f.name for f in fields if not f.metadata.get("pytree_node", True)]
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls
