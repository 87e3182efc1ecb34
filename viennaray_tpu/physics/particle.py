"""Particle models.

The reference's CRTP virtual-dispatch particles (rayParticle.hpp:21-124) and
the GPU particle data struct (rayParticle.hpp:206-220) collapse here into a
single pytree dataclass: continuous parameters (sticking, per-material sticking
table, cosine exponent, cone angle) are arrays — and therefore differentiable —
while the behavioral choice (reflection model) is a jit-static enum.

Custom physics: pass ``collision_fn`` / ``reflection_fn`` overrides to the
trace kernel (see trace/kernel.py); JAX functions are the idiomatic equivalent
of the reference's GPU direct-callable table (gpu/raygCallableConfig.hpp).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from ..utils import pytree as struct

from ..config import ReflectionKind
from . import reflection


@struct.dataclass
class Particle:
    """A particle species' parameters (pytree).

    Attributes:
      sticking: scalar default sticking probability.
      material_sticking: optional (num_materials,) sticking lookup by material
        id (ref GPU per-material sticking map, rayParticle.hpp:213).
      cosine_exponent: power of the source cosine lobe
        (ref: getSourceDistributionPower, rayParticle.hpp:69).
      cone_angle: max cone angle for CONED_COSINE reflection.
      mean_free_path: gas-phase scattering mean free path; < 0 disables
        (ref: getMeanFreePath, rayParticle.hpp:73).
      reflection_kind: static reflection model selector.
      direction: optional fixed initial direction (3,) overriding the
        source's sampled direction for every ray — the analog of
        ``initNewWithDirection`` returning a nonzero vector
        (rayParticle.hpp:31,92) and the GPU particle struct's fixed
        ``direction`` field (rayParticle.hpp:206-220). Normalized (and
        z-flattened in 2D) by the trace kernel. For per-ray randomized
        directions use the ``init_dir_fn`` hook on ``trace_batch``.
      data_labels: static names of the flux channels this particle fills
        (ref: getLocalDataLabels, rayParticle.hpp:78).
      name: species name.
    """

    sticking: jnp.ndarray
    cosine_exponent: jnp.ndarray
    cone_angle: jnp.ndarray
    material_sticking: Optional[jnp.ndarray] = None
    direction: Optional[jnp.ndarray] = None
    mean_free_path: float = struct.field(pytree_node=False, default=-1.0)
    reflection_kind: int = struct.field(
        pytree_node=False, default=int(ReflectionKind.DIFFUSE)
    )
    data_labels: Tuple[str, ...] = struct.field(
        pytree_node=False, default=("flux",)
    )
    name: str = struct.field(pytree_node=False, default="particle")

    def sticking_for(self, material_ids):
        """Per-hit sticking: material table if provided, else the scalar."""
        if self.material_sticking is None:
            return jnp.broadcast_to(self.sticking, material_ids.shape)
        return self.material_sticking[jnp.clip(material_ids, 0, None)]

    def reflect(self, key, ray_dir, normal, dim: int):
        kind = ReflectionKind(self.reflection_kind)
        if kind == ReflectionKind.DIFFUSE:
            return reflection.diffuse(key, normal, dim)
        if kind == ReflectionKind.SPECULAR:
            return reflection.specular(ray_dir, normal, dim)
        return reflection.coned_cosine(key, ray_dir, normal, self.cone_angle, dim)


def DiffuseParticle(
    sticking_probability: float,
    data_label: str = "flux",
    dtype=jnp.float32,
    material_sticking=None,
) -> Particle:
    """Constant-sticking diffuse particle (ref: rayParticle.hpp:126-163)."""
    return Particle(
        sticking=jnp.asarray(sticking_probability, dtype),
        cosine_exponent=jnp.asarray(1.0, dtype),
        cone_angle=jnp.asarray(0.0, dtype),
        material_sticking=None
        if material_sticking is None
        else jnp.asarray(material_sticking, dtype),
        reflection_kind=int(ReflectionKind.DIFFUSE),
        data_labels=(data_label,),
        name="DiffuseParticle",
    )


def SpecularParticle(
    sticking_probability: float,
    source_power: float,
    data_label: str = "flux",
    dtype=jnp.float32,
    material_sticking=None,
    direction=None,
) -> Particle:
    """Constant-sticking specular particle (ref: rayParticle.hpp:165-204).

    ``direction``: optional fixed initial direction (the GPU particle
    struct's ``direction`` field, rayParticle.hpp:217)."""
    return Particle(
        sticking=jnp.asarray(sticking_probability, dtype),
        cosine_exponent=jnp.asarray(source_power, dtype),
        cone_angle=jnp.asarray(0.0, dtype),
        material_sticking=None
        if material_sticking is None
        else jnp.asarray(material_sticking, dtype),
        direction=None if direction is None else jnp.asarray(direction, dtype),
        reflection_kind=int(ReflectionKind.SPECULAR),
        data_labels=(data_label,),
        name="SpecularParticle",
    )


def ConedCosineParticle(
    sticking_probability: float,
    cone_angle: float,
    source_power: float = 1.0,
    data_label: str = "flux",
    dtype=jnp.float32,
) -> Particle:
    """Coned-cosine reflecting particle (reflection: rayReflection.hpp:52-120)."""
    return Particle(
        sticking=jnp.asarray(sticking_probability, dtype),
        cosine_exponent=jnp.asarray(source_power, dtype),
        cone_angle=jnp.asarray(cone_angle, dtype),
        reflection_kind=int(ReflectionKind.CONED_COSINE),
        data_labels=(data_label,),
        name="ConedCosineParticle",
    )
