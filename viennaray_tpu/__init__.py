"""viennaray_tpu: a differentiable Monte Carlo flux tracer on accelerators.

Built from scratch in JAX/XLA/Pallas with the capabilities of ViennaRay
(semiconductor topography flux simulation): power-cosine sources, disk /
triangle / line geometries, diffuse / specular / coned-cosine reflections with
sticking probabilities, reflective / periodic / ignore boundaries, gas-phase
scattering, flux accumulation with exact area normalization and neighborhood
smoothing — plus what the reference never had: multi-device ray sharding over
``jax.sharding.Mesh`` and gradients of flux w.r.t. geometry and sticking.

See SURVEY.md for the structural map of the reference this build follows.
"""

import os as _os

# Persistent XLA compilation cache: trace kernels are large staged loops and
# recompiling them per process dominates small runs. JAX itself honours
# JAX_COMPILATION_CACHE_DIR; without it the cache goes to one fixed directory
# in the checkout (the path is part of the cache key, so it must not move).
# Opt out with VIENNARAY_TPU_NO_CACHE=1.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)
if not _os.environ.get("VIENNARAY_TPU_NO_CACHE") and not _os.environ.get(
    "JAX_COMPILATION_CACHE_DIR"
):
    import jax as _jax

    try:
        _os.makedirs(CACHE_DIR, exist_ok=True)
        _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    except OSError:  # read-only checkout: run without the cache
        pass

from .config import (
    BoundaryCondition,
    NormalizationType,
    ReflectionKind,
    TraceConfig,
    TraceDirection,
    disk_factor,
)
from .data import DataLog, MergeType, TraceInfo, TracingData
from .geometry.disk_geometry import DiskGeometry
from .geometry.mesh import DiskMesh, LineMesh, TriangleMesh, lines_to_triangles
from .geometry.triangle_geometry import TriangleGeometry
from .physics.particle import (
    ConedCosineParticle,
    DiffuseParticle,
    Particle,
    SpecularParticle,
)
from .physics.source import GridSource, RandomSource, SurfaceSource
from .geometry.line_geometry import LineGeometry
from .trace.tracer import TraceDisk, TraceLine, TraceTriangle

__version__ = "0.1.0"

__all__ = [
    "BoundaryCondition",
    "NormalizationType",
    "ReflectionKind",
    "TraceConfig",
    "TraceDirection",
    "disk_factor",
    "DataLog",
    "MergeType",
    "TraceInfo",
    "TracingData",
    "DiskGeometry",
    "DiskMesh",
    "LineMesh",
    "TriangleMesh",
    "lines_to_triangles",
    "TriangleGeometry",
    "Particle",
    "DiffuseParticle",
    "SpecularParticle",
    "ConedCosineParticle",
    "RandomSource",
    "GridSource",
    "SurfaceSource",
    "TraceDisk",
    "TraceLine",
    "TraceTriangle",
    "LineGeometry",
]
