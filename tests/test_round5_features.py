"""Round-5 feature tests: knobs plumbing, and the nearest-hit kernel
(interpret mode on the CPU) under shard_map at >= 8 chunks."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

import viennaray_tpu as vrt
from viennaray_tpu.config import (
    BoundaryCondition,
    TraceConfig,
    TraceDirection,
)
from viennaray_tpu.io import fixtures
from viennaray_tpu.trace.kernel import EnvKnobs

from test_fused_round2 import _use_kernel


def _cfg3d():
    return TraceConfig(
        dim=3,
        source_direction=TraceDirection.POS_Z,
        boundary_conditions=(BoundaryCondition.PERIODIC,) * 3,
        rng_seed=5,
        use_random_seed=False,
    )


def _trench_geo(gd=0.4):
    pts, nrm = fixtures.create_trench_grid_3d(
        grid_delta=gd, extent=3.0, trench_width=2.0, trench_depth=2.0
    )
    return vrt.DiskGeometry.build(pts, nrm, gd, dim=3)


def test_env_knobs_hashable_and_static():
    """EnvKnobs must be hashable (it is a jit static argument) and reflect
    the environment at resolution time, so a changed knob recompiles."""
    k = EnvKnobs.from_env()
    hash(k)  # hashable
    assert k == EnvKnobs.from_env()
    old = os.environ.get("VIENNARAY_TPU_PERMUTE")
    os.environ["VIENNARAY_TPU_PERMUTE"] = "sort"
    try:
        assert EnvKnobs.from_env().permute == "sort"
        assert EnvKnobs.from_env() != k or k.permute == "sort"
    finally:
        if old is None:
            os.environ.pop("VIENNARAY_TPU_PERMUTE", None)
        else:
            os.environ["VIENNARAY_TPU_PERMUTE"] = old


def test_fused_sharded_many_chunks(monkeypatch):
    """The nearest-hit kernel runs INSIDE shard_map (geometry >= 8 chunks)
    and reproduces the unsharded flux (trace_sharded psums per-shard flux;
    device count only changes reduction order)."""
    from viennaray_tpu.parallel.mesh import make_ray_mesh, trace_sharded
    from viennaray_tpu.config import adjust_bounding_box, get_trace_settings
    from viennaray_tpu.physics.source import RandomSource

    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    _use_kernel(monkeypatch, True)
    geo = _trench_geo(0.25)
    assert geo.soa_chunk_bbs.shape[0] >= 8
    particle = vrt.DiffuseParticle(0.1)
    config = dataclasses.replace(_cfg3d(), ray_batch_size=512)
    bbox = adjust_bounding_box(
        np.asarray(geo.bbox), config.source_direction, geo.disk_radius, 3
    )
    s = get_trace_settings(config.source_direction)
    source = RandomSource(
        bbox=jnp.asarray(bbox, jnp.float32),
        cosine_power=particle.cosine_exponent,
        ray_dir=s[0], first_dir=s[1], second_dir=s[2], min_max=s[3],
        pos_neg=float(s[4]), dim=3, num_points=geo.num_primitives,
    )
    total = 512 * 8
    key = jax.random.PRNGKey(11)
    flux_8, totals_8 = trace_sharded(
        geo, source, particle, jnp.asarray(bbox, jnp.float32), config,
        "disk", key, total, make_ray_mesh(jax.devices()[:8]),
    )
    flux_1, totals_1 = trace_sharded(
        geo, source, particle, jnp.asarray(bbox, jnp.float32), config,
        "disk", key, total, make_ray_mesh(jax.devices()[:1]),
    )
    flux_8 = np.asarray(flux_8)
    flux_1 = np.asarray(flux_1)
    assert flux_8.sum() > 0
    assert (np.asarray(totals_8) == np.asarray(totals_1)).all()
    rel = np.linalg.norm(flux_8 - flux_1) / np.linalg.norm(flux_1)
    assert rel < 1e-6, rel
