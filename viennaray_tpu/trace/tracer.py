"""User-facing tracers: ``TraceDisk`` and ``TraceTriangle``.

These mirror the reference's ``Trace`` API surface (rayTrace.hpp:15-180,
rayTraceDisk.hpp, rayTraceTriangle.hpp) — setters for particle, geometry,
boundary conditions, ray counts, seeds; ``apply()`` runs the trace;
``normalize_flux`` / ``smooth_flux`` post-process — while the implementation
is a jitted wavefront kernel looping over mega-batches of rays (the analog of
the 2^29-ray GPU launch clamp, gpu/raygTrace.hpp:132-160).
"""

from __future__ import annotations

import os
import time
from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    BoundaryCondition,
    NormalizationType,
    TraceConfig,
    TraceDirection,
    adjust_bounding_box,
    get_trace_settings,
)
from ..data import DataLog, TraceInfo, TracingData
from ..geometry.disk_geometry import DiskGeometry
from ..geometry.mesh import DiskMesh, LineMesh, TriangleMesh
from ..geometry.neighborhood import build_neighborhood
from ..geometry.triangle_geometry import TriangleGeometry
from ..ops import vec
from ..physics.source import RandomSource
from . import postprocess
from .kernel import EnvKnobs, trace_batch


@partial(
    jax.jit,
    static_argnames=(
        "config", "geo_type", "collision_fn", "reflection_fn", "aux_init_fn",
        "init_dir_fn", "log_fn", "kahan", "knobs",
    ),
    donate_argnums=(7, 8),
)
def _traced_batch(
    geometry, source, particle, bbox, batch_key, ray_indices, valid,
    flux_acc, flux_comp, config, geo_type, collision_fn=None,
    reflection_fn=None, aux_init_fn=None, init_dir_fn=None, log_fn=None,
    kahan=True, knobs=None,
):
    """One traced mega-batch folded into the running flux accumulator.

    ``kahan``: compensated (Kahan) summation across batches — the device-
    side equivalent of the reference GPU build's f64 accumulation
    (normKernels.cu:5-9): the error term keeps low-weight per-batch sums
    from vanishing into f32 cancellation over 1e8-ray campaigns, with no
    per-batch host round trip. The f64-quality total is recovered at the
    end as float64(sum) + float64(comp)."""
    out = trace_batch(
        geometry, source, particle, bbox, batch_key, ray_indices, valid,
        config, geo_type, collision_fn=collision_fn,
        reflection_fn=reflection_fn, aux_init_fn=aux_init_fn,
        init_dir_fn=init_dir_fn, log_fn=log_fn, knobs=knobs,
    )
    if log_fn is not None:
        flux, counters, logs = out
    else:
        flux, counters = out
        logs = None
    if kahan:
        y = flux + flux_comp  # comp carries the running error (negated)
        t = flux_acc + y
        comp_new = y - (t - flux_acc)
        flux_acc, flux_comp = t, comp_new
    else:
        flux_acc = flux_acc + flux
    # one stacked counter vector -> ONE host fetch per batch instead of six
    cnt_vec = jnp.stack(list(counters)).astype(jnp.int32)
    return flux_acc, flux_comp, cnt_vec, logs


class _TraceBase:
    """Shared setter surface (ref: rayTrace.hpp:15-180)."""

    def __init__(self, dim: int = 3):
        self._dim = dim
        self._particle = None
        self._custom_source = None
        self._boundary_conditions = tuple(
            BoundaryCondition.REFLECTIVE for _ in range(3)
        )
        self._source_direction = (
            TraceDirection.POS_Z if dim == 3 else TraceDirection.POS_Y
        )
        self._num_rays_per_point = 1000
        self._num_rays_fixed = 0
        self._max_reflections = 2**30
        self._max_boundary_hits = 1000
        self._rng_seed = 0
        self._use_random_seed = True
        self._primary_direction = None
        self._run_number = 1
        # mega-batch width: larger batches amortize per-batch fixed costs
        # (source sampling/sort, compaction-ladder restart, per-batch sync)
        self._ray_batch_size = int(
            os.environ.get("VIENNARAY_TPU_BATCH", 2**20)
        )
        self._use_wdist = False
        self._flux_model = "neighbor"
        # f64 cross-batch flux accumulation, matching the reference GPU
        # build's default-ON double precision (normKernels.cu:5-9,
        # CMakeLists.txt:16); env kill switch for A/B benchmarking
        self._accumulate_f64 = (
            os.environ.get("VIENNARAY_TPU_F64_ACCUM", "1") == "1"
        )
        self._print_progress = False
        self._log_fn = None
        self._collision_fn = None
        self._reflection_fn = None
        self._aux_init_fn = None
        self._init_dir_fn = None
        self._local_data = TracingData()
        self._global_data = None
        self._info = TraceInfo()
        self._data_log = DataLog()
        self.geometry = None

    # -- setters (ref: rayTrace.hpp:34-121) -------------------------------
    def set_particle_type(self, particle):
        self._particle = particle

    def set_boundary_conditions(self, conds: Sequence[BoundaryCondition]):
        conds = tuple(BoundaryCondition(c) for c in conds)
        if len(conds) < self._dim:
            raise ValueError("One boundary condition per dimension required")
        padded = conds + tuple(
            BoundaryCondition.REFLECTIVE for _ in range(3 - len(conds))
        )
        self._boundary_conditions = padded[:3]

    def set_source(self, source):
        self._custom_source = source

    def reset_source(self):
        self._custom_source = None

    def set_number_of_rays_per_point(self, n: int):
        self._num_rays_per_point = int(n)
        self._num_rays_fixed = 0

    def set_number_of_rays_fixed(self, n: int):
        self._num_rays_fixed = int(n)
        self._num_rays_per_point = 0

    def set_max_reflections(self, n: int):
        self._max_reflections = int(n)

    def set_max_boundary_hits(self, n: int):
        self._max_boundary_hits = int(n)

    def set_source_direction(self, direction: TraceDirection):
        self._source_direction = TraceDirection(direction)

    def set_primary_direction(self, direction):
        d = np.asarray(direction, np.float64)
        d = d / np.linalg.norm(d)
        self._primary_direction = tuple(float(x) for x in d)

    def set_use_random_seeds(self, use: bool):
        self._use_random_seed = bool(use)

    def set_rng_seed(self, seed: int):
        self._rng_seed = int(seed)
        self._use_random_seed = False

    def set_ray_batch_size(self, n: int):
        self._ray_batch_size = int(n)

    def set_use_wdist(self, use: bool):
        self._use_wdist = bool(use)

    def set_f64_accumulation(self, use: bool):
        """Toggle float64 cross-batch flux accumulation (the analog of the
        reference's VIENNARAY_GPU_DOUBLE_PRECISION, default ON). Per-batch
        device sums stay f32 either way."""
        self._accumulate_f64 = bool(use)

    def set_flux_model(self, model: str):
        """Disk flux deposit model: "neighbor" (CPU reference contract,
        rayTraceKernel.hpp:255-300) or "window" (GPU candidate-window
        contract, GeneralPipelineDisk.cu:51-59)."""
        if model not in ("neighbor", "window"):
            raise ValueError(f"unknown flux model {model!r}")
        self._flux_model = model

    def enable_progress_bar(self):
        """(ref: rayTrace.hpp:69) — prints one line per mega-batch."""
        self._print_progress = True

    def disable_progress_bar(self):
        self._print_progress = False

    def set_data_log_fn(self, fn):
        """Per-ray data logging hook (analog of particle->logData,
        rayUtil.hpp:49-63 + rayTraceKernel.hpp:132). Runs INSIDE the jitted
        trace right after particle init: fn(key, aux, ray_indices, valid) ->
        list of 1-D contribution arrays (e.g. an init-energy histogram over
        the batch), summed additively across batches/runs into
        get_data_log().data. ``aux`` is the per-ray state allocated by
        ``aux_init_fn`` (see set_custom_functions)."""
        self._log_fn = fn

    def set_custom_functions(self, collision_fn=None, reflection_fn=None,
                             aux_init_fn=None, init_dir_fn=None):
        """Install custom particle behavior hooks (the JAX analog of the
        reference's virtual dispatch / GPU direct-callable table,
        rayParticle.hpp:43-66, gpu/raygCallableConfig.hpp). See
        trace/kernel.py:trace_batch for the hook signatures."""
        self._collision_fn = collision_fn
        self._reflection_fn = reflection_fn
        self._aux_init_fn = aux_init_fn
        self._init_dir_fn = init_dir_fn

    # -- data access (ref: rayTrace.hpp:135-145) ---------------------------
    def get_local_data(self) -> TracingData:
        return self._local_data

    def set_global_data(self, data: TracingData):
        self._global_data = data

    def get_global_data(self):
        return self._global_data

    def get_ray_trace_info(self) -> TraceInfo:
        return self._info

    def get_data_log(self) -> DataLog:
        return self._data_log

    # -- shared internals ---------------------------------------------------
    def _make_config(self) -> TraceConfig:
        return TraceConfig(
            dim=self._dim,
            num_rays_per_point=self._num_rays_per_point,
            num_rays_fixed=self._num_rays_fixed,
            max_reflections=self._max_reflections,
            max_boundary_hits=self._max_boundary_hits,
            rng_seed=self._rng_seed,
            use_random_seed=self._use_random_seed,
            source_direction=self._source_direction,
            boundary_conditions=self._boundary_conditions,
            primary_direction=self._primary_direction,
            ray_batch_size=self._ray_batch_size,
            use_wdist=self._use_wdist,
            flux_model=self._flux_model,
        )

    def _base_seed(self) -> int:
        if self._use_random_seed:
            return int.from_bytes(os.urandom(4), "little")
        # (ref: rayTraceKernel.hpp:100 seed = runNumber + rngSeed)
        return (self._rng_seed + self._run_number) & 0xFFFFFFFF

    def _default_source(self, adjusted_bbox, num_points):
        settings = get_trace_settings(self._source_direction)
        ray_dir, first_dir, second_dir, min_max, pos_neg = settings
        basis = None
        if self._primary_direction is not None:
            basis = vec.orthonormal_basis(
                jnp.asarray(self._primary_direction, jnp.float32)
            )
        return RandomSource(
            bbox=jnp.asarray(adjusted_bbox, jnp.float32),
            cosine_power=self._particle.cosine_exponent,
            basis=basis,
            ray_dir=ray_dir,
            first_dir=first_dir,
            second_dir=second_dir,
            min_max=min_max,
            pos_neg=float(pos_neg),
            dim=self._dim,
            num_points=num_points,
        )

    def _trace_setup(self, geometry, geo_type: str):
        """(config, total rays, source, device bbox, batch width) of one
        apply() on ``geometry``."""
        config = self._make_config()
        n_prims = geometry.num_primitives
        total_rays = config.total_rays(n_prims)
        bbox_margin = (
            geometry.disk_radius if geo_type == "disk" else geometry.grid_delta
        )
        adjusted = adjust_bounding_box(
            np.asarray(geometry.bbox), self._source_direction, bbox_margin,
            self._dim,
        )
        if self._custom_source is not None:
            source = self._custom_source
        else:
            source = self._default_source(adjusted, n_prims)
        # clamp the batch to the next power of two >= the ray count (floor
        # 512) so small runs don't trace a mostly-dead mega-batch while
        # kernel SHAPES stay shared across ray counts (each distinct batch
        # width costs a fresh compile of the whole ladder)
        batch = min(
            config.ray_batch_size,
            max(512, 1 << (max(total_rays, 2) - 1).bit_length()),
        )
        return (config, total_rays, source, jnp.asarray(adjusted, jnp.float32),
                batch)

    def _run_trace(self, geometry, geo_type: str):
        config, total_rays, source, bbox_dev, batch = self._trace_setup(
            geometry, geo_type
        )
        n_prims = geometry.num_primitives
        self._last_source = source
        base_key = jax.random.PRNGKey(self._base_seed())
        num_batches = max(1, -(-total_rays // batch))
        # multi-channel local data: with a custom collision_fn and L > 1
        # labels the flux is (L, N) (ref: gpu/raygTrace.hpp:97-99)
        n_chan = (
            len(self._particle.data_labels)
            if self._collision_fn is not None
            else 1
        )
        flux_shape = (n_chan, n_prims) if n_chan > 1 else (n_prims,)
        flux = jnp.zeros(flux_shape, jnp.float32)
        comp = jnp.zeros(flux_shape, jnp.float32)
        # f64-equivalent flux accumulation across mega-batches (the
        # reference GPU build defaults to double precision,
        # normKernels.cu:5-9 + CMakeLists.txt:16): device-side Kahan
        # summation — no per-batch host fetch — with the float64 total
        # recovered at the end from (sum, comp).
        acc_f64 = self._accumulate_f64 and num_batches > 1
        totals = np.zeros(6, np.int64)
        # ray-ordering knobs resolved from the env HERE — outside jit, once
        # per apply() — so flipping an env knob between applies recompiles
        # instead of silently reusing the stale trace
        knobs = EnvKnobs.from_env()

        t0 = time.perf_counter()
        for b in range(num_batches):
            ray_indices = jnp.arange(b * batch, (b + 1) * batch, dtype=jnp.int32)
            valid = ray_indices < total_rays
            batch_key = jax.random.fold_in(base_key, b)
            flux, comp, counters, logs = _traced_batch(
                geometry, source, self._particle, bbox_dev, batch_key,
                ray_indices, valid, flux, comp, config, geo_type,
                collision_fn=self._collision_fn,
                reflection_fn=self._reflection_fn,
                aux_init_fn=self._aux_init_fn,
                init_dir_fn=self._init_dir_fn,
                log_fn=self._log_fn,
                kahan=acc_f64,
                knobs=knobs,
            )
            totals += np.asarray(counters, np.int64)
            if logs is not None:
                rows = [np.asarray(r, np.float64) for r in logs]
                if not self._data_log.data:
                    self._data_log.data = rows
                else:
                    for j, r in enumerate(rows):
                        self._data_log.data[j] = self._data_log.data[j] + r
            if self._print_progress:
                print(
                    f"viennaray-tpu: batch {b + 1}/{num_batches} "
                    f"({min((b + 1) * batch, total_rays)}/{total_rays} rays)",
                    flush=True,
                )
        flux.block_until_ready()
        elapsed = time.perf_counter() - t0

        self._info = TraceInfo(
            num_rays=total_rays,
            total_rays_traced=int(totals[0]),
            non_geometry_hits=int(totals[1]),
            geometry_hits=int(totals[2]),
            particle_hits=int(totals[3]),
            boundary_hits=int(totals[4]),
            reflections=int(totals[5]),
            time=elapsed,
        )
        self._run_number += 1  # (ref: rayTraceDisk.hpp:54)
        if acc_f64:
            # compensated total: f64(sum) + f64(err) recovers the bits the
            # f32 running sum rounded away
            return (
                np.asarray(flux, np.float64) + np.asarray(comp, np.float64)
            )
        return np.asarray(flux)

    def _store_local_data(self, flux):
        """Accumulate into labelled channels; channels are keyed by label so
        multi-species runs (different particles, same tracer) keep separate
        flux rows like the GPU tracer's species x label buffer
        (gpu/raygTrace.hpp:97-99).

        Multi-channel particles (custom collision_fn + L > 1 data labels)
        return (L, N) flux; channel i goes to label i, mirroring the
        reference where each surfaceCollision writes its own labelled row
        (rayParticle.hpp:60-66). A single-channel (N,) flux with several
        labels fills channel 0 and leaves the rest zero — the reference's
        untouched-channel behavior."""
        labels = self._particle.data_labels
        flux = np.asarray(flux)
        if flux.ndim == 2 and flux.shape[0] == len(labels):
            rows = [flux[i] for i in range(len(labels))]
        else:
            flat = flux.reshape(-1) if flux.ndim == 2 else flux
            rows = [flat] + [np.zeros_like(flat) for _ in labels[1:]]
        for lbl, row in zip(labels, rows):
            try:
                idx = self._local_data.get_vector_data_index(lbl)
            except KeyError:
                idx = self._local_data.add_vector_data(len(row), lbl)
            self._local_data.accumulate_vector(idx, row)


class TraceDisk(_TraceBase):
    """Oriented-disk tracer (ref: rayTraceDisk.hpp)."""

    def set_geometry(self, points, normals=None, grid_delta=None,
                     disk_radius=None):
        if isinstance(points, DiskMesh):
            mesh = points
            self.geometry = DiskGeometry.from_mesh(mesh, dim=self._dim)
        else:
            self.geometry = DiskGeometry.build(
                points, normals, grid_delta, dim=self._dim,
                disk_radius=disk_radius,
            )

    def set_material_ids(self, material_ids):
        self.geometry = self.geometry.replace(
            material_ids=jnp.asarray(np.asarray(material_ids, np.int32))
        )

    def apply(self):
        """Run the trace (ref: rayTraceDisk.hpp:19-57)."""
        self._check_settings()
        settings = get_trace_settings(self._source_direction)
        boundary_dirs = (settings[1], settings[2])
        self.geometry = self.geometry.with_areas(
            boundary_dirs, self._boundary_conditions
        )
        flux = self._run_trace(self.geometry, "disk")
        self._store_local_data(flux)
        return flux

    def normalize_flux(self, flux, norm: NormalizationType = NormalizationType.SOURCE):
        """(ref: rayTraceDisk.hpp:103-142)"""
        flux = jnp.asarray(flux, jnp.float32)
        areas = self.geometry.areas
        if NormalizationType(norm) == NormalizationType.MAX:
            out = postprocess.normalize_flux_max_disk(
                flux, areas, self.geometry.disk_radius
            )
        else:
            config = self._make_config()
            total = config.total_rays(self.geometry.num_primitives)
            out = postprocess.normalize_flux_source(
                flux, areas, self._last_source.source_area(), total
            )
        return np.asarray(out)

    def smooth_flux(self, flux, num_neighbors: int = 1):
        """(ref: rayTraceDisk.hpp:146-193)"""
        if num_neighbors < 1:
            return np.asarray(flux)
        if num_neighbors == 1:
            neighbors = self.geometry.neighbors
        else:
            nbrs, _ = build_neighborhood(
                np.asarray(self.geometry.points),
                num_neighbors * 2.0 * self.geometry.disk_radius,
                dim=3,  # (ref: rayTraceDisk.hpp:169 always inits 3D here)
            )
            neighbors = jnp.asarray(nbrs)
        out = postprocess.smooth_flux(
            jnp.asarray(flux, jnp.float32), self.geometry.normals, neighbors
        )
        return np.asarray(out)

    def _check_settings(self):
        if self._particle is None:
            self._info.error = True
            raise ValueError("No particle was specified in TraceDisk")
        if self.geometry is None:
            self._info.error = True
            raise ValueError("No geometry was passed to TraceDisk")
        if self.geometry.disk_radius > self.geometry.grid_delta:
            self._info.warning = True


class TraceLine(_TraceBase):
    """Native 2D line-segment tracer — parity with the GPU-only
    ``gpu::TraceLine`` (gpu/raygTraceLine.hpp): segments are primitives (no
    triangle extrusion), flux is per segment, areas are segment lengths,
    smoothing is not implemented."""

    def __init__(self):
        super().__init__(dim=2)

    def set_geometry(self, mesh: LineMesh, material_ids=None):
        from ..geometry.line_geometry import LineGeometry

        self.geometry = LineGeometry.from_mesh(mesh, material_ids=material_ids)

    def set_material_ids(self, material_ids):
        self.geometry = self.geometry.replace(
            material_ids=jnp.asarray(np.asarray(material_ids, np.int32))
        )

    def apply(self):
        if self._particle is None:
            self._info.error = True
            raise ValueError("No particle was specified in TraceLine")
        if self.geometry is None:
            self._info.error = True
            raise ValueError("No geometry was passed to TraceLine")
        flux = self._run_trace(self.geometry, "line")
        self._store_local_data(flux)
        return flux

    def normalize_flux(self, flux, norm: NormalizationType = NormalizationType.SOURCE):
        """flux *= sourceArea/(length * numRays)
        (ref: gpu/raygTraceLine.hpp:29-58, normKernels.cu line variant)."""
        flux = jnp.asarray(flux, jnp.float32)
        areas = self.geometry.areas
        if NormalizationType(norm) == NormalizationType.MAX:
            out = postprocess.normalize_flux_max_triangle(flux, areas)
        else:
            config = self._make_config()
            total = config.total_rays(self.geometry.num_primitives)
            out = postprocess.normalize_flux_source(
                flux, areas, self._last_source.source_area(), total
            )
        return np.asarray(out)

    def smooth_flux(self, flux, num_neighbors: int = 1):
        """Not implemented for line geometry (ref: raygTraceLine.hpp:26-28)."""
        return np.asarray(flux)


class TraceTriangle(_TraceBase):
    """Triangle-mesh tracer (ref: rayTraceTriangle.hpp)."""

    def set_geometry(self, mesh_or_points, triangles=None, grid_delta=None):
        if isinstance(mesh_or_points, TriangleMesh):
            self.geometry = TriangleGeometry.from_mesh(
                mesh_or_points, dim=self._dim
            )
        elif isinstance(mesh_or_points, LineMesh):
            if self._dim != 2:
                raise ValueError("Line geometry is only supported in 2D")
            self.geometry = TriangleGeometry.from_line_mesh(mesh_or_points)
        else:
            self.geometry = TriangleGeometry.build(
                mesh_or_points, triangles, grid_delta, dim=self._dim
            )

    def set_material_ids(self, material_ids):
        self.geometry = self.geometry.replace(
            material_ids=jnp.asarray(np.asarray(material_ids, np.int32))
        )

    def apply(self):
        """(ref: rayTraceTriangle.hpp:19-61)"""
        if self._particle is None:
            self._info.error = True
            raise ValueError("No particle was specified in TraceTriangle")
        if self.geometry is None:
            self._info.error = True
            raise ValueError("No geometry was passed to TraceTriangle")
        flux = self._run_trace(self.geometry, "triangle")
        self._store_local_data(flux)
        return flux

    def normalize_flux(self, flux, norm: NormalizationType = NormalizationType.SOURCE):
        """(ref: rayTraceTriangle.hpp:92-130)"""
        flux = jnp.asarray(flux, jnp.float32)
        areas = self.geometry.areas
        if NormalizationType(norm) == NormalizationType.MAX:
            out = postprocess.normalize_flux_max_triangle(flux, areas)
        else:
            config = self._make_config()
            total = config.total_rays(self.geometry.num_primitives)
            out = postprocess.normalize_flux_source(
                flux, areas, self._last_source.source_area(), total
            )
        return np.asarray(out)

    def smooth_flux(self, flux, num_neighbors: int = 1):
        """No-op for element meshes (ref: rayTraceTriangle.hpp:134-136)."""
        return np.asarray(flux)
