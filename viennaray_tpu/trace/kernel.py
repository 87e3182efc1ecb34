"""The wavefront trace kernel.

Re-architecture of ``rayInternal::TraceKernel`` (rayTraceKernel.hpp:20-527)
for an accelerator. The reference traces each ray through a private
``do {} while(reflect)`` bounce loop on an OpenMP thread; here the whole ray
batch advances together through a ``lax.while_loop``: every iteration
intersects all active rays against the geometry (the fused nearest-hit kernel
of ops/hit_kernel.py on the GPU, chunked [rays, prims] tiles in XLA
elsewhere), resolves the per-ray event (geometry hit / domain-wall hit /
escape / gas scattering) with ``jnp.where`` lattices, deposits flux, and
samples reflections — the wavefront form of the reference's per-ray branches.

Event semantics mirrored 1:1 from rayTraceKernel.hpp:
- miss (escape through the source-axis faces) -> nonGeometryHits (:172-176)
- gas-phase scattering with P = 1 - exp(-t/lambda) preempting the hit; the
  scatter point is org + dir * u with u the probability draw — the
  reference's exact arithmetic (:179-203)
- boundary hits capped at max_boundary_hits, then reflective wall = specular
  flip / periodic wall = teleport to opposite wall / ignore = kill
  (:206-214, rayBoundary.hpp:29-127)
- disk backface: first hit passes through, second kills (:225-241);
  triangle backface kills (:243-248)
- disk neighbor multi-hit via ``check_local_intersection`` over the padded
  neighbor matrix (:255-300), optional 1/distance weighting (VIENNARAY_USE_WDIST)
- sticking update w -= w*s, max-reflections cap, Russian roulette
  (kill below 0.1 w0, renew to 0.3 w0, :309-335, :435-460)

RNG/determinism contract: the key hierarchy is
fold_in(base_key, global_batch_index) -> fold_in(batch_key, bounce) ->
fold_in(bounce_key, purpose). With a fixed seed and fixed ``ray_batch_size``
the flux is bitwise reproducible for any device count (tests/rngSeed analog),
because batches are keyed by their global index, not by device, and the flux
deposit (ops/deposit.py) sums in an order fixed by the data.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.ad_checkpoint import checkpoint_name as _checkpoint_name

from ..config import (
    BoundaryCondition,
    TraceConfig,
    get_trace_settings,
)
from ..ops import deposit, grid_traverse, hit_kernel, intersect, sampling
from ..ops.intersect import BIG

# event codes
EV_GEO = 0
EV_WALL1 = 1
EV_WALL2 = 2
EV_EXIT = 3


class BatchCounters(NamedTuple):
    """Device-side per-batch counters (ref: TraceInfo, rayUtil.hpp:65-76)."""

    total_traces: jnp.ndarray
    non_geometry_hits: jnp.ndarray
    geometry_hits: jnp.ndarray
    particle_hits: jnp.ndarray
    boundary_hits: jnp.ndarray
    reflections: jnp.ndarray

    @classmethod
    def zeros(cls):
        z = jnp.zeros((), jnp.int32)
        return cls(z, z, z, z, z, z)


import os as _os

# the per-bounce coherence resort runs at or above this many prims; below it
# the geometry has few kernel chunks left to skip
RESORT_MIN_PRIMS = 4096


class EnvKnobs(NamedTuple):
    """Ray-ordering knobs, resolved from the environment OUTSIDE the jitted
    trace (hashable -> part of the jit static cache key).

    Reading env vars at trace time would silently reuse a stale compiled
    trace after the env changes mid-process (the jit cache key would not
    include them). The tracer builds one of these per ``apply()`` via
    ``from_env()`` and passes it down as a static argument, so flipping a
    knob between applies recompiles correctly. Callers invoking
    ``trace_batch`` directly may pass ``knobs=None`` to get trace-time
    resolution (fresh process required after env changes)."""

    bounce_sort: bool = True      # per-bounce coherence resort
    sort_dirbins: str = "auto"    # direction bins for the resort key
    sort_every: int = 1           # resort cadence (bounces)
    permute: str = "sort"         # lane-permutation backend: sort | gather
    source_sort: bool = True      # source-plane Morton sort
    compact_sort: str = "spatial"  # compaction order: spatial | alive
    stage_shrink: int = 2         # compaction-ladder shrink factor

    @classmethod
    def from_env(cls) -> "EnvKnobs":
        e = _os.environ.get
        return cls(
            bounce_sort=e("VIENNARAY_TPU_BOUNCE_SORT", "1") == "1",
            sort_dirbins=e("VIENNARAY_TPU_SORT_DIRBINS", "auto"),
            sort_every=max(1, int(e("VIENNARAY_TPU_SORT_EVERY", "1"))),
            permute=e("VIENNARAY_TPU_PERMUTE", "sort"),
            source_sort=e("VIENNARAY_TPU_SOURCE_SORT", "1") == "1",
            compact_sort=e("VIENNARAY_TPU_COMPACT_SORT", "spatial"),
            stage_shrink=int(e("VIENNARAY_TPU_STAGE_SHRINK", "2")),
        )


def _wall_crossing(org, dirn, axis, lo, hi, t_near):
    """Crossing time of the next wall plane along one axis; BIG if parallel,
    behind, or closer than t_near (Embree skips hits below tnear)."""
    d = dirn[:, axis]
    o = org[:, axis]
    t = jnp.where(
        d > 0.0,
        (hi - o) / jnp.where(d == 0, 1e-30, d),
        jnp.where(d < 0.0, (lo - o) / jnp.where(d == 0, 1e-30, d), BIG),
    )
    return jnp.where(t > t_near, t, BIG)


def trace_batch(
    geometry,
    source,
    particle,
    bbox,
    batch_key,
    ray_indices,
    valid,
    config: TraceConfig,
    geo_type: str,
    collision_fn=None,
    reflection_fn=None,
    aux_init_fn=None,
    init_dir_fn=None,
    log_fn=None,
    differentiable: bool = False,
    num_bounces: Optional[int] = None,
    knobs: Optional[EnvKnobs] = None,
):
    """Trace one mega-batch of rays to extinction; returns (flux, counters).

    geometry: DiskGeometry or TriangleGeometry (per ``geo_type``).
    bbox: (2, 3) source-adjusted bounding box (ref: rayUtil.hpp:104-143).
    ray_indices: (R,) global ray indices (reserved for index-keyed sources).
    valid: (R,) bool — lanes beyond the total ray count start dead.
    collision_fn(flux, prim, weight, dirn, normal, mat, key[, aux]) -> flux and
    — ``flux`` is (N,) for single-label particles, or (L, N) when the
    particle declares L > 1 ``data_labels``: the fn writes distinct values
    into distinct labelled channels (ref: rayParticle.hpp:60-66; GPU result
    buffer numElements x sum(dataLabels), gpu/raygTrace.hpp:97-99) —
    reflection_fn(key, dirn, normal, prim, mat, weight[, aux]) ->
    (sticking, new_dir[, aux]) optionally override the particle's built-in
    behavior (the JAX analog of the reference's virtual dispatch / GPU
    callable table). aux_init_fn(key, ray_indices) -> (R, A) allocates
    per-ray auxiliary state (the analog of stateful custom particles, e.g.
    ion energy set in initNew, rayParticle.hpp:30-31); when provided, both
    hooks take and reflection_fn returns the aux array.

    init_dir_fn(key, ray_indices) -> (R, 3) optionally overrides the initial
    ray direction per ray — the analog of ``initNewWithDirection``
    (rayParticle.hpp:31,92): rows that are exactly the zero vector keep the
    source's sampled direction (the reference's ``isZero`` check,
    rayTraceKernel.hpp:133-139); nonzero rows are normalized and used.
    The ``particle.direction`` field is the constant-direction special case
    (GPU particle struct, rayParticle.hpp:217).

    log_fn(key, aux, ray_indices, valid) -> sequence of 1-D arrays runs
    INSIDE the jitted trace right after particle init — the analog of
    ``particle->logData(myDataLog)`` (rayTraceKernel.hpp:132,
    rayUtil.hpp:49-63): it sees the per-ray init state (``aux``) and returns
    per-row log contributions (e.g. an energy histogram over the batch),
    merged additively across batches by the caller. When provided,
    trace_batch returns (flux, counters, logs).
    """
    if knobs is None:
        knobs = EnvKnobs.from_env()
    dim = config.dim
    ray_axis, first_dir, second_dir, _, _ = get_trace_settings(
        config.source_direction
    )
    bc1 = BoundaryCondition(config.boundary_conditions[first_dir])
    bc2 = (
        BoundaryCondition(config.boundary_conditions[second_dir])
        if dim == 3
        else BoundaryCondition.IGNORE
    )

    R = ray_indices.shape[0]
    if geo_type == "disk":
        dtype = geometry.points.dtype
    elif geo_type == "triangle":
        dtype = geometry.vertices.dtype
    else:  # line
        dtype = geometry.p0.dtype
    n_prims = geometry.num_primitives

    lo1, hi1 = bbox[0, first_dir], bbox[1, first_dir]
    lo2, hi2 = bbox[0, second_dir], bbox[1, second_dir]
    lo_r, hi_r = bbox[0, ray_axis], bbox[1, ray_axis]

    if geo_type == "disk":
        prim_normals = geometry.normals
        material_ids = geometry.material_ids
    else:
        prim_normals = geometry.normals
        material_ids = geometry.material_ids

    # ---- source sampling -------------------------------------------------
    k_src = jax.random.fold_in(batch_key, 0x5EED)
    org, dirn, w0 = source.sample(k_src, ray_indices)
    org = org.astype(dtype)
    dirn = dirn.astype(dtype)
    w0 = w0.astype(dtype)

    # ---- particle-controlled initial direction ---------------------------
    # (ref: initNewWithDirection, rayParticle.hpp:31,92; zero vector means
    # "use the source direction", rayTraceKernel.hpp:133-139)
    def _use_dir(cand):
        nonzero = jnp.any(cand != 0.0, axis=-1, keepdims=True)
        if dim == 2:
            cand = cand.at[:, 2].set(0.0)
        n = jnp.linalg.norm(cand, axis=-1, keepdims=True)
        cand = cand / jnp.where(n > 0.0, n, 1.0)
        return jnp.where(nonzero, cand.astype(dtype), dirn)

    if getattr(particle, "direction", None) is not None:
        dirn = _use_dir(jnp.broadcast_to(particle.direction, (R, 3)))
    if init_dir_fn is not None:
        dirn = _use_dir(
            init_dir_fn(jax.random.fold_in(batch_key, 0xD1B), ray_indices)
        )

    if aux_init_fn is not None:
        aux0 = aux_init_fn(jax.random.fold_in(batch_key, 0xA0C), ray_indices)
    else:
        aux0 = jnp.zeros((R, 1), dtype)

    logs = None
    if log_fn is not None:
        logs = tuple(
            log_fn(jax.random.fold_in(batch_key, 0x10C), aux0, ray_indices,
                   valid)
        )

    weight = jnp.where(valid, w0, 0.0)
    alive = valid
    hit_from_back = jnp.zeros((R,), bool)
    del valid  # permuted below; use `alive` from here on
    n_refl = jnp.zeros((R,), jnp.int32)
    n_bdry = jnp.zeros((R,), jnp.int32)
    # Multi-channel local data (ref: rayParticle.hpp:60-66 writes distinct
    # values into distinct labelled channels inside surfaceCollision; the GPU
    # result buffer is numElements x sum(dataLabels), gpu/raygTrace.hpp:97-99):
    # with a custom collision_fn and L > 1 data labels the flux carried
    # through the trace is (L, N) and the collision_fn owns every channel.
    # Built-in particles have exactly one channel -> plain (N,) as before.
    n_chan = len(particle.data_labels) if collision_fn is not None else 1
    if n_chan > 1:
        flux = jnp.zeros((n_chan, n_prims), dtype)
    else:
        flux = jnp.zeros((n_prims,), dtype)
    counters = BatchCounters.zeros()
    if config.flux_model == "window" and (
        collision_fn is not None or config.use_wdist
    ):
        raise NotImplementedError(
            "flux_model='window' supports built-in deposits only (no "
            "collision_fn / use_wdist) — the GPU candidate-window contract "
            "has no neighbor-id list to hand to a custom collision"
        )

    mean_free_path = particle.mean_free_path
    t_near = jnp.asarray(config.t_near, dtype)

    def cond(state):
        it, _, _, _, _, alive, *_ = state
        return jnp.logical_and(it < config.max_bounces, jnp.any(alive))

    # ---- per-bounce coherence re-sort ------------------------------------
    # Diffuse bounces scatter a block's rays over the whole geometry, which
    # defeats the nearest-hit kernel's per-block chunk skip. Re-sorting the
    # batch every bounce by (position cell, direction bin) keeps the rays of
    # a block coherent, and herds dead lanes together. Uniforms are drawn
    # after the permutation. Deterministic: stable sort on state-derived keys.
    bbs_lo = jnp.stack([bbox[0, 0], bbox[0, 1], bbox[0, 2]])
    bbs_ext = jnp.maximum(
        jnp.stack([bbox[1, 0], bbox[1, 1], bbox[1, 2]]) - bbs_lo, 1e-6
    )
    resort = (
        not differentiable
        and knobs.bounce_sort
        and R >= 4096
        and n_prims >= RESORT_MIN_PRIMS
    )

    # direction-bin count for the coherence key: 8 = sign octants;
    # 32/64 = 8 xy-octants x 4/8 polar bands. Finer bins pay when the
    # geometry is finer than a block's direction spread.
    _db_env = knobs.sort_dirbins
    if _db_env == "auto":
        dirbins = 64 if n_prims > 65536 else 32
    else:
        dirbins = int(_db_env)

    def _coherence_key(org, dirn, alive):
        cell = jnp.clip(
            ((org - bbs_lo) / bbs_ext * 16.0).astype(jnp.int32), 0, 15
        )
        if dirbins >= 32:
            # 8 xy-octants x 4 (or 8, dirbins>=64) polar bands
            nb_pol = 8 if dirbins >= 64 else 4
            dbin = (
                (dirn[:, 0] > 0).astype(jnp.int32)
                + 2 * (dirn[:, 1] > 0).astype(jnp.int32)
                + 4 * (jnp.abs(dirn[:, 0]) > jnp.abs(dirn[:, 1])).astype(
                    jnp.int32
                )
                + 8 * jnp.clip(
                    ((dirn[:, 2] + 1.0) * (nb_pol / 2.0)).astype(jnp.int32),
                    0, nb_pol - 1,
                )
            )
            nb_d = 8 * nb_pol
        else:
            dbin = (
                (dirn[:, 0] > 0).astype(jnp.int32)
                + 2 * (dirn[:, 1] > 0).astype(jnp.int32)
                + 4 * (dirn[:, 2] > 0).astype(jnp.int32)
            )
            nb_d = 8
        key_s = (
            ((cell[:, 0] * 16 + cell[:, 1]) * 16 + cell[:, 2]) * nb_d + dbin
        )
        return jnp.where(alive, key_s, jnp.int32(1 << 30))

    def _coherence_perm(org, dirn, alive):
        return jnp.argsort(_coherence_key(org, dirn, alive), stable=True)

    def _permute_state(take, org, dirn, weight, w0, alive, hfb, n_refl,
                       n_bdry, aux):
        """Apply a lane permutation as ONE packed row-gather: the whole
        per-ray state packed into an (R, 13+A) f32 matrix moves in one
        gather instead of nine narrow ones. int/bool flags round-trip
        exactly through f32 (values < 2^24)."""
        if aux.dtype != org.dtype or org.dtype != jnp.float32:
            return (
                org[take], dirn[take], weight[take], w0[take], alive[take],
                hfb[take], n_refl[take], n_bdry[take], aux[take],
            )
        f = lambda a: a[:, None].astype(jnp.float32)
        packed = jnp.concatenate(
            [org, dirn, f(weight), f(w0), f(alive), f(hfb), f(n_refl),
             f(n_bdry), aux],
            axis=1,
        )[take]
        return (
            packed[:, 0:3], packed[:, 3:6], packed[:, 6], packed[:, 7],
            packed[:, 8] > 0.5, packed[:, 9] > 0.5,
            packed[:, 10].astype(jnp.int32), packed[:, 11].astype(jnp.int32),
            packed[:, 12:],
        )

    def _sorted_state(key_s, org, dirn, weight, w0, alive, hfb, n_refl,
                      n_bdry, aux):
        """Reorder the state ascending-by-key via ONE multi-operand
        ``lax.sort`` that carries the payload columns along with the key.
        Stable, so deterministic."""
        f = lambda a: a.astype(jnp.float32)
        cols = (
            key_s, org[:, 0], org[:, 1], org[:, 2], dirn[:, 0], dirn[:, 1],
            dirn[:, 2], weight, w0, f(alive), f(hfb), f(n_refl), f(n_bdry),
        ) + tuple(aux[:, j] for j in range(aux.shape[1]))
        out = jax.lax.sort(cols, num_keys=1, is_stable=True)
        org2 = jnp.stack(out[1:4], axis=1)
        dir2 = jnp.stack(out[4:7], axis=1)
        return (
            org2, dir2, out[7], out[8], out[9] > 0.5, out[10] > 0.5,
            out[11].astype(jnp.int32), out[12].astype(jnp.int32),
            jnp.stack(out[13:], axis=1).astype(aux.dtype),
        )

    # cadence: resort every K bounces (K=1 default); K>1 skips whole
    # sort rounds via lax.cond at some coherence cost.
    sort_every = max(1, knobs.sort_every)
    # permutation backend: "sort" (default) = multi-operand lax.sort;
    # "gather" = stable argsort + ONE packed row-gather.
    permute_mode = knobs.permute

    @jax.named_scope("resort")
    def _resorted(it, org, dirn, weight, w0, alive, hfb, n_refl, n_bdry,
                  aux):
        def do(_):
            if (permute_mode == "sort" and org.dtype == jnp.float32
                    and aux.dtype == jnp.float32):
                key_s = _coherence_key(org, dirn, alive)
                return _sorted_state(
                    key_s, org, dirn, weight, w0, alive, hfb, n_refl,
                    n_bdry, aux,
                )
            take = _coherence_perm(org, dirn, alive)
            return _permute_state(
                take, org, dirn, weight, w0, alive, hfb, n_refl, n_bdry, aux
            )

        if sort_every == 1:
            return do(None)
        return jax.lax.cond(
            it % sort_every == 0,
            do,
            lambda _: (org, dirn, weight, w0, alive, hfb, n_refl, n_bdry,
                       aux),
            None,
        )

    def body(state):
        (it, org, dirn, weight, w0, alive, hfb, n_refl, n_bdry, aux, flux,
         cnt) = state
        if resort:
            (org, dirn, weight, w0, alive, hfb, n_refl, n_bdry, aux) = (
                _resorted(
                    it, org, dirn, weight, w0, alive, hfb, n_refl, n_bdry,
                    aux,
                )
            )
        Rb = org.shape[0]  # stage width (shrinks after compaction)
        key_b = jax.random.fold_in(batch_key, it + 1)
        k_scat, k_scat_dir, k_refl, k_roul = jax.random.split(key_b, 4)

        # ---- 1. intersect geometry (ref: rayTraceKernel.hpp:163-167) ----
        # The fused kernel (ops/hit_kernel.py) where its choice function
        # picks it; otherwise the XLA grid DDA for large geometries, or the
        # chunked brute force.
        #
        # Differentiable traces use the kernel too: hit SELECTION is
        # piecewise-constant (straight-through, SURVEY §7), so the kernel
        # runs on stop_gradient inputs — no AD rules needed — and the hit
        # time is then RECOMPUTED differentiably from the selected prim's
        # gathered fields (O(R) instead of the O(R x P) brute force whose
        # min() AD routes the same gradient anyway).
        with jax.named_scope("intersect"):
            kern = (
                getattr(hit_kernel, f"{geo_type}_kernel")(n_prims)
                if geo_type in ("disk", "triangle")
                else "xla"
            )
            use_kernel = (
                kern != "xla"
                and getattr(geometry, "prims_soa", None) is not None
                and dtype == jnp.float32
            )
            use_grid = (
                getattr(geometry, "grid", None) is not None
                and not use_kernel
                and not differentiable
                and n_prims >= config.grid_min_prims
            )
            sg = jax.lax.stop_gradient
            # Differentiable traces: tag the expensive intermediates so the
            # scan's checkpoint policy SAVES them instead of rematerializing the
            # whole bounce in the backward pass — the nearest-hit search
            # (primal-only: it runs on stop_gradient inputs) and the
            # neighbor-record gather would otherwise each run twice per bounce.
            # Saved residuals are small: 3x(R,) + (R, K*8) per bounce.
            name_val = (
                _checkpoint_name if differentiable else (lambda x, _: x)
            )
            if use_kernel:
                t_geo, prim, hit_geo = name_val(
                    hit_kernel.nearest_hit(
                        sg(org), sg(dirn), geometry.prims_soa, geometry.soa_perm,
                        geometry.soa_chunk_bbs, kind=geo_type,
                        t_near=config.t_near, interpret=kern == "interpret",
                    ),
                    "isect",
                )
                if differentiable:
                    t_geo = _hit_time(geometry, geo_type, prim, org, dirn)
            elif geo_type == "disk":
                if use_grid:
                    t_geo, prim, hit_geo = grid_traverse.disk_grid_nearest_hit(
                        org, dirn, geometry.points, geometry.normals,
                        geometry.radii, geometry.grid, t_near,
                    )
                else:
                    t_geo, prim, hit_geo = name_val(
                        intersect.disk_nearest_hit(
                            org, dirn, geometry.points, geometry.normals,
                            geometry.radii, t_near,
                        ),
                        "isect",
                    )
            elif geo_type == "triangle":
                if use_grid:
                    t_geo, prim, hit_geo = grid_traverse.triangle_grid_nearest_hit(
                        org, dirn, geometry.vertices, geometry.triangles,
                        geometry.grid, t_near,
                    )
                else:
                    t_geo, prim, hit_geo = name_val(
                        intersect.triangle_nearest_hit(
                            org, dirn, geometry.vertices, geometry.triangles,
                            t_near,
                        ),
                        "isect",
                    )
            else:  # native 2D line segments (ref: GeneralPipelineLine.cu)
                t_geo, prim, hit_geo = intersect.line_nearest_hit(
                    org, dirn, geometry.p0, geometry.p1, t_near,
                )

        # ---- 2. boundary-wall crossings ---------------------------------
        # The walls are FINITE rectangles spanning the adjusted bbox on the
        # two lateral axes only (ref: rayBoundary.hpp:164-245, 8 triangles);
        # a crossing whose hit point lies outside the rectangle (e.g. below
        # the geometry or above the source plane) is not a wall hit — the ray
        # simply flies on and, with nothing else ahead, escapes (Embree miss,
        # rayTraceKernel.hpp:172-176).
        def wall_t(axis, lo, hi, other_axis, other_lo, other_hi):
            t = _wall_crossing(org, dirn, axis, lo, hi, t_near)
            hp_r = org[:, ray_axis] + dirn[:, ray_axis] * t
            ok = (hp_r >= lo_r) & (hp_r <= hi_r)
            if dim == 3:
                hp_o = org[:, other_axis] + dirn[:, other_axis] * t
                ok &= (hp_o >= other_lo) & (hp_o <= other_hi)
            return jnp.where(ok, t, BIG)

        t_w1 = wall_t(first_dir, lo1, hi1, second_dir, lo2, hi2)
        if dim == 3:
            t_w2 = wall_t(second_dir, lo2, hi2, first_dir, lo1, hi1)
        else:
            t_w2 = jnp.full((Rb,), BIG)

        t_geo_m = jnp.where(hit_geo, t_geo, BIG)
        ts = jnp.stack([t_geo_m, t_w1, t_w2], axis=0)  # (3, R)
        event = jnp.argmin(ts, axis=0).astype(jnp.int32)
        t_ev = jnp.min(ts, axis=0)
        # no hit anywhere -> escape (Embree miss)
        event = jnp.where(t_ev >= BIG, EV_EXIT, event)

        is_exit = alive & (event == EV_EXIT)

        # ---- 3. gas scattering (ref: rayTraceKernel.hpp:179-203) --------
        if mean_free_path > 0.0:
            u_scat = jax.random.uniform(k_scat, (Rb,), dtype=dtype)
            p_scat = 1.0 - jnp.exp(-t_ev / mean_free_path)
            scattering = alive & (~is_exit) & (u_scat < p_scat)
            scatter_org = org + dirn * u_scat[:, None]
            rnd_sphere = _unit_sphere_batch(k_scat_dir, Rb, dtype)
            if dim == 2:
                rnd_sphere = rnd_sphere.at[:, 2].set(0.0)
                rnd_sphere = rnd_sphere / jnp.maximum(
                    jnp.linalg.norm(rnd_sphere, axis=1, keepdims=True), 1e-12
                )
        else:
            scattering = jnp.zeros((Rb,), bool)
            scatter_org = org
            rnd_sphere = dirn

        is_wall1 = alive & (~scattering) & (event == EV_WALL1)
        is_wall2 = alive & (~scattering) & (event == EV_WALL2)
        is_wall = is_wall1 | is_wall2
        is_geo_ev = alive & (~scattering) & (event == EV_GEO)

        hitpoint = org + dirn * t_ev[:, None]

        # ---- 4. boundary processing (ref: rayBoundary.hpp:29-127) -------
        n_bdry_new = n_bdry + is_wall.astype(jnp.int32)
        bdry_overflow = is_wall & (n_bdry_new > config.max_boundary_hits)

        new_org = org
        new_dir = dirn
        dead = jnp.zeros((Rb,), bool)

        def apply_wall(mask, axis, lo, hi, bc, new_org, new_dir, dead):
            if bc == BoundaryCondition.REFLECTIVE:
                new_org = jnp.where(mask[:, None], hitpoint, new_org)
                flipped = new_dir.at[:, axis].multiply(-1.0)
                new_dir = jnp.where(mask[:, None], flipped, new_dir)
            elif bc == BoundaryCondition.PERIODIC:
                moved = hitpoint.at[:, axis].set(
                    jnp.where(dirn[:, axis] > 0, lo, hi)
                )
                new_org = jnp.where(mask[:, None], moved, new_org)
            else:  # IGNORE -> terminate (ref: rayBoundary.hpp:66-69)
                dead = dead | mask
            return new_org, new_dir, dead

        live_wall1 = is_wall1 & (~bdry_overflow)
        live_wall2 = is_wall2 & (~bdry_overflow)
        new_org, new_dir, dead = apply_wall(
            live_wall1, first_dir, lo1, hi1, bc1, new_org, new_dir, dead
        )
        if dim == 3:
            new_org, new_dir, dead = apply_wall(
                live_wall2, second_dir, lo2, hi2, bc2, new_org, new_dir, dead
            )

        # ---- 5. surface interaction -------------------------------------
        prim_c = jnp.clip(prim, 0, n_prims - 1)
        n_hit = name_val(prim_normals[prim_c], "nhit")
        mat_hit = material_ids[prim_c]
        backface = jnp.sum(dirn * n_hit, axis=1) > 0.0

        if geo_type == "disk":
            bf_kill = is_geo_ev & backface & hfb
            bf_pass = is_geo_ev & backface & (~hfb)
            collide = is_geo_ev & (~backface)
        else:
            bf_kill = is_geo_ev & backface
            bf_pass = jnp.zeros((Rb,), bool)
            collide = is_geo_ev & (~backface)

        # flux accumulation (ref: DiffuseParticle::surfaceCollision adds the
        # current rayWeight, rayParticle.hpp:148-156)
        if geo_type == "disk" and config.flux_model == "window":
            # GPU candidate-window contract (GeneralPipelineDisk.cu:51-59):
            # every disk with t_near < t <= t_hit + tau deposits, tau =
            # 1.1*gridDelta (gpu/raygTrace.hpp:116)
            tau = jnp.asarray(1.1 * geometry.grid_delta, dtype)
            wdep = jnp.where(collide, weight, 0.0)
            tlim = jnp.where(collide, t_geo + tau, -BIG)
            flux = flux + intersect.disk_window_deposit(
                org, dirn, geometry.points, geometry.normals,
                geometry.radii, tlim, wdep, t_near,
            )
        elif geo_type == "disk":
            nb_ids = geometry.neighbors[prim_c]  # (R, K)
            K = nb_ids.shape[1]
            nb_c = jnp.clip(nb_ids, 0, n_prims - 1)
            if getattr(geometry, "neighbor_pack", None) is not None:
                # one contiguous gather of the packed per-prim records
                rec = name_val(
                    geometry.neighbor_pack[prim_c].reshape(Rb, K, 8), "nbrec"
                )
                nb_ok, nb_dist = intersect.check_neighbors_packed(
                    org, dirn, rec
                )
            else:
                nb_pad_ok = nb_ids >= 0
                nb_centers = name_val(geometry.points[nb_c], "nbrec")
                nb_normals = name_val(geometry.normals[nb_c], "nbrec")
                nb_radii = name_val(geometry.radii[nb_c], "nbrec")
                nb_ok, nb_dist = intersect.check_local_intersection(
                    org, dirn, nb_centers, nb_normals, nb_radii
                )
                nb_ok = nb_ok & nb_pad_ok
            nb_ok = nb_ok & collide[:, None]

            if config.use_wdist:
                # 1/distance weighting (ref: rayTraceKernel.hpp:258-296)
                prim_dist = (
                    jnp.linalg.norm(hitpoint - geometry.points[prim_c], axis=1)
                    + 1e-6
                )
                dists = jnp.concatenate(
                    [prim_dist[:, None], nb_dist + 1e-6], axis=1
                )
                hits_mask = jnp.concatenate(
                    [collide[:, None], nb_ok], axis=1
                )
                inv_sum = jnp.sum(
                    jnp.where(hits_mask, 1.0 / dists, 0.0), axis=1, keepdims=True
                )
                num_hits = jnp.sum(hits_mask, axis=1, keepdims=True)
                w_all = (
                    weight[:, None]
                    / dists
                    / jnp.maximum(inv_sum, 1e-30)
                    * num_hits
                )
                w_all = jnp.where(hits_mask, w_all, 0.0)
            else:
                w_all = jnp.where(
                    jnp.concatenate([collide[:, None], nb_ok], axis=1),
                    weight[:, None],
                    0.0,
                )
            ids_all = jnp.concatenate([prim_c[:, None], nb_c], axis=1)
            if collision_fn is not None:
                if aux_init_fn is not None:
                    flux = collision_fn(
                        flux, ids_all, w_all, dirn, n_hit, mat_hit, key_b, aux,
                    )
                else:
                    flux = collision_fn(
                        flux, ids_all, w_all, dirn, n_hit, mat_hit, key_b,
                    )
            else:
                flux = flux + deposit.flux_deposit(
                    ids_all.reshape(-1), w_all.reshape(-1), n_prims
                )
        else:
            w_hit = jnp.where(collide, weight, 0.0)
            if collision_fn is not None:
                if aux_init_fn is not None:
                    flux = collision_fn(
                        flux, prim_c[:, None], w_hit[:, None], dirn, n_hit,
                        mat_hit, key_b, aux,
                    )
                else:
                    flux = collision_fn(
                        flux, prim_c[:, None], w_hit[:, None], dirn, n_hit,
                        mat_hit, key_b,
                    )
            else:
                flux = flux + deposit.flux_deposit(prim_c, w_hit, n_prims)

        # ---- 6. reflection + sticking (ref: rayTraceKernel.hpp:309-335) --
        aux_out = aux
        if reflection_fn is not None:
            if aux_init_fn is not None:
                sticking, refl_dir, aux_new = reflection_fn(
                    k_refl, dirn, n_hit, prim_c, mat_hit, weight, aux
                )
                aux_out = jnp.where(collide[:, None], aux_new, aux)
            else:
                sticking, refl_dir = reflection_fn(
                    k_refl, dirn, n_hit, prim_c, mat_hit, weight
                )
        else:
            sticking = particle.sticking_for(mat_hit)
            with jax.named_scope("reflect"):
                refl_dir = particle.reflect(k_refl, dirn, n_hit, dim)

        new_weight = weight - weight * sticking
        died_absorb = collide & (new_weight <= 0.0)
        n_refl_new = n_refl + collide.astype(jnp.int32)
        died_max_refl = collide & (n_refl_new > config.max_reflections)

        # Russian roulette (ref: rejectionControl, rayTraceKernel.hpp:435-460)
        if config.roulette:
            low = config.weight_threshold_frac * w0
            renew = config.renew_weight_frac * w0
            needs_roulette = collide & (new_weight < low)
            u_roul = jax.random.uniform(k_roul, (Rb,), dtype=dtype)
            kill_prob = 1.0 - new_weight / jnp.maximum(renew, 1e-30)
            died_roulette = needs_roulette & (u_roul < kill_prob)
            renewed = needs_roulette & (~died_roulette)
            new_weight = jnp.where(renewed, renew, new_weight)
        else:
            died_roulette = jnp.zeros((Rb,), bool)

        survived_collide = (
            collide & (~died_absorb) & (~died_max_refl) & (~died_roulette)
        )

        # ---- 7. state update --------------------------------------------
        new_org = jnp.where(scattering[:, None], scatter_org, new_org)
        new_dir = jnp.where(scattering[:, None], rnd_sphere, new_dir)
        new_org = jnp.where(
            (bf_pass | survived_collide)[:, None], hitpoint, new_org
        )
        new_dir = jnp.where(survived_collide[:, None], refl_dir, new_dir)
        if dim == 2:
            zeroed = new_dir.at[:, 2].set(0.0)
            norm = jnp.maximum(
                jnp.linalg.norm(zeroed, axis=1, keepdims=True), 1e-12
            )
            new_dir = zeroed / norm

        weight_out = jnp.where(collide, new_weight, weight)
        hfb_out = hfb | bf_pass
        dead = (
            dead
            | is_exit
            | bdry_overflow
            | bf_kill
            | died_absorb
            | died_max_refl
            | died_roulette
        )
        alive_out = alive & (~dead)

        # dtype pinned so the carry stays int32 under jax_enable_x64 (the
        # f64-precision tracing mode; sum() would otherwise promote)
        isum = lambda m: jnp.sum(m, dtype=jnp.int32)
        cnt = BatchCounters(
            total_traces=cnt.total_traces + isum(alive),
            non_geometry_hits=cnt.non_geometry_hits + isum(is_exit),
            geometry_hits=cnt.geometry_hits + isum(collide),
            particle_hits=cnt.particle_hits + isum(scattering),
            boundary_hits=cnt.boundary_hits + isum(is_wall),
            reflections=cnt.reflections + isum(collide),
        )

        return (
            it + 1,
            new_org,
            new_dir,
            weight_out,
            w0,
            alive_out,
            hfb_out,
            n_refl_new,
            n_bdry_new,
            aux_out,
            flux,
            cnt,
        )

    # ---- source-coherence sort -------------------------------------------
    # Random source origins give every kernel block a domain-sized bounding
    # radius, which defeats the nearest-hit kernel's per-block chunk skip
    # from bounce 0. Sorting the batch by source-plane Morton cell makes
    # blocks spatially compact (deterministic per seed; deposits are
    # order-independent sums, and each lane's uniforms remain i.i.d.).
    if (
        not differentiable
        and knobs.source_sort
        and R >= 2048
    ):
        nb = 6  # 64x64 source-plane cells
        c1 = jnp.clip(
            ((org[:, first_dir] - lo1) / jnp.maximum(hi1 - lo1, 1e-30)
             * (1 << nb)).astype(jnp.int32),
            0, (1 << nb) - 1,
        )
        if dim == 3:
            c2 = jnp.clip(
                ((org[:, second_dir] - lo2) / jnp.maximum(hi2 - lo2, 1e-30)
                 * (1 << nb)).astype(jnp.int32),
                0, (1 << nb) - 1,
            )
            key_m = jnp.zeros_like(c1)
            for bit in range(nb):
                key_m = key_m | (((c1 >> bit) & 1) << (2 * bit))
                key_m = key_m | (((c2 >> bit) & 1) << (2 * bit + 1))
        else:
            key_m = c1
        take = jnp.argsort(key_m, stable=True)
        if aux0.dtype == jnp.float32 and org.dtype == jnp.float32:
            # one packed row-gather (same rationale as _permute_state)
            pk = jnp.concatenate(
                [org, dirn, weight[:, None], w0[:, None],
                 alive[:, None].astype(jnp.float32), aux0],
                axis=1,
            )[take]
            org, dirn = pk[:, 0:3], pk[:, 3:6]
            weight, w0 = pk[:, 6], pk[:, 7]
            alive, aux0 = pk[:, 8] > 0.5, pk[:, 9:]
        else:
            org, dirn = org[take], dirn[take]
            weight, w0 = weight[take], w0[take]
            alive, aux0 = alive[take], aux0[take]

    state = (
        jnp.int32(0), org, dirn, weight, w0, alive, hit_from_back,
        n_refl, n_bdry, aux0, flux, counters,
    )
    if differentiable:
        # lax.while_loop is not reverse-differentiable; a fixed-length scan
        # over `num_bounces` rounds is (dead lanes are no-ops). Gradients flow
        # through the weights (sticking) and hit positions; discrete path
        # decisions are treated straight-through (SURVEY §7 design stance).
        bounces = num_bounces if num_bounces is not None else 32

        def scan_body(s, _):
            return body(s), None

        # rematerialize each bounce in the backward pass: without this the
        # VJP saves every bounce's (R, P) intersection intermediates
        # (over a hundred GB at batch 2^17 x 2993 prims x 8 bounces);
        # with it, memory is one bounce's working set
        # (jax.checkpoint trades ~2x backward FLOPs — SURVEY §7 remat note).
        # The save_only policy keeps the EXPENSIVE tagged intermediates
        # (nearest-hit search outputs — so the nearest-hit kernel never
        # re-runs in the backward pass — and the neighbor/normal gathers) while
        # still rematerializing the cheap elementwise bounce logic:
        # ~(3 + K*8 + 3) * R floats per bounce of residuals.
        policy = jax.checkpoint_policies.save_only_these_names(
            "isect", "nbrec", "nhit"
        )
        state, _ = jax.lax.scan(
            jax.checkpoint(scan_body, policy=policy), state, None,
            length=bounces,
        )
        if logs is not None:
            return state[-2], state[-1], logs
        return state[-2], state[-1]

    # ---- staged execution with ray compaction ---------------------------
    # Roulette kills rays at different bounce counts, so a fixed-size
    # wavefront wastes whole-batch work on a tail of stragglers (the
    # divergent-lifetime problem, SURVEY §7 hard parts). Run the loop until
    # the survivor count fits a 4x smaller batch, compact the survivors to
    # the front (stable argsort — deterministic), and continue at the
    # smaller width. Work becomes ~ total ray-bounces instead of
    # max_bounces x batch.
    # 2x shrink per stage (VIENNARAY_TPU_STAGE_SHRINK), floored at 512
    # lanes: the long tail — e.g. near-horizontal rays ping-ponging between
    # periodic walls until the max_boundary_hits cap (up to 1000
    # iterations) — then runs at minimal width instead of full batch cost,
    # and the fine ladder sheds dead roulette lanes from the wide stages
    # soon after they die.
    min_stage = 512
    shrink = knobs.stage_shrink
    stage_caps = []
    cap = R
    while cap > min_stage:
        cap //= shrink
        stage_caps.append(max(cap, min_stage))
    stage_caps.append(0)  # final stage: run to extinction
    # spatial compaction: sort survivors by origin cell + direction octant
    # so kernel blocks stay coherent after diffuse bounces decohere the
    # source order (VIENNARAY_TPU_COMPACT_SORT=alive compacts by liveness
    # only)
    spatial_sort = knobs.compact_sort == "spatial"
    if spatial_sort:
        bb_lo = jnp.stack([bbox[0, 0], bbox[0, 1], bbox[0, 2]])
        bb_ext = jnp.maximum(
            jnp.stack([bbox[1, 0], bbox[1, 1], bbox[1, 2]]) - bb_lo, 1e-6
        )

    for cap in stage_caps:
        cap_c = jnp.int32(cap)

        def stage_cond(s):
            it, _, _, _, _, alive_s, *_ = s
            return jnp.logical_and(
                it < config.max_bounces,
                jnp.sum(alive_s.astype(jnp.int32)) > cap_c,
            )

        state = jax.lax.while_loop(stage_cond, body, state)
        if cap == 0:
            break
        (it, org, dirn, weight, w0, alive, hfb, n_refl, n_bdry, aux, flux,
         counters) = state
        with jax.named_scope("compact"):
            if spatial_sort:
                # position-major (16^3 cells), direction-octant minor:
                # clustering by origin shrinks each block's bounding radius
                # first; the octant tiebreak aligns directions within a cell
                cell = jnp.clip(
                    ((org - bb_lo) / bb_ext * 16.0).astype(jnp.int32), 0, 15
                )
                octant = (
                    (dirn[:, 0] > 0).astype(jnp.int32)
                    + 2 * (dirn[:, 1] > 0).astype(jnp.int32)
                    + 4 * (dirn[:, 2] > 0).astype(jnp.int32)
                )
                key_s = (
                    ((cell[:, 0] * 16 + cell[:, 1]) * 16 + cell[:, 2]) * 8
                    + octant
                )
                key_s = jnp.where(alive, key_s, jnp.int32(1 << 30))
                take = jnp.argsort(key_s, stable=True)[:cap]
            else:
                take = jnp.argsort(jnp.logical_not(alive), stable=True)[:cap]
            state = (it,) + _permute_state(
                take, org, dirn, weight, w0, alive, hfb, n_refl, n_bdry, aux
            ) + (flux, counters)

    if logs is not None:
        return state[-2], state[-1], logs
    return state[-2], state[-1]


def _unit_sphere_batch(key, n, dtype):
    return sampling.unit_sphere(key, (n,), dtype=dtype)


def _hit_time(geometry, geo_type, prim, org, dirn):
    """Differentiable hit time of each ray on its selected prim: the plane
    identity t = (p - o).n / d.n for disks and (planar) triangles."""
    pc = jnp.clip(prim, 0, geometry.num_primitives - 1)
    if geo_type == "disk":
        p = geometry.points[pc]
    else:
        p = geometry.vertices[geometry.triangles[pc, 0]]
    n_h = geometry.normals[pc]
    den = jnp.sum(dirn * n_h, axis=1)
    den = jnp.where(den == 0.0, 1e-30, den)
    return jnp.sum((p - org) * n_h, axis=1) / den
