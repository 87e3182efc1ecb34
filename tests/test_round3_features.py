"""Round-3 feature tests: window flux model, multi-channel local data, f64
cross-batch accumulation."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import viennaray_tpu as vrt
from viennaray_tpu.config import TraceConfig, TraceDirection
from viennaray_tpu.io import fixtures

from test_fused_round2 import _trace_once, _use_kernel, cfg2d  # noqa: F401


def test_window_flux_model_unfused_matches_fused(monkeypatch, cfg2d):
    """flux_model='window' gives the same deposits behind the kernel's hits
    as behind the brute force's: same RNG stream, same hits."""
    pts, nrm = fixtures.create_trench_grid_2d(grid_delta=0.1)
    geo = vrt.DiskGeometry.build(pts, nrm, 0.1, dim=2)
    p = vrt.DiffuseParticle(0.1)
    cfg_w = dataclasses.replace(cfg2d, flux_model="window")

    _use_kernel(monkeypatch, True)
    f_fused, c_fused = _trace_once(geo, "disk", cfg_w, p)
    _use_kernel(monkeypatch, False)
    f_unfused, c_unfused = _trace_once(geo, "disk", cfg_w, p)

    assert f_fused.sum() > 0
    rel = np.linalg.norm(f_fused - f_unfused) / np.linalg.norm(f_fused)
    assert rel < 1e-5, rel
    assert c_fused.geometry_hits == c_unfused.geometry_hits
    # window mode deposits MORE than neighbor mode on this trench
    f_nb, _ = _trace_once(geo, "disk", cfg2d, p)
    assert f_unfused.sum() > f_nb.sum()


def test_window_rejects_custom_collision(cfg2d):
    pts, nrm = fixtures.create_trench_grid_2d(grid_delta=0.1)
    geo = vrt.DiskGeometry.build(pts, nrm, 0.1, dim=2)
    p = vrt.DiffuseParticle(0.1)
    cfg_w = dataclasses.replace(cfg2d, flux_model="window", use_wdist=True)
    with pytest.raises(NotImplementedError):
        _trace_once(geo, "disk", cfg_w, p)


def test_multichannel_local_data():
    """A two-label particle writes DISTINCT values into distinct channels in
    one apply() (ref: rayParticle.hpp:60-66; GPU buffer
    numElements x sum(dataLabels), gpu/raygTrace.hpp:97-99)."""
    pts, nrm = fixtures.create_trench_grid_2d(grid_delta=0.2)
    t = vrt.TraceDisk(dim=2)
    t.set_geometry(pts, nrm, 0.2)
    t.set_boundary_conditions([vrt.BoundaryCondition.REFLECTIVE] * 2)
    part = vrt.DiffuseParticle(0.3)
    part = part.replace(data_labels=("ionFlux", "energyFlux"))
    t.set_particle_type(part)

    def collision_fn(flux, ids, w, dirn, normal, mat, key):
        # channel 0: plain flux; channel 1: energy-weighted (2x) flux
        f0 = flux[0].at[ids.reshape(-1)].add(w.reshape(-1))
        f1 = flux[1].at[ids.reshape(-1)].add(2.0 * w.reshape(-1))
        return jnp.stack([f0, f1])

    t.set_custom_functions(collision_fn=collision_fn)
    t.set_source_direction(TraceDirection.POS_Y)
    t.set_number_of_rays_fixed(4096)
    t.set_rng_seed(9)
    t.set_ray_batch_size(4096)
    flux = t.apply()
    assert flux.shape == (2, len(pts))
    ion = t.get_local_data().get_vector_data("ionFlux")
    en = t.get_local_data().get_vector_data("energyFlux")
    assert ion.sum() > 0
    np.testing.assert_allclose(en, 2.0 * ion, rtol=1e-6)


def test_multilabel_without_custom_fn_zero_extra_channels():
    """Built-in deposits fill channel 0 only; extra declared labels stay
    zero (the reference's untouched-channel behavior), never duplicated."""
    pts, nrm = fixtures.create_trench_grid_2d(grid_delta=0.2)
    t = vrt.TraceDisk(dim=2)
    t.set_geometry(pts, nrm, 0.2)
    t.set_boundary_conditions([vrt.BoundaryCondition.REFLECTIVE] * 2)
    part = vrt.DiffuseParticle(0.3)
    part = part.replace(data_labels=("flux", "untouched"))
    t.set_particle_type(part)
    t.set_source_direction(TraceDirection.POS_Y)
    t.set_number_of_rays_fixed(2048)
    t.set_rng_seed(9)
    t.set_ray_batch_size(2048)
    t.apply()
    assert t.get_local_data().get_vector_data("flux").sum() > 0
    assert t.get_local_data().get_vector_data("untouched").sum() == 0


def test_f64_accumulation_default_and_agreement():
    """f64 cross-batch accumulation (reference GPU double precision analog,
    normKernels.cu:5-9): default ON, agrees with the f32 path at small
    scales, and returns float64."""
    pts, nrm = fixtures.create_trench_grid_2d(grid_delta=0.2)

    def run(f64):
        t = vrt.TraceDisk(dim=2)
        t.set_geometry(pts, nrm, 0.2)
        t.set_boundary_conditions([vrt.BoundaryCondition.REFLECTIVE] * 2)
        t.set_particle_type(vrt.DiffuseParticle(0.1))
        t.set_source_direction(TraceDirection.POS_Y)
        t.set_number_of_rays_fixed(8192)
        t.set_rng_seed(5)
        t.set_ray_batch_size(2048)  # 4 batches -> accumulation engages
        t.set_f64_accumulation(f64)
        return t.apply()

    f64_flux = run(True)
    f32_flux = run(False)
    assert f64_flux.dtype == np.float64
    np.testing.assert_allclose(f64_flux, f32_flux, rtol=2e-5)
    # identical streams: per-batch sums are bitwise equal, so the f64 sum
    # differs from the f32 sum only by accumulation error
    assert np.abs(f64_flux - f32_flux).max() <= 0.5
