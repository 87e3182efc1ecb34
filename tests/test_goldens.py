"""Cross-round golden flux regression (see benchmarks/make_goldens.py).

Goldens are generated on CPU with fixed seeds; these tests re-trace the same
configs and require statistical agreement (the trace is bitwise reproducible
for a fixed backend, but goldens may have been generated on a different
backend, so tolerances are Monte Carlo sized)."""

import json
import os

import numpy as np
import pytest

GOLDEN_DIR = os.environ.get(
    "VIENNARAY_TPU_GOLDEN_DIR",
    os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "benchmarks",
        "golden",
    ),
)

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(GOLDEN_DIR, "manifest.json")),
    reason="goldens not generated",
)


def _load(name):
    flux = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
    with open(os.path.join(GOLDEN_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    return flux, manifest[name]


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _check(norm, golden):
    """Monte-Carlo-sized tolerance cross-backend; BITWISE on the golden's
    own generation conditions (CPU backend, same CPU type) — the trace is
    deterministic there, so any drift beyond reordering means a physics
    change (5% alone would hide subtle drift).

    VIENNARAY_TPU_GOLDEN_BITWISE=1 forces the bitwise assert regardless of
    the fingerprint gate — the CI in-job leg generates the goldens on the
    SAME runner immediately before this test, so bitwise reproduction (the
    rngSeed contract, tests/rngSeed/rngSeed.cpp analog, cross-process) must
    hold unconditionally there."""
    assert _rel_l2(norm, golden) < 0.05
    import jax

    with open(os.path.join(GOLDEN_DIR, "manifest.json")) as f:
        gen_fp = json.load(f).get("_cpu_fingerprint")
    from benchmarks.make_goldens import _cpu_fingerprint

    force = os.environ.get("VIENNARAY_TPU_GOLDEN_BITWISE") == "1"
    if force or (
        jax.default_backend() == "cpu"
        and gen_fp == _cpu_fingerprint()  # XLA:CPU codegen is per-microarch
    ):
        np.testing.assert_array_equal(
            np.asarray(norm, np.float32), np.asarray(golden, np.float32)
        )


def test_golden_trace2d():
    from benchmarks.make_goldens import config_trace2d

    golden, meta = _load("trace2d")
    t = config_trace2d()
    t.set_number_of_rays_fixed(meta["num_rays"])  # honors --quick goldens
    norm = t.normalize_flux(t.apply())
    _check(norm, golden)


def test_golden_disk2d_trench():
    from benchmarks.make_goldens import config_disk2d_trench

    golden, meta = _load("disk2d_trench")
    t = config_disk2d_trench()
    t.set_number_of_rays_fixed(meta["num_rays"])
    norm = t.normalize_flux(t.apply())
    _check(norm, golden)


def test_golden_disk3d_trench():
    from benchmarks.make_goldens import config_disk3d_trench

    golden, meta = _load("disk3d_trench")
    t = config_disk3d_trench()
    t.set_number_of_rays_fixed(meta["num_rays"])
    norm = t.smooth_flux(t.normalize_flux(t.apply()), 1)
    _check(norm, golden)
