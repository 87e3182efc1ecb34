"""chip_smoke.py off the card: it refuses the CPU, and its phase functions
run at a tiny size here (kernel in interpret mode)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script], capture_output=True, text=True, cwd=cwd,
        env=env, timeout=300,
    )


def _last_json(stdout):
    lines = stdout.strip().splitlines()
    try:
        return json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        return None


def test_smoke_fails_on_cpu():
    out = _run(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert out.returncode != 0
    assert _last_json(out.stdout) is None
    assert "needs a GPU" in out.stderr + out.stdout


def test_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run("chip_smoke.py", tmp_path)
    assert out.returncode != 0
    assert _last_json(out.stdout) is None


def test_kernel_phase_tiny():
    rows = chip_smoke.phase_kernels(n_rays=2048, tiny=True, interpret=True)
    assert [r["geometry"] for r in rows] == ["disk3d", "tri3d"]
    assert all(r["id_equal"] == 1.0 and r["hit_equal"] == 1.0 for r in rows)


def test_main_path_phases_tiny():
    row = chip_smoke.phase_flagship(rays_per_point=1, check_golden=False)
    assert row["num_rays"] == 2993 and row["geometry_hits"] > 0
    rows = chip_smoke.phase_kinds(names=("line2d",), rays_per_point=1,
                                  check_golden=False)
    assert rows[0]["bitwise_repeat"]


def test_gradient_phase_tiny():
    row = chip_smoke.phase_gradient(grid_delta=1.0, batch=1024, bounces=3)
    assert np.isfinite(row["d_flux_d_sticking"]) and row["rel"] < 1e-2


def test_four_device_phase_on_virtual_devices():
    import jax

    assert len(jax.devices()) >= 4, "conftest provides 8 CPU devices"
    row = chip_smoke.phase_four(n_devices=4, per_shard=512, grid_delta=1.0)
    assert row["rel"] == 0.0 and row["repeat_bitwise"]
