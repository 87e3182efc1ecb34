"""Where the package puts JAX's persistent compilation cache, checked in
fresh interpreters (the package decides at import time)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir(env_overrides):
    env = {k: v for k, v in os.environ.items()
           if k not in ("VIENNARAY_TPU_NO_CACHE",
                        "JAX_COMPILATION_CACHE_DIR")}
    env.update(env_overrides)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c",
         "import viennaray_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120,
        check=True,
    )
    return out.stdout.strip().splitlines()[-1]


def test_cache_in_checkout_without_env():
    assert _cache_dir({}) == os.path.join(ROOT, ".jax_cache")


def test_cache_follows_jax_compilation_cache_dir(tmp_path):
    d = str(tmp_path / "cc")
    assert _cache_dir({"JAX_COMPILATION_CACHE_DIR": d}) == d


def test_cache_opt_out():
    assert _cache_dir({"VIENNARAY_TPU_NO_CACHE": "1"}) in ("None", "")
