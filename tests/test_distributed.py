"""2-process multi-host execution test (SURVEY §2.9/§5.8's net-new
communication backend).

Spawns two worker processes, each owning one virtual CPU device, joined by
``jax.distributed.initialize`` (via ``initialize_distributed``) into a
2-device global mesh. The sharded trace then exercises the REAL multi-host
path — bootstrap, cross-process mesh construction, cross-process psum —
and the flux must be BITWISE equal to a single-process 2-device run (the
RNG contract keys shards by global sub-batch index, so the stream layout
is identical; psum reduction order over 2 devices is fixed).

The single-process reference also runs in a subprocess (2 local virtual
devices) so both sides use identical code and backend flags.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "distributed_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


SINGLE_PROC_REF = """
import os, sys
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
)
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})
sys.path.insert(0, {here!r})
import numpy as np
from viennaray_tpu.parallel.mesh import make_ray_mesh, trace_sharded
from test_parallel import _setup

geometry, source, particle, bbox, config = _setup(rays_per_point=50)
mesh = make_ray_mesh()
assert mesh.devices.size == 2
total = config.total_rays(geometry.num_primitives)
flux, totals = trace_sharded(
    geometry, source, particle, bbox, config, "disk",
    jax.random.PRNGKey(config.rng_seed), total, mesh,
)
np.save({out!r}, np.asarray(flux, np.float64))
np.save({out!r} + ".counters.npy", totals)
"""


@pytest.mark.slow
def test_two_process_distributed_bitwise(tmp_path):
    """jax.distributed bootstrap + cross-process psum == single-process."""
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    out2p = str(tmp_path / "flux_2proc.npy")
    out1p = str(tmp_path / "flux_1proc.npy")

    env = dict(os.environ)
    # a clean slate: the workers pick their own platform/devices
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"

    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), "2", coord, out2p],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, _ = p.communicate()
        outs.append(stdout.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i][-4000:]}"
    assert os.path.exists(out2p), outs[0][-4000:]

    ref = subprocess.run(
        [sys.executable, "-c",
         SINGLE_PROC_REF.format(
             repo=os.path.dirname(HERE), here=HERE, out=out1p
         )],
        env=env, capture_output=True, timeout=600,
    )
    assert ref.returncode == 0, ref.stderr.decode(errors="replace")[-4000:]

    f2 = np.load(out2p)
    f1 = np.load(out1p)
    c2 = np.load(out2p + ".counters.npy")
    c1 = np.load(out1p + ".counters.npy")
    np.testing.assert_array_equal(f2, f1)  # BITWISE (rngSeed contract)
    np.testing.assert_array_equal(c2, c1)
    assert f2.sum() > 0
