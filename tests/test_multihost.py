"""Two-process jax.distributed test.

``initialize_multihost`` (ptzjax/dist.py) was previously zero-coverage
because the tests have no second host. This exercises the REAL multi-process
path on localhost: two OS processes, gloo CPU collectives, a 2x2
("host", "chip") mesh spanning both processes, and the full sharded BA —
asserting both processes converge to the single-process result.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = str(Path(__file__).resolve().parents[1])

WORKER = r"""
import os, sys
proc_id = int(sys.argv[1])
port = sys.argv[2]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")
sys.path.insert(0, sys.argv[3])
from ptzjax import dist
from ptzjax.config import SLAMConfig
from ptzjax.synth import make_ba_problem

dist.initialize_multihost(f"127.0.0.1:{port}", 2, proc_id)
assert jax.process_count() == 2
assert len(jax.devices()) == 4 and len(jax.local_devices()) == 2

prob, intr = make_ba_problem(k=8, m=256, c=4)
cfg = SLAMConfig(ba_iters=8)
mesh = dist.make_mesh_2d(num_hosts=2, chips_per_host=2)
res = dist.run_sharded(prob, intr, cfg, mesh)
import json as _json
print("RESULT " + _json.dumps({
    "proc": proc_id,
    "cost": float(res.cost),
    "initial_cost": float(res.initial_cost),
    "cams0": [float(v) for v in jax.device_get(res.cams)[1]],
}), flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_ba(tmp_path):
    port = _free_port()
    env = {**os.environ}
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(pid), str(port), REPO],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO, env=env,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        outs.append(out)

    results = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert lines, f"no RESULT line in: {out[-500:]}"
        results.append(json.loads(lines[0][len("RESULT "):]))

    # both processes see the same replicated solution
    assert results[0]["cost"] == results[1]["cost"]
    assert results[0]["cams0"] == results[1]["cams0"]
    assert results[0]["cost"] < 1e-2 * results[0]["initial_cost"]

    # and it matches the single-process run of the identical problem
    from ptzjax.synth import make_ba_problem
    from ptzjax import ba
    from ptzjax.config import SLAMConfig

    prob, intr = make_ba_problem(k=8, m=256, c=4)
    ref = ba.run(prob, intr, SLAMConfig(ba_iters=8))
    np.testing.assert_allclose(
        results[0]["cost"], float(ref.cost), rtol=1e-4
    )
    np.testing.assert_allclose(
        results[0]["cams0"],
        np.asarray(ref.cams)[1],
        rtol=1e-4, atol=1e-5,
    )
