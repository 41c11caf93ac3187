"""Entry-point plumbing: the compile-cache location and ``chip_smoke.py``'s
refusal to report a result without a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

_CACHE_PROBE = r"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
from ptzjax import compile_cache
print("SETUP", compile_cache.setup())
print("CONFIG", jax.config.jax_compilation_cache_dir)
"""


def _probe(env, code=_CACHE_PROBE):
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, env=env, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    return dict(
        line.split(" ", 1) for line in r.stdout.splitlines()
        if line.startswith(("SETUP", "CONFIG"))
    )


def test_compile_cache_honours_env_var(tmp_path):
    cache = tmp_path / "cache"
    env = {**os.environ, "JAX_COMPILATION_CACHE_DIR": str(cache)}
    code = _CACHE_PROBE + (
        "import jax.numpy as jnp\n"
        "jax.block_until_ready(jax.jit(lambda x: jnp.cos(x) * 3)(jnp.ones(7)))\n"
    )
    out = _probe(env, code)
    assert out["SETUP"] == str(cache) == out["CONFIG"]
    assert any(cache.iterdir()), "nothing was cached in the env var's dir"


def test_compile_cache_defaults_inside_checkout():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    out = _probe(env)
    assert out["SETUP"] == str(REPO / ".jax_cache") == out["CONFIG"]


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """On the CPU (or without the package beside it) the smoke script
    exits non-zero and prints no result line."""
    if where == "checkout":
        cwd, script = REPO, REPO / "chip_smoke.py"
    else:
        cwd = tmp_path
        script = Path(shutil.copy(REPO / "chip_smoke.py", tmp_path))
    r = subprocess.run(
        [sys.executable, str(script), "--out", str(tmp_path / "out")],
        capture_output=True, text=True, cwd=cwd, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def _summary(**kw):
    s = {
        "frames_lost": 0, "ba_cost_before": 90.0, "ba_cost_after": 77.0,
        "pan_mae_deg": 0.0007, "tilt_mae_deg": 0.0003, "focal_mae_px": 0.15,
    }
    return {**s, **kw}


@pytest.mark.parametrize(
    "change,violations",
    [
        ({}, 0),
        ({"frames_lost": 1}, 1),
        ({"ba_cost_after": 95.0}, 1),
        ({"pan_mae_deg": float("nan"), "focal_mae_px": 5.0}, 2),
    ],
)
def test_chip_smoke_tracking_gate(change, violations):
    sys.path.insert(0, str(REPO))
    import chip_smoke

    bad = chip_smoke.check_tracking(
        "online", _summary(**change), chip_smoke.CPU_REF["online"]
    )
    assert len(bad) == violations, bad
