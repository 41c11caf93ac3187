"""Test harness: run everything on CPU with 8 virtual devices so distributed
code paths (Mesh/shard_map/psum) are exercised without real multi-chip
hardware (SURVEY.md §6 item 5).

The CPU is chosen with ``jax.config.update("jax_platforms", "cpu")`` before
the first backend initialization (which is lazy, so doing it here in
conftest is early enough); that holds on a machine with a GPU as well. The
GPU path is checked by running ``python chip_smoke.py`` on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)
