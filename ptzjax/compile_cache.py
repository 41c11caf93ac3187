"""Where JAX keeps its persistent compile cache.

Every entry point (``python -m ptzjax.run``, ``bench.py``, ``chip_smoke.py``,
the scripts under ``benchmarks/``) calls ``setup()`` before it compiles
anything, so reruns of the same shapes load their executables instead of
compiling them again.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def setup() -> str:
    """Point the persistent compile cache at a directory and return it.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing. Otherwise the cache goes to ``<checkout>/.jax_cache``,
    found from this file's location (the directory is gitignored).
    """
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
