"""ctypes bridge to the native C++ relocalization forest.

Mirrors how the reference loads its only native component
(``slam_system/rf_map`` C++ .so via ctypes — SURVEY.md §2 layer 6, §3):
descriptors go down to the BTDTR forest, predicted rays come back, and the
3-DoF pose solve runs through the same jitted vote+refine pipeline as the
keyframe relocalization path (``reloc.solve_from_correspondences``), so the
two variants are interchangeable backends behind one result type.

The shared library builds on demand (``make -C cpp/reloc_forest``); the
build is cached by mtime.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from functools import lru_cache

from ptzjax.config import SLAMConfig
from ptzjax.geometry import Intrinsics
from ptzjax.reloc import RelocResult, solve_from_correspondences


@lru_cache(maxsize=8)
def _solve_jit(cfg: SLAMConfig, f_range, num_f, tol_px):
    """Jitted pose solve for the HOST-side forest path. ``relocalize``/
    ``relocalize_keyframes`` run inside the already-jitted frame step, but
    the forest path calls the solve from host Python, where eager per-op
    dispatch would launch every op of the solve separately."""
    import jax

    return jax.jit(
        lambda mrays, xy, w, intr: solve_from_correspondences(
            mrays, xy, w, intr, cfg,
            f_range=f_range, num_f=num_f, tol_px=tol_px,
        )
    )

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_REPO, "cpp", "reloc_forest")
_LIB = os.path.join(_SRC_DIR, "libreloc_forest.so")

_lib = None


def _load_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    src = os.path.join(_SRC_DIR, "reloc_forest.cpp")
    if not os.path.exists(_LIB) or (
        os.path.exists(src) and os.path.getmtime(src) > os.path.getmtime(_LIB)
    ):
        subprocess.run(
            ["make", "-C", _SRC_DIR, "libreloc_forest.so"],
            check=True, capture_output=True,
        )
    lib = ctypes.CDLL(_LIB)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.rf_create.restype = ctypes.c_void_p
    lib.rf_create.argtypes = [ctypes.c_int] * 6 + [ctypes.c_uint32]
    lib.rf_destroy.argtypes = [ctypes.c_void_p]
    lib.rf_add_keyframe.restype = ctypes.c_int
    lib.rf_add_keyframe.argtypes = [ctypes.c_void_p, fp, fp, ctypes.c_int, ctypes.c_int]
    lib.rf_num_samples.restype = ctypes.c_int
    lib.rf_num_samples.argtypes = [ctypes.c_void_p]
    lib.rf_relocalize.restype = ctypes.c_int
    lib.rf_relocalize.argtypes = [ctypes.c_void_p, fp, ctypes.c_int, ctypes.c_int, fp, fp]
    lib.rf_save.restype = ctypes.c_int
    lib.rf_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rf_load.restype = ctypes.c_void_p
    lib.rf_load.argtypes = [ctypes.c_char_p]
    lib.rf_set_async.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rf_training.restype = ctypes.c_int
    lib.rf_training.argtypes = [ctypes.c_void_p]
    lib.rf_wait.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _as_f32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), np.float32)


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class ForestPrediction(NamedTuple):
    rays: np.ndarray   # (Q, 2) predicted (theta, phi)
    conf: np.ndarray   # (Q,) confidence in [0, 1]


class RelocForest:
    """Online-trained descriptor -> ray regressor (native BTDTR)."""

    def __init__(
        self,
        num_trees: int = 8,
        max_depth: int = 16,
        min_leaf: int = 4,
        candidate_dims: int = 16,
        candidate_thresh: int = 8,
        backtrack_leaves: int = 8,
        seed: int = 17,
        async_train: bool = False,
        _handle: int | None = None,
    ):
        """``async_train=True`` moves tree rebuilds to a native background
        thread: ``add_keyframe`` returns in ~the sample
        memcpy time and queries keep serving the previous trees while a
        build is in flight. Use ``wait()`` for deterministic hand-offs."""
        self._lib = _load_lib()
        if _handle is not None:
            self._h = _handle
        else:
            self._h = self._lib.rf_create(
                num_trees, max_depth, min_leaf, candidate_dims,
                candidate_thresh, backtrack_leaves, seed,
            )
        if async_train:
            self._lib.rf_set_async(self._h, 1)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.rf_destroy(h)
            self._h = None

    @property
    def num_samples(self) -> int:
        return self._lib.rf_num_samples(self._h)

    @property
    def training(self) -> bool:
        """True while an async background rebuild is in flight."""
        return bool(self._lib.rf_training(self._h))

    def wait(self) -> None:
        """Block until any in-flight background rebuild has swapped in."""
        self._lib.rf_wait(self._h)

    def add_keyframe(self, desc, rays, valid=None) -> int:
        """Train on one keyframe's (descriptor, ray) pairs (SURVEY.md §4.1
        'rf_map.add_keyframe'). Rows with valid=False are dropped."""
        desc = _as_f32(desc)
        rays = _as_f32(rays)
        if valid is not None:
            keep = np.asarray(valid, bool)
            desc, rays = desc[keep], rays[keep]
        if len(desc) == 0:
            return 0
        rc = self._lib.rf_add_keyframe(
            self._h, _fptr(desc), _fptr(rays), len(desc), desc.shape[1]
        )
        if rc != 0:
            raise ValueError("descriptor dimension mismatch")
        return len(desc)

    def predict(self, desc) -> ForestPrediction:
        """Regress a ray per descriptor (SURVEY.md §4.4 path B)."""
        desc = _as_f32(desc)
        q = len(desc)
        out_rays = np.zeros((q, 2), np.float32)
        out_conf = np.zeros((q,), np.float32)
        rc = self._lib.rf_relocalize(
            self._h, _fptr(desc), q, desc.shape[1], _fptr(out_rays),
            _fptr(out_conf),
        )
        if rc != q:
            raise RuntimeError("forest not trained (no keyframes added)")
        return ForestPrediction(out_rays, out_conf)

    def save(self, path: str) -> None:
        if self._lib.rf_save(self._h, path.encode()) != 0:
            raise IOError(f"cannot write {path}")

    @staticmethod
    def load(path: str) -> "RelocForest":
        lib = _load_lib()
        h = lib.rf_load(path.encode())
        if not h:
            raise IOError(f"cannot read forest from {path}")
        return RelocForest(_handle=h)


def relocalize_rf(
    forest: RelocForest,
    desc,
    xy,
    valid,
    intr: Intrinsics,
    cfg: SLAMConfig,
    min_conf: float = 0.55,
    **solve_kw,
) -> RelocResult:
    """Forest-backed relocalization: regress rays natively, solve the pose
    on device through the shared vote+refine pipeline (SURVEY.md §4.4
    path B). Drop-in alternative to ``reloc.relocalize``.

    An untrained forest (possible with ``async_train`` while the FIRST
    build is still in flight) reports failure instead of raising — the
    caller stays lost and retries next frame, by which time the background
    build has landed."""
    q = len(np.asarray(desc))
    try:
        pred = forest.predict(np.asarray(desc))
    except RuntimeError:
        return RelocResult(
            pose=jnp.zeros((3,), jnp.float32),
            inliers=jnp.asarray(0, jnp.int32),
            success=jnp.asarray(False),
            matched_ray_ids=jnp.full((q,), -1, jnp.int32),
            matched_ok=jnp.zeros((q,), bool),
        )
    w = jnp.asarray(np.asarray(valid, bool) & (pred.conf >= min_conf))
    fn = _solve_jit(
        cfg,
        solve_kw.pop("f_range", (800.0, 6000.0)),
        solve_kw.pop("num_f", 32),
        solve_kw.pop("tol_px", 8.0),
    )
    if solve_kw:
        raise TypeError(f"unsupported solve kwargs: {sorted(solve_kw)}")
    pose, inl, n, success = fn(
        jnp.asarray(pred.rays), jnp.asarray(xy), w, intr
    )
    return RelocResult(
        pose=pose,
        inliers=n,
        success=success,
        matched_ray_ids=jnp.full((len(pred.rays),), -1, jnp.int32),
        matched_ok=inl,
    )
