"""ASan/UBSan harness for the native relocalization forest (SURVEY.md §7
sanitizers row).

Drives the C API of cpp/reloc_forest directly through ctypes WITHOUT
importing jax (jaxlib's nanobind throws C++ exceptions that trip ASan's
__cxa_throw interceptor check, which would mask real findings). Exercises
create / online train / query / save / load / destroy across several
shapes, including adversarial ones (single sample, deep trees, repeated
descriptors).

Usage (records the run; result log -> benchmarks/SANITIZERS.md):
  make -C cpp/reloc_forest clean && make -C cpp/reloc_forest SANITIZE=1
  LD_PRELOAD=$(gcc -print-file-name=libasan.so) \
      ASAN_OPTIONS=detect_leaks=1 \
      LSAN_OPTIONS=suppressions=benchmarks/lsan.supp:print_suppressions=0 \
      python benchmarks/sanitize_forest.py
  make -C cpp/reloc_forest clean && make -C cpp/reloc_forest  # restore -O3

The suppressions file masks CPython-interpreter-internal allocations only;
a leak reaching through reloc_forest.cpp frames still fails the run.
"""

from __future__ import annotations

import ctypes
import os
import sys
import tempfile

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LIB = os.path.join(_REPO, "cpp", "reloc_forest", "libreloc_forest.so")


def main() -> None:
    lib = ctypes.CDLL(_LIB)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.rf_create.restype = ctypes.c_void_p
    lib.rf_create.argtypes = [ctypes.c_int] * 6 + [ctypes.c_uint32]
    lib.rf_destroy.argtypes = [ctypes.c_void_p]
    lib.rf_add_keyframe.restype = ctypes.c_int
    lib.rf_add_keyframe.argtypes = [ctypes.c_void_p, fp, fp, ctypes.c_int,
                                    ctypes.c_int]
    lib.rf_num_samples.restype = ctypes.c_int
    lib.rf_num_samples.argtypes = [ctypes.c_void_p]
    lib.rf_relocalize.restype = ctypes.c_int
    lib.rf_relocalize.argtypes = [ctypes.c_void_p, fp, ctypes.c_int,
                                  ctypes.c_int, fp, fp]
    lib.rf_save.restype = ctypes.c_int
    lib.rf_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rf_load.restype = ctypes.c_void_p
    lib.rf_load.argtypes = [ctypes.c_char_p]

    def ptr(a):
        return a.ctypes.data_as(fp)

    rng = np.random.default_rng(0)

    for dim, n_kf, kf_size, trees, depth in (
        (128, 6, 400, 8, 16),
        (64, 3, 50, 4, 24),     # deep trees, few samples
        (32, 1, 1, 2, 4),       # single-sample training set
        (128, 2, 500, 8, 16),   # heavy duplicates
    ):
        h = lib.rf_create(trees, depth, 4, 16, 8, 8, 17)
        assert h
        total = 0
        for k in range(n_kf):
            desc = rng.normal(size=(kf_size, dim)).astype(np.float32)
            if kf_size >= 100:
                desc[kf_size // 2:] = desc[: kf_size - kf_size // 2]  # dups
            desc /= np.maximum(
                np.linalg.norm(desc, axis=-1, keepdims=True), 1e-9
            )
            rays = rng.uniform(-0.5, 0.5, (kf_size, 2)).astype(np.float32)
            rc = lib.rf_add_keyframe(
                h, ptr(np.ascontiguousarray(desc)),
                ptr(np.ascontiguousarray(rays)), kf_size, dim,
            )
            assert rc == 0, rc
            total += kf_size
        assert lib.rf_num_samples(h) == total

        q = min(total, 64)
        qd = rng.normal(size=(q, dim)).astype(np.float32)
        qd /= np.maximum(np.linalg.norm(qd, axis=-1, keepdims=True), 1e-9)
        out_rays = np.zeros((q, 2), np.float32)
        out_conf = np.zeros((q,), np.float32)
        rc = lib.rf_relocalize(
            h, ptr(np.ascontiguousarray(qd)), q, dim, ptr(out_rays),
            ptr(out_conf),
        )
        assert rc == q, rc
        assert np.isfinite(out_rays).all() and np.isfinite(out_conf).all()

        # dim-mismatch rejection path
        bad = rng.normal(size=(4, dim + 1)).astype(np.float32)
        rc = lib.rf_add_keyframe(h, ptr(np.ascontiguousarray(bad)),
                                 ptr(out_rays), 4, dim + 1)
        assert rc != 0

        # save / load / re-query roundtrip. rf_save re-seeds and REBUILDS
        # the live forest (documented: incremental training advances the
        # RNG), so the roundtrip contract is post-save live == loaded —
        # not pre-save == loaded.
        with tempfile.NamedTemporaryFile(suffix=".rf", delete=False) as f:
            path = f.name
        assert lib.rf_save(h, path.encode()) == 0
        rc = lib.rf_relocalize(
            h, ptr(np.ascontiguousarray(qd)), q, dim, ptr(out_rays),
            ptr(out_conf),
        )
        assert rc == q
        h2 = lib.rf_load(path.encode())
        assert h2
        out2 = np.zeros((q, 2), np.float32)
        conf2 = np.zeros((q,), np.float32)
        rc = lib.rf_relocalize(
            h2, ptr(np.ascontiguousarray(qd)), q, dim, ptr(out2), ptr(conf2)
        )
        assert rc == q
        np.testing.assert_array_equal(out2, out_rays)
        os.unlink(path)
        lib.rf_destroy(h)
        lib.rf_destroy(h2)
        print(f"ok dim={dim} kf={n_kf}x{kf_size} trees={trees} depth={depth}",
              flush=True)

    # --- async training (native background thread) -----------------------
    # exercises: set_async, concurrent add while a build is in flight,
    # queries against the served tree set during a build, wait, save (which
    # joins), and destroy with a build potentially in flight. Run under
    # TSan (make TSAN=1) as well as ASan/UBSan/LSan.
    lib.rf_set_async.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rf_training.restype = ctypes.c_int
    lib.rf_training.argtypes = [ctypes.c_void_p]
    lib.rf_wait.argtypes = [ctypes.c_void_p]

    dim = 64
    h = lib.rf_create(8, 16, 4, 16, 8, 8, 17)
    lib.rf_set_async(h, 1)
    q = 32
    qd = rng.normal(size=(q, dim)).astype(np.float32)
    qd /= np.maximum(np.linalg.norm(qd, axis=-1, keepdims=True), 1e-9)
    out_rays = np.zeros((q, 2), np.float32)
    out_conf = np.zeros((q,), np.float32)
    for batch in (500, 2000, 3000, 4000):
        desc = rng.normal(size=(batch, dim)).astype(np.float32)
        desc /= np.maximum(np.linalg.norm(desc, axis=-1, keepdims=True), 1e-9)
        rays = rng.uniform(-0.5, 0.5, (batch, 2)).astype(np.float32)
        rc = lib.rf_add_keyframe(
            h, ptr(np.ascontiguousarray(desc)),
            ptr(np.ascontiguousarray(rays)), batch, dim,
        )
        assert rc == 0
        # query immediately: must serve the previous tree set (or report
        # untrained before the FIRST build lands) without racing the build
        rc = lib.rf_relocalize(
            h, ptr(np.ascontiguousarray(qd)), q, dim, ptr(out_rays),
            ptr(out_conf),
        )
        assert rc in (q, -1)
    lib.rf_wait(h)
    rc = lib.rf_relocalize(
        h, ptr(np.ascontiguousarray(qd)), q, dim, ptr(out_rays),
        ptr(out_conf),
    )
    assert rc == q and np.isfinite(out_rays).all()
    # save joins the trainer and rebuilds deterministically
    with tempfile.NamedTemporaryFile(suffix=".rf", delete=False) as f:
        path = f.name
    assert lib.rf_save(h, path.encode()) == 0
    os.unlink(path)
    # destroy with a build possibly in flight (dtor joins)
    more = rng.normal(size=(6000, dim)).astype(np.float32)
    mrays = rng.uniform(-0.5, 0.5, (6000, 2)).astype(np.float32)
    assert lib.rf_add_keyframe(h, ptr(np.ascontiguousarray(more)),
                               ptr(np.ascontiguousarray(mrays)), 6000, dim) == 0
    lib.rf_destroy(h)
    print("ok async train/query/save/destroy", flush=True)

    print("SANITIZE PASS", flush=True)


if __name__ == "__main__":
    sys.exit(main())
