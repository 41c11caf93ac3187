"""Tests for sequence I/O, the eval harness, and checkpoint/resume."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from ptzjax import checkpoint, io, synth
from ptzjax.config import SLAMConfig
from ptzjax.eval import reprojection_rmse, trajectory_errors
from ptzjax.geometry import Intrinsics


class TestAnnotations:
    def test_npz_roundtrip(self, tmp_path):
        rng = np.random.default_rng(0)
        cams = np.stack(
            [
                rng.normal(0.0, 0.3, 20),
                rng.normal(-0.1, 0.05, 20),
                rng.uniform(1500.0, 3000.0, 20),
            ],
            axis=-1,
        ).astype(np.float32)
        intr = Intrinsics.create(640.0, 360.0)
        p = str(tmp_path / "ann.npz")
        io.save_annotations_npz(p, cams, intr, [f"f{i:04d}.jpg" for i in range(20)])
        ann = io.load_annotations(p)
        np.testing.assert_allclose(ann.cameras, cams)
        assert float(ann.intr.cx) == 640.0
        assert len(ann.image_names) == 20

    def test_mat_plain_array_degrees(self, tmp_path):
        import scipy.io as sio

        # reference-style: (T, 3) with pan/tilt in DEGREES
        cams_deg = np.stack(
            [np.linspace(-30, 30, 10), np.full(10, -9.0), np.full(10, 3000.0)],
            axis=-1,
        )
        p = str(tmp_path / "seq.mat")
        sio.savemat(p, {"ptz": cams_deg})
        ann = io.load_annotations(p)
        np.testing.assert_allclose(
            ann.cameras[:, 0], np.deg2rad(cams_deg[:, 0]), atol=1e-6
        )
        np.testing.assert_allclose(ann.cameras[:, 2], 3000.0)

    def test_mat_missing_key_raises(self, tmp_path):
        import scipy.io as sio

        p = str(tmp_path / "bad.mat")
        sio.savemat(p, {"unrelated": np.zeros(3)})
        with pytest.raises(ValueError, match="no annotation key"):
            io.load_annotations(p)

    def test_boxes_to_mask(self):
        m = io.boxes_to_mask(
            np.array([[10, 10, 20, 30]], np.float32), 64, 64, dilate=2
        )
        assert not m[15, 15] and not m[9, 9]  # inside + dilated rim
        assert m[40, 40] and m[2, 2]

    def test_jsonl_writer(self, tmp_path):
        p = str(tmp_path / "log.jsonl")
        io.write_trajectory_jsonl(
            p, [{"frame": 0, "pose": np.array([1.0, 2.0, 3.0])}]
        )
        rec = json.loads(open(p).read().strip())
        assert rec["pose"] == [1.0, 2.0, 3.0]


class TestEval:
    def test_trajectory_errors_known_values(self):
        gt = np.zeros((4, 3))
        pred = gt + np.array([np.deg2rad(0.5), np.deg2rad(-0.25), 10.0])
        e = trajectory_errors(pred, gt)
        assert abs(e.pan_mae_deg - 0.5) < 1e-6
        assert abs(e.tilt_mae_deg - 0.25) < 1e-6
        assert abs(e.focal_mae_px - 10.0) < 1e-6
        assert abs(e.pan_rmse_deg - 0.5) < 1e-6

    def test_reprojection_rmse_zero_and_positive(self):
        intr = Intrinsics.create(640.0, 360.0)
        gt = synth.make_trajectory(6, seed=1)
        assert reprojection_rmse(gt, gt, intr, 1280, 720) < 1e-4
        pred = gt + np.array([1e-3, 0, 0], np.float32)
        r = reprojection_rmse(pred, gt, intr, 1280, 720)
        # 1 mrad pan at f ~ 2500 px => ~2.5 px shift
        assert 1.5 < r < 4.0, r


class TestCheckpoint:
    def test_slam_state_roundtrip(self, tmp_path):
        from ptzjax.features import synth_features
        from ptzjax.slam import PTZSlam

        cfg = SLAMConfig(
            max_rays=16, max_keypoints=32, max_map_rays=64, max_keyframes=4,
            kf_desc_dim=16,
        )
        seq = synth.make_sequence(num_frames=3, num_rays=200, seed=0)
        rng = np.random.default_rng(0)
        desc = rng.normal(size=(200, 16)).astype(np.float32)
        desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
        seq = seq._replace(descriptors=desc)
        slam = PTZSlam(cfg, seq.intr)
        f0, _ = synth_features(seq, 0, cfg.max_keypoints)
        state = slam.init(f0.xy, f0.desc, f0.valid, seq.cameras[0])
        f1, _ = synth_features(seq, 1, cfg.max_keypoints)
        state, _ = slam.step(state, f1.xy, f1.desc, f1.valid)

        p = str(tmp_path / "state.npz")
        checkpoint.save_pytree(p, state)
        fresh = slam.init(f0.xy, f0.desc, f0.valid, seq.cameras[0])
        restored = checkpoint.load_pytree(p, fresh)

        # resuming from the restored state is identical to continuing
        f2, _ = synth_features(seq, 2, cfg.max_keypoints)
        a, _ = slam.step(state, f2.xy, f2.desc, f2.valid)
        b, _ = slam.step(restored, f2.xy, f2.desc, f2.valid)
        np.testing.assert_allclose(
            np.asarray(a.ekf.pose), np.asarray(b.ekf.pose), atol=1e-6
        )

    def test_structure_mismatch_raises(self, tmp_path):
        p = str(tmp_path / "x.npz")
        checkpoint.save_pytree(p, {"a": jnp.zeros(3)})
        with pytest.raises(ValueError, match="structure mismatch"):
            checkpoint.load_pytree(p, {"b": jnp.zeros(3)})

    def test_shape_mismatch_raises(self, tmp_path):
        p = str(tmp_path / "y.npz")
        checkpoint.save_pytree(p, {"a": jnp.zeros(3)})
        with pytest.raises(ValueError, match="capacity/config changed"):
            checkpoint.load_pytree(p, {"a": jnp.zeros(5)})


class TestRansacPanTilt:
    def test_rejects_outliers(self):
        import jax.numpy as jnp

        from ptzjax.match import ransac_pan_tilt
        from ptzjax.geometry import project_rays

        rng = np.random.default_rng(0)
        intr = Intrinsics.create(640.0, 360.0)
        cam = jnp.asarray([0.15, -0.05, 2200.0], jnp.float32)
        rays = jnp.asarray(
            np.stack([rng.uniform(0.0, 0.3, 80), rng.uniform(-0.15, 0.02, 80)], -1),
            jnp.float32,
        )
        pix = project_rays(cam, rays, intr)
        pix = pix + jnp.asarray(rng.normal(0, 0.5, pix.shape), jnp.float32)
        bad = np.zeros(80, bool)
        bad[rng.choice(80, 20, replace=False)] = True
        pix = jnp.where(
            jnp.asarray(bad)[:, None],
            jnp.asarray(rng.uniform(0, 1000, (80, 2)), jnp.float32),
            pix,
        )
        ok = jnp.ones((80,), bool)
        inl = np.asarray(
            ransac_pan_tilt(rays, pix, ok, cam[2], 640.0, 360.0, inlier_px=3.0)
        )
        # all kept matches are true inliers; most true inliers kept
        assert not (inl & bad).any()
        assert inl[~bad].mean() > 0.9

    def test_profile_trace_writes(self, tmp_path):
        import jax.numpy as jnp

        from ptzjax.eval import profile_trace

        out = profile_trace(
            lambda: jnp.ones((64, 64)) @ jnp.ones((64, 64)),
            str(tmp_path / "trace"),
        )
        assert float(out[0, 0]) == 64.0
        import os

        assert os.path.isdir(str(tmp_path / "trace"))


class TestAnnotationNegativePaths:
    """Malformed-annotation handling: the .mat/.npz
    probe must fail LOUDLY with a diagnostic, never track garbage."""

    def _savemat(self, tmp_path, name, **kw):
        import scipy.io as sio

        p = str(tmp_path / name)
        sio.savemat(p, kw)
        return p

    def test_mat_missing_annotation_key(self, tmp_path):
        import pytest

        from ptzjax.io import load_annotations

        p = self._savemat(tmp_path, "a.mat", unrelated=np.ones((4, 3)))
        with pytest.raises(ValueError, match="no annotation key"):
            load_annotations(p)

    def test_mat_wrong_column_count(self, tmp_path):
        import pytest

        from ptzjax.io import load_annotations

        # (6, 2): 12 values — divisible by 3, so a naive reshape would
        # silently build garbage (pan, tilt, focal) rows
        p = self._savemat(tmp_path, "b.mat", annotation=np.ones((6, 2)))
        with pytest.raises(ValueError, match=r"\(T, 3\)"):
            load_annotations(p)

    def test_mat_non_finite_values(self, tmp_path):
        import pytest

        from ptzjax.io import load_annotations

        arr = np.tile([10.0, -5.0, 2000.0], (5, 1))
        arr[3, 1] = np.nan
        p = self._savemat(tmp_path, "c.mat", annotation=arr)
        with pytest.raises(ValueError, match="non-finite"):
            load_annotations(p)

    def test_mat_non_positive_focal(self, tmp_path):
        import pytest

        from ptzjax.io import load_annotations

        arr = np.tile([10.0, -5.0, 2000.0], (5, 1))
        arr[2, 2] = 0.0  # suggests wrong column order
        p = self._savemat(tmp_path, "d.mat", annotation=arr)
        with pytest.raises(ValueError, match="focal"):
            load_annotations(p)

    def test_mat_degrees_detected_and_converted(self, tmp_path):
        from ptzjax.io import load_annotations

        arr = np.tile([25.0, -9.0, 2400.0], (4, 1))  # degrees-scale pan
        p = self._savemat(tmp_path, "e.mat", annotation=arr)
        ann = load_annotations(p)
        np.testing.assert_allclose(ann.cameras[0, 0], np.deg2rad(25.0), rtol=1e-6)
        np.testing.assert_allclose(ann.cameras[0, 2], 2400.0)

    def test_npz_missing_keys(self, tmp_path):
        import pytest

        from ptzjax.io import load_annotations

        p = str(tmp_path / "f.npz")
        np.savez(p, cameras=np.tile([0.1, -0.05, 2000.0], (4, 1)))
        with pytest.raises(ValueError, match="missing keys"):
            load_annotations(p)

    def test_npz_bad_shape(self, tmp_path):
        import pytest

        from ptzjax.io import load_annotations

        p = str(tmp_path / "g.npz")
        np.savez(p, cameras=np.ones((0, 3)), cx=640.0, cy=360.0)
        with pytest.raises(ValueError, match="non-empty"):
            load_annotations(p)

    def test_garbage_mat_file_raises(self, tmp_path):
        import pytest

        from ptzjax.io import load_annotations

        p = str(tmp_path / "h.mat")
        with open(p, "wb") as f:
            f.write(b"not a mat file at all" * 10)
        with pytest.raises(Exception):
            load_annotations(p)

    def test_malformed_bboxes(self):
        import pytest

        from ptzjax.io import boxes_to_mask

        with pytest.raises(ValueError, match=r"\(N, 4\)"):
            boxes_to_mask(np.ones((3,)), 64, 64)
