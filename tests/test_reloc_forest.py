"""Native BTDTR relocalization forest: training, backtracking queries,
pose recovery parity with the keyframe path (SURVEY.md §6, build step 8)."""

import numpy as np
import pytest

from ptzjax import synth
from ptzjax.config import SLAMConfig
from ptzjax.features import synth_features
from ptzjax.geometry import Intrinsics

rf = pytest.importorskip("ptzjax.reloc_forest")


@pytest.fixture(scope="module")
def trained():
    """Forest trained from 6 synthetic keyframes."""
    cfg = SLAMConfig(max_keypoints=128, kf_desc_dim=32)
    seq = synth.make_sequence(num_frames=60, num_rays=900, seed=4)
    rng = np.random.default_rng(4)
    desc = rng.normal(size=(900, 32)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    seq = seq._replace(descriptors=desc)

    forest = rf.RelocForest(seed=7)
    for k in range(0, 60, 10):
        f, ids = synth_features(seq, k, cfg.max_keypoints, desc_noise=0.02)
        rays = np.where(
            (ids >= 0)[:, None], seq.rays[np.clip(ids, 0, None)], 0.0
        ).astype(np.float32)
        forest.add_keyframe(f.desc, rays, valid=f.valid & (ids >= 0))
    return forest, seq, cfg


class TestForestRegression:
    def test_training_accumulates(self, trained):
        forest, _, _ = trained
        assert forest.num_samples > 300

    def test_predicts_rays_near_gt(self, trained):
        forest, seq, cfg = trained
        f, ids = synth_features(seq, 25, cfg.max_keypoints, desc_noise=0.02, seed=1)
        keep = np.asarray(f.valid) & (ids >= 0)
        pred = forest.predict(f.desc[keep])
        gt = seq.rays[ids[keep]]
        err = np.linalg.norm(pred.rays - gt, axis=-1)
        confident = pred.conf > 0.55
        assert confident.mean() > 0.5
        # confident predictions should hit their ray (rays are ~mrad apart)
        assert np.median(err[confident]) < 5e-3, np.median(err[confident])

    def test_untrained_predict_raises(self):
        empty = rf.RelocForest()
        with pytest.raises(RuntimeError, match="not trained"):
            empty.predict(np.zeros((3, 32), np.float32))

    def test_save_load_roundtrip(self, trained, tmp_path):
        forest, seq, cfg = trained
        p = str(tmp_path / "forest.bin")
        forest.save(p)
        back = rf.RelocForest.load(p)
        assert back.num_samples == forest.num_samples
        f, _ = synth_features(seq, 33, cfg.max_keypoints, seed=2)
        a = forest.predict(f.desc)
        b = back.predict(f.desc)
        # same samples + same seed => same trees => identical predictions
        np.testing.assert_allclose(a.rays, b.rays)


class TestForestRelocalization:
    def test_recovers_lost_pose(self, trained):
        forest, seq, cfg = trained
        frame = 37  # not a training keyframe
        f, _ = synth_features(seq, frame, cfg.max_keypoints, desc_noise=0.02, seed=3)
        intr = Intrinsics.create(float(seq.intr.cx), float(seq.intr.cy))
        res = rf.relocalize_rf(forest, f.desc, f.xy, f.valid, intr, cfg)
        assert bool(res.success), int(res.inliers)
        gt = seq.cameras[frame]
        pose = np.asarray(res.pose)
        assert abs(pose[0] - gt[0]) < 2e-3, (pose, gt)
        assert abs(pose[1] - gt[1]) < 2e-3
        assert abs(pose[2] - gt[2]) < 30.0

    def test_parity_with_keyframe_path(self, trained):
        """Both relocalization variants recover the same pose (SURVEY.md §1
        item 4: (a) keyframe match, (b) random forest)."""
        from ptzjax import mapstore
        from ptzjax.reloc import relocalize

        forest, seq, cfg = trained
        frame = 44
        f, ids = synth_features(seq, frame, cfg.max_keypoints, desc_noise=0.02, seed=5)
        intr = Intrinsics.create(float(seq.intr.cx), float(seq.intr.cy))

        # keyframe path: ray store populated with GT rays + descriptors
        cfg_store = cfg.replace(max_map_rays=1024)
        store = mapstore.init_ray_store(cfg_store)
        import jax.numpy as jnp

        n = len(seq.rays)
        store = store._replace(
            rays=jnp.asarray(seq.rays)[: cfg_store.max_map_rays].at[:].get()
            if n >= cfg_store.max_map_rays
            else jnp.zeros((cfg_store.max_map_rays, 2)).at[:n].set(jnp.asarray(seq.rays)),
            desc=jnp.zeros((cfg_store.max_map_rays, 32)).at[:n].set(
                jnp.asarray(seq.descriptors)
            ),
            valid=jnp.zeros((cfg_store.max_map_rays,), bool).at[:n].set(True),
        )
        res_kf = relocalize(
            jnp.asarray(f.desc), jnp.asarray(f.xy), jnp.asarray(f.valid),
            store, intr, cfg_store,
        )
        res_rf = rf.relocalize_rf(forest, f.desc, f.xy, f.valid, intr, cfg)
        assert bool(res_kf.success) and bool(res_rf.success)
        a, b = np.asarray(res_kf.pose), np.asarray(res_rf.pose)
        assert abs(a[0] - b[0]) < 2e-3
        assert abs(a[1] - b[1]) < 2e-3
        assert abs(a[2] - b[2]) < 40.0


class TestAsyncTraining:
    """Background (native-thread) training: keyframe-
    time stalls bounded by the sample memcpy, not the tree rebuild."""

    def _data(self, n, dim=32, seed=11):
        rng = np.random.default_rng(seed)
        desc = rng.normal(size=(n, dim)).astype(np.float32)
        desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
        rays = rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32)
        return desc, rays

    def test_async_matches_sync_predictions(self):
        """Same data, same seed, one rebuild each: async trees must equal
        the synchronous ones (the trainer owns the same RNG sequence)."""
        desc, rays = self._data(3000)
        q, _ = self._data(64, seed=12)
        f_sync = rf.RelocForest(seed=5)
        f_sync.add_keyframe(desc, rays)
        f_async = rf.RelocForest(seed=5, async_train=True)
        f_async.add_keyframe(desc, rays)
        f_async.wait()
        p_s = f_sync.predict(q)
        p_a = f_async.predict(q)
        np.testing.assert_array_equal(p_s.rays, p_a.rays)
        np.testing.assert_array_equal(p_s.conf, p_a.conf)

    def test_async_add_does_not_stall(self):
        """At ~4k samples the synchronous rebuild costs ~1 s; the async
        add_keyframe must return in well under 50 ms (the r3 'Done' bar)."""
        import time

        desc, rays = self._data(4000)
        f = rf.RelocForest(async_train=True)
        t0 = time.perf_counter()
        f.add_keyframe(desc, rays)
        dt = time.perf_counter() - t0
        assert f.training or f.num_samples == 4000
        f.wait()
        assert dt < 0.05, f"async add_keyframe stalled {dt * 1e3:.0f} ms"
        # the background build landed and serves queries
        q, _ = self._data(16, seed=13)
        assert len(f.predict(q).rays) == 16

    def test_queries_serve_old_trees_during_build(self):
        """A query issued while a rebuild is in flight must answer from the
        previous tree set (not block, not crash)."""
        desc, rays = self._data(2000)
        f = rf.RelocForest(async_train=True)
        f.add_keyframe(desc, rays)
        f.wait()                       # first trees in place
        q, _ = self._data(32, seed=14)
        before = f.predict(q)
        more_d, more_r = self._data(3000, seed=15)
        f.add_keyframe(more_d, more_r)  # triggers a background rebuild
        during = f.predict(q)           # served concurrently
        np.testing.assert_array_equal(before.rays, during.rays)
        f.wait()
        after = f.predict(q)            # new trees (more samples) now serve
        assert after.rays.shape == before.rays.shape

    def test_untrained_async_reloc_reports_failure(self):
        """relocalize_rf on a forest whose FIRST build hasn't landed must
        report failure, not raise (the CLI stays lost and retries)."""
        from ptzjax.geometry import Intrinsics

        f = rf.RelocForest(async_train=True)
        cfg = SLAMConfig(kf_desc_dim=32)
        intr = Intrinsics.create(640.0, 360.0)
        desc, _ = self._data(64, seed=16)
        xy = np.zeros((64, 2), np.float32)
        res = rf.relocalize_rf(f, desc, xy, np.ones(64, bool), intr, cfg)
        assert not bool(res.success)
        assert int(res.inliers) == 0
