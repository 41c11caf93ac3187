"""From-pixels integration: panorama-rendered video -> vision kernels ->
SLAM loop, judged against the ground-truth trajectory (SURVEY.md §6 items
2-3: the synthetic oracle extended to real image formation)."""

import jax.numpy as jnp
import numpy as np

from ptzjax import synth
from ptzjax.config import SLAMConfig
from ptzjax.frontend import extract_features
from ptzjax.geometry import Intrinsics, project_rays
from ptzjax.slam import PTZSlam

W, H = 640, 360


def _cfg():
    return SLAMConfig(
        image_width=W,
        image_height=H,
        max_keypoints=160,
        max_rays=96,
        max_map_rays=1024,
        max_keyframes=16,
        kf_desc_dim=128,
        sigma_obs=1.0,
        min_inliers=10,
    )


def _render(num_frames, f0=1100.0, pan_amp=0.12, f_amp=60.0, seed=0):
    pano = synth.make_panorama(
        theta_range=(-0.6, 0.6), phi_range=(-0.35, 0.2),
        texels_per_rad=2200.0, seed=seed,
    )
    cams = synth.make_trajectory(
        num_frames, pan_amp=pan_amp, tilt0=-0.05, tilt_amp=0.02,
        f0=f0, f_amp=f_amp, period=num_frames * 1.6, seed=seed,
    )
    intr = Intrinsics.create(W / 2.0, H / 2.0)
    imgs = np.stack(
        [synth.render_image(pano, c, intr, W, H) for c in cams]
    )
    return imgs, cams, intr


class TestVisionGeometryConsistency:
    def test_matches_obey_gt_projection(self):
        """Keypoints matched across two frames must displace exactly as the
        GT cameras predict (vision stack is geometrically faithful)."""
        imgs, cams, intr = _render(2, seed=3)
        cfg = _cfg()
        from ptzjax.match import match_descriptors

        xy0, d0, v0 = extract_features(
            jnp.asarray(imgs[0]), cfg
        )
        xy1, d1, v1 = extract_features(
            jnp.asarray(imgs[1]), cfg
        )
        m = match_descriptors(d1, d0, v1, v0, ratio=0.8)
        ok = np.asarray(m.ok)
        assert ok.sum() > 40, ok.sum()
        # transfer matched frame-0 points through GT geometry into frame 1
        from ptzjax.geometry import back_project_pixels

        src = jnp.asarray(xy0)[jnp.asarray(m.idx)]
        rays = back_project_pixels(jnp.asarray(cams[0]), src, intr)
        pred = project_rays(jnp.asarray(cams[1]), rays, intr)
        err = np.linalg.norm(np.asarray(pred) - np.asarray(xy1), axis=-1)[ok]
        assert np.median(err) < 0.7, np.median(err)
        assert (err < 3.0).mean() > 0.9


class TestKLTFrontend:
    def test_track_features_persistence_and_refill(self):
        """The KLT table must carry points across frames (flow, not
        re-detection), refill freed slots, and keep positions geometrically
        consistent with the GT cameras."""
        from ptzjax.frontend import track_features
        from ptzjax.geometry import back_project_pixels

        # pan_amp scaled so per-frame motion is ~14 px (broadcast-like);
        # the default 6-frame render would compress the whole trajectory
        # period into ~10 frames -> 86 px/frame, beyond any KLT's basin
        imgs, cams, intr = _render(6, pan_amp=0.02, f_amp=8.0, seed=4)
        cfg = _cfg()
        xy, desc, valid = extract_features(jnp.asarray(imgs[0]), cfg)
        prev_xy = np.asarray(xy)
        for k in range(1, 6):
            xy, desc, valid, tracked = track_features(
                jnp.asarray(imgs[k - 1]), jnp.asarray(imgs[k]),
                xy, valid, cfg,
            )
            tr = np.asarray(tracked)
            va = np.asarray(valid)
            assert tr.sum() >= 40, f"frame {k}: only {tr.sum()} tracked"
            assert va.sum() >= tr.sum()
            # tracked rows obey GT geometry
            rays = back_project_pixels(jnp.asarray(cams[k - 1]),
                                       jnp.asarray(prev_xy), intr)
            pred = np.asarray(project_rays(jnp.asarray(cams[k]), rays, intr))
            err = np.linalg.norm(np.asarray(xy) - pred, axis=-1)[tr]
            assert np.median(err) < 0.3, f"frame {k}: median {np.median(err)}"
            prev_xy = np.asarray(xy)

    def test_slam_on_klt_frontend(self):
        """Full loop: LK-tracked tables drive the SLAM segment as well as
        per-frame re-detection does."""
        from ptzjax.frontend import track_features

        frames = 30
        imgs, cams, intr = _render(frames, seed=2)
        cfg = _cfg()
        slam = PTZSlam(cfg, intr)

        xy, desc, valid = extract_features(jnp.asarray(imgs[0]), cfg)
        state = slam.init(xy, desc, valid, cams[0])
        seq = []
        for k in range(1, frames):
            xy, desc, valid, _ = track_features(
                jnp.asarray(imgs[k - 1]), jnp.asarray(imgs[k]),
                xy, valid, cfg,
            )
            seq.append((xy, desc, valid))
        state, infos = slam.run_segment(
            state,
            jnp.stack([s[0] for s in seq]),
            jnp.stack([s[1] for s in seq]),
            jnp.stack([s[2] for s in seq]),
        )
        pose = np.asarray(infos.pose)
        lost = np.asarray(infos.lost)
        assert not lost.any(), f"lost at frames {np.nonzero(lost)[0]}"
        pan_err = np.abs(pose[:, 0] - cams[1:, 0])
        assert pan_err.mean() < 2.5e-3, pan_err.mean()
        f_err = np.abs(pose[:, 2] - cams[1:, 2])
        assert f_err.mean() < 25.0, f_err.mean()


class TestFromPixelsSLAM:
    def test_tracks_rendered_sequence(self):
        frames = 40
        imgs, cams, intr = _render(frames, seed=1)
        cfg = _cfg()
        slam = PTZSlam(cfg, intr)

        feats = [
            extract_features(jnp.asarray(im), cfg)
            for im in imgs
        ]
        state = slam.init(*feats[0], cams[0])
        xy = jnp.stack([f[0] for f in feats[1:]])
        desc = jnp.stack([f[1] for f in feats[1:]])
        valid = jnp.stack([f[2] for f in feats[1:]])
        state, infos = slam.run_segment(state, xy, desc, valid)

        pose = np.asarray(infos.pose)
        lost = np.asarray(infos.lost)
        assert not lost.any(), f"lost at frames {np.nonzero(lost)[0]}"
        pan_err = np.abs(pose[:, 0] - cams[1:, 0])
        tilt_err = np.abs(pose[:, 1] - cams[1:, 1])
        f_err = np.abs(pose[:, 2] - cams[1:, 2])
        # bounds: subpixel detector noise at f~1100 px -> ~1e-3 rad scale
        assert pan_err.mean() < 2.5e-3, pan_err.mean()
        assert tilt_err.mean() < 2.5e-3, tilt_err.mean()
        assert f_err.mean() < 25.0, f_err.mean()


class TestFusedFromPixels:
    def test_fused_segment_matches_staged(self):
        """run_segment_pixels (frames -> features -> step inside ONE scan)
        must track the rendered sequence like the staged path does."""
        frames = 30
        imgs, cams, intr = _render(frames, seed=1)
        cfg = _cfg()
        slam = PTZSlam(cfg, intr)
        f0 = extract_features(jnp.asarray(imgs[0]), cfg)
        state = slam.init(*f0, cams[0])
        state, infos = slam.run_segment_pixels(
            state, jnp.asarray(imgs[1:])
        )
        lost = np.asarray(infos.lost)
        assert not lost.any(), f"lost at {np.nonzero(lost)[0]}"
        pose = np.asarray(infos.pose)
        pan_err = np.abs(pose[:, 0] - cams[1:, 0])
        assert pan_err.mean() < 2.5e-3, pan_err.mean()

    def test_fused_klt_segment(self):
        frames = 20
        imgs, cams, intr = _render(frames, pan_amp=0.02, f_amp=8.0, seed=4)
        cfg = _cfg()
        slam = PTZSlam(cfg, intr)
        xy, desc, valid = extract_features(
            jnp.asarray(imgs[0]), cfg
        )
        state = slam.init(xy, desc, valid, cams[0])
        state, infos, xy_t, valid_t = slam.run_segment_pixels_klt(
            state, jnp.asarray(imgs[1:]), jnp.asarray(imgs[0]), xy, valid,
        )
        assert xy_t.shape == xy.shape and valid_t.shape == valid.shape
        lost = np.asarray(infos.lost)
        assert not lost.any(), f"lost at {np.nonzero(lost)[0]}"
        pose = np.asarray(infos.pose)
        pan_err = np.abs(pose[:, 0] - cams[1:, 0])
        assert pan_err.mean() < 2.5e-3, pan_err.mean()
