"""Correlated-outlier stress: moving textured blobs (player analogues)
composited into the rendered video (SURVEY.md §1.1
masking rationale). Unlike i.i.d. teleported outliers, blob features are
spatially coherent and temporally persistent with consistent WRONG motion —
the failure mode the reference's player-box masks exist for.

Done criterion: with >= 15% of pixels on movers, the masked run tracks
cleanly; the unmasked run either tracks or fails LOUDLY (lost flag), never
silently drifts."""

import jax.numpy as jnp
import numpy as np
import pytest

from ptzjax import synth
from ptzjax.config import SLAMConfig
from ptzjax.frontend import extract_features
from ptzjax.geometry import Intrinsics
from ptzjax.io import boxes_to_mask
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


@pytest.fixture(scope="module")
def mover_scene():
    frames = 50
    seed = 5
    pano = synth.make_panorama(
        theta_range=(-0.6, 0.6), phi_range=(-0.35, 0.2),
        texels_per_rad=2200.0, seed=seed,
    )
    cams = synth.make_trajectory(
        frames, pan_amp=0.12, tilt0=-0.05, tilt_amp=0.02,
        f0=1100.0, f_amp=60.0, period=frames * 1.6, seed=seed,
    )
    intr = Intrinsics.create(W / 2.0, H / 2.0)
    movers = synth.make_moving_blobs(
        frames, num_blobs=8, theta_range=(-0.35, 0.35),
        phi_range=(-0.16, 0.0), ang_w=0.075, speed=0.006, seed=seed,
    )
    imgs = np.stack(
        [
            synth.render_image(pano, cams[k], intr, W, H,
                               movers=movers, frame=k)
            for k in range(frames)
        ]
    )
    masks = np.stack(
        [
            boxes_to_mask(
                synth.mover_boxes(movers, k, cams[k], intr, W, H), H, W
            )
            for k in range(frames)
        ]
    )
    return imgs, masks, cams, intr, movers


def test_mover_coverage_and_boxes(mover_scene):
    """The scene is a real stress (>= 15% mover pixels on average) and the
    GT boxes actually cover the blobs (mask validity)."""
    imgs, masks, cams, intr, movers = mover_scene
    fracs = [
        synth.mover_pixel_fraction(movers, k, cams[k], intr, W, H)
        for k in range(len(cams))
    ]
    assert np.mean(fracs) >= 0.15, np.mean(fracs)

    # every pixel whose value came from a blob must be masked out:
    # re-render frame 10 without movers; differing pixels are blob pixels
    k = 10
    pano = synth.make_panorama(
        theta_range=(-0.6, 0.6), phi_range=(-0.35, 0.2),
        texels_per_rad=2200.0, seed=5,
    )
    clean = synth.render_image(pano, cams[k], intr, W, H)
    blob_pix = np.abs(imgs[k] - clean) > 1e-6
    # masks are True where detection is ALLOWED
    leaked = blob_pix & masks[k]
    assert leaked.mean() < 1e-3, leaked.mean()


def _run(imgs, cams, intr, masks=None, **cfg_kw):
    cfg = _cfg().replace(**cfg_kw)
    slam = PTZSlam(cfg, intr)
    m0 = None if masks is None else jnp.asarray(masks[0])
    f0 = extract_features(jnp.asarray(imgs[0]), cfg, mask=m0)
    state = slam.init(*f0, cams[0])
    state, infos = slam.run_segment_pixels(
        state, jnp.asarray(imgs[1:]),
        masks=None if masks is None else jnp.asarray(masks[1:]),
    )
    lost = np.asarray(infos.lost)
    pose = np.asarray(infos.pose)
    pan_err = np.abs(pose[:, 0] - cams[1:, 0])
    return lost, pan_err


def test_masked_run_tracks_cleanly(mover_scene):
    """With player-box masks the movers are invisible to the frontend: the
    loop must track as cleanly as the mover-free scenes do."""
    imgs, masks, cams, intr, _ = mover_scene
    lost, pan_err = _run(imgs, cams, intr, masks=masks)
    assert not lost.any(), f"lost at {np.nonzero(lost)[0]}"
    assert pan_err.mean() < 2.5e-3, pan_err.mean()


def test_unmasked_run_never_silently_drifts(mover_scene):
    """Without masks, blob features enter the pipeline. Acceptable
    outcomes: the consensus/innovation gates hold (clean track), or the
    loop declares LOST. NOT acceptable: no lost flag while the pose walks
    away from GT (silent drift — the reference's masking failure mode)."""
    imgs, masks, cams, intr, _ = mover_scene
    lost, pan_err = _run(imgs, cams, intr, masks=None)
    if not lost.any():
        # claims to be tracking the whole way -> it must actually be
        # tracking (same bar as the masked run, modestly relaxed for the
        # extra clutter)
        assert pan_err.mean() < 4.0e-3, (
            f"silent drift: no lost flag but pan MAE {pan_err.mean():.2e}"
        )
        assert pan_err.max() < 2.0e-2, (
            f"silent drift: no lost flag but peak pan err {pan_err.max():.2e}"
        )


def test_unmasked_run_tracks_with_capacity_headroom(mover_scene):
    """With slot capacity sized for the clutter (2x — still below the
    product default of 256), the consensus pre-gate + fast wrong-motion
    slot retirement must carry the UNMASKED run cleanly: movers are
    detected, matched, consensus-rejected, and retired without ever
    starving the static background out of the bounded table."""
    imgs, masks, cams, intr, _ = mover_scene
    lost, pan_err = _run(imgs, cams, intr, masks=None, max_rays=192)
    assert not lost.any(), f"lost at {np.nonzero(lost)[0]}"
    assert pan_err.mean() < 1.5e-3, pan_err.mean()
