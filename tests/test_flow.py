"""Pyramidal LK optical flow: subpixel accuracy, PTZ-motion tracking, and
rejection behavior (KLT parity — SURVEY.md §2 layer 3, §8.5)."""

import numpy as np
import pytest

from ptzjax import synth
from ptzjax.config import SLAMConfig
from ptzjax.geometry import Intrinsics, back_project_pixels, project_rays
from ptzjax.kernels.detect import detect_keypoints
from ptzjax.kernels.flow import build_pyramid, lk_track


def _textured_image(h, w, seed=0):
    pano = synth.make_panorama(seed=seed)
    return pano.tex[:h, :w].astype(np.float32)


def test_pyramid_shapes_and_dc_preservation():
    img = _textured_image(120, 160)
    pyr = build_pyramid(img, 3)
    assert [p.shape for p in pyr] == [(120, 160), (60, 80), (30, 40)]
    # blur+pool preserves the mean (edge-padded binomial kernel sums to 1)
    np.testing.assert_allclose(
        float(np.asarray(pyr[1]).mean()), float(img.mean()), atol=5e-3
    )
    # a constant image passes through every level unchanged
    cpyr = build_pyramid(np.full((64, 64), 3.5, np.float32), 3)
    for p in cpyr:
        np.testing.assert_allclose(np.asarray(p), 3.5, rtol=1e-6)


def test_pure_translation_subpixel():
    """A translated resampling of the same texture must be tracked to
    sub-0.1px accuracy (the classic LK sanity bar)."""
    pano = synth.make_panorama(seed=3)
    h, w = 240, 320
    dx, dy = 7.3, -4.6  # subpixel, several pixels: needs pyramid level 1+
    y, x = np.mgrid[0:h, 0:w]

    def sample(xs, ys):
        x0 = np.floor(xs).astype(int)
        y0 = np.floor(ys).astype(int)
        fx = (xs - x0).astype(np.float32)
        fy = (ys - y0).astype(np.float32)
        t = pano.tex
        return (
            t[y0, x0] * (1 - fy) * (1 - fx)
            + t[y0, x0 + 1] * (1 - fy) * fx
            + t[y0 + 1, x0] * fy * (1 - fx)
            + t[y0 + 1, x0 + 1] * fy * fx
        ).astype(np.float32)

    img0 = sample(x + 100.0, y + 100.0)
    img1 = sample(x + 100.0 + dx, y + 100.0 + dy)

    kp = detect_keypoints(img0, max_keypoints=64, threshold=1e-4)
    res = lk_track(img0, img1, kp.xy, kp.valid)
    tracked = np.asarray(res.tracked) & np.asarray(kp.valid)
    assert tracked.sum() >= 30
    flow = np.asarray(res.xy) - np.asarray(kp.xy)
    err = np.abs(flow[tracked] - np.array([-dx, -dy]))
    # frame 1 content sits at position - (dx, dy) relative to frame 0
    assert np.median(err) < 0.1, f"median flow error {np.median(err)}"


def _render_pair(dpan=0.004, dtilt=-0.002, df=5.0, seed=1):
    pano = synth.make_panorama(seed=seed)
    intr = Intrinsics.create(320.0, 180.0)
    cam0 = np.array([0.05, -0.05, 1600.0], np.float32)
    cam1 = cam0 + np.array([dpan, dtilt, df], np.float32)
    img0 = synth.render_image(pano, cam0, intr, 640, 360)
    img1 = synth.render_image(pano, cam1, intr, 640, 360)
    return img0, img1, cam0, cam1, intr


def test_ptz_motion_tracking_matches_geometry():
    """Track across a real pan/tilt/zoom step and compare against the exact
    geometric correspondence (back-project through cam0, project through
    cam1) — the end-to-end contract the SLAM loop needs from a KLT mode."""
    img0, img1, cam0, cam1, intr = _render_pair()
    kp = detect_keypoints(img0, max_keypoints=128, threshold=1e-4)
    res = lk_track(img0, img1, kp.xy, kp.valid)

    rays = back_project_pixels(cam0, kp.xy, intr)
    gt_xy = np.asarray(project_rays(cam1, rays, intr))
    in_view = (
        (gt_xy[:, 0] > 8) & (gt_xy[:, 0] < 632)
        & (gt_xy[:, 1] > 8) & (gt_xy[:, 1] < 352)
    )
    tracked = np.asarray(res.tracked) & np.asarray(kp.valid) & in_view
    assert tracked.sum() >= 0.6 * (np.asarray(kp.valid) & in_view).sum()
    err = np.linalg.norm(np.asarray(res.xy)[tracked] - gt_xy[tracked], axis=-1)
    assert np.median(err) < 0.3, f"median px error {np.median(err)}"
    assert np.mean(err) < 1.0


def test_out_of_view_points_rejected():
    """Points whose content leaves the frame must come back tracked=False
    (forward-backward + border rejection).

    The pan is 0.012 rad * f=1600 ~ 19 px of image motion — comfortably
    inside the pyramid's convergence basin (the synthetic panorama has no
    structure coarser than ~41 px, so very large motions are untrackable on
    this texture by ANY correlation tracker), while still pushing left-edge
    content out of the frame.
    """
    img0, img1, cam0, cam1, intr = _render_pair(dpan=0.012, dtilt=0.0, df=0.0)
    xy = np.array(
        [[3.0, 50.0], [5.0, 200.0], [2.0, 300.0], [320.0, 180.0]], np.float32
    )
    valid = np.ones(4, bool)
    res = lk_track(img0, img1, xy, valid)
    ok = np.asarray(res.tracked)
    # the center point has its correspondence in view and should survive
    assert ok[3]
    err = abs(float(np.asarray(res.xy)[3, 0]) - 320.0 + 0.012 * 1600.0)
    assert err < 0.5, f"center track off by {err}px"
    # edge points' true correspondences are at x ~ -16: out of frame
    assert not ok[:3].any()


def test_invalid_inputs_stay_invalid():
    img = _textured_image(120, 160)
    xy = np.array([[40.0, 40.0], [80.0, 60.0]], np.float32)
    res = lk_track(img, img, xy, np.array([True, False]))
    ok = np.asarray(res.tracked)
    assert ok[0] and not ok[1]
    # zero motion: tracked position == input position
    np.testing.assert_allclose(np.asarray(res.xy)[0], xy[0], atol=1e-3)


def test_flat_region_rejected_by_texturedness():
    img0 = np.zeros((96, 128), np.float32)
    img1 = np.zeros((96, 128), np.float32)
    xy = np.array([[64.0, 48.0]], np.float32)
    res = lk_track(img0, img1, xy, np.array([True]))
    assert not bool(np.asarray(res.tracked)[0])

