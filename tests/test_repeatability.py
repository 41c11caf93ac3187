"""Keypoint-level kernel parity vs OpenCV (SURVEY.md §6 item 3: "Pallas
detector/matcher vs OpenCV SIFT/BF on real images: repeatability and
match-inlier overlap thresholds (not bit equality)").

The trajectory-level comparison lives in the bench suite (frontends group);
these tests pin the DETECTOR's repeatability under a known PTZ warp and the
MATCHER's inlier overlap against cv2's BF matcher, so a kernel regression
is caught at the component level, not three layers up.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ptzjax import synth
from ptzjax.config import SLAMConfig
from ptzjax.geometry import Intrinsics, back_project_pixels, project_rays
from ptzjax.kernels.detect import detect_keypoints

cv2 = pytest.importorskip("cv2")

W, H = 640, 360


def _pair(seed=11, dpan=0.01, df=30.0):
    pano = synth.make_panorama(
        theta_range=(-0.5, 0.5), phi_range=(-0.3, 0.18),
        texels_per_rad=2200.0, seed=seed,
    )
    intr = Intrinsics.create(W / 2.0, H / 2.0)
    cam0 = np.array([0.02, -0.05, 1200.0], np.float32)
    cam1 = cam0 + np.array([dpan, -0.002, df], np.float32)
    img0 = synth.render_image(pano, cam0, intr, W, H)
    img1 = synth.render_image(pano, cam1, intr, W, H)
    return img0, img1, cam0, cam1, intr


def _repeatability(xy0, v0, xy1, v1, cam0, cam1, intr, tol=1.5):
    """Fraction of frame-0 keypoints whose GT-warped position has a frame-1
    detection within tol px (only counting those that stay in view)."""
    rays = back_project_pixels(jnp.asarray(cam0), jnp.asarray(xy0), intr)
    warped = np.asarray(project_rays(jnp.asarray(cam1), rays, intr))
    inside = (
        np.asarray(v0)
        & (warped[:, 0] > 12) & (warped[:, 0] < W - 12)
        & (warped[:, 1] > 12) & (warped[:, 1] < H - 12)
    )
    if inside.sum() == 0:
        return 0.0
    b = np.asarray(xy1)[np.asarray(v1)]
    d = np.linalg.norm(warped[inside][:, None, :] - b[None, :, :], axis=-1)
    return float((d.min(axis=1) < tol).mean())


def test_detector_repeatability_vs_cv2():
    """Under a small PTZ warp, the Harris detector's repeatability must be
    high in absolute terms AND comparable to cv2 SIFT's on the same pair."""
    img0, img1, cam0, cam1, intr = _pair()

    kp0 = detect_keypoints(jnp.asarray(img0), 256, threshold=0.01)
    kp1 = detect_keypoints(jnp.asarray(img1), 256, threshold=0.01)
    rep_dev = _repeatability(
        kp0.xy, kp0.valid, kp1.xy, kp1.valid, cam0, cam1, intr
    )

    sift = cv2.SIFT_create(nfeatures=256)
    u0 = (np.clip(np.asarray(img0), 0, 1) * 255).astype(np.uint8)
    u1 = (np.clip(np.asarray(img1), 0, 1) * 255).astype(np.uint8)
    k0 = sift.detect(u0, None)
    k1 = sift.detect(u1, None)
    xy0 = np.array([k.pt for k in k0], np.float32).reshape(-1, 2)
    xy1 = np.array([k.pt for k in k1], np.float32).reshape(-1, 2)
    rep_cv2 = _repeatability(
        xy0, np.ones(len(xy0), bool), xy1, np.ones(len(xy1), bool),
        cam0, cam1, intr,
    )

    assert rep_dev > 0.6, f"device detector repeatability {rep_dev:.2f}"
    # comparable: within a 0.75 factor of cv2's SIFT on the same pair
    assert rep_dev > 0.75 * rep_cv2, (rep_dev, rep_cv2)


def test_matcher_inlier_overlap_vs_cv2_bf():
    """Descriptor matching: our gated-free matcher's geometric-inlier set
    must overlap cv2's BFMatcher+ratio-test inliers on the same SIFT
    descriptors (matcher-only comparison: identical inputs)."""
    from ptzjax.match import match_descriptors

    img0, img1, cam0, cam1, intr = _pair(seed=12)
    sift = cv2.SIFT_create(nfeatures=256)
    u0 = (np.clip(np.asarray(img0), 0, 1) * 255).astype(np.uint8)
    u1 = (np.clip(np.asarray(img1), 0, 1) * 255).astype(np.uint8)
    k0, d0 = sift.detectAndCompute(u0, None)
    k1, d1 = sift.detectAndCompute(u1, None)
    assert len(k0) > 60 and len(k1) > 60
    d0 = d0 / np.maximum(np.linalg.norm(d0, axis=-1, keepdims=True), 1e-9)
    d1 = d1 / np.maximum(np.linalg.norm(d1, axis=-1, keepdims=True), 1e-9)
    xy0 = np.array([k.pt for k in k0], np.float32)
    xy1 = np.array([k.pt for k in k1], np.float32)

    def gt_ok(i, j, tol=2.0):
        rays = back_project_pixels(
            jnp.asarray(cam0), jnp.asarray(xy0[i][None]), intr
        )
        w = np.asarray(project_rays(jnp.asarray(cam1), rays, intr))[0]
        return np.linalg.norm(w - xy1[j]) < tol

    # ours
    m = match_descriptors(
        jnp.asarray(d0), jnp.asarray(d1),
        jnp.ones(len(d0), bool), jnp.ones(len(d1), bool),
    )
    ours = {
        (i, int(np.asarray(m.idx)[i]))
        for i in np.flatnonzero(np.asarray(m.ok))
    }
    ours_inl = {p for p in ours if gt_ok(*p)}

    # cv2 BF + Lowe ratio + mutual (crossCheck applies to knnMatch poorly;
    # emulate with ratio both ways like our matcher's mutual-best rule)
    bf = cv2.BFMatcher(cv2.NORM_L2)
    knn = bf.knnMatch(d0, d1, k=2)
    fwd = {
        mm[0].queryIdx: mm[0].trainIdx
        for mm in knn
        if len(mm) == 2 and mm[0].distance < 0.9 * mm[1].distance
    }
    knn_b = bf.knnMatch(d1, d0, k=2)
    bwd = {
        mm[0].queryIdx: mm[0].trainIdx
        for mm in knn_b
        if len(mm) == 2 and mm[0].distance < 0.9 * mm[1].distance
    }
    cv2m = {(q, t) for q, t in fwd.items() if bwd.get(t) == q}
    cv2_inl = {p for p in cv2m if gt_ok(*p)}

    assert len(ours_inl) > 30 and len(cv2_inl) > 30, (
        len(ours_inl), len(cv2_inl),
    )
    # our inlier yield within 0.7x of cv2's, and the sets mostly agree
    assert len(ours_inl) > 0.7 * len(cv2_inl), (len(ours_inl), len(cv2_inl))
    overlap = len(ours_inl & cv2_inl) / max(1, min(len(ours_inl), len(cv2_inl)))
    assert overlap > 0.7, overlap
