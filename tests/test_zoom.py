"""Zoom robustness (SURVEY.md §1.1/§8.5 — the reference's
SIFT is scale-invariant because zoom changes feature scale). Our PTZ-specific
answer: focal length is EKF state, so descriptors sample at f/f_ref spacing
(no pyramid) and slot descriptors refresh on confirmed matches."""

import jax.numpy as jnp
import numpy as np

from ptzjax import synth
from ptzjax.config import SLAMConfig
from ptzjax.frontend import extract_features
from ptzjax.geometry import Intrinsics, project_rays, back_project_pixels
from ptzjax.match import match_descriptors
from ptzjax.slam import PTZSlam

W, H = 640, 360
F_REF = 1650.0


def _cfg(**kw):
    base = dict(
        image_width=W,
        image_height=H,
        max_keypoints=160,
        max_rays=96,
        max_map_rays=1024,
        max_keyframes=16,
        kf_desc_dim=128,
        sigma_obs=1.0,
        min_inliers=10,
        descriptor_f_ref=F_REF,
    )
    base.update(kw)
    return SLAMConfig(**base)


def _pano(seed=0):
    return synth.make_panorama(
        theta_range=(-0.6, 0.6), phi_range=(-0.35, 0.2),
        texels_per_rad=2200.0, seed=seed,
    )


def test_descriptor_match_survives_2x_zoom():
    """The same landmarks, seen at f=1100 and f=2200 (2x zoom): f-scaled
    descriptors must still match; fixed-scale descriptors must be visibly
    worse (this is the failure mode being fixed)."""
    pano = _pano(seed=5)
    intr = Intrinsics.create(W / 2.0, H / 2.0)
    cam_a = np.array([0.0, -0.05, 1100.0], np.float32)
    cam_b = np.array([0.0, -0.05, 2200.0], np.float32)
    img_a = jnp.asarray(synth.render_image(pano, cam_a, intr, W, H))
    img_b = jnp.asarray(synth.render_image(pano, cam_b, intr, W, H))
    cfg = _cfg()

    xy_a, d_a, v_a = extract_features(
        img_a, cfg, focal=jnp.asarray(cam_a[2])
    )
    # transfer frame-a keypoints into frame b through GT geometry; keep
    # those that land inside the zoomed view
    rays = back_project_pixels(jnp.asarray(cam_a), xy_a, intr)
    xy_b = project_rays(jnp.asarray(cam_b), rays, intr)
    inside = (
        np.asarray(v_a)
        & (np.asarray(xy_b)[:, 0] > 25) & (np.asarray(xy_b)[:, 0] < W - 25)
        & (np.asarray(xy_b)[:, 1] > 25) & (np.asarray(xy_b)[:, 1] < H - 25)
    )
    assert inside.sum() > 30

    from ptzjax.kernels.descriptor import describe_keypoints

    d_b_scaled = describe_keypoints(
        img_b, xy_b, jnp.asarray(inside), scale=jnp.asarray(cam_b[2] / F_REF)
    )
    d_a_scaled = describe_keypoints(
        img_a, xy_a, jnp.asarray(inside), scale=jnp.asarray(cam_a[2] / F_REF)
    )
    d_b_fixed = describe_keypoints(img_b, xy_b, jnp.asarray(inside))
    d_a_fixed = describe_keypoints(img_a, xy_a, jnp.asarray(inside))

    cos_scaled = np.asarray(jnp.sum(d_a_scaled * d_b_scaled, -1))[inside]
    cos_fixed = np.asarray(jnp.sum(d_a_fixed * d_b_fixed, -1))[inside]
    assert np.median(cos_scaled) > 0.8, np.median(cos_scaled)
    assert np.median(cos_scaled) > np.median(cos_fixed) + 0.1, (
        np.median(cos_scaled), np.median(cos_fixed),
    )


def _run_zoom_sequence(cfg, frames, f0, f_amp, drop=(), seed=1,
                       pan_amp=0.05):
    """Host loop using the ESTIMATED focal for descriptor scaling (the
    honest pipeline: no GT enters the frontend)."""
    pano = _pano(seed=seed)
    intr = Intrinsics.create(W / 2.0, H / 2.0)
    # period ~ frames so the focal sine sweeps its FULL range (close to a
    # whole cycle) within the sequence
    cams = synth.make_trajectory(
        frames, pan_amp=pan_amp, tilt0=-0.05, tilt_amp=0.02,
        f0=f0, f_amp=f_amp, period=frames * 1.05, seed=seed,
    )
    imgs = [synth.render_image(pano, c, intr, W, H) for c in cams]
    slam = PTZSlam(cfg, intr)
    feats0 = extract_features(
        jnp.asarray(imgs[0]), cfg, focal=jnp.asarray(cams[0][2]),
    )
    state = slam.init(*feats0, cams[0])
    infos = []
    for k in range(1, frames):
        f_est = jnp.asarray(state.ekf.pose[2])
        xy, desc, valid = extract_features(
            jnp.asarray(imgs[k]), cfg, focal=f_est
        )
        if k in drop:
            valid = jnp.zeros_like(valid)
        state, info = slam.process(state, xy, desc, valid)
        info["frame"] = k
        infos.append(info)
    return cams, state, infos


def test_tracking_through_2x_zoom():
    """Full from-pixels loop across a 1100 -> 2200 px focal sweep (2x zoom,
    normal in broadcast): f-scaled descriptors + slot refresh must hold
    tracking the whole way."""
    frames = 50
    cfg = _cfg()
    cams, state, infos = _run_zoom_sequence(
        cfg, frames, f0=F_REF, f_amp=550.0, seed=2
    )
    lost = [i["frame"] for i in infos if i["lost"]]
    assert not lost, f"lost at {lost}"
    f_gt = cams[1:, 2]
    assert f_gt.max() / f_gt.min() > 1.7          # the sweep really is ~2x
    pose = np.stack([i["pose"] for i in infos])
    pan_err = np.abs(pose[:, 0] - cams[1:, 0])
    f_err = np.abs(pose[:, 2] - f_gt)
    assert pan_err.mean() < 3e-3, pan_err.mean()
    assert f_err.mean() < 40.0, f_err.mean()


def test_zoom_sweep_inserts_keyframes():
    """A pure zoom sweep (no pan) must INSERT keyframes via the zoom half
    of the pan/zoom criterion (cfg.keyframe_zoom_ratio): view_overlap reads
    zoom-in as full containment, and with zero inserts the loop runs
    pure-EKF and gauge-drifts over long sequences (the r5 10k-soak focal
    collapse). The windowed BA those inserts trigger is the anti-drift
    anchor."""
    frames = 50
    cfg = _cfg()
    cams, state, infos = _run_zoom_sequence(
        cfg, frames, f0=F_REF, f_amp=450.0, seed=4, pan_amp=0.0
    )
    assert not any(i["lost"] for i in infos)
    inserts = sum(bool(i["keyframe"]) for i in infos)
    # f sweeps F_REF +- 450 (ratio ~1.7 end to end) => several 12% steps
    assert inserts >= 2, f"zoom sweep inserted only {inserts} keyframes"


def test_reloc_after_zoom():
    """Lose tracking mid-zoom (blackout) and recover against a map whose
    descriptors were recorded at a different focal: zoom-normalized
    descriptors make relocalization focal-agnostic."""
    frames = 60
    cfg = _cfg()
    drop = set(range(30, 36))
    cams, state, infos = _run_zoom_sequence(
        cfg, frames, f0=F_REF, f_amp=500.0, drop=drop, seed=3
    )
    by_frame = {i["frame"]: i for i in infos}
    assert any(
        by_frame[k]["lost"] or by_frame[k]["event"] == "reloc"
        for k in sorted(drop)
    )
    tail = [i for i in infos if i["frame"] >= 45]
    assert tail and all(i["event"] == "track" for i in tail)
    assert not any(i["lost"] for i in tail)
    pose = np.stack([i["pose"] for i in tail])
    idx = np.array([i["frame"] for i in tail])
    pan_err = np.abs(pose[:, 0] - cams[idx, 0])
    assert pan_err.mean() < 3e-3, pan_err.mean()
