"""Outlier/dropout stress (SURVEY.md §6 item 2
"+noise, outliers, dropouts"): the keyframe/BA path must stay healthy when
a real fraction of observations are garbage — teleported matches in BA,
and outlier keypoints feeding the full SLAM loop end-to-end."""

import jax
import jax.numpy as jnp
import numpy as np

from ptzjax import ba, synth
from ptzjax.config import SLAMConfig
from ptzjax.features import synth_features
from ptzjax.slam import PTZSlam, infos_to_dicts
from tests.test_ba import build_problem


def _inject_outliers(prob, frac, seed=0, width=1280.0, height=720.0):
    """Teleport a fraction of the VALID observations uniformly in the image
    (synth.render_frame's outlier model, applied at the BA table level)."""
    rng = np.random.default_rng(seed)
    w = np.asarray(prob.obs_w)
    pix = np.asarray(prob.obs_pix).copy()
    valid = w > 0
    hit = valid & (rng.uniform(size=w.shape) < frac)
    n = int(hit.sum())
    pix[hit] = np.stack(
        [rng.uniform(0, width, n), rng.uniform(0, height, n)], -1
    )
    return prob._replace(obs_pix=jnp.asarray(pix)), hit


def test_robust_ba_beats_quadratic_under_outliers():
    """15% teleported observations: Huber-IRLS BA must land near GT while
    quadratic BA is visibly dragged off it."""
    prob, intr, gt_cams, gt_rays, n_real = build_problem(
        num_kf=6, num_rays_cap=160, noise=0.5, seed=11
    )
    prob, hit = _inject_outliers(prob, 0.15, seed=11)
    assert hit.sum() > 50

    cfg = SLAMConfig(ba_iters=20, ba_huber_px=3.0, ba_irls_rounds=2)
    res_q = ba.run(prob, intr, cfg)
    res_r = ba.run_robust(prob, intr, cfg)

    def cam_err(cams):
        d = np.abs(np.asarray(cams) - gt_cams)
        return d[:, 0].max(), d[:, 2].max()  # pan (rad), focal (px)

    pan_q, f_q = cam_err(res_q.cams)
    pan_r, f_r = cam_err(res_r.cams)
    # robust recovers the cameras; quadratic is dragged off by the outliers
    assert pan_r < 1e-3, (pan_r, pan_q)
    assert f_r < 5.0, (f_r, f_q)
    assert pan_r < 0.5 * pan_q, (pan_r, pan_q)
    assert float(res_r.cost) < float(res_r.initial_cost)


def test_robust_ba_noop_on_clean_problem():
    """With no outliers, IRLS must not hurt: same minimum as quadratic."""
    prob, intr, gt_cams, _, _ = build_problem(
        num_kf=6, num_rays_cap=160, noise=0.5, seed=3
    )
    cfg = SLAMConfig(ba_iters=20, ba_huber_px=3.0, ba_irls_rounds=2)
    res_q = ba.run(prob, intr, cfg)
    res_r = ba.run_robust(prob, intr, cfg)
    np.testing.assert_allclose(
        np.asarray(res_r.cams), np.asarray(res_q.cams), rtol=1e-5, atol=2e-4
    )


def _slam_outlier_run(
    frames, noise_px, sigma_obs, outlier_frac, *, max_lost, pan_tol,
    purity_med, purity_tail_px, final_pan_tol, seed=21, min_kf=3,
):
    """Full SLAM loop under noise/outlier pressure: tracking holds,
    keyframe association stays pure, and the final robust BA improves the
    map, across sigma_obs
    — the association constants now live in SLAMConfig and must hold at
    sigma 1-3 px with the DEFAULT values, no retuning)."""
    cfg = SLAMConfig(
        max_rays=96, max_keypoints=192, max_map_rays=2048, max_keyframes=24,
        kf_desc_dim=128, sigma_obs=sigma_obs, ba_huber_px=3.0,
        ba_irls_rounds=2,
    )
    # hold PER-FRAME motion constant across sequence lengths (amplitudes
    # scale with the period): the sweep probes sigma_obs sensitivity of the
    # association constants, not the cold-start velocity capture range
    # (which is a separate, documented function of track_gate_px)
    sc = frames / 150.0
    seq = synth.make_sequence(
        num_frames=frames, num_rays=2200, pan_amp=0.45 * sc,
        tilt_amp=0.03 * sc, f_amp=350.0 * sc, period=frames * 1.1,
        seed=seed,
    )
    feats = [
        synth_features(
            seq, k, cfg.max_keypoints, noise_px=noise_px,
            outlier_frac=outlier_frac, dropout_frac=0.05, seed=seed,
        )[0]
        for k in range(frames)
    ]
    slam = PTZSlam(cfg, seq.intr)
    state = slam.init(feats[0].xy, feats[0].desc, feats[0].valid,
                      seq.cameras[0])
    xy = jnp.asarray(np.stack([f.xy for f in feats]))
    desc = jnp.asarray(np.stack([f.desc for f in feats]))
    valid = jnp.asarray(np.stack([f.valid for f in feats]))
    state, infos = slam.run_segment(state, xy[1:], desc[1:], valid[1:])
    recs = infos_to_dicts(infos)

    lost = [r["frame"] for r in recs if r["lost"]]
    assert len(lost) <= max_lost, f"lost {len(lost)} frames: {lost[:10]}"
    assert int(state.kf.count) >= min_kf

    pose = np.stack([r["pose"] for r in recs])
    pan_err = np.abs(pose[:, 0] - seq.cameras[1:, 0])
    assert pan_err.mean() < pan_tol, pan_err.mean()

    # keyframe ASSOCIATION PURITY under outlier pressure: project each
    # keyframe's associated map rays through the GT pose of that frame —
    # an aliasing match (keypoint linked to the wrong ray) shows up as a
    # large reprojection error in the keyframe table itself, upstream of
    # BA
    from ptzjax.geometry import project_rays

    kf = jax.device_get(state.kf)
    rays_store = np.asarray(jax.device_get(state.rays.rays))
    purity_errs = []
    for i in range(kf.poses.shape[0]):
        if not kf.valid[i]:
            continue
        fv = kf.feat_valid[i] & (kf.ray_ids[i] >= 0)
        if fv.sum() < 5:
            continue
        gt_pose = seq.cameras[int(kf.frame_idx[i])]
        proj = np.asarray(project_rays(
            jnp.asarray(gt_pose), jnp.asarray(rays_store[kf.ray_ids[i][fv]]),
            seq.intr,
        ))
        purity_errs.append(np.linalg.norm(proj - kf.xy[i][fv], axis=-1))
    err = np.concatenate(purity_errs)
    # the noise floor is ~noise_px obs noise + map-ray estimation error; an
    # aliased association would sit tens of px off. Demand a clean bulk
    # and a small polluted tail.
    assert np.median(err) < purity_med, np.median(err)
    assert (err > purity_tail_px).mean() < 0.05, (err > purity_tail_px).mean()

    # the offline robust BA at the end must not degrade keyframe poses —
    # and the keyframe association tables (built under outlier pressure)
    # must be clean enough for it to improve them
    kf_idx = np.asarray(state.kf.frame_idx)
    kf_valid = np.asarray(state.kf.valid)
    pre = np.asarray(state.kf.poses)
    state2, info = slam.bundle_adjust(state)
    post = np.asarray(state2.kf.poses)
    gt_kf = seq.cameras[np.clip(kf_idx, 0, frames - 1)]
    err_pre = np.abs(pre[kf_valid, 0] - gt_kf[kf_valid, 0]).mean()
    err_post = np.abs(post[kf_valid, 0] - gt_kf[kf_valid, 0]).mean()
    assert err_post <= err_pre * 1.5 + 1e-4, (err_pre, err_post)
    assert err_post < final_pan_tol, err_post


def test_slam_long_run_with_outliers_and_dropouts():
    """150 frames, sigma 1 px, 12% outliers + 5% dropouts (the r2 'Done'
    criterion run)."""
    _slam_outlier_run(
        150, noise_px=0.5, sigma_obs=1.0, outlier_frac=0.12,
        max_lost=3, pan_tol=3e-3, purity_med=3.0, purity_tail_px=10.0,
        final_pan_tol=2e-3,
    )


def test_slam_outlier_purity_sigma2():
    """sigma_obs = 2 px + 20% outliers: the DEFAULT association constants
    (track_ratio/kf_ratio/kf_gate) must hold without retuning.
    Tolerances scale with the noise floor (~2 px vs ~0.5 px)."""
    _slam_outlier_run(
        100, noise_px=2.0, sigma_obs=2.0, outlier_frac=0.20,
        max_lost=4, pan_tol=6e-3, purity_med=7.0, purity_tail_px=20.0,
        final_pan_tol=5e-3, seed=33, min_kf=2,
    )


def test_consensus_hypothesis_cap_matches_full():
    """Q = 512 > max_hypotheses: the top-256-by-score hypothesis cut
    (association cost) must produce the same inlier set
    as exhaustive hypotheses on a static-majority scene with a coherent
    wrong-motion (mover) cluster, and must reject the movers."""
    import jax.numpy as jnp

    from ptzjax import match as matchlib

    rng = np.random.default_rng(7)
    q = 512
    cx, cy, f = 640.0, 360.0, 2000.0
    pan, tilt = 0.08, -0.04
    # statics: rays consistent with (pan, tilt); movers: coherent offset
    rays = np.stack(
        [rng.uniform(-0.2, 0.2, q) + pan, rng.uniform(-0.1, 0.1, q) + tilt],
        -1,
    ).astype(np.float32)
    is_mover = np.zeros(q, bool)
    is_mover[400:] = True
    du = rays[:, 0] - pan
    dv = rays[:, 1] - tilt
    px = f * np.tan(du) + cx
    py = -f * np.tan(dv) / np.cos(du) + cy
    # movers: displaced by a COHERENT wrong motion (same angular offset)
    px = np.where(is_mover, px + 40.0, px) + rng.normal(0, 0.5, q)
    py = np.where(is_mover, py + 25.0, py) + rng.normal(0, 0.5, q)
    xy = np.stack([px, py], -1).astype(np.float32)
    ok = jnp.ones((q,), bool)
    score = jnp.asarray(rng.uniform(0.6, 1.0, q).astype(np.float32))

    inl_cap, cnt_cap = matchlib.consensus_pan_tilt(
        jnp.asarray(rays), jnp.asarray(xy), ok, jnp.asarray(f), cx, cy,
        inlier_px=8.0, score=score, max_hypotheses=256,
    )
    inl_full, cnt_full = matchlib.consensus_pan_tilt(
        jnp.asarray(rays), jnp.asarray(xy), ok, jnp.asarray(f), cx, cy,
        inlier_px=8.0, score=score, max_hypotheses=512,
    )
    inl_cap = np.asarray(inl_cap)
    inl_full = np.asarray(inl_full)
    assert int(cnt_cap) >= 390 and int(cnt_full) >= 390
    # movers rejected by both
    assert not inl_cap[is_mover].any()
    assert not inl_full[is_mover].any()
    # the capped hypothesis set finds the same consensus
    assert (inl_cap == inl_full).mean() > 0.99, (inl_cap != inl_full).sum()


def test_slam_outlier_purity_sigma3():
    """sigma_obs = 3 px + 20% outliers: upper end of broadcast keypoint
    noise; same default constants."""
    _slam_outlier_run(
        100, noise_px=3.0, sigma_obs=3.0, outlier_frac=0.20,
        max_lost=5, pan_tol=9e-3, purity_med=10.0, purity_tail_px=28.0,
        final_pan_tol=7e-3, seed=34, min_kf=2,
    )
