"""EKF integration tests vs the synthetic oracle (SURVEY.md §6 item 2):
known trajectory + ray field -> noisy slot-aligned observations -> the filter
must recover the trajectory within bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptzjax import ekf, synth
from ptzjax.config import SLAMConfig


def build_slot_stream(seq, ray_subset, max_obs_noise=0.5, outlier_frac=0.0, seed=0):
    """Slot-aligned observation stream for a fixed set of ray ids."""
    T = len(seq.cameras)
    n = len(ray_subset)
    slot_of_ray = {int(r): i for i, r in enumerate(ray_subset)}
    obs = np.zeros((T, n, 2), np.float32)
    mask = np.zeros((T, n), bool)
    for k in range(T):
        pix, _, ids = synth.render_frame(
            seq, k, noise_px=max_obs_noise, outlier_frac=outlier_frac, seed=seed
        )
        for p, rid in zip(pix, ids):
            s = slot_of_ray.get(int(rid))
            if s is not None:
                obs[k, s] = p
                mask[k, s] = True
    return obs, mask


def make_test_problem(T=90, n_slots=96, noise=0.5, outlier_frac=0.0):
    seq = synth.make_sequence(
        num_frames=T, num_rays=1200, pan_amp=0.08, tilt_amp=0.02, f_amp=200.0,
        period=200.0, seed=3,
    )
    _, _, ids0 = synth.render_frame(seq, 0, noise_px=0.0, seed=0)
    subset = ids0[np.linspace(0, len(ids0) - 1, n_slots).astype(int)]
    obs, mask = build_slot_stream(seq, subset, noise, outlier_frac)
    return seq, subset, obs, mask


def init_from_frame0(seq, subset, obs0, mask0, cfg):
    state = ekf.init_state(jnp.asarray(seq.cameras[0]), cfg)
    state = ekf.insert_rays(
        state,
        jnp.asarray(obs0),
        jnp.asarray(mask0),
        jnp.asarray(subset, jnp.int32),
        seq.intr,
        cfg,
    )
    return state


def run_tracking(noise, outlier_frac=0.0, T=90):
    seq, subset, obs, mask = make_test_problem(T=T, noise=noise, outlier_frac=outlier_frac)
    cfg = SLAMConfig(max_rays=96, sigma_obs=max(noise, 0.3))
    state = init_from_frame0(seq, subset, obs[0], mask[0], cfg)
    _, (poses, stats) = jax.jit(
        lambda s, o, m: ekf.scan_track(s, o, m, seq.intr, cfg)
    )(state, jnp.asarray(obs[1:]), jnp.asarray(mask[1:]))
    gt = seq.cameras[1:]
    err = np.abs(np.asarray(poses) - gt)
    return err, np.asarray(stats.lost), np.asarray(stats.num_used)


def test_noiseless_tracking_is_tight():
    err, lost, used = run_tracking(noise=0.0)
    assert not lost.any()
    assert used.min() >= 30
    assert err[:, 0].max() < 2e-4, f"pan err {err[:, 0].max()}"
    assert err[:, 1].max() < 2e-4, f"tilt err {err[:, 1].max()}"
    assert err[:, 2].max() < 2.0, f"focal err {err[:, 2].max()}"


def test_noisy_tracking_within_bounds():
    err, lost, _ = run_tracking(noise=0.5)
    assert not lost.any()
    # 0.5 px noise at f~2500 -> ~2e-4 rad per obs; filter averages ~90 obs
    assert np.mean(err[:, 0]) < 3e-4, f"mean pan err {np.mean(err[:, 0])}"
    assert np.mean(err[:, 1]) < 3e-4
    assert np.mean(err[:, 2]) < 6.0, f"mean focal err {np.mean(err[:, 2])}"


def test_outliers_are_gated():
    err_clean, _, _ = run_tracking(noise=0.5, outlier_frac=0.0)
    err_dirty, lost, _ = run_tracking(noise=0.5, outlier_frac=0.1)
    assert not lost.any()
    # gating must keep the degradation modest
    assert np.mean(err_dirty[:, 0]) < 3 * max(np.mean(err_clean[:, 0]), 1e-4)


def test_lost_detection():
    seq, subset, obs, mask = make_test_problem(T=30, noise=0.5)
    cfg = SLAMConfig(max_rays=96, min_inliers=12)
    state = init_from_frame0(seq, subset, obs[0], mask[0], cfg)
    mask[15:] = False  # occlusion: all observations vanish
    _, (_, stats) = ekf.scan_track(
        state, jnp.asarray(obs[1:]), jnp.asarray(mask[1:]), seq.intr, cfg
    )
    lost = np.asarray(stats.lost)
    assert not lost[:10].any()
    assert lost[15:].all()


def test_insert_and_retire_lifecycle():
    seq = synth.make_sequence(num_frames=4, num_rays=300, seed=1)
    cfg = SLAMConfig(max_rays=16, max_missed=3)
    state = ekf.init_state(jnp.asarray(seq.cameras[0]), cfg)
    assert int(state.active.sum()) == 0

    pix, _, ids = synth.render_frame(seq, 0, noise_px=0.0, seed=0)
    k = 10
    state = ekf.insert_rays(
        state,
        jnp.asarray(pix[:k]),
        jnp.ones((k,), bool),
        jnp.asarray(ids[:k], jnp.int32),
        seq.intr,
        cfg,
    )
    assert int(state.active.sum()) == k
    # inserted rays back-project to truth (frame-0 pose is exact)
    got = np.asarray(state.rays[np.asarray(state.active)])
    want = seq.rays[ids[:k]]
    assert np.abs(np.sort(got, 0) - np.sort(want, 0)).max() < 1e-3

    # capacity clamp: offering more than free slots fills exactly to capacity
    state2 = ekf.insert_rays(
        state,
        jnp.asarray(pix[: 2 * k]),
        jnp.ones((2 * k,), bool),
        jnp.asarray(ids[: 2 * k], jnp.int32),
        seq.intr,
        cfg,
    )
    assert int(state2.active.sum()) == cfg.max_rays

    # retire: miss everything for > max_missed frames
    s = state
    empty_obs = jnp.zeros((cfg.max_rays, 2), jnp.float32)
    empty_mask = jnp.zeros((cfg.max_rays,), bool)
    for _ in range(cfg.max_missed + 1):
        s, _ = ekf.step(s, empty_obs, empty_mask, seq.intr, cfg)
    s = ekf.retire_lost(s, cfg)
    assert int(s.active.sum()) == 0
    assert np.all(np.asarray(s.ray_ids) == -1)


def test_update_with_no_observations_is_identity_on_pose():
    cfg = SLAMConfig(max_rays=8)
    intr = synth.make_sequence(num_frames=2).intr
    state = ekf.init_state(jnp.array([0.1, -0.05, 2000.0]), cfg)
    pre = state.cam
    state2, stats = ekf.update(
        state,
        jnp.zeros((8, 2), jnp.float32),
        jnp.zeros((8,), bool),
        intr,
        cfg,
    )
    np.testing.assert_allclose(np.asarray(state2.cam), np.asarray(pre), atol=1e-6)
    assert bool(stats.lost)


def test_covariance_stays_finite_and_symmetric():
    err, _, _ = run_tracking(noise=0.5, T=40)
    seq, subset, obs, mask = make_test_problem(T=40, noise=0.5)
    cfg = SLAMConfig(max_rays=96)
    state = init_from_frame0(seq, subset, obs[0], mask[0], cfg)
    final, _ = ekf.scan_track(
        state, jnp.asarray(obs[1:]), jnp.asarray(mask[1:]), seq.intr, cfg
    )
    cov = np.asarray(final.cov)
    assert np.all(np.isfinite(cov))
    np.testing.assert_allclose(cov, cov.T, atol=1e-5)
    assert np.all(np.linalg.eigvalsh(cov) > -1e-4)


def test_structured_update_matches_dense_oracle():
    """The structured Kalman algebra (H never materialized — ekf.update)
    must equal the textbook dense-H Joseph update, computed here in fp64
    NumPy, on a random well-conditioned joint state."""
    from ptzjax.geometry import Intrinsics, project_jacobians, project_rays

    cfg = SLAMConfig(max_rays=24, sigma_obs=1.0, min_inliers=2,
                     innovation_gate_px=1e6, gate_maha2=1e9)
    n = cfg.max_rays
    d = 6 + 2 * n
    intr = Intrinsics.create(640.0, 360.0)
    rng = np.random.default_rng(0)

    state = ekf.init_state(np.array([0.1, -0.05, 2000.0], np.float32), cfg)
    rays = np.stack(
        [rng.uniform(0.0, 0.2, n), rng.uniform(-0.15, 0.0, n)], -1
    ).astype(np.float32)
    a = rng.normal(size=(d, d)).astype(np.float32) * 0.01
    cov = a @ a.T + np.diag(rng.uniform(0.3, 1.0, d)).astype(np.float32)
    cov = (0.5 * (cov + cov.T)).astype(np.float32)
    active = np.ones((n,), bool)
    active[-3:] = False
    state = state._replace(
        rays=jnp.asarray(rays), cov=jnp.asarray(cov),
        active=jnp.asarray(active),
        ray_ids=jnp.where(jnp.asarray(active), jnp.arange(n), -1),
    )
    pred = np.asarray(project_rays(state.pose, state.rays, intr))
    obs = (pred + rng.normal(0, 1.0, pred.shape)).astype(np.float32)
    obs_mask = np.ones((n,), bool)
    obs_mask[0] = False

    new, stats = ekf.update(
        state, jnp.asarray(obs), jnp.asarray(obs_mask), intr, cfg
    )
    used = np.asarray(stats.used_mask)
    assert used.sum() >= n - 5

    # fp64 dense-H oracle with the SAME gate decisions, in the BLOCKED
    # state/measurement layout (ekf.py module docstring): state columns are
    # [cam6 | theta_1..N | phi_1..N], measurement rows [x_1..N | y_1..N].
    _, j_cam, j_ray = project_jacobians(state.pose, state.rays, intr)
    jc = np.asarray(j_cam, np.float64) * used[:, None, None]
    jr = np.asarray(j_ray, np.float64) * used[:, None, None]
    h = np.zeros((2 * n, d))
    for i in range(n):
        h[i, 0:3] = jc[i, 0]                 # x-residual row of slot i
        h[n + i, 0:3] = jc[i, 1]             # y-residual row
        h[i, 6 + i] = jr[i, 0, 0]            # dx/dtheta
        h[i, 6 + n + i] = jr[i, 0, 1]        # dx/dphi
        h[n + i, 6 + i] = jr[i, 1, 0]        # dy/dtheta
        h[n + i, 6 + n + i] = jr[i, 1, 1]    # dy/dphi
    p = np.asarray(cov, np.float64)
    r = np.eye(2 * n) * cfg.sigma_obs**2
    innov2 = np.where(used[:, None], obs - pred, 0.0)
    innov = np.concatenate([innov2[:, 0], innov2[:, 1]])
    s = h @ p @ h.T + r
    k = p @ h.T @ np.linalg.inv(s)
    dx = k @ innov
    ikh = np.eye(d) - k @ h
    cov_ref = ikh @ p @ ikh.T + k @ r @ k.T

    np.testing.assert_allclose(
        np.asarray(new.cam[:3]),
        np.asarray(state.cam[:3], np.float64) + dx[:3],
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(new.rays),
        rays + np.stack([dx[6 : 6 + n], dx[6 + n :]], -1),
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(new.cov), cov_ref, rtol=2e-3, atol=2e-4
    )


@pytest.mark.parametrize("n", [32, 256])
def test_update_matches_fp64_dense_oracle(n):
    """eval.ekf_update_oracle_errors (the on-device check of chip_smoke.py
    phase c and the bench's parity group) holds on the CPU in fp32."""
    from ptzjax.eval import ekf_update_oracle_errors

    cam_err, cov_err = ekf_update_oracle_errors(n=n)
    assert cam_err < 5e-3 and cov_err < 5e-3, (cam_err, cov_err)
