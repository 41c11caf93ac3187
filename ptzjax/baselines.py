"""Baseline trackers the full SLAM system is compared against.

The reference repo keeps its earlier homography-EKF tracker under
``deprecated/`` (SURVEY.md §2 layer 8, §3), and the paper's headline claim
is that keyframes + BA markedly reduce drift vs that pure frame-to-frame
EKF (SURVEY.md §9). This module provides the on-device equivalent so the
eval harness can reproduce the comparison: a map-free visual-odometry
tracker whose per-frame measurement is the relative pose between
consecutive frames.

For a rotating PTZ camera the frame-to-frame homography is
K_k R_rel K_{k-1}^{-1}; instead of estimating the 8-DoF homography and
decomposing it (the reference's CPU route), we use the PTZ
parameterization directly: back-project frame k-1's matched keypoints
through the current pose estimate into rays, then solve frame k's 3-DoF
pose from those rays with the shared RANSAC + Huber-GN pipeline. A 6-dim
constant-velocity EKF (pose + velocities, NO landmark block) smooths the
per-frame solves — the same filter family as the reference's
homography-EKF, minus the map that our full system adds on top.

Drift: every frame's measurement is chained to the previous estimate, so
error integrates over time — exactly the failure mode the paper
demonstrates and the keyframe map fixes. See
``tests/test_baselines.py::test_slam_beats_homography_baseline``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ptzjax import match as matchlib
from ptzjax.config import SLAMConfig
from ptzjax.geometry import Intrinsics, back_project_pixels
from ptzjax.reloc import solve_pose

_HI = jax.lax.Precision.HIGHEST


class VOState(NamedTuple):
    """Carry of the frame-to-frame scan."""

    cam: jax.Array        # (6,) pose + velocity
    cov: jax.Array        # (6, 6)
    xy: jax.Array         # (K, 2) previous frame keypoints
    desc: jax.Array       # (K, D) previous frame descriptors
    valid: jax.Array      # (K,) previous frame validity


class VOInfo(NamedTuple):
    pose: jax.Array       # (3,)
    num_inliers: jax.Array
    updated: jax.Array    # bool: measurement accepted


def _predict(cam: jax.Array, cov: jax.Array, cfg: SLAMConfig):
    cam = cam.at[0:3].add(cfg.dt * cam[3:6])
    cov = cov.at[0:3, :].add(cfg.dt * cov[3:6, :])
    cov = cov.at[:, 0:3].add(cfg.dt * cov[:, 3:6])
    # np (not jnp) constant: built from concrete cfg floats, so keep it a
    # host literal folded into HLO — a traced-in device-array constant
    # stalls every dispatch on this backend (see ba.lm_iteration)
    accel = np.array(
        [cfg.sigma_pan**2, cfg.sigma_tilt**2, cfg.sigma_focal**2], np.float32
    )
    q = np.diag(np.concatenate([accel * cfg.dt**2, accel]))
    return cam, cov + q


def _frame(
    state: VOState, frame, *, intr: Intrinsics, cfg: SLAMConfig
) -> tuple[VOState, VOInfo]:
    xy, desc, valid = frame
    cam, cov = _predict(state.cam, state.cov, cfg)
    pose_pred = cam[:3]

    # associate against the PREVIOUS frame only (no map, no keyframes)
    m = matchlib.match_descriptors(
        desc, state.desc, valid, state.valid, ratio=cfg.ratio_test
    )
    # rays of the matched previous keypoints through the previous estimate:
    # this chaining is what integrates error frame over frame (drift)
    rays_prev = back_project_pixels(
        state.cam[:3], state.xy[m.idx], intr
    )
    inl = matchlib.ransac_pan_tilt(
        rays_prev, xy, m.ok, pose_pred[2], intr.cx, intr.cy,
        num_hypotheses=cfg.ransac_iters, inlier_px=3 * cfg.ransac_inlier_px,
    )
    n_inl = inl.sum()
    z = solve_pose(rays_prev, xy, inl, intr, pose_pred, iters=10)

    # 6-dim EKF update with the solved pose as the measurement, z = [I 0] x.
    # Measurement noise shrinks with the inlier count (pose solve averages
    # n_inl pixel observations).
    scale = cfg.sigma_obs / jnp.sqrt(jnp.maximum(n_inl, 1).astype(jnp.float32))
    r = jnp.diag(
        (jnp.array([1.0 / pose_pred[2], 1.0 / pose_pred[2], 1.0]) * scale) ** 2
    )
    s = cov[0:3, 0:3] + r
    k_gain = jnp.linalg.solve(s.T, cov[:, 0:3].T).T          # (6, 3)
    ok = n_inl >= cfg.min_inliers
    innov = jnp.where(ok, z - pose_pred, 0.0)
    cam = cam + k_gain @ innov
    ikh = jnp.eye(6) - jnp.where(ok, 1.0, 0.0) * (
        k_gain @ jnp.concatenate([jnp.eye(3), jnp.zeros((3, 3))], 1)
    )
    cov = ikh @ cov @ ikh.T + jnp.where(ok, 1.0, 0.0) * (
        k_gain @ r @ k_gain.T
    )
    cov = 0.5 * (cov + cov.T)

    new = VOState(cam=cam, cov=cov, xy=xy, desc=desc, valid=valid)
    return new, VOInfo(pose=cam[:3], num_inliers=n_inl, updated=ok)


def init_vo(
    pose0: jax.Array, xy0, desc0, valid0, cfg: SLAMConfig
) -> VOState:
    cam = jnp.concatenate(
        [jnp.asarray(pose0, jnp.float32), jnp.zeros(3, jnp.float32)]
    )
    diag = jnp.array(
        [1e-6, 1e-6, 1e-6, cfg.init_vel_std**2, cfg.init_vel_std**2,
         cfg.init_vel_std_f**2], jnp.float32,
    )
    return VOState(
        cam=cam, cov=jnp.diag(diag), xy=jnp.asarray(xy0),
        desc=jnp.asarray(desc0), valid=jnp.asarray(valid0),
    )


@partial(jax.jit, static_argnames=("cfg",))
def track_homography_ekf(
    state: VOState, xy_seq, desc_seq, valid_seq, *, intr: Intrinsics,
    cfg: SLAMConfig,
) -> tuple[VOState, VOInfo]:
    """Run the baseline over a whole sequence as one lax.scan.

    Args:
      xy_seq: (T, K, 2); desc_seq: (T, K, D); valid_seq: (T, K).

    Returns:
      (final carry, stacked per-frame VOInfo).
    """
    body = partial(_frame, intr=intr, cfg=cfg)
    return jax.lax.scan(body, state, (xy_seq, desc_seq, valid_seq))
