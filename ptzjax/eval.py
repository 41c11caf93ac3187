"""Evaluation harness: trajectory accuracy, reprojection error, throughput.

Mirrors the reference's experiment-script metrics (SURVEY.md §4.5, §7):
per-frame |delta pan| / |delta tilt| / |delta f| against ground truth,
reprojection RMSE over a shared landmark set, plus honest device timing
(block_until_ready-fenced) — the reference never measured throughput
(offline Python); broadcast-rate online tracking is this engine's own bar
(BASELINE.md).
"""

from __future__ import annotations

import time
from functools import partial
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ptzjax.geometry import Intrinsics, in_view_mask, project_rays


class TrajectoryErrors(NamedTuple):
    """Summary statistics of a tracked trajectory vs ground truth.

    Angles in degrees (matching how the reference's paper reports them),
    focal in pixels.
    """

    pan_mae_deg: float
    tilt_mae_deg: float
    focal_mae_px: float
    pan_rmse_deg: float
    tilt_rmse_deg: float
    focal_rmse_px: float
    num_frames: int

    def as_dict(self) -> dict[str, Any]:
        return dict(self._asdict())


def trajectory_errors(pred: np.ndarray, gt: np.ndarray) -> TrajectoryErrors:
    """Per-frame (pan, tilt, f) error summary. pred/gt: (T, 3), radians."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    d = pred - gt
    d_deg = np.rad2deg(d[:, :2])
    return TrajectoryErrors(
        pan_mae_deg=float(np.abs(d_deg[:, 0]).mean()),
        tilt_mae_deg=float(np.abs(d_deg[:, 1]).mean()),
        focal_mae_px=float(np.abs(d[:, 2]).mean()),
        pan_rmse_deg=float(np.sqrt((d_deg[:, 0] ** 2).mean())),
        tilt_rmse_deg=float(np.sqrt((d_deg[:, 1] ** 2).mean())),
        focal_rmse_px=float(np.sqrt((d[:, 2] ** 2).mean())),
        num_frames=len(pred),
    )


def reprojection_rmse(
    pred: np.ndarray,
    gt: np.ndarray,
    intr: Intrinsics,
    width: float,
    height: float,
    rays: np.ndarray | None = None,
    grid: int = 12,
) -> float:
    """RMSE of pixel displacement between predicted and GT cameras over a
    shared ray set (the paper's reprojection metric, SURVEY.md §1 item 6).

    If ``rays`` is None, uses a grid of rays back-projected through the GT
    camera of each frame (covers the actual field of view).
    """
    pred_j = jnp.asarray(pred, jnp.float32)
    gt_j = jnp.asarray(gt, jnp.float32)
    rays_in = None if rays is None else jnp.asarray(rays, jnp.float32)

    # ONE jitted program end-to-end: on this environment every eager jnp op
    # is a separate remote compile+dispatch (~seconds each); an un-jitted
    # metric costs minutes where the jitted one costs milliseconds.
    @partial(jax.jit, static_argnames=("use_grid",))
    def _rmse(pred_j, gt_j, rays_in, use_grid):
        if use_grid:
            xs = jnp.linspace(0.05 * width, 0.95 * width, grid)
            ys = jnp.linspace(0.05 * height, 0.95 * height, grid)
            gx, gy = jnp.meshgrid(xs, ys)
            pix = jnp.stack([gx.reshape(-1), gy.reshape(-1)], -1)  # (G, 2)
            from ptzjax.geometry import back_project_pixels

            rays_t = jax.vmap(lambda c: back_project_pixels(c, pix, intr))(gt_j)
        else:
            rays_t = jnp.broadcast_to(
                rays_in[None], (gt_j.shape[0], rays_in.shape[0], 2)
            )

        def frame_rmse(c_pred, c_gt, r):
            a = project_rays(c_pred, r, intr)
            b = project_rays(c_gt, r, intr)
            ok = in_view_mask(c_gt, r, intr, width, height, margin=1.0)
            e2 = jnp.sum((a - b) ** 2, -1)
            return jnp.sqrt(
                jnp.sum(jnp.where(ok, e2, 0.0)) / jnp.maximum(ok.sum(), 1)
            )

        per_frame = jax.vmap(frame_rmse)(pred_j, gt_j, rays_t)
        return jnp.sqrt(jnp.mean(per_frame**2))

    if rays_in is None:
        # pass a dummy for the unused branch (static arg selects the path)
        rays_in = jnp.zeros((1, 2), jnp.float32)
        return float(_rmse(pred_j, gt_j, rays_in, True))
    return float(_rmse(pred_j, gt_j, rays_in, False))


class Timing(NamedTuple):
    """block_until_ready-fenced timing of a device computation."""

    mean_ms: float
    best_ms: float
    reps: int


def time_fn(fn: Callable[[], Any], reps: int = 5, warmup: int = 1) -> Timing:
    """Honest device timing: fences with block_until_ready (SURVEY.md §7
    tracing/profiling)."""
    for _ in range(warmup):
        jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return Timing(
        mean_ms=float(np.mean(times) * 1e3),
        best_ms=float(np.min(times) * 1e3),
        reps=reps,
    )


def profile_trace(fn: Callable[[], Any], log_dir: str) -> Any:
    """Run ``fn`` under a jax.profiler trace (SURVEY.md §7 tracing row).

    Produces a TensorBoard-compatible trace in ``log_dir``; use for kernel
    time breakdowns on real hardware. Returns fn's (blocked) result.
    """
    with jax.profiler.trace(log_dir):
        out = fn()
        jax.block_until_ready(out)
    return out


def evaluate_run(
    infos,
    gt_cameras: np.ndarray,
    intr: Intrinsics,
    width: float,
    height: float,
) -> dict[str, Any]:
    """Full post-run report from a ``run_segment`` FrameInfo stack.

    Returns a JSON-ready dict: trajectory errors, reprojection RMSE, lost/
    relocalization/keyframe counts — the §7 observability contract.
    """
    h = jax.device_get(infos)
    pose = np.asarray(h.pose)
    gt = np.asarray(gt_cameras)[-len(pose):]
    errs = trajectory_errors(pose, gt)
    return {
        **errs.as_dict(),
        "reprojection_rmse_px": reprojection_rmse(pose, gt, intr, width, height),
        "frames_lost": int(np.asarray(h.lost).sum()),
        "reloc_attempts": int((np.asarray(h.event) == 1).sum()),
        "reloc_successes": int(np.asarray(h.reloc_success).sum()),
        "keyframes_inserted": int(np.asarray(h.keyframe).sum()),
        "mean_matches": float(np.asarray(h.num_matches).mean()),
        "mean_active_slots": float(np.asarray(h.num_active_slots).mean()),
    }


def ekf_update_oracle_errors(
    n: int = 256, seed: int = 3
) -> tuple[float, float]:
    """One joint EKF update at ``n`` ray slots against an fp64 dense-H
    Kalman update of the same state and observations.

    The state is an SPD covariance with off-diagonal coupling, all slots
    active and observed with 1 px noise. Returns (cam_err, cov_rel_err):
    the max absolute camera-state error and the max covariance error
    relative to the largest covariance entry. On the H100 this is the check
    of the TF32 gain path (``ekf._mmh``) for a single update; the closed
    loop is checked separately.
    """
    from ptzjax import ekf as ekflib
    from ptzjax.config import SLAMConfig
    from ptzjax.geometry import project_jacobians

    rng = np.random.default_rng(seed)
    intr = Intrinsics.create(640.0, 360.0)
    cfg = SLAMConfig(max_rays=n, sigma_obs=1.0, min_inliers=2,
                     innovation_gate_px=1e6, gate_maha2=1e9)
    d = 6 + 2 * n
    est = ekflib.init_state(np.array([0.1, -0.05, 2000.0], np.float32), cfg)
    rays = np.stack(
        [rng.uniform(0.0, 0.2, n), rng.uniform(-0.15, 0.0, n)], -1
    ).astype(np.float32)
    a = rng.normal(size=(d, d)).astype(np.float32) * 0.01
    cov = a @ a.T + np.diag(rng.uniform(0.3, 1.0, d)).astype(np.float32)
    cov = (0.5 * (cov + cov.T)).astype(np.float32)
    est = est._replace(
        rays=jnp.asarray(rays), cov=jnp.asarray(cov),
        active=jnp.ones((n,), bool),
        ray_ids=jnp.arange(n, dtype=jnp.int32),
    )
    pred = np.asarray(project_rays(est.pose, est.rays, intr))
    obs = (pred + rng.normal(0, 1.0, pred.shape)).astype(np.float32)
    new, stats = jax.jit(
        lambda s, o: ekflib.update(s, o, jnp.ones((n,), bool), intr, cfg)
    )(est, jnp.asarray(obs))
    used = np.asarray(stats.used_mask)

    # fp64 reference with H materialized in the blocked layout
    _, j_cam, j_ray = project_jacobians(est.pose, est.rays, intr)
    jc = np.asarray(j_cam, np.float64) * used[:, None, None]
    jr = np.asarray(j_ray, np.float64) * used[:, None, None]
    h = np.zeros((2 * n, d))
    idx = np.arange(n)
    h[idx, 0:3] = jc[:, 0]
    h[n + idx, 0:3] = jc[:, 1]
    h[idx, 6 + idx] = jr[:, 0, 0]
    h[idx, 6 + n + idx] = jr[:, 0, 1]
    h[n + idx, 6 + idx] = jr[:, 1, 0]
    h[n + idx, 6 + n + idx] = jr[:, 1, 1]
    p64 = cov.astype(np.float64)
    r64 = np.eye(2 * n)
    innov2 = np.where(used[:, None], obs - pred, 0.0)
    innov = np.concatenate([innov2[:, 0], innov2[:, 1]])
    s64 = h @ p64 @ h.T + r64
    k64 = p64 @ h.T @ np.linalg.inv(s64)
    dx = k64 @ innov
    ikh = np.eye(d) - k64 @ h
    cov_ref = ikh @ p64 @ ikh.T + k64 @ r64 @ k64.T
    cam_err = float(
        np.abs(np.asarray(new.cam[:3], np.float64)
               - (np.asarray(est.cam[:3], np.float64) + dx[:3])).max()
    )
    cov_err = float(
        np.abs(np.asarray(new.cov, np.float64) - cov_ref).max()
        / np.abs(cov_ref).max()
    )
    return cam_err, cov_err
