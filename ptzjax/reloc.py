"""Relocalization: recover (pan, tilt, focal) when tracking is lost.

A static-shape redesign of the reference's keyframe relocalization
(``slam_system/relocalization.py`` — SURVEY.md §2 layer 6, §4.4): match the
lost frame's descriptors against the global ray store (one matmul —
covering all keyframes at once, where the reference loops keyframes), then
solve the 3-DoF pose from 2D<->ray correspondences.

The nonlinear solve needs an initialization; we use a batched hypothesis
sweep instead of sequential RANSAC (SURVEY.md §8.5): for each candidate focal
length on a log grid, every correspondence votes a (pan, tilt) directly
(closed form below); the densest vote wins, inliers are scored batched, and a
Huber-weighted Gauss-Newton refinement polishes all three parameters.

Closed-form vote: theta = pan + atan((x-cx)/f) inverts to
    pan_i  = theta_i - atan((x_i - cx) / f)
    tilt_i = phi_i   - atan(-(y_i - cy) * cos(atan((x_i-cx)/f)) / f)
so each match proposes a full (pan, tilt) for a hypothesized f.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ptzjax import match as matchlib
from ptzjax.config import SLAMConfig
from ptzjax.geometry import Intrinsics, project_jacobians
from ptzjax.mapstore import KeyframeStore, RayStore

_HI = jax.lax.Precision.HIGHEST


class RelocResult(NamedTuple):
    pose: jax.Array       # (3,) recovered (pan, tilt, f)
    inliers: jax.Array    # () int32 consensus size after refinement
    success: jax.Array    # () bool
    matched_ray_ids: jax.Array  # (Q,) int32 ray id per query feature (-1 none)
    matched_ok: jax.Array       # (Q,) bool final inlier mask per query


def _vote_pose(f: jax.Array, rays: jax.Array, xy: jax.Array, w: jax.Array, intr):
    """Median (pan, tilt) vote for one hypothesized focal length."""
    u = jnp.arctan2(xy[:, 0] - intr.cx, f)
    pan_i = rays[:, 0] - u
    tilt_i = rays[:, 1] - jnp.arctan2(-(xy[:, 1] - intr.cy) * jnp.cos(u), f)
    # masked median: sort with invalid pushed to +inf, pick middle of valid
    def masked_median(vals):
        n = jnp.maximum(w.sum(), 1)
        sv = jnp.sort(jnp.where(w, vals, jnp.inf))
        return sv[(n - 1) // 2]

    return jnp.stack([masked_median(pan_i), masked_median(tilt_i), f])


def _count_inliers(pose, rays, xy, w, intr, tol_px):
    pix, _, _ = project_jacobians(pose, rays, intr)
    err = jnp.linalg.norm(pix - xy, axis=-1)
    inl = w & (err < tol_px)
    return inl, inl.sum()


def solve_pose(
    rays: jax.Array,
    xy: jax.Array,
    w: jax.Array,
    intr: Intrinsics,
    init_pose: jax.Array,
    iters: int = 20,
    huber_px: float = 3.0,
    damping: float = 1e-3,
) -> jax.Array:
    """Huber-weighted damped Gauss-Newton over (pan, tilt, f).

    The reference solves this with scipy least_squares (SURVEY.md §4.4); here
    it is a fixed-iteration lax.fori loop of 3x3 solves, fully on device.
    """
    fs = 1e-3  # focal scaling for conditioning, as in BA

    def body(_, pose):
        pix, j_cam, _ = project_jacobians(pose, rays, intr)
        r = pix - xy                                 # (N, 2)
        j = j_cam.at[..., 2].divide(fs)              # scaled f column
        rn = jnp.linalg.norm(r, axis=-1)
        hub = jnp.sqrt(jnp.where(rn > huber_px, huber_px / jnp.maximum(rn, 1e-9), 1.0))
        wgt = (w.astype(jnp.float32) * hub)[:, None]
        jw = j * wgt[..., None]
        rw = r * wgt
        h = jnp.einsum("nab,nac->bc", jw, jw, precision=_HI)
        g = jnp.einsum("nab,na->b", jw, rw, precision=_HI)
        h = h + damping * jnp.diag(jnp.diag(h)) + 1e-8 * jnp.eye(3)
        # np (not jnp) constant: traced-in jnp constants become captured
        # device buffers that stall every dispatch on this backend
        step = jnp.linalg.solve(h, -g) * np.array([1.0, 1.0, 1.0 / fs], np.float32)
        return pose + step

    return jax.lax.fori_loop(0, iters, body, init_pose)


def solve_from_correspondences(
    mrays: jax.Array,
    xy: jax.Array,
    w: jax.Array,
    intr: Intrinsics,
    cfg: SLAMConfig,
    f_range: tuple[float, float] = (800.0, 6000.0),
    num_f: int = 32,
    tol_px: float = 8.0,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Pose from 2D<->ray correspondences: focal-grid vote -> two rounds of
    gate + Huber-GN refine. Shared by the keyframe path (descriptor match vs
    the ray store) and the native forest path (``ptzjax.reloc_forest``),
    mirroring the reference's two relocalization variants (SURVEY.md §1
    item 4, §4.4).

    Returns:
      (pose (3,), inlier_mask (Q,), num_inliers (), success ()).
    """
    fgrid = jnp.exp(
        jnp.linspace(jnp.log(f_range[0]), jnp.log(f_range[1]), num_f)
    ).astype(jnp.float32)
    poses = jax.vmap(lambda f: _vote_pose(f, mrays, xy, w, intr))(fgrid)
    counts = jax.vmap(
        lambda p: _count_inliers(p, mrays, xy, w, intr, 2 * tol_px)[1]
    )(poses)
    best = poses[jnp.argmax(counts)]

    # refine on the coarse inlier set, then re-gate and refine once more
    inl0, _ = _count_inliers(best, mrays, xy, w, intr, 4 * tol_px)
    pose1 = solve_pose(mrays, xy, inl0, intr, best, iters=cfg.reloc_iters)
    inl1, n1 = _count_inliers(pose1, mrays, xy, w, intr, tol_px)
    pose2 = solve_pose(mrays, xy, inl1, intr, pose1, iters=cfg.reloc_iters)
    inl2, n2 = _count_inliers(pose2, mrays, xy, w, intr, tol_px)
    success = n2 >= cfg.reloc_min_matches
    return pose2, inl2, n2, success


def relocalize(
    desc: jax.Array,
    xy: jax.Array,
    valid: jax.Array,
    ray_store: RayStore,
    intr: Intrinsics,
    cfg: SLAMConfig,
    f_range: tuple[float, float] = (800.0, 6000.0),
    num_f: int = 32,
    tol_px: float = 8.0,
) -> RelocResult:
    """Full relocalization from a lost frame's features (SURVEY.md §4.4)."""
    m = matchlib.match_descriptors(
        desc, ray_store.desc, valid, ray_store.valid, ratio=cfg.ratio_test
    )
    mrays = ray_store.rays[m.idx]                    # (Q, 2)
    pose2, inl2, n2, success = solve_from_correspondences(
        mrays, xy, m.ok, intr, cfg, f_range=f_range, num_f=num_f,
        tol_px=tol_px,
    )
    return RelocResult(
        pose=pose2,
        inliers=n2,
        success=success,
        matched_ray_ids=jnp.where(inl2, m.idx, -1),
        matched_ok=inl2,
    )


def relocalize_keyframes(
    desc: jax.Array,
    xy: jax.Array,
    valid: jax.Array,
    kf: KeyframeStore,
    ray_store: RayStore,
    intr: Intrinsics,
    cfg: SLAMConfig,
    f_range: tuple[float, float] = (800.0, 6000.0),
    num_f: int = 32,
    tol_px: float = 8.0,
) -> RelocResult:
    """Nearest-keyframe relocalization (the reference's path A, SURVEY.md
    §4.4; BASELINE.md config 2 "nearest-keyframe lookup + pose re-init").

    The reference loops keyframes and BF-matches sequentially; here the lost
    frame's descriptors are matched against ALL keyframe feature tables in
    one matmul (Q x K*F scores). A per-keyframe match-count vote picks
    the nearest keyframe, the winner's 2D<->ray correspondences drive the
    same vote+refine pose solve, and the pose is seeded from the winning
    keyframe's stored pose (skipping the blind focal-grid sweep).
    """
    k, f, d = kf.desc.shape
    flat_desc = kf.desc.reshape(k * f, d)
    flat_ok = (kf.feat_valid & kf.valid[:, None] & (kf.ray_ids >= 0)).reshape(-1)
    m = matchlib.match_descriptors(
        desc, flat_desc, valid, flat_ok, ratio=cfg.ratio_test, mutual=False
    )
    kf_of = m.idx // f
    votes = jnp.zeros((k,), jnp.int32).at[jnp.where(m.ok, kf_of, k)].add(
        1, mode="drop"
    )
    kbest = jnp.argmax(votes)

    ray_ids = kf.ray_ids.reshape(-1)[m.idx]
    ok = m.ok & (kf_of == kbest) & (ray_ids >= 0)
    mrays = ray_store.rays[jnp.clip(ray_ids, 0, None)]

    # pose init: the nearest keyframe's stored pose (refine handles the rest)
    init = kf.poses[kbest]
    inl0, _ = _count_inliers(init, mrays, xy, ok, intr, 4 * tol_px)
    pose1 = solve_pose(mrays, xy, inl0, intr, init, iters=cfg.reloc_iters)
    inl1, n1 = _count_inliers(pose1, mrays, xy, ok, intr, tol_px)
    pose2 = solve_pose(mrays, xy, inl1, intr, pose1, iters=cfg.reloc_iters)
    inl2, n2 = _count_inliers(pose2, mrays, xy, ok, intr, tol_px)

    # fall back to the focal-grid vote when the keyframe seed fails (e.g. the
    # camera zoomed far between losing and recovering)
    pose_v, inl_v, n_v, _ = solve_from_correspondences(
        mrays, xy, ok, intr, cfg, f_range=f_range, num_f=num_f, tol_px=tol_px
    )
    use_vote = n_v > n2
    pose2 = jnp.where(use_vote, pose_v, pose2)
    inl2 = jnp.where(use_vote, inl_v, inl2)
    n2 = jnp.where(use_vote, n_v, n2)

    success = n2 >= cfg.reloc_min_matches
    return RelocResult(
        pose=pose2,
        inliers=n2,
        success=success,
        matched_ray_ids=jnp.where(inl2, ray_ids, -1),
        matched_ok=inl2,
    )
