"""Descriptor matching.

The on-device analogue of the reference's BF matcher + Lowe ratio test + mutual
check (``slam_system/image_process.py`` — SURVEY.md §2 layer 3, §8.5). The
score matrix D_q D_r^T is one matmul; top-2/ratio/mutual are row/col
reductions. Everything is padded + masked, no dynamic shapes.

Descriptors are unit-norm, so squared L2 distance = 2 - 2 * cosine and the
Lowe ratio test ``d1/d2 < ratio`` becomes ``(1 - s1) < ratio^2 (1 - s2)``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_NEG = -1e9


class MatchResult(NamedTuple):
    """Per-query-row match into the reference set.

    Attributes:
      idx: (Q,) int32 best reference index (0 where invalid).
      ok: (Q,) bool match survived ratio/mutual/gating.
      score: (Q,) fp32 cosine similarity of the best match.
    """

    idx: jax.Array
    ok: jax.Array
    score: jax.Array


def _masked_scores(
    d_query: jax.Array,
    d_ref: jax.Array,
    q_valid: jax.Array,
    r_valid: jax.Array,
) -> jax.Array:
    s = jnp.dot(d_query, d_ref.T, preferred_element_type=jnp.float32)
    s = jnp.where(q_valid[:, None] & r_valid[None, :], s, _NEG)
    return s


def _top2(s: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Row-wise (best idx, best val, second val). Scatter-free: the best
    entry is knocked out with a one-hot compare+select, not a per-row
    scatter."""
    i1 = jnp.argmax(s, axis=1).astype(jnp.int32)
    v1 = jnp.take_along_axis(s, i1[:, None], axis=1)[:, 0]
    cols = jnp.arange(s.shape[1], dtype=jnp.int32)
    v2 = jnp.max(jnp.where(cols[None, :] == i1[:, None], _NEG, s), axis=1)
    return i1, v1, v2


def match_descriptors(
    d_query: jax.Array,
    d_ref: jax.Array,
    q_valid: jax.Array,
    r_valid: jax.Array,
    ratio: float = 0.8,
    mutual: bool = True,
    min_score: float = 0.5,
) -> MatchResult:
    """BF match with Lowe ratio, absolute score floor, and optional
    mutual-best check.

    Args:
      d_query: (Q, D) unit descriptors; d_ref: (R, D).
      q_valid, r_valid: validity masks.
      ratio: Lowe ratio on L2 distances (reference default 0.8 [M]).
      min_score: absolute cosine floor — rejects "best of nothing" matches
        when the true counterpart is absent (random unit cosines are
        ~1/sqrt(D), far below any genuine match).
    """
    s = _masked_scores(d_query, d_ref, q_valid, r_valid)
    idx, v1, v2 = _top2(s)
    # distances on unit vectors: d^2 = 2 - 2 s  (clamp for fp noise)
    d1 = jnp.maximum(1.0 - v1, 0.0)
    d2 = jnp.maximum(1.0 - v2, 1e-12)
    ok = q_valid & (v1 > min_score) & (d1 < ratio * ratio * d2)
    if mutual:
        col_best = jnp.argmax(s, axis=0).astype(jnp.int32)   # (R,)
        ok = ok & (col_best[idx] == jnp.arange(s.shape[0], dtype=jnp.int32))
    return MatchResult(idx=jnp.where(ok, idx, 0), ok=ok, score=v1)


def match_gated(
    d_query: jax.Array,
    xy_query: jax.Array,
    d_ref: jax.Array,
    xy_ref_pred: jax.Array,
    q_valid: jax.Array,
    r_valid: jax.Array,
    gate_px: float,
    ratio: float = 0.9,
    min_score: float = 0.5,
) -> MatchResult:
    """Match with a spatial gate: query keypoints may only match reference
    entries whose predicted pixel position is within gate_px. This is the
    tracking-mode matcher (the reference uses KLT optical flow for this role
    — SURVEY.md §8.5 chooses descriptor re-match + gating instead, which is
    one matmul rather than an image-pyramid scan).
    """
    s = _masked_scores(d_query, d_ref, q_valid, r_valid)
    d2 = jnp.sum(
        (xy_query[:, None, :] - xy_ref_pred[None, :, :]) ** 2, axis=-1
    )
    s = jnp.where(d2 <= gate_px * gate_px, s, _NEG)
    idx, v1, v2 = _top2(s)
    dd1 = jnp.maximum(1.0 - v1, 0.0)
    dd2 = jnp.maximum(1.0 - v2, 1e-12)
    # ratio only when a second candidate exists inside the gate
    has2 = v2 > _NEG / 2
    ratio_ok = jnp.where(has2, dd1 < ratio * ratio * dd2, True)
    ok = q_valid & (v1 > min_score) & ratio_ok
    col_best = jnp.argmax(s, axis=0).astype(jnp.int32)
    ok = ok & (col_best[idx] == jnp.arange(s.shape[0], dtype=jnp.int32))
    return MatchResult(idx=jnp.where(ok, idx, 0), ok=ok, score=v1)


def ransac_pan_tilt(
    rays: jax.Array,
    xy: jax.Array,
    ok: jax.Array,
    focal: jax.Array,
    cx: float,
    cy: float,
    num_hypotheses: int = 64,
    inlier_px: float = 3.0,
    seed: int = 0,
) -> jax.Array:
    """Pan-tilt-consistency outlier rejection for 2D<->ray matches.

    A static-shape replacement for the reference's RANSAC match filter
    (``slam_system/image_process.py`` ``run_ransac`` — SURVEY.md §2 layer 3,
    §8.5): a homography is overkill for a rotating camera, since ONE
    correspondence determines (pan, tilt) given the focal length. Every
    hypothesis is a single match's closed-form (pan, tilt) vote; all
    hypotheses are scored against all matches as one batched (H, Q)
    computation — no sequential loop.

    Args:
      rays: (Q, 2) matched ray angles; xy: (Q, 2) pixel positions.
      ok: (Q,) candidate mask. focal: scalar current focal estimate.

    Returns:
      (Q,) bool inlier mask (subset of ``ok``).
    """
    q = rays.shape[0]
    u = jnp.arctan2(xy[:, 0] - cx, focal)
    pan_i = rays[:, 0] - u
    tilt_i = rays[:, 1] - jnp.arctan2(-(xy[:, 1] - cy) * jnp.cos(u), focal)

    # hypothesis set: the votes of `num_hypotheses` pseudo-random candidates
    # (falls back to candidate 0's vote where the pick is invalid)
    key = jax.random.PRNGKey(seed)
    pick = jax.random.randint(key, (num_hypotheses,), 0, q)
    first_ok = jnp.argmax(ok)
    pick = jnp.where(ok[pick], pick, first_ok)
    h_pan = pan_i[pick]                                      # (H,)
    h_tilt = tilt_i[pick]

    # score: reproject all matches under each hypothesis (closed form)
    du = rays[None, :, 0] - h_pan[:, None]                   # (H, Q)
    dv = rays[None, :, 1] - h_tilt[:, None]
    px = focal * jnp.tan(du) + cx
    py = -focal * jnp.tan(dv) / jnp.cos(du) + cy
    err2 = (px - xy[None, :, 0]) ** 2 + (py - xy[None, :, 1]) ** 2
    inl = ok[None, :] & (err2 < inlier_px * inlier_px)       # (H, Q)
    best = jnp.argmax(inl.sum(axis=1))
    return inl[best]


def consensus_pan_tilt(
    rays: jax.Array,
    xy: jax.Array,
    ok: jax.Array,
    focal: jax.Array,
    cx: float,
    cy: float,
    inlier_px: float = 6.0,
    focal_correct: bool = True,
    score: jax.Array | None = None,
    max_hypotheses: int = 256,
) -> tuple[jax.Array, jax.Array]:
    """Exhaustive pan-tilt consensus: EVERY candidate match votes.

    Deterministic, sampling-free variant of ``ransac_pan_tilt`` for the
    per-frame tracking pre-gate: with Q <= 256 the full
    (Q, Q) hypothesis-vs-match table is one cheap batched computation, so
    there is no reason to subsample hypotheses (a fixed-key subsample
    collapses onto few distinct votes when the ok-density is low).

    Above ``max_hypotheses`` candidates the HYPOTHESIS axis is cut to the
    top-``max_hypotheses`` matches by ``score`` (deterministic top-k, ok
    rows first) while every match still gets scored as an inlier — the
    (Q, Q) transcendental table at Q = 512 was 4x the 256-row cost for no
    accuracy gain: only ONE good static hypothesis is
    needed, and the statics dominate any trackable frame, so the best
    static vote survives any top-256 cut. Scoreless calls fall back to
    ok-ordering (still deterministic).

    ``focal_correct`` makes the score robust to a focal-estimate bias: a
    wrong focal spreads static-scene residuals RADIALLY (d pred / d f =
    [tan(du), -tan(dv)/cos(du)] — exactly the normalized image offset), so
    each hypothesis fits the 1-D focal correction ``df`` in closed form
    over its coarse inliers and scores with it removed. The focal is
    weakly observable for narrow-FOV rotation (f and angular scale are
    near-gauge), so a 0.5-1% persistent bias is the EXPECTED filter state
    — an uncorrected 6 px consensus slowly rejects the wide-field statics
    and starves. Wrong-motion clusters gain nothing: their residuals are
    not radial.

    Returns:
      (inlier_mask (Q,), best_count ()): matches consistent with the
      winning single-match (pan, tilt) vote, and the winner's support.
      Callers should fall back to per-match gating when ``best_count`` is
      not a clear majority — a split consensus must not starve the filter.
    """
    q = rays.shape[0]
    u = jnp.arctan2(xy[:, 0] - cx, focal)
    pan_i = rays[:, 0] - u
    tilt_i = rays[:, 1] - jnp.arctan2(-(xy[:, 1] - cy) * jnp.cos(u), focal)

    if q > max_hypotheses:
        # deterministic hypothesis cut: ok candidates ranked by match score
        rank = jnp.where(
            ok, 0.0 if score is None else score.astype(jnp.float32), _NEG
        )
        _, hyp_idx = jax.lax.top_k(rank, max_hypotheses)     # (H,)
        h_pan = pan_i[hyp_idx]
        h_tilt = tilt_i[hyp_idx]
        hyp_ok = ok[hyp_idx]
    else:
        h_pan, h_tilt, hyp_ok = pan_i, tilt_i, ok

    du = rays[None, :, 0] - h_pan[:, None]                   # (H, Q)
    dv = rays[None, :, 1] - h_tilt[:, None]
    tx = jnp.tan(du)
    ty = -jnp.tan(dv) / jnp.cos(du)
    ex = xy[None, :, 0] - (focal * tx + cx)
    ey = xy[None, :, 1] - (focal * ty + cy)
    if focal_correct:
        err2 = ex * ex + ey * ey
        coarse = ok[None, :] & (err2 < 9.0 * inlier_px * inlier_px)
        num = jnp.sum(jnp.where(coarse, tx * ex + ty * ey, 0.0), axis=1)
        den = jnp.sum(jnp.where(coarse, tx * tx + ty * ty, 0.0), axis=1)
        df = num / jnp.maximum(den, 1e-6)                    # (Q,)
        ex = ex - df[:, None] * tx
        ey = ey - df[:, None] * ty
    err2 = ex * ex + ey * ey
    inl = ok[None, :] & (err2 < inlier_px * inlier_px)       # (H, Q)
    counts = jnp.where(hyp_ok, inl.sum(axis=1), -1)          # invalid: -1
    best = jnp.argmax(counts)

    # refit-and-rescore: the winning hypothesis carries its OWN observation
    # noise (~2 sigma common-mode) plus its slot-ray estimation error, which
    # against a ~2 inlier_px gate falsely rejects a quarter of the statics.
    # One least-squares (pan, tilt, focal) correction over the winner's
    # inliers (small-angle basis: dpx/dpan ~ -f, dpy/dtilt ~ f, d/df =
    # (tx, ty); second-order terms < 10% inside a +-0.3 rad half-FOV)
    # removes it — standard RANSAC refinement, all closed-form.
    w = inl[best].astype(jnp.float32)
    bx, by = ex[best], ey[best]
    btx, bty = tx[best], ty[best]
    nw = jnp.maximum(w.sum(), 1.0)
    # normal equations for [d_pan_px, d_tilt_px, d_f] with orthogonalized
    # pan/tilt (their bases are disjoint axes); focal couples to both
    a11 = nw                      # sum w * 1 (x-axis)
    a22 = nw                      # (y-axis)
    a13 = jnp.sum(w * btx)
    a23 = jnp.sum(w * bty)
    a33 = jnp.sum(w * (btx * btx + bty * bty)) + 1e-6
    b1 = jnp.sum(w * bx)
    b2 = jnp.sum(w * by)
    b3 = jnp.sum(w * (btx * bx + bty * by))
    # closed-form 3x3 solve (no LU factorization call for one tiny
    # system). The
    # system is [[a11,0,a13],[0,a22,a23],[a13,a23,a33]] + 1e-6 I.
    a11 = a11 + 1e-6
    a22 = a22 + 1e-6
    a33 = a33 + 1e-6
    det = a11 * (a22 * a33 - a23 * a23) + a13 * (-a22 * a13)
    # bound magnitude but PRESERVE sign (sign(0) treated as +): replacing a
    # small negative det with +eps would flip the refit direction
    sgn = jnp.where(det < 0.0, -1.0, 1.0)
    det = sgn * jnp.maximum(jnp.abs(det), 1e-12)
    sol = (
        jnp.array(
            [
                b1 * (a22 * a33 - a23 * a23)
                + b2 * (a23 * a13)
                + b3 * (-a22 * a13),
                b1 * (a13 * a23)
                + b2 * (a11 * a33 - a13 * a13)
                + b3 * (-a11 * a23),
                b1 * (-a13 * a22)
                + b2 * (-a11 * a23)
                + b3 * (a11 * a22),
            ]
        )
        / det
    )
    rx = bx - sol[0] - sol[2] * btx
    ry = by - sol[1] - sol[2] * bty
    refined = ok & (rx * rx + ry * ry < inlier_px * inlier_px)
    return refined, refined.sum()


def scatter_to_slots(
    result: MatchResult,
    xy_query: jax.Array,
    num_slots: int,
) -> tuple[jax.Array, jax.Array]:
    """Convert query->slot matches into slot-aligned EKF observations.

    Args:
      result: matches where ``idx`` indexes EKF slots.

    Returns:
      (obs (N,2), obs_mask (N,)) for ekf.update.

    Scatter-free: matches are unique per slot (mutual-best check), so the
    slot table is a one-hot (N, Q) compare + a row gather. (A one-hot
    matmul would be no substitute: at TF32 on the H100 it would quantize
    x in [1024, 1280) by up to 0.5 px — ulp = 1 there — against
    sigma_obs = 1 px, so the exact gather is required.)
    """
    tgt = jnp.where(result.ok, result.idx, num_slots)
    onehot = tgt[None, :] == jnp.arange(num_slots, dtype=jnp.int32)[:, None]
    hit = onehot.any(axis=1)
    cand = jnp.argmax(onehot, axis=1)                        # (N,) query row
    obs = jnp.where(hit[:, None], xy_query[cand], 0.0)
    return obs, hit
