"""MonoSLAM-style EKF over the PTZ camera with joint ray landmarks.

A static-shape redesign of the reference's per-frame tracking filter
(reference: ``slam_system/ptz_slam.py`` EKF — SURVEY.md §4.2, §8.3). The
reference grows and shrinks its state/covariance dynamically in NumPy; here
everything is a fixed-capacity padded state (N_max ray slots + validity masks) so the whole
predict/update/lifecycle step is one jitted, static-shape computation, and a
full sequence runs as a single ``lax.scan``.

State layout (SURVEY.md §8.3) — BLOCKED, not interleaved:
    x = (pan, tilt, f, d_pan, d_tilt, d_f, theta_1..theta_N, phi_1..phi_N)
with dense covariance P of size (6 + 2N)^2. The reference (and round 1-3 of
this engine) interleaves (theta_i, phi_i) pairs; that layout forces every
blockdiag-Jacobian product through (N, 2, N, 2)-shaped reshapes. Grouping
all thetas then all phis makes every per-slot 2x2 Jacobian block a DIAGONAL
of an (N, N) block, so the whole measurement algebra becomes (D, N)-shaped
broadcasting and (*, 3) matmuls with no reshapes. The measurement space is
blocked the same way: residual = (x_1..x_N, y_1..y_N). For N=256 the heavy
ops are ~518x518 matmuls and a 512x512 Cholesky.

Masking convention: slot i inactive or unobserved => its H rows are zeroed and
its innovation zeroed, so the Kalman update is exactly the update of the
observed subproblem; inactive P blocks are kept at identity to stay
well-conditioned.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from functools import partial

from ptzjax.config import SLAMConfig
from ptzjax.geometry import Intrinsics, back_project_pixels, project_jacobians

# Covariance algebra must not run at reduced matmul precision: rounding
# destroys the SPD structure of S = H P H^T + R and NaNs the Cholesky. On
# the H100, f32 matmuls at DEFAULT and HIGH run on the tensor cores as TF32
# (10-bit mantissa, unit roundoff ~4.9e-4); HIGHEST is full fp32. Two tiers:
#
#   _mm  (HIGHEST, fp32): everything whose product lands in the
#        covariance P (Joseph form, K H, K R K^T) or feeds the Cholesky.
#        The state is heterogeneous (focal variance in px^2 ~1e2 vs
#        converged angle variances ~1e-6 rad^2, cond(P) ~ 1e8): a
#        relative matmul error far below TF32's couples large-scale entries
#        into small-scale ones and has destroyed SPD after tens of frames
#        (a reduced-precision Joseph form once NaN'd the closed loop near
#        frame 80 while a single-update oracle check still passed).
#   _mmh (HIGH, TF32): the GAIN path only — K and the triangular-inverse
#        products feeding it. The Joseph form yields a CONSISTENT filter
#        for ANY gain K (it computes the covariance OF the gain actually
#        applied), so a ~1e-3-relative gain perturbation is
#        suboptimality, not inconsistency. tests/test_precision.py runs
#        the closed loop with these products rounded to TF32, and
#        chip_smoke.py checks one update on the card against an fp64
#        oracle and runs the closed loop there.
_mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
_mmh = partial(jnp.matmul, precision=jax.lax.Precision.HIGH)


def _inv_lower(l: jax.Array) -> jax.Array:
    """Exact inverse of a lower-triangular matrix from matmuls only.

    Triangular SUBSTITUTION is an n-step serial dependence chain; whether
    cuBLAS's triangular solve beats this on the H100 is unmeasured
    (ROADMAP D4/S5). Instead: write L = D (I - N) with D = diag(L) and N
    strictly lower, so N is nilpotent (N^n = 0) and the inverse is the
    FINITE Neumann product (I-N)^{-1} = prod_k (I + N^{2^k}), k < log2(n)
    — pure matmul algebra, fp-exact in structure (no approximation).
    Above 128 a 2x2 block recursion keeps the matmul flops near the
    classic O(n^3/3): inv([[A,0],[B,C]]) = [[iA,0],[-iC B iA, iC]].
    """
    n = l.shape[0]
    if n > 128 and n % 2 == 0:
        h = n // 2
        ia = _inv_lower(l[:h, :h])
        ic = _inv_lower(l[h:, h:])
        off = -_mm(ic, _mm(l[h:, :h], ia))
        return jnp.concatenate(
            [
                jnp.concatenate([ia, jnp.zeros((h, h), l.dtype)], 1),
                jnp.concatenate([off, ic], 1),
            ]
        )
    dinv = 1.0 / jnp.diagonal(l)
    nmat = jnp.eye(n, dtype=l.dtype) - l * dinv[:, None]  # strictly lower
    x = jnp.eye(n, dtype=l.dtype) + nmat
    p = nmat
    k = 2
    while k < n:
        p = _mm(p, p)
        x = x + _mm(p, x)
        k *= 2
    return x * dinv[None, :]


def _inv_chol(s: jax.Array, leaf: int = 128) -> jax.Array:
    """L^{-1} of the Cholesky factor of SPD ``s``, via 2x2 block recursion
    with XLA-chol leaves — so S^{-1} = il.T @ il.

    A Cholesky factorization is a serial chain of n steps. The textbook
    block factorization
        S = [[A, B^T], [B, C]],  L = [[L_A, 0], [L21, L_S]],
        L21 = B L_A^{-T},  L_S = chol(C - L21 L21^T)
    replaces one big serial factorization with two half-size ones plus
    matmuls, and because the EKF only ever consumes L^{-1}, the
    recursion INVERTS as it factors (leaf: XLA chol + ``_inv_lower``'s
    finite Neumann product):
        L^{-1} = [[iLA, 0], [-iLS L21 iLA, iLS]]
    — the leading block is never inverted twice. Exact algebra (same
    factorization, different operation order); products feeding the Schur
    complement run at HIGHEST (it must stay SPD). Recursing 512 -> four
    128-leaves shortens the serial chol chain; whether cuSOLVER's
    ``cho_factor``/``cho_solve`` is faster on the H100 is ROADMAP D4/S5.
    """
    n = s.shape[0]
    if n <= leaf or n % 2:
        return _inv_lower(jnp.linalg.cholesky(s))
    h = n // 2
    ila = _inv_chol(s[:h, :h], leaf)
    l21 = _mm(s[h:, :h], ila.T)                    # B L_A^{-T}
    schur = s[h:, h:] - _mm(l21, l21.T)
    # RELATIVE jitter: the Schur complement is PD in exact arithmetic, but
    # its fp32 rounding error scales with ||S|| — when the innovation
    # covariance is large (big state covariance during stress), the error
    # can exceed lambda_min and hand the chol leaf a non-PD block, NaN-ing
    # the whole filter (observed once per ~5k frames in the r5 soak). A
    # 1e-6-relative diagonal bias is far below the gain tolerance.
    schur = schur + jnp.eye(h, dtype=s.dtype) * (
        1e-6 * jnp.trace(schur) / h
    )
    ils = _inv_chol(0.5 * (schur + schur.T), leaf)
    off = -_mm(ils, _mm(l21, ila))
    return jnp.concatenate(
        [
            jnp.concatenate([ila, jnp.zeros((h, h), s.dtype)], 1),
            jnp.concatenate([off, ils], 1),
        ]
    )


class EKFState(NamedTuple):
    """Padded EKF state. N = ray-slot capacity; dim D = 6 + 2N.

    Attributes:
      cam: (6,) pan, tilt, f, and their per-frame velocities.
      rays: (N, 2) slot ray angles (theta, phi); garbage where inactive.
      cov: (D, D) joint covariance.
      active: (N,) bool slot validity.
      missed: (N,) int32 consecutive frames without an observation.
      rej: (N,) int32 consecutive frames whose MATCHED observation failed
        the motion-consensus gate — positive wrong-motion evidence (a
        moving object claimed this slot), unlike mere absence. Reset by any
        non-rejected frame; reaching cfg.max_rejected retires the slot
        (i.i.d. outliers practically never string 3 consecutive
        rejections; movers do so immediately).
      ray_ids: (N,) int32 global map ray id per slot (-1 = empty).
    """

    cam: jax.Array
    rays: jax.Array
    cov: jax.Array
    active: jax.Array
    missed: jax.Array
    rej: jax.Array
    ray_ids: jax.Array

    @property
    def capacity(self) -> int:
        return self.rays.shape[0]

    @property
    def pose(self) -> jax.Array:
        """(pan, tilt, f) 3-vector."""
        return self.cam[:3]


def init_state(pose: jax.Array, cfg: SLAMConfig) -> EKFState:
    """Fresh state around a known initial pose (SURVEY.md §4.1)."""
    n = cfg.max_rays
    d = 6 + 2 * n
    cam = jnp.concatenate([jnp.asarray(pose, jnp.float32), jnp.zeros(3, jnp.float32)])
    p0 = jnp.eye(d, dtype=jnp.float32)
    # camera starts exactly known (GT init, like the reference's first frame);
    # tiny diagonal keeps Cholesky happy. Velocities get the init prior.
    diag = jnp.concatenate(
        [
            jnp.full((3,), 1e-6, jnp.float32),
            jnp.array(
                [cfg.init_vel_std**2, cfg.init_vel_std**2, cfg.init_vel_std_f**2],
                jnp.float32,
            ),
            jnp.ones((2 * n,), jnp.float32),
        ]
    )
    return EKFState(
        cam=cam,
        rays=jnp.zeros((n, 2), jnp.float32),
        cov=p0 * diag,
        active=jnp.zeros((n,), bool),
        missed=jnp.zeros((n,), jnp.int32),
        rej=jnp.zeros((n,), jnp.int32),
        ray_ids=jnp.full((n,), -1, jnp.int32),
    )


def _process_noise(n: int, cfg: SLAMConfig) -> jax.Array:
    d = 6 + 2 * n
    q = jnp.zeros((d,), jnp.float32)
    accel = jnp.array(
        [cfg.sigma_pan**2, cfg.sigma_tilt**2, cfg.sigma_focal**2], jnp.float32
    )
    # constant-velocity model driven by per-frame acceleration noise:
    # position picks up dt^2/4..dt^2 terms; keep the standard diagonal approx.
    q = q.at[0:3].set(accel * cfg.dt**2)
    q = q.at[3:6].set(accel)
    return jnp.diag(q)


def predict(state: EKFState, cfg: SLAMConfig) -> EKFState:
    """Constant-velocity predict; rays are static (SURVEY.md §8.3)."""
    n = state.capacity
    d = 6 + 2 * n
    cam = state.cam.at[0:3].add(cfg.dt * state.cam[3:6])
    # F = I with dt coupling on the camera block. Apply structurally instead
    # of building F: rows/cols 0:3 pick up dt * rows/cols 3:6.
    p = state.cov
    p = p.at[0:3, :].add(cfg.dt * p[3:6, :])
    p = p.at[:, 0:3].add(cfg.dt * p[:, 3:6])
    p = p + _process_noise(n, cfg)
    return state._replace(cam=cam, cov=p)


class UpdateStats(NamedTuple):
    num_used: jax.Array       # observations that passed gating
    num_observed: jax.Array   # observations offered (active slot + valid)
    innovation_rms: jax.Array # gated-innovation RMS in pixels
    lost: jax.Array           # bool: too few inliers => tracking lost
    used_mask: jax.Array      # (N,) bool: slot's observation passed the gate


def update(
    state: EKFState,
    obs: jax.Array,
    obs_mask: jax.Array,
    intr: Intrinsics,
    cfg: SLAMConfig,
) -> tuple[EKFState, UpdateStats]:
    """Joint EKF measurement update from slot-aligned pixel observations.

    Args:
      obs: (N, 2) measured pixel positions, aligned to ray slots.
      obs_mask: (N,) bool — slot observed this frame.

    Returns:
      Updated state and per-frame statistics (SURVEY.md §4.2: lost detection
      by inlier count).
    """
    n = state.capacity
    d = 6 + 2 * n
    pose = state.cam[:3]
    offered = obs_mask & state.active

    pred_pix, j_cam, j_ray = project_jacobians(pose, state.rays, intr)
    innov = obs - pred_pix  # (N, 2)

    # Structured Kalman algebra in the BLOCKED layout (module docstring):
    # H = [Jc | 0 | diag-blocks], never materialized. In the blocked state
    # each per-slot 2x2 ray-Jacobian entry becomes a DIAGONAL of an (N, N)
    # block, so every blockdiag product below is a broadcast multiply on
    # (D, N) tiles — no (N, 2, N, 2) reshapes.
    jcx = j_cam[:, 0, :]                                 # (N, 3)
    jcy = j_cam[:, 1, :]
    jra = j_ray[:, 0, 0]                                 # (N,) dx/dtheta
    jrb = j_ray[:, 0, 1]                                 # dx/dphi
    jrc = j_ray[:, 1, 0]                                 # dy/dtheta
    jrd = j_ray[:, 1, 1]                                 # dy/dphi

    def pht_of(cov, jc, a, b):
        """P H_c^T for one measurement component: (D, N)."""
        return (
            _mm(cov[:, 0:3], jc.T)
            + cov[:, 6 : 6 + n] * a[None, :]
            + cov[:, 6 + n :] * b[None, :]
        )

    pht_x = pht_of(state.cov, jcx, jra, jrb)             # (D, N)
    pht_y = pht_of(state.cov, jcy, jrc, jrd)

    def s_diag(pht, jc, a, b):
        """diag(H_c (P H_e^T)) — the per-slot entry of one 2x2 gate block.
        The ray terms are diagonals of (N, N) blocks: one masked reduce."""
        eye_n = jnp.eye(n, dtype=jnp.float32)
        return (
            (jc * pht[0:3].T).sum(1)
            + a * (pht[6 : 6 + n] * eye_n).sum(0)
            + b * (pht[6 + n :] * eye_n).sum(0)
        )

    # Mahalanobis innovation gate against the *predicted* per-slot
    # innovation covariance S_i = (H P H^T 2x2 block) + R. This admits
    # large pixel innovations while the velocity is still uncertain (right
    # after init/reloc) and tightens as the filter converges; a fixed pixel
    # gate deadlocks with constant-velocity startup (lost -> reloc -> zero
    # velocity -> lost). s01 == s10 exactly (P symmetric).
    sig2 = cfg.sigma_obs**2
    s00 = s_diag(pht_x, jcx, jra, jrb) + sig2
    s01 = s_diag(pht_y, jcx, jra, jrb)
    s11 = s_diag(pht_y, jcy, jrc, jrd) + sig2
    ix, iy = innov[:, 0], innov[:, 1]
    det = s00 * s11 - s01 * s01
    maha2 = (s11 * ix**2 - 2.0 * s01 * ix * iy + s00 * iy**2) / jnp.maximum(
        det, 1e-12
    )
    px_ok = jnp.linalg.norm(innov, axis=-1) < cfg.innovation_gate_px
    used = offered & (maha2 < cfg.gate_maha2) & px_ok

    # Gate rescue: a camera acceleration beyond the constant-velocity
    # model's process noise (a broadcast operator reversing a pan) shifts
    # ALL innovations coherently past the tight gate at once — which is
    # indistinguishable from "lost" by count alone and used to trigger a
    # spurious relocalization. If the tight gate starves while a widened
    # gate admits a LARGE consistent set (true loss leaves only scattered
    # coincidences, not 3x min_inliers agreeing matches), trust the wide
    # set; the px ceiling still bounds outliers.
    used_wide = offered & (maha2 < cfg.gate_rescue_factor * cfg.gate_maha2) & px_ok
    rescue = (used.sum() < cfg.min_inliers) & (
        used_wide.sum() >= 3 * cfg.min_inliers
    )
    used = jnp.where(rescue, used_wide, used)
    u1 = used.astype(jnp.float32)                        # (N,)
    innov = jnp.where(used[:, None], innov, 0.0)

    # apply the gate: zero unused Jacobian rows (fp-exact commutation with
    # every product below)
    jcx = jcx * u1[:, None]
    jcy = jcy * u1[:, None]
    jra = jra * u1
    jrb = jrb * u1
    jrc = jrc * u1
    jrd = jrd * u1

    # JOINT update with the two-tier precision split of _mm/_mmh (module
    # top): the covariance path (everything whose product lands in P) runs
    # at HIGHEST, full fp32; the GAIN path (K and the triangular inverse
    # feeding it) runs at HIGH, TF32 on the H100 — the Joseph form keeps
    # the filter consistent for any gain, so TF32 rounding of K is a
    # suboptimality, not an instability.
    ph_t = jnp.concatenate([pht_x, pht_y], axis=1) * jnp.concatenate(
        [u1, u1]
    )[None, :]                                           # (D, 2N), masked
    pht_c = ph_t[0:3]
    pht_t = ph_t[6 : 6 + n]
    pht_p = ph_t[6 + n :]
    sx = _mm(jcx, pht_c) + jra[:, None] * pht_t + jrb[:, None] * pht_p
    sy = _mm(jcy, pht_c) + jrc[:, None] * pht_t + jrd[:, None] * pht_p
    s = jnp.concatenate([sx, sy], axis=0)                # (2N, 2N)
    s = 0.5 * (s + s.T)
    r_diag = jnp.full((2 * n,), sig2, jnp.float32)
    s = s + jnp.diag(r_diag)
    # K = PHT S^-1: S^-1 = L^-T L^-1 with L^-1 from the blocked
    # factor-and-invert recursion (_inv_chol) — XLA 128-chol leaves plus
    # Neumann-product matmul algebra; no full-size substitution loops.
    il = _inv_chol(s)
    k = _mmh(_mmh(ph_t, il.T), il)                       # (D, 2N)

    dx = k @ jnp.concatenate([innov[:, 0], innov[:, 1]])
    cam = state.cam + dx[:6]
    rays = state.rays + jnp.stack([dx[6 : 6 + n], dx[6 + n :]], axis=-1)

    # Joseph-form covariance update for fp32 stability (HIGHEST tier).
    # K H reuses the blocked structure: cols 0:3 = K·[Jcx; Jcy], cols 3:6
    # = 0, the theta column block = Kx*diag(a) + Ky*diag(c) (broadcasts).
    kx = k[:, :n]
    ky = k[:, n:]
    kh = jnp.concatenate(
        [
            _mm(kx, jcx) + _mm(ky, jcy),
            jnp.zeros((d, 3), jnp.float32),
            kx * jra[None, :] + ky * jrc[None, :],
            kx * jrb[None, :] + ky * jrd[None, :],
        ],
        axis=1,
    )
    ikh = jnp.eye(d, dtype=jnp.float32) - kh
    cov = _mm(_mm(ikh, state.cov), ikh.T) + _mm(k * r_diag[None, :], k.T)
    cov = 0.5 * (cov + cov.T)
    # numerical hygiene: fp32 Joseph products under large gains (ill-
    # conditioned S while the geometry is degrading) can push a diagonal
    # entry NEGATIVE; a negative variance silently disables every
    # chi-square test downstream (NaN sigma comparisons are False) and
    # turns a correctable drift into a death spiral (observed in the r5
    # 10k soak). Floor the diagonal; a filter whose state went non-finite
    # declares LOST (relocalization re-initializes it cleanly).
    dg = jnp.diagonal(cov)
    cov = cov + jnp.diag(jnp.maximum(dg, 1e-8) - dg)

    num_used = used.sum()
    num_obs = offered.sum()
    rms = jnp.sqrt(
        jnp.sum(innov**2) / jnp.maximum(1.0, 2.0 * num_used.astype(jnp.float32))
    )
    # a non-finite posterior (rare fp blowout under stress) becomes a
    # ONE-FRAME NO-OP: keep the finite predicted state, flag lost so the
    # caller relocalizes — never let NaN into the carried state, the map,
    # or (via the live-focal descriptor scale) the frontend
    finite = (
        jnp.isfinite(cam).all()
        & jnp.isfinite(dg).all()
        & jnp.isfinite(rays).all()
    )
    cam = jnp.where(finite, cam, state.cam)
    rays = jnp.where(finite, rays, state.rays)
    cov = jnp.where(finite, cov, state.cov)
    stats = UpdateStats(
        num_used=num_used,
        num_observed=num_obs,
        innovation_rms=rms,
        lost=(num_used < cfg.min_inliers) | ~finite,
        used_mask=used & finite,
    )
    missed = jnp.where(
        stats.used_mask, 0, state.missed + state.active.astype(jnp.int32)
    )
    return state._replace(cam=cam, rays=rays, cov=cov, missed=missed), stats


def retire_lost(state: EKFState, cfg: SLAMConfig) -> EKFState:
    """Free slots unobserved for too long (reference: ray deletion, §4.2)."""
    drop = state.active & (
        (state.missed > cfg.max_missed) | (state.rej >= cfg.max_rejected)
    )
    return _clear_slots(state, drop)


def _clear_slots(state: EKFState, drop: jax.Array) -> EKFState:
    n = state.capacity
    keep = ~drop
    active = state.active & keep
    ray_ids = jnp.where(keep, state.ray_ids, -1)
    # reset dropped slots' covariance to identity, zero cross terms
    # (blocked layout: slot i owns state rows 6+i and 6+N+i)
    full = jnp.concatenate([jnp.zeros((6,), bool), drop, drop])
    cov = jnp.where(full[:, None] | full[None, :], 0.0, state.cov)
    cov = cov + jnp.diag(jnp.where(full, 1.0, 0.0))
    return state._replace(
        active=active, ray_ids=ray_ids, cov=cov,
        missed=jnp.where(keep, state.missed, 0),
        rej=jnp.where(keep, state.rej, 0),
    )


class SlotClaim(NamedTuple):
    """Bookkeeping of candidate -> free-slot assignment (deterministic:
    the j-th accepted candidate claims the j-th free slot).

    Attributes:
      cand_ok: (K,) candidate accepted (masked in and a free slot exists).
      target: (K,) int32 slot index per candidate (n where rejected).
      newly: (N,) bool slot claimed in this call.
      cand_of_slot: (N,) int32 claiming candidate per slot (k where none).
    """

    cand_ok: jax.Array
    target: jax.Array
    newly: jax.Array
    cand_of_slot: jax.Array


def claim_slots(active: jax.Array, cand_mask: jax.Array) -> SlotClaim:
    """Assign accepted candidates to free slots, fully scatter-free.

    The rank->index maps are built with ``searchsorted`` over the rank
    cumsums (both nondecreasing) instead of rank-scatters; whether a plain
    ``.at[].set`` is as fast on the H100 is ROADMAP D2. Callers should use ``cand_of_slot`` gathers + masked selects
    for the heavy payloads."""
    n = active.shape[0]
    k = cand_mask.shape[0]
    free = ~active
    csf = jnp.cumsum(free.astype(jnp.int32))              # (N,) nondecreasing
    free_rank = csf - 1
    cand_csum = jnp.cumsum(cand_mask.astype(jnp.int32))   # (K,)
    cand_rank = cand_csum - 1
    num_free = csf[-1]
    cand_ok = cand_mask & (cand_rank < num_free)
    num_ok = cand_ok.sum()
    # slot_of_rank[r] = index of the r-th free slot = first i: csf[i] == r+1
    slot_of_rank = jnp.searchsorted(
        csf, jnp.arange(1, k + 1, dtype=jnp.int32), method="compare_all"
    ).astype(jnp.int32)                                   # (K,), n = none
    target = jnp.where(
        cand_ok, slot_of_rank[jnp.clip(cand_rank, 0, k - 1)], n
    )
    newly = free & (free_rank < num_ok)
    # cand_of_slot[i] = index of the free_rank[i]-th accepted candidate
    idx_by_rank = jnp.searchsorted(
        cand_csum, jnp.arange(1, n + 1, dtype=jnp.int32),
        method="compare_all",
    ).astype(jnp.int32)                                   # (N,), k = none
    cand_of_slot = jnp.where(
        newly, idx_by_rank[jnp.clip(free_rank, 0, n - 1)], k
    )
    return SlotClaim(cand_ok, target, newly, cand_of_slot)


def insert_rays(
    state: EKFState,
    pixels: jax.Array,
    cand_mask: jax.Array,
    cand_ids: jax.Array,
    intr: Intrinsics,
    cfg: SLAMConfig,
) -> EKFState:
    """Back-project fresh keypoints into free slots (SURVEY.md §4.2).

    MonoSLAM-style state augmentation: the new ray is g(pose, pixel), so its
    covariance is G_c P_cc G_c^T + G_p R G_p^T with full cross-covariance
    G_c P_c,* against the existing state (including other rays inserted in
    the same call). Without this, new-ray uncertainty is uncorrelated with
    the camera and the filter can silently absorb pose error into the map
    (observed as a locked-in focal-length bias on noiseless data).

    All writes are slot-major gathers + dense masked selects, not a
    per-candidate scatter of the (2K, 2K) new-new block (~262k scattered
    elements per frame).

    Args:
      pixels: (K, 2) candidate keypoint positions.
      cand_mask: (K,) bool — candidate is real.
      cand_ids: (K,) int32 global ray ids to record.
    """
    n = state.capacity
    k = pixels.shape[0]
    d = 6 + 2 * n
    pose = state.cam[:3]
    new_rays = back_project_pixels(pose, pixels, intr)   # (K, 2)

    # Jacobians of g(pose, pixel) via autodiff (exact; insertion is not hot).
    def g(c, px):
        return back_project_pixels(c, px[None, :], intr)[0]

    g_cam = jax.vmap(jax.jacfwd(g, argnums=0), (None, 0))(pose, pixels)  # (K,2,3)
    g_pix = jax.vmap(jax.jacfwd(g, argnums=1), (None, 0))(pose, pixels)  # (K,2,2)

    claim = claim_slots(state.active, cand_mask)
    sel = claim.newly                                     # (N,)
    safe = jnp.clip(claim.cand_of_slot, 0, k - 1)         # (N,) gather index

    rays = jnp.where(sel[:, None], new_rays[safe], state.rays)
    active = state.active | sel
    ray_ids = jnp.where(sel, cand_ids[safe], state.ray_ids)
    missed = jnp.where(sel, 0, state.missed)
    rej = jnp.where(sel, 0, state.rej)

    # --- covariance augmentation (slot-major, scatter-free, blocked) ---
    zero2 = sel[:, None, None].astype(jnp.float32)
    g_cam_s = g_cam[safe] * zero2                         # (N,2,3), 0 if old
    g_pix_s = g_pix[safe] * zero2                         # (N,2,2)
    g_t = g_cam_s[:, 0, :]                                # (N,3) d theta/d pose
    g_p = g_cam_s[:, 1, :]                                # (N,3) d phi/d pose

    # 1) clear the claimed slots' rows/cols (stale identity blocks);
    #    blocked layout: slot i owns rows 6+i (theta) and 6+N+i (phi).
    full = jnp.concatenate([jnp.zeros((6,), bool), sel, sel])   # (D,)
    cov = jnp.where(full[:, None] | full[None, :], 0.0, state.cov)

    # 2) cross-covariance of new rays vs the whole (cleared) state:
    #    P_new,* = G_c P_pose,*   (velocity/pixel terms have zero Jacobian).
    cross_full = jnp.concatenate(
        [
            jnp.zeros((6, d), jnp.float32),
            _mm(g_t, cov[0:3, :]),                        # (N, D)
            _mm(g_p, cov[0:3, :]),
        ]
    )                                                     # (D, D)
    cov = jnp.where(full[:, None], cross_full, cov)
    cov = jnp.where(full[None, :], cross_full.T, cov)

    # 3) new-new blocks: G_ci P_cc G_cj^T + delta_ij (G_p R G_p^T + prior),
    #    assembled as the four (N, N) quadrants of the ray-ray block.
    pcc = state.cov[0:3, 0:3]
    gt_p = _mm(g_t, pcc)                                  # (N, 3)
    gp_p = _mm(g_p, pcc)
    b_tt = _mm(gt_p, g_t.T)                               # (N, N)
    b_tp = _mm(gt_p, g_p.T)
    b_pp = _mm(gp_p, g_p.T)
    # per-slot 2x2 pixel-noise + prior terms land on the quadrant diagonals
    sig2 = cfg.sigma_obs**2
    prior = (cfg.init_ray_std**2) * sel.astype(jnp.float32)
    d_tt = sig2 * (g_pix_s[:, 0, 0] ** 2 + g_pix_s[:, 0, 1] ** 2) + prior
    d_tp = sig2 * (
        g_pix_s[:, 0, 0] * g_pix_s[:, 1, 0]
        + g_pix_s[:, 0, 1] * g_pix_s[:, 1, 1]
    )
    d_pp = sig2 * (g_pix_s[:, 1, 0] ** 2 + g_pix_s[:, 1, 1] ** 2) + prior
    eye_n = jnp.eye(n, dtype=jnp.float32)
    b_tt = b_tt + eye_n * d_tt[:, None]
    b_tp = b_tp + eye_n * d_tp[:, None]
    b_pp = b_pp + eye_n * d_pp[:, None]
    blocks_full = jnp.concatenate(
        [
            jnp.zeros((6, d), jnp.float32),
            jnp.concatenate([jnp.zeros((n, 6), jnp.float32), b_tt, b_tp], 1),
            jnp.concatenate([jnp.zeros((n, 6), jnp.float32), b_tp.T, b_pp], 1),
        ]
    )
    cov = jnp.where(full[:, None] & full[None, :], blocks_full, cov)

    return state._replace(
        rays=rays, active=active, ray_ids=ray_ids, missed=missed, rej=rej,
        cov=cov
    )


def step(
    state: EKFState,
    obs: jax.Array,
    obs_mask: jax.Array,
    intr: Intrinsics,
    cfg: SLAMConfig,
) -> tuple[EKFState, UpdateStats]:
    """predict + update; jit-friendly single-frame step."""
    state = predict(state, cfg)
    return update(state, obs, obs_mask, intr, cfg)


def scan_track(
    state: EKFState,
    obs_seq: jax.Array,
    mask_seq: jax.Array,
    intr: Intrinsics,
    cfg: SLAMConfig,
) -> tuple[EKFState, tuple[jax.Array, UpdateStats]]:
    """Track a whole sequence of slot-aligned observations with lax.scan.

    Args:
      obs_seq: (T, N, 2), mask_seq: (T, N).

    Returns:
      (final_state, (poses (T, 3), stats)).
    """

    def body(s, frame):
        o, m = frame
        s, st = step(s, o, m, intr, cfg)
        return s, (s.pose, st)

    return jax.lax.scan(body, state, (obs_seq, mask_seq))
