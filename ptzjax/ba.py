"""Bundle adjustment: Levenberg–Marquardt with the ray-landmark Schur
complement (SURVEY.md §8.4).

An on-device replacement for the reference's ``slam_system/bundle_adjustment.py``
(scipy ``least_squares(method='trf')`` with a lil_matrix sparsity pattern —
SURVEY.md §2 layer 7, §4.3). Instead of a general sparse solver, we exploit
the problem's exact structure:

- cameras are 3-vectors (pan, tilt, focal), rays are 2-vectors;
- J splits into camera blocks A (2x3) and ray blocks B (2x2);
- the normal equations reduce by eliminating rays: per-ray 2x2 inverses (free
  elementwise) and a small dense (3K x 3K) reduced camera system solved by
  Cholesky.

Data layout is **ray-major**: a padded (M, C) table of observations where M is
the ray capacity and C the max keyframes-per-ray. Each ray's V block, g_r, and
W row live entirely in its table row, which makes the distributed version a
pure psum over ray shards (SURVEY.md §5): shard M, all-reduce the (3K x 3K)
camera system, solve replicated, scatter per-ray updates locally.

Parameter scaling: focal length enters the parameter vector as f * focal_scale
(default 1e-3) so all parameters are O(1) in fp32 (SURVEY.md §10 hard parts).
All reductions run at Precision.HIGHEST, full fp32: the default on the H100
is TF32 (10-bit mantissa), which is not enough for normal equations.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ptzjax.config import SLAMConfig
from ptzjax.geometry import Intrinsics, project_jacobians

_HI = jax.lax.Precision.HIGHEST


class BAProblem(NamedTuple):
    """Padded ray-major BA problem.

    Attributes:
      cams: (K, 3) initial keyframe poses (pan, tilt, f) — f unscaled pixels.
      rays: (M, 2) initial ray angles.
      obs_pix: (M, C, 2) observed pixel positions.
      obs_cam: (M, C) int32 camera index per observation (0 for padding).
      obs_w: (M, C) fp32 weight, 0 for padding/invalid.
      cam_free: (K,) bool — False freezes a camera (gauge fixing / padding).
    """

    cams: jax.Array
    rays: jax.Array
    obs_pix: jax.Array
    obs_cam: jax.Array
    obs_w: jax.Array
    cam_free: jax.Array


class BAResult(NamedTuple):
    cams: jax.Array
    rays: jax.Array
    cost: jax.Array           # final weighted SSE (px^2)
    initial_cost: jax.Array
    iterations: jax.Array     # LM iterations run
    accepted: jax.Array       # number of accepted steps


def _gather_obs(cams: jax.Array, rays: jax.Array, prob: BAProblem, intr: Intrinsics):
    """Residuals + Jacobian blocks for every (ray, slot) observation.

    Returns r (M,C,2), A (M,C,2,3) wrt scaled params, B (M,C,2,2).
    """
    cam_per_obs = cams[prob.obs_cam]                     # (M, C, 3)
    m, c = prob.obs_cam.shape
    pix, j_cam, j_ray = project_jacobians(
        cam_per_obs.reshape(m * c, 1, 3)[:, 0, :],       # (MC, 3)
        rays[:, None, :].repeat(c, 1).reshape(m * c, 1, 2),
        intr,
    )
    r = pix.reshape(m, c, 2) - prob.obs_pix
    a = j_cam.reshape(m, c, 2, 3)
    b = j_ray.reshape(m, c, 2, 2)
    w = prob.obs_w[..., None]
    return r * w, a * w[..., None], b * w[..., None]


def _scale_jac(a: jax.Array, focal_scale: float) -> jax.Array:
    """Rescale the focal column for the scaled parameterization."""
    return a.at[..., 2].divide(focal_scale)


def compute_cost(
    cams: jax.Array, rays: jax.Array, prob: BAProblem, intr: Intrinsics
) -> jax.Array:
    """Weighted SSE. Jacobian-free: the LM accept/reject test evaluates this
    once per iteration, so it must not pay for the (A, B) blocks."""
    from ptzjax.geometry import project_rays

    cam_per_obs = cams[prob.obs_cam]                             # (M, C, 3)
    rays_b = jnp.broadcast_to(
        rays[:, None, None, :], (*prob.obs_cam.shape, 1, 2)
    )
    pix = project_rays(cam_per_obs, rays_b, intr)[..., 0, :]     # (M, C, 2)
    r = (pix - prob.obs_pix) * prob.obs_w[..., None]
    return jnp.sum(r * r)


def _cam_onehot(obs_cam: jax.Array, num_cams: int, dtype=jnp.float32):
    """(M, C) int camera ids -> (M, C, K) one-hot selector.

    Turns every "segment-sum by camera id" into a dense matmul instead of a
    scatter (whether that still pays on the GPU is ROADMAP D2). Padding
    observations carry weight 0 in (r, A, B), so their (arbitrary) cam-0
    one-hot rows contribute nothing.
    """
    return jax.nn.one_hot(obs_cam, num_cams, dtype=dtype)


def normal_terms(
    cams: jax.Array,
    rays: jax.Array,
    prob: BAProblem,
    intr: Intrinsics,
    focal_scale: float,
):
    """Per-shard LM normal-equation terms (pure; psum-able across ray shards).

    Returns:
      u: (K, 3, 3) camera Gauss-Newton blocks, g_c: (K, 3),
      v: (M, 2, 2) ray blocks, g_r: (M, 2), w_blk: (M, C, 3, 2) A^T B.
    """
    k = cams.shape[0]
    r, a, b = _gather_obs(cams, rays, prob, intr)
    a = _scale_jac(a, focal_scale)

    # camera system: A^T A and A^T r reduced by camera id via one-hot matmul
    # instead of segment_sum
    e = _cam_onehot(prob.obs_cam, k, a.dtype)                    # (M,C,K)
    ata = jnp.einsum("mcab,mcad->mcbd", a, a, precision=_HI)     # (M,C,3,3)
    atr = jnp.einsum("mcab,mca->mcb", a, r, precision=_HI)       # (M,C,3)
    u = jnp.einsum("mck,mcbd->kbd", e, ata, precision=_HI)       # (K,3,3)
    g_c = jnp.einsum("mck,mcb->kb", e, atr, precision=_HI)       # (K,3)

    # ray system: local to each table row
    v = jnp.einsum("mcab,mcad->mbd", b, b, precision=_HI)        # (M,2,2)
    g_r = jnp.einsum("mcab,mca->mb", b, r, precision=_HI)        # (M,2)
    w_blk = jnp.einsum("mcab,mcad->mcbd", a, b, precision=_HI)   # (M,C,3,2)
    return u, g_c, v, g_r, w_blk


def _inv2x2(v: jax.Array, eps: float = 1e-10) -> jax.Array:
    """Batched closed-form 2x2 inverse; padding rows (zero blocks) -> ~0."""
    a, b_ = v[..., 0, 0], v[..., 0, 1]
    c, d = v[..., 1, 0], v[..., 1, 1]
    det = a * d - b_ * c + eps
    inv = jnp.stack(
        [jnp.stack([d, -b_], -1), jnp.stack([-c, a], -1)], -2
    ) / det[..., None, None]
    return inv


def _damp(h: jax.Array, lam: jax.Array, eps: float = 1e-8) -> jax.Array:
    """LM damping: H + lam * diag(H) + eps I (Marquardt scaling)."""
    n = h.shape[-1]
    eye = jnp.eye(n, dtype=h.dtype)
    diag = h * eye
    return h + lam * diag + eps * eye


def schur_local(v, g_r, w_blk, obs_cam, num_cams, lam):
    """Shard-local Schur-correction contributions (SURVEY.md §5): everything
    here only touches this shard's ray rows, so sharded BA just psums the
    returned (K,K,3,3) + (K,3) blocks — the one collective on the LM
    critical path.

    The camera-pair correction W V^-1 W^T is assembled WITHOUT materializing
    the (M, C, C, 3, 3) pair tensor or a k*k segment_sum: project Y and W
    onto camera columns with the one-hot selector (two thin matmuls), then
    one (K*3, M*2) x (M*2, K*3) contraction — all matmuls, no scatters.

    Returns (s_corr, rhs_corr, v_inv); v_inv is reused by back_substitute.
    """
    k = num_cams
    v_inv = _inv2x2(_damp(v, lam))                                # (M,2,2)
    y = jnp.einsum("mcab,mbd->mcad", w_blk, v_inv, precision=_HI) # (M,C,3,2)

    e = _cam_onehot(obs_cam, k, w_blk.dtype)                      # (M,C,K)
    gy = jnp.einsum("mck,mcae->mkae", e, y, precision=_HI)        # (M,K,3,2)
    gw = jnp.einsum("mck,mcae->mkae", e, w_blk, precision=_HI)    # (M,K,3,2)
    # s_corr[k,l,a,b] = sum_m sum_e gy[m,k,a,e] * gw[m,l,b,e]
    s_corr = jnp.einsum("mkae,mlbe->klab", gy, gw, precision=_HI) # (K,K,3,3)

    rhs_corr = jnp.einsum("mkae,me->ka", gy, g_r, precision=_HI)  # (K,3)
    return s_corr, rhs_corr, v_inv


def schur_assemble(u, g_c, s_corr, rhs_corr, cam_free, lam):
    """Assemble the damped, gauge-fixed reduced system from (already
    all-reduced) terms. Runs replicated on every shard; S is (3K, 3K) —
    small and dense by design."""
    k = u.shape[0]
    s = jnp.zeros((k, k, 3, 3), u.dtype)
    s = s.at[jnp.arange(k), jnp.arange(k)].set(_damp(u, lam))
    s = s - s_corr
    rhs = -g_c + rhs_corr                                          # (K,3)

    # gauge / padding: frozen cameras get identity rows/cols, zero rhs
    free = cam_free.astype(u.dtype)
    s = s * free[:, None, None, None] * free[None, :, None, None]
    eye3 = jnp.eye(3, dtype=u.dtype)
    s = s.at[jnp.arange(k), jnp.arange(k)].add(
        (1.0 - free)[:, None, None] * eye3
    )
    rhs = rhs * free[:, None]
    return s.transpose(0, 2, 1, 3).reshape(3 * k, 3 * k), rhs.reshape(-1)


def schur_reduce(u, g_c, v, g_r, w_blk, obs_cam, cam_free, lam):
    """Single-device convenience: local contributions + assembly."""
    s_corr, rhs_corr, _ = schur_local(v, g_r, w_blk, obs_cam, u.shape[0], lam)
    return schur_assemble(u, g_c, s_corr, rhs_corr, cam_free, lam)


def back_substitute(v_inv, g_r, w_blk, obs_cam, dc):
    """Per-ray updates dr_j = V_j^{-1} (-g_rj - sum_c W_jc^T dc_{cam});
    embarrassingly parallel over rays (SURVEY.md §8.4). ``v_inv`` is the
    damped inverse already computed by ``schur_local`` — shared, not
    recomputed."""
    dc_blocks = dc.reshape(-1, 3)
    wt_dc = jnp.einsum(
        "mcab,mca->mb", w_blk, dc_blocks[obs_cam], precision=_HI
    )                                                             # (M,2)
    return jnp.einsum("mab,mb->ma", v_inv, -g_r - wt_dc, precision=_HI)


# --- fast path ---------------------------------------------------------------
#
# The block-tensor formulation above is the readable spec, with tiny
# trailing dims ((M,C,3,3), (M,C,3,2)). The fast path used by
# ``run``/``lm_iteration`` computes the SAME math component-wise over flat
# (C, M) / (N,) arrays and reduces with a handful of plain matmuls. Which of
# the two the H100 favours is unmeasured (ROADMAP D3).
#
# Structure exploited (SURVEY.md §8.2): B = -A[:, :2] (the ray Jacobian is
# the negated pan/tilt camera columns), so with q_ij = sum_r a_ri * a_rj
# (6 unique products) and atr_i = sum_r a_ri * r_r (3 products):
#   U   = segsum_cam q          (full 3x3 symmetric)
#   V   = sum_C q[0:2, 0:2]     (per-ray 2x2)
#   W   = -q[:, 0:2]            (per-obs 3x2)
#   g_c = segsum_cam atr
#   g_r = -sum_C atr[0:2]
# Everything flows from 9 elementwise product arrays.


class BAPrecomp(NamedTuple):
    """LM-loop invariants (functions of the observation tables only).

    Flat observation order is c-major: n = c * M + m, so (N,) arrays
    reshape to (C, M) with rays on lanes.

    Attributes:
      e_flat: (N, K) one-hot camera selector (scatter-free segment sums).
      obs_cam_t: (C, M) int32; obs_x_t, obs_y_t, w_t: (C, M) fp32.
    """

    e_flat: jax.Array
    obs_cam_t: jax.Array
    obs_x_t: jax.Array
    obs_y_t: jax.Array
    w_t: jax.Array


def precompute(prob: BAProblem) -> BAPrecomp:
    """Build the LM-loop invariants.

    Memory note: ``e_flat`` is a dense (M*C, K) fp32 one-hot — O(M*C*K).
    At the online/benchmark sizes (M<=8192, C<=8, K<=64) that is <=16 MB
    and buys scatter-free segment sums; for very large OFFLINE problems
    (say M*C*K*4 bytes beyond a few GB) shard M over the mesh
    (``dist.run_sharded`` divides M per device, shrinking e_flat
    proportionally) before reaching for a segment-sum rewrite.
    """
    k = prob.cams.shape[0]
    obs_cam_t = prob.obs_cam.T                                   # (C, M)
    return BAPrecomp(
        e_flat=jax.nn.one_hot(obs_cam_t.reshape(-1), k, dtype=jnp.float32),
        obs_cam_t=obs_cam_t,
        obs_x_t=prob.obs_pix[..., 0].T,
        obs_y_t=prob.obs_pix[..., 1].T,
        w_t=prob.obs_w.T,
    )


def _per_obs_cam_params(cams: jax.Array, pre: BAPrecomp):
    """(pan, tilt, f) per observation as three (C, M) arrays, via ONE
    (3,K) x (K,N) matmul against the one-hot selector (no gathers)."""
    c, m = pre.obs_cam_t.shape
    camt = jax.lax.dot_general(
        cams, pre.e_flat, (((0,), (1,)), ((), ())),
        precision=_HI,
    )                                                            # (3, N)
    camt = camt.reshape(3, c, m)
    return camt[0], camt[1], camt[2]


def _projection_comps(cams, rays, pre: BAPrecomp, intr):
    """Shared projection front-end: residual and trig components, all
    (C, M) elementwise."""
    from ptzjax.geometry import ANGLE_CLIP

    pan, tilt, f = _per_obs_cam_params(cams, pre)
    u = jnp.clip(rays[None, :, 0] - pan, -ANGLE_CLIP, ANGLE_CLIP)
    v = jnp.clip(rays[None, :, 1] - tilt, -ANGLE_CLIP, ANGLE_CLIP)
    tu = jnp.tan(u)
    tv = jnp.tan(v)
    su = 1.0 / jnp.cos(u)
    sv = 1.0 / jnp.cos(v)
    w = pre.w_t
    r0 = (f * tu + intr.cx - pre.obs_x_t) * w
    r1 = (-f * tv * su + intr.cy - pre.obs_y_t) * w
    return f, tu, tv, su, sv, w, r0, r1


def fast_cost(cams, rays, prob: BAProblem, pre: BAPrecomp, intr) -> jax.Array:
    *_, r0, r1 = _projection_comps(cams, rays, pre, intr)
    return jnp.sum(r0 * r0 + r1 * r1)


def _fast_terms(cams, rays, lam, prob: BAProblem, pre: BAPrecomp, intr, fs):
    """All LM normal-equation terms, component-wise. Returns the psum-able
    camera-system blocks plus the shard-local pieces back-substitution
    needs."""
    k = cams.shape[0]
    c, m = pre.obs_cam_t.shape
    f, tu, tv, su, sv, w, r0, r1 = _projection_comps(cams, rays, pre, intr)

    # weighted Jacobian components (SURVEY.md §8.2); col 2 carries the
    # focal parameter scaling (a01 == 0 identically)
    a00 = -f * su * su * w
    a02 = tu * w / fs
    a10 = f * tv * su * tu * w
    a11 = f * sv * sv * su * w
    a12 = -tv * su * w / fs

    q00 = a00 * a00 + a10 * a10
    q01 = a10 * a11
    q02 = a00 * a02 + a10 * a12
    q11 = a11 * a11
    q12 = a11 * a12
    q22 = a02 * a02 + a12 * a12
    atr0 = a00 * r0 + a10 * r1
    atr1 = a11 * r1
    atr2 = a02 * r0 + a12 * r1

    # camera system: one (9,N) x (N,K) matmul replaces both segment sums
    p9 = jnp.stack(
        [q00, q01, q02, q11, q12, q22, atr0, atr1, atr2]
    ).reshape(9, c * m)
    ug = jax.lax.dot_general(
        p9, pre.e_flat, (((1,), (0,)), ((), ())), precision=_HI
    )                                                            # (9, K)
    u = jnp.stack(
        [
            jnp.stack([ug[0], ug[1], ug[2]], -1),
            jnp.stack([ug[1], ug[3], ug[4]], -1),
            jnp.stack([ug[2], ug[4], ug[5]], -1),
        ],
        -2,
    )                                                            # (K, 3, 3)
    g_c = ug[6:9].T                                              # (K, 3)

    # per-ray 2x2 system (V = sum_C q[:2,:2], g_r = -sum_C atr[:2]) and its
    # damped closed-form inverse — all (M,) component arrays
    v00 = q00.sum(0)
    v01 = q01.sum(0)
    v11 = q11.sum(0)
    gr0 = -atr0.sum(0)
    gr1 = -atr1.sum(0)
    d00 = v00 * (1.0 + lam) + 1e-8
    d11 = v11 * (1.0 + lam) + 1e-8
    det = d00 * d11 - v01 * v01 + 1e-10
    i00 = d11 / det
    i01 = -v01 / det
    i11 = d00 / det

    # per-obs W = -q[:, :2] and Y = W V^-1 (6 components each)
    w_col0 = (-q00, -q01, -q02)          # W[i, 0] for i = 0..2
    w_col1 = (-q01, -q11, -q12)          # W[i, 1]
    y = []                               # y[a*2+e] = Y[a, e], (C, M)
    for a in range(3):
        y.append(w_col0[a] * i00[None, :] + w_col1[a] * i01[None, :])
        y.append(w_col0[a] * i01[None, :] + w_col1[a] * i11[None, :])

    # project Y and W onto camera columns: gy/gw (6, M, K); the explicit
    # C-term sum fuses into one elementwise kernel (C is 6-8, static)
    e3 = pre.e_flat.reshape(c, m, k)
    wl = [w_col0[0], w_col1[0], w_col0[1], w_col1[1], w_col0[2], w_col1[2]]
    ys = jnp.stack(y)                                            # (6, C, M)
    ws = jnp.stack(wl)                                           # (6, C, M)
    gy = jnp.einsum("pcm,cmk->pmk", ys, e3, precision=_HI)
    gw = jnp.einsum("pcm,cmk->pmk", ws, e3, precision=_HI)

    # Schur correction: ONE (6K, M) x (M, 6K) matmul, then fold the inner
    # 2-dim (e) pairs — s_corr[k,l,a,b] = sum_e z[(a,e),k,(b,e),l]
    z = jax.lax.dot_general(
        gy, gw, (((1,), (1,)), ((), ())), precision=_HI
    )                                                            # (6,K,6,K)
    z6 = z.reshape(3, 2, k, 3, 2, k)
    s_corr = (
        z6[:, 0, :, :, 0, :] + z6[:, 1, :, :, 1, :]
    ).transpose(1, 3, 0, 2)                                      # (K,K,3,3)

    grs = jnp.stack([gr0, gr1, gr0, gr1, gr0, gr1])              # (6, M)
    rhs6 = jnp.einsum("pmk,pm->pk", gy, grs, precision=_HI)      # (6, K)
    rhs_corr = rhs6.reshape(3, 2, k).sum(1).T                    # (K, 3)

    local = (w_col0, w_col1, (gr0, gr1), (i00, i01, i11))
    return u, g_c, s_corr, rhs_corr, local


def _fast_back_substitute(dc, pre: BAPrecomp, local):
    """dr_j = V_j^{-1}(-g_rj - sum W^T dc) from the component arrays."""
    (w_col0, w_col1, (gr0, gr1), (i00, i01, i11)) = local
    c, m = pre.obs_cam_t.shape
    dct = jax.lax.dot_general(
        dc.reshape(-1, 3), pre.e_flat, (((0,), (1,)), ((), ())),
        precision=_HI,
    ).reshape(3, c, m)                                           # (3, C, M)
    wt0 = (
        w_col0[0] * dct[0] + w_col0[1] * dct[1] + w_col0[2] * dct[2]
    ).sum(0)
    wt1 = (
        w_col1[0] * dct[0] + w_col1[1] * dct[1] + w_col1[2] * dct[2]
    ).sum(0)
    rhs0 = -gr0 - wt0
    rhs1 = -gr1 - wt1
    return jnp.stack([i00 * rhs0 + i01 * rhs1, i01 * rhs0 + i11 * rhs1], -1)


def _lm_iteration_fast(
    cams, rays, lam, prob: BAProblem, pre: BAPrecomp, intr,
    cfg: SLAMConfig, axis_name=None,
):
    fs = cfg.ba_focal_scale
    u, g_c, s_corr, rhs_corr, local = _fast_terms(
        cams, rays, lam, prob, pre, intr, fs
    )
    if axis_name is not None:
        u, g_c, s_corr, rhs_corr = jax.lax.psum(
            (u, g_c, s_corr, rhs_corr), axis_name
        )
    s, rhs = schur_assemble(u, g_c, s_corr, rhs_corr, prob.cam_free, lam)
    chol = jax.scipy.linalg.cho_factor(s, lower=True)
    dc = jax.scipy.linalg.cho_solve(chol, rhs)     # replicated on all shards
    dr = _fast_back_substitute(dc, pre, local)     # shard-local
    # np (not jnp) constant: traced-in jnp constants become captured device
    # buffers that stall every dispatch on this backend (kernels/flow.py)
    dc_unscaled = dc.reshape(-1, 3) * np.array([1.0, 1.0, 1.0 / fs], np.float32)
    new_cams = cams + dc_unscaled * prob.cam_free[:, None]
    new_rays = rays + dr
    return new_cams, new_rays


def lm_iteration(
    cams, rays, lam, prob: BAProblem, intr, cfg: SLAMConfig, axis_name=None
):
    """One damped step: build, reduce, solve, back-substitute. Returns the
    candidate parameters (caller decides acceptance).

    With ``axis_name`` set (inside shard_map over ray shards), the camera
    system is psum-reduced over the mesh axis; ray elimination and back
    substitution stay shard-local (SURVEY.md §5, §8.4).

    Convenience wrapper that rebuilds the loop-invariant precomp; ``run``
    hoists it out of the LM loop instead.
    """
    return _lm_iteration_fast(
        cams, rays, lam, prob, precompute(prob), intr, cfg,
        axis_name=axis_name,
    )


class LMState(NamedTuple):
    """Checkpointable LM-loop carry (SURVEY.md §7: offline BA resumable per
    LM iteration — serialize with ``checkpoint.save_pytree`` between
    ``run_lm`` calls and a multi-host job restarts exactly where it was).
    """

    cams: jax.Array
    rays: jax.Array
    lam: jax.Array
    cost: jax.Array
    accepted: jax.Array
    iterations: jax.Array


def init_lm_state(
    prob: BAProblem, intr: Intrinsics, cfg: SLAMConfig, axis_name=None
) -> LMState:
    pre = precompute(prob)
    cost0 = fast_cost(prob.cams, prob.rays, prob, pre, intr)
    if axis_name is not None:
        cost0 = jax.lax.psum(cost0, axis_name)
    return LMState(
        cams=prob.cams,
        rays=prob.rays,
        lam=jnp.asarray(cfg.ba_lambda0, prob.cams.dtype),
        cost=cost0,
        accepted=jnp.asarray(0, jnp.int32),
        iterations=jnp.asarray(0, jnp.int32),
    )


def run_lm(
    prob: BAProblem,
    intr: Intrinsics,
    cfg: SLAMConfig,
    lm: LMState,
    num_iters: int | None = None,
    axis_name=None,
) -> LMState:
    """Advance the LM loop ``num_iters`` damped steps from ``lm``.

    Rejected steps keep parameters and raise lambda; accepted steps lower it
    (SURVEY.md §8.4 LM schedule). Everything stays on device. Works unchanged
    inside shard_map over ray shards when ``axis_name`` is given (a name or
    tuple of mesh axis names) — costs are psum-ed, the reduced camera solve
    is replicated, rays stay local. Chaining run_lm(10) twice (with a
    checkpoint roundtrip in between) is bitwise-identical to run_lm(20).
    """
    pre = precompute(prob)   # loop-invariant: XLA hoists it out of the scan

    def total_cost(cams, rays):
        c = fast_cost(cams, rays, prob, pre, intr)
        if axis_name is not None:
            c = jax.lax.psum(c, axis_name)
        return c

    def body(carry: LMState, _):
        cand_cams, cand_rays = _lm_iteration_fast(
            carry.cams, carry.rays, carry.lam, prob, pre, intr, cfg,
            axis_name=axis_name,
        )
        cand_cost = total_cost(cand_cams, cand_rays)
        ok = cand_cost < carry.cost
        new = LMState(
            cams=jnp.where(ok, cand_cams, carry.cams),
            rays=jnp.where(ok, cand_rays, carry.rays),
            lam=jnp.clip(
                jnp.where(
                    ok,
                    carry.lam * cfg.ba_lambda_down,
                    carry.lam * cfg.ba_lambda_up,
                ),
                1e-10,
                1e6,
            ),
            cost=jnp.where(ok, cand_cost, carry.cost),
            accepted=carry.accepted + ok.astype(jnp.int32),
            iterations=carry.iterations + 1,
        )
        return new, new.cost

    n = cfg.ba_iters if num_iters is None else num_iters
    lm, _ = jax.lax.scan(body, lm, None, length=n)
    return lm


def run(
    prob: BAProblem, intr: Intrinsics, cfg: SLAMConfig, axis_name=None
) -> BAResult:
    """Full LM loop with accept/reject, fixed iteration count (static shape).
    Convenience wrapper over init_lm_state + run_lm."""
    lm0 = init_lm_state(prob, intr, cfg, axis_name=axis_name)
    lm = run_lm(prob, intr, cfg, lm0, axis_name=axis_name)
    return BAResult(
        cams=lm.cams,
        rays=lm.rays,
        cost=lm.cost,
        initial_cost=lm0.cost,
        iterations=lm.iterations,
        accepted=lm.accepted,
    )


def huber_factors(
    cams, rays, prob: BAProblem, intr, huber_px: float
) -> jax.Array:
    """(M, C) Huber IRLS factors from the current residual norms: 1 inside
    ``huber_px``, sqrt(huber/|r|) beyond — squaring into the quadratic cost
    gives each outlier linear (not quadratic) influence."""
    pre = precompute(prob)
    *_, w, r0, r1 = _projection_comps(cams, rays, pre, intr)
    rn = jnp.sqrt(r0 * r0 + r1 * r1) / jnp.maximum(w, 1e-9)  # unweighted |r|
    wh = jnp.sqrt(jnp.minimum(1.0, huber_px / jnp.maximum(rn, 1e-9)))
    return jnp.where(w > 0, wh, 0.0).T                       # (M, C)


def run_robust(
    prob: BAProblem,
    intr,
    cfg: SLAMConfig,
    rounds: int | None = None,
    axis_name=None,
) -> BAResult:
    """Huber-IRLS robust BA (SURVEY.md §6 item 2 "+noise, outliers,
    dropouts"): alternate the quadratic LM solve with reweighting every
    observation by the Huber factor of its current residual norm
    (``cfg.ba_huber_px``), so gross outliers — teleported matches, aliased
    keyframe associations — get LINEAR instead of quadratic influence and
    stop dragging the minimum. rounds=0 degenerates to ``run``.

    The FIRST weights are computed at the INITIAL parameters (the tracked
    map is near the truth, so outliers already stand out there) — weighting
    after an unrobust solve would let the outliers corrupt the linearization
    point the weights are judged from. The returned ``initial_cost`` is the
    first round's starting cost; ``cost`` is under the final robust weights
    (not directly comparable — compare parameter error, not costs, across
    robustness settings).
    """
    rounds = cfg.ba_irls_rounds if rounds is None else rounds
    if rounds <= 0:
        return run(prob, intr, cfg, axis_name=axis_name)
    base_w = prob.obs_w
    init_cost = None
    for _ in range(rounds):
        wh = huber_factors(
            prob.cams, prob.rays, prob._replace(obs_w=base_w), intr,
            cfg.ba_huber_px,
        )
        prob = prob._replace(obs_w=base_w * wh)
        res = run(prob, intr, cfg, axis_name=axis_name)
        if init_cost is None:
            init_cost = res.initial_cost
        prob = prob._replace(cams=res.cams, rays=res.rays)
    return res._replace(initial_cost=init_cost)
