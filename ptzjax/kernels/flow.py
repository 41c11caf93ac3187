"""Pyramidal Lucas-Kanade optical flow at fixed-capacity keypoint tables.

The on-device equivalent of the reference's KLT tracking-mode matcher
(``slam_system/image_process.py`` ``optical_flow_matching`` via
``cv2.calcOpticalFlowPyrLK`` — SURVEY.md §2 layer 3, §4.2, §8.5). The SLAM
loop's default association is descriptor re-match (``ptzjax.match``); this
kernel completes frontend parity and gives a cheaper tracking mode when
descriptors don't need refreshing every frame.

Design (everything static-shape, one jit):
  * pyramid: ``levels`` 2x mean-pool downsamples (Python-unrolled — each
    level is a different static shape).
  * per level, coarse->fine: classic iterative LK. The template patch and
    its spatial-gradient normal matrix G (2x2 per keypoint) come from the
    *previous* frame and stay fixed across iterations; each
    ``lax.fori_loop`` step resamples the next frame at the current guess,
    forms the image-difference vector b, and applies the closed-form 2x2
    solve. All K keypoints advance together under ``vmap``.
  * patch sampling reuses the contiguous-slice trick from the descriptor
    kernel: one ``dynamic_slice`` of a (P+1, P+1) window per keypoint plus
    a 4-term blend of static shifts — every sample of a keypoint shares
    the same fractional offset, so the blend IS bilinear interpolation.
    The K windows are one XLA gather; nothing in the Newton loop gathers.
  * validity: G min-eigenvalue (texturedness, the Shi-Tomasi criterion),
    in-bounds check, residual bound, and an optional forward-backward
    consistency pass (track next->prev and demand round-trip < fb_tol px)
    — the same rejection stack OpenCV pipelines bolt onto KLT.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class FlowResult(NamedTuple):
    """Tracked keypoints in the next frame.

    Attributes:
      xy: (K, 2) tracked (x, y) positions.
      tracked: (K,) bool — input-valid, textured, converged in-bounds.
      residual: (K,) mean |I_next - I_prev| over the window at convergence,
        normalized by the template window's std (contrast-invariant).
    """

    xy: jax.Array
    tracked: jax.Array
    residual: jax.Array


def _binomial5(a: jax.Array) -> jax.Array:
    """Separable 5-tap binomial blur (1 4 6 4 1)/16 — the standard pyramid
    anti-aliasing filter. Edge-padded so borders don't darken."""
    # python-float taps fold into the fused stencil as literals
    k = (1 / 16.0, 4 / 16.0, 6 / 16.0, 4 / 16.0, 1 / 16.0)

    def conv(x, axis):
        x = jnp.moveaxis(x, axis, -1)
        xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(2, 2)], mode="edge")
        out = sum(k[i] * xp[..., i : i + x.shape[-1]] for i in range(5))
        return jnp.moveaxis(out, -1, axis)

    return conv(conv(a, 0), 1)


def build_pyramid(img: jax.Array, levels: int) -> list[jax.Array]:
    """Blur-then-2x-subsample pyramid, level 0 = full resolution. Without
    the blur, fine texture aliases into decorrelated noise at coarse levels
    and large motions never converge."""
    img = img.astype(jnp.float32)
    pyr = [img]
    for _ in range(1, levels):
        a = _binomial5(pyr[-1])
        h, w = a.shape
        a = a[: h - h % 2, : w - w % 2]
        pyr.append(a.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3)))
    return pyr


def _gather(
    pimg: jax.Array, ys: jax.Array, xs: jax.Array, size: int
) -> jax.Array:
    """(K, size, size) integer windows ``pimg[ys:ys+size, xs:xs+size]``:
    a vmapped ``dynamic_slice``, which XLA lowers to one gather."""
    return jax.vmap(
        lambda yy, xx: jax.lax.dynamic_slice(pimg, (yy, xx), (size, size))
    )(ys, xs)


def _sample_patches(img: jax.Array, xy: jax.Array, patch: int) -> jax.Array:
    """(K, patch, patch) bilinear patches centered on subpixel ``xy``:
    sample p of a patch sits exactly at xy + (p - (patch-1)/2) (odd patch
    sizes — the windowed einsum sampler in ``_lk_level`` uses the same
    convention, and the two MUST agree or LK converges half a pixel off)."""
    h, w = img.shape
    c = patch // 2
    win = patch + 1
    pad = c + 1
    pimg = jnp.pad(img, pad, mode="edge")

    y0 = jnp.floor(xy[:, 1]).astype(jnp.int32)
    x0 = jnp.floor(xy[:, 0]).astype(jnp.int32)
    fy = jnp.clip(xy[:, 1] - y0, 0.0, 1.0)[:, None, None]
    fx = jnp.clip(xy[:, 0] - x0, 0.0, 1.0)[:, None, None]
    ys = jnp.clip(y0 - c + pad, 0, h + 2 * pad - win)
    xs = jnp.clip(x0 - c + pad, 0, w + 2 * pad - win)
    windows = _gather(pimg, ys, xs, win)                 # (K, win, win)
    return (
        windows[:, :-1, :-1] * (1 - fy) * (1 - fx)
        + windows[:, :-1, 1:] * (1 - fy) * fx
        + windows[:, 1:, :-1] * fy * (1 - fx)
        + windows[:, 1:, 1:] * fy * fx
    )                                                    # (K, patch, patch)


# in-level displacement budget (px) the per-keypoint window covers; LK's
# own convergence basin is ~patch/2, so this is not the limiting factor.
# 5 px: after a coarse-level init the in-level correction is < 2 px, and
# the anchored backward check only needs to DETECT divergence (a track
# escaping the window clamps at its edge and fails fb_tol). The sampling
# einsums scale with (patch + 2*_DISP + 1)^2 — 8 -> 5 cut them ~40%
# (3.1 -> 1.0 ms per 512-kp 720p pair combined with the r5 fb/iteration
# changes; tracks and CLI accuracy unchanged on the oracle suites).
_DISP = 5


def _extract_windows(
    img: jax.Array, xy: jax.Array, win: int, anchor_off: int
):
    """(K, win, win) integer-aligned windows whose (anchor_off, anchor_off)
    pixel sits at round(xy). Returns (windows, anchor) with anchor the
    integer position of window pixel (0, 0) in image coordinates."""
    h, w = img.shape
    pad = win
    pimg = jnp.pad(img, pad, mode="edge")
    y0 = jnp.round(xy[:, 1]).astype(jnp.int32) - anchor_off
    x0 = jnp.round(xy[:, 0]).astype(jnp.int32) - anchor_off
    ys = jnp.clip(y0 + pad, 0, h + 2 * pad - win)
    xs = jnp.clip(x0 + pad, 0, w + 2 * pad - win)
    windows = _gather(pimg, ys, xs, win)
    anchor = jnp.stack([xs - pad, ys - pad], -1).astype(jnp.float32)  # (K, 2)
    return windows, anchor


def _sel_weights(pos: jax.Array, patch: int, win: int) -> jax.Array:
    """(K, patch, win) bilinear row/col selection matrices: row p of the
    output samples window coordinate pos + p. Positions are clamped to the
    window (edge behavior), matching edge-padded direct sampling."""
    p = jnp.arange(patch, dtype=jnp.float32)[None, :, None]   # (1, P, 1)
    wco = jnp.arange(win, dtype=jnp.float32)[None, None, :]   # (1, 1, W)
    t = jnp.clip(pos[:, None, None] + p, 0.0, win - 1.0)
    return jnp.clip(1.0 - jnp.abs(t - wco), 0.0, 1.0)         # (K, P, W)


def _select(sy: jax.Array, windows: jax.Array, sx: jax.Array) -> jax.Array:
    """(K, P, P) bilinear samples: sy @ window @ sx^T per keypoint.

    HIGH is TF32 on the H100's tensor cores (10-bit mantissa, unit
    roundoff ~4.9e-4) and fp32 on the CPU. LK needs ~1e-3 relative
    accuracy here for stable subpixel convergence, which TF32 meets;
    tests/test_precision.py runs the closed KLT loop with these products
    rounded to TF32, and chip_smoke.py runs it on the card."""
    return jnp.einsum(
        "kpw,kwv,kqv->kpq", sy, windows, sx,
        precision=jax.lax.Precision.HIGH,
    )


def _lk_level(prev, nxt, xy_prev, guess, patch: int, iters: int):
    """One pyramid level of iterative LK for all keypoints.

    Per-keypoint windows of the next frame are gathered ONCE (one batched
    dynamic_slice), and every Newton iteration samples inside them with
    bilinear selection-matrix einsums — batched (P, W) x (W, W) x (W, P)
    matmuls, zero gathers in the loop, where resampling at each guess
    would gather K windows per iteration per level per direction.

    Returns (refined guess (K, 2), min_eig (K,), residual (K,)).
    """
    # template + fixed spatial gradients from the previous frame
    tmpl_w = _sample_patches(prev, xy_prev, patch + 2)   # (K, P+2, P+2)
    tmpl = tmpl_w[:, 1:-1, 1:-1]
    gx = 0.5 * (tmpl_w[:, 1:-1, 2:] - tmpl_w[:, 1:-1, :-2])
    gy = 0.5 * (tmpl_w[:, 2:, 1:-1] - tmpl_w[:, :-2, 1:-1])
    gxx = (gx * gx).sum(axis=(1, 2))
    gxy = (gx * gy).sum(axis=(1, 2))
    gyy = (gy * gy).sum(axis=(1, 2))
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    min_eig = 0.5 * (tr - jnp.sqrt(jnp.maximum(tr * tr - 4.0 * det, 0.0)))
    min_eig = min_eig / (patch * patch)  # per-pixel, like cv2's minEigThreshold
    inv_det = jnp.where(det > 1e-12, 1.0 / jnp.maximum(det, 1e-12), 0.0)

    # next-frame windows around the initial guess, wide enough for the
    # whole in-level search (_DISP px each way)
    win = patch + 2 * _DISP + 1
    windows, anchor = _extract_windows(nxt, guess, win, _DISP + patch // 2)
    def sample(g):
        # corner of the patch in window coordinates (fractional)
        corner = g - anchor - (patch - 1) / 2.0           # (K, 2) x, y
        sy = _sel_weights(corner[:, 1], patch, win)       # (K, P, W)
        sx = _sel_weights(corner[:, 0], patch, win)
        return _select(sy, windows, sx)                   # (K, P, P)

    def body(_, g):
        di = tmpl - sample(g)                             # (K, P, P)
        bx = (di * gx).sum(axis=(1, 2))
        by = (di * gy).sum(axis=(1, 2))
        dx = inv_det * (gyy * bx - gxy * by)
        dy = inv_det * (gxx * by - gxy * bx)
        return g + jnp.stack([dx, dy], -1)

    guess = jax.lax.fori_loop(0, iters, body, guess)
    # residual normalized by template contrast: a converged track scores
    # ~0.05, a wrong lock on decorrelated texture ~1. This catches the one
    # failure forward-backward can't — symmetric non-convergence (LK leaves
    # the point in place in both directions, round-trip error ~0).
    tstd = tmpl.std(axis=(1, 2))
    resid = jnp.abs(tmpl - sample(guess)).mean(axis=(1, 2))
    resid = resid / jnp.maximum(tstd, 1e-6)
    return guess, min_eig, resid


def _lk_forward(prev_pyr, next_pyr, xy, patch: int, iters: int):
    """Coarse-to-fine LK through prebuilt pyramids; returns
    (xy_next, min_eig@level0, residual@level0).

    Iteration schedule: upper (coarse) levels run ``max(3, iters // 2)``
    Newton steps — their only job is to land the guess inside the next
    level's convergence basin (~patch/2 px), which quadratic LK reaches in
    2-3 steps; only level 0 runs the full ``iters`` for subpixel accuracy.
    Full-iteration coarse levels measured 0 tracking-quality gain for ~35%
    of the forward cost."""
    levels = len(prev_pyr)
    scale = 2.0 ** (levels - 1)
    guess = xy / scale
    min_eig = resid = None
    coarse_iters = max(3, iters // 2)
    for lvl in range(levels - 1, -1, -1):
        s = 2.0**lvl
        guess, min_eig, resid = _lk_level(
            prev_pyr[lvl], next_pyr[lvl], xy / s, guess, patch,
            iters if lvl == 0 else coarse_iters,
        )
        if lvl > 0:
            guess = guess * 2.0
    return guess, min_eig, resid


@partial(
    jax.jit,
    static_argnames=("levels", "patch", "iters", "fb_check"),
)
def lk_track(
    img_prev: jax.Array,
    img_next: jax.Array,
    xy: jax.Array,
    valid: jax.Array,
    *,
    levels: int = 4,
    patch: int = 13,
    iters: int = 8,
    min_eig: float = 1e-3,
    max_residual: float = 0.5,
    fb_check: bool = True,
    fb_tol: float = 1.0,
    border: float = 2.0,
) -> FlowResult:
    """Track keypoints from ``img_prev`` to ``img_next``.

    Args:
      img_prev, img_next: (H, W) float grayscale frames.
      xy: (K, 2) keypoint positions (x, y) in ``img_prev``.
      valid: (K,) bool input mask.
      levels: pyramid levels (handles up to ~``2**levels * patch/2`` px
        of motion).
      patch: LK window side (odd).
      iters: Newton iterations per level.
      min_eig: Shi-Tomasi per-pixel min-eigenvalue threshold relative to the
        image's gradient scale (texturedness gate).
      max_residual: reject tracks whose mean abs window error exceeds this
        fraction of the template's own contrast (std) — contrast-invariant.
      fb_check: also track next->prev and reject round-trips > ``fb_tol`` px.
      border: reject tracks within this many pixels of the image edge.

    Returns:
      FlowResult with the same capacity K.
    """
    img_prev = img_prev.astype(jnp.float32)
    img_next = img_next.astype(jnp.float32)
    prev_pyr = build_pyramid(img_prev, levels)
    next_pyr = build_pyramid(img_next, levels)

    new_xy, eig, resid = _lk_forward(prev_pyr, next_pyr, xy, patch, iters)

    h, w = img_next.shape
    ok = (
        valid
        & (eig > min_eig)
        & (resid < max_residual)
        & (new_xy[:, 0] >= border)
        & (new_xy[:, 0] <= w - 1 - border)
        & (new_xy[:, 1] >= border)
        & (new_xy[:, 1] <= h - 1 - border)
        & jnp.isfinite(new_xy).all(axis=-1)
    )
    if fb_check:
        # backward CHECK, not a backward search: the expected round-trip
        # destination is known (the original xy), so the backward track
        # runs a single full-resolution LK level with its window anchored
        # at xy — template from img_next at new_xy, searched in img_prev.
        # A correct forward track converges back to ~xy (round-trip error
        # ~tenths of a px); a wrong lock either diverges inside the +-_DISP px
        # window or clamps at its edge, failing fb_tol either way. This
        # replaces a full backward pyramid descent (4 levels x iters) at
        # identical rejection power on the oracle suite: initializing at
        # the answer only biases ACCEPTANCE of tracks whose textures
        # actually round-trip, which is the definition of a good track;
        # symmetric non-convergence is caught by the residual gate.
        back_xy, _, _ = _lk_level(
            next_pyr[0], prev_pyr[0], new_xy, xy, patch, iters
        )
        ok = ok & (jnp.linalg.norm(back_xy - xy, axis=-1) < fb_tol)

    new_xy = jnp.where(ok[:, None], new_xy, xy)
    return FlowResult(xy=new_xy, tracked=ok, residual=resid)
