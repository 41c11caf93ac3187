"""SIFT-style descriptors at fixed-capacity keypoint tables.

The on-device replacement for the descriptor half of the reference's OpenCV
SIFT (``slam_system/image_process.py`` ``detect_compute_sift`` — SURVEY.md
§2 layer 3, §8.5): a 4x4-cell x 8-orientation gradient histogram over a
16x16 patch, Gaussian-weighted, bilinearly soft-binned over space and
orientation, L2-normalized with the standard 0.2 clip-and-renormalize.

We compute the *upright* variant (no per-keypoint dominant-orientation
rotation): PTZ broadcast cameras pan/tilt/zoom but do not roll, so patch
orientation is stable across frames and the rotation step would only add
gather traffic. This matches how the reference's matches behave on its
footage while keeping the kernel one fused gather + dense einsum.

Shapes are static: (K, 2) keypoints in, (K, 128) descriptors out, with the
input validity mask passed through.

Performance note: every sample position of one keypoint shares the SAME
fractional offset (the sample grid is integer-spaced around the subpixel
center), so bilinear sampling factors into (a) one contiguous patch
extraction per keypoint (batched ``dynamic_slice`` — whole rows, no
scattered gathers) and (b) a 4-term blend of static shifts of that patch.
Gradients are central differences inside the patch (linear ops commute
with the bilinear blend, so this is exact). The histogram accumulation is
an einsum over precomputed soft-binning weights, a batched matrix product
for XLA.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PATCH = 16          # patch side (pixels)
CELLS = 4           # spatial cells per side
ORI_BINS = 8
DESC_DIM = CELLS * CELLS * ORI_BINS  # 128

# scaled-sampling window (PTZ zoom normalization): big enough to resample a
# (PATCH+2)-sample grid at spacing up to MAX_SCALE from its center
MAX_SCALE = 2.5
SCALED_WIN = 46


def _patch_grid() -> tuple[jnp.ndarray, jnp.ndarray]:
    """Sample offsets relative to the keypoint: PATCH x PATCH centered."""
    c = (PATCH - 1) / 2.0
    off = jnp.arange(PATCH, dtype=jnp.float32) - c
    dy, dx = jnp.meshgrid(off, off, indexing="ij")
    return dy.reshape(-1), dx.reshape(-1)  # (P*P,)


def _spatial_weights() -> jnp.ndarray:
    """(P*P, CELLS*CELLS) bilinear cell weights x Gaussian window."""
    dy, dx = _patch_grid()
    sigma = PATCH / 2.0
    gauss = jnp.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    # cell coordinate in [ -0.5, CELLS-0.5 ]
    cell = (jnp.stack([dy, dx], -1) + PATCH / 2.0) / (PATCH / CELLS) - 0.5
    w = []
    for cy in range(CELLS):
        for cx in range(CELLS):
            wy = jnp.clip(1.0 - jnp.abs(cell[:, 0] - cy), 0.0, 1.0)
            wx = jnp.clip(1.0 - jnp.abs(cell[:, 1] - cx), 0.0, 1.0)
            w.append(wy * wx)
    return jnp.stack(w, -1) * gauss[:, None]  # (P*P, C*C)


def _window_starts(img: jax.Array, xy: jax.Array, win: int):
    """Shared geometry of the window extraction: padded image, integer
    window starts, and fractional offsets."""
    h, w = img.shape
    half = win // 2
    pad = half + 1
    pimg = jnp.pad(img, pad, mode="edge")
    y0 = jnp.floor(xy[:, 1] + 0.5).astype(jnp.int32)
    x0 = jnp.floor(xy[:, 0] + 0.5).astype(jnp.int32)
    fy = jnp.clip(xy[:, 1] + 0.5 - y0, 0.0, 1.0)[:, None, None]
    fx = jnp.clip(xy[:, 0] + 0.5 - x0, 0.0, 1.0)[:, None, None]
    # sub row i samples y + (i - (win-1)/2): symmetric half-integer grid
    ys = jnp.clip(y0 - half + pad, 0, h + 2 * pad - win - 1)
    xs = jnp.clip(x0 - half + pad, 0, w + 2 * pad - win - 1)
    return pimg, ys, xs, fy, fx


def _blend(patches, fy, fx, win: int) -> jax.Array:
    """4-shift bilinear blend over (K, >=win+1, >=win+1) patches — all
    samples of one keypoint share the same fractional offset, so the blend
    IS the interpolation."""
    return (
        patches[:, :win, :win] * (1 - fy) * (1 - fx)
        + patches[:, :win, 1 : win + 1] * (1 - fy) * fx
        + patches[:, 1 : win + 1, :win] * fy * (1 - fx)
        + patches[:, 1 : win + 1, 1 : win + 1] * fy * fx
    )                                                    # (K, win, win)


def _extract_aligned(img: jax.Array, xy: jax.Array, win: int) -> jax.Array:
    """Per-keypoint (win, win) windows, subpixel-aligned to the keypoint.

    Returned window center (index (win-1)/2 + 0.5 convention) sits exactly
    on the keypoint. The vmapped ``dynamic_slice`` of one contiguous
    (win+1, win+1) window per keypoint lowers to a single XLA gather.
    """
    pimg, ys, xs, fy, fx = _window_starts(img, xy, win)
    patches = jax.vmap(
        lambda yy, xx: jax.lax.dynamic_slice(
            pimg, (yy, xx), (win + 1, win + 1)
        )
    )(ys, xs)                                            # (K, win+1, win+1)
    return _blend(patches, fy, fx, win)


def _resample_matrix(scale: jax.Array, n_out: int, win: int) -> jax.Array:
    """(n_out, win) shared bilinear resampling weights: output sample i sits
    at (i - (n_out-1)/2) * scale from the window center. ``scale`` is a
    traced per-frame scalar — weights are data, shapes are static."""
    off = (jnp.arange(n_out, dtype=jnp.float32) - (n_out - 1) / 2.0) * scale
    pos = off + (win - 1) / 2.0                          # (n_out,)
    j = jnp.arange(win, dtype=jnp.float32)
    return jnp.clip(1.0 - jnp.abs(pos[:, None] - j[None, :]), 0.0, 1.0)


@jax.jit
def describe_keypoints(
    img: jax.Array,
    xy: jax.Array,
    valid: jax.Array,
    scale: jax.Array | None = None,
) -> jax.Array:
    """Compute (K, 128) unit-norm upright-SIFT descriptors.

    Args:
      img: (H, W) grayscale float image.
      xy: (K, 2) subpixel keypoint positions (x, y).
      valid: (K,) bool; invalid rows return zero descriptors.
      scale: optional per-frame sample spacing in pixels (a traced scalar).
        This is the PTZ zoom normalization (SURVEY.md §8.5; the reference's
        SIFT is scale-invariant via a pyramid): focal length is state, so
        sampling at ``scale = f / f_ref`` keeps the descriptor's ANGULAR
        footprint constant across zoom — no octave pyramid needed. Clamped
        to [1/MAX_SCALE, MAX_SCALE]. None = fixed 1-pixel spacing (slightly
        cheaper; identical to scale=1).

    Returns:
      (K, 128) fp32, L2-normalized per row (zeros where invalid).
    """
    img = img.astype(jnp.float32)

    if scale is None:
        sub = _extract_aligned(img, xy, PATCH + 2)       # (K, P+2, P+2)
    else:
        s = jnp.clip(
            jnp.asarray(scale, jnp.float32), 1.0 / MAX_SCALE, MAX_SCALE
        )
        windows = _extract_aligned(img, xy, SCALED_WIN)  # (K, W, W)
        r = _resample_matrix(s, PATCH + 2, SCALED_WIN)   # (P+2, W)
        # separable shared-weight resample: two small batched matmuls
        sub = jnp.einsum(
            "iw,kwv,jv->kij", r, windows, r,
            preferred_element_type=jnp.float32,
        )                                                # (K, P+2, P+2)

    # central-difference gradients inside the aligned patch
    gxs = 0.5 * (sub[:, 1:-1, 2:] - sub[:, 1:-1, :-2])   # (K, P, P)
    gys = 0.5 * (sub[:, 2:, 1:-1] - sub[:, :-2, 1:-1])
    gxs = gxs.reshape(-1, PATCH * PATCH)                 # (K, P2)
    gys = gys.reshape(-1, PATCH * PATCH)
    mag = jnp.sqrt(gxs * gxs + gys * gys + 1e-12)
    ori = jnp.arctan2(gys, gxs)               # [-pi, pi)

    # soft orientation binning: linear split across the two nearest bins
    b = (ori / (2.0 * jnp.pi) + 0.5) * ORI_BINS  # [0, 8)
    b0 = jnp.floor(b)
    fb = b - b0
    b0i = jnp.mod(b0.astype(jnp.int32), ORI_BINS)
    b1i = jnp.mod(b0i + 1, ORI_BINS)
    onehot0 = jax.nn.one_hot(b0i, ORI_BINS, dtype=jnp.float32)
    onehot1 = jax.nn.one_hot(b1i, ORI_BINS, dtype=jnp.float32)
    ori_w = onehot0 * (1.0 - fb)[..., None] + onehot1 * fb[..., None]

    spatial = _spatial_weights()              # (P2, C2)
    # hist[k, c, o] = sum_p mag[k,p] * spatial[p,c] * ori_w[k,p,o]
    hist = jnp.einsum(
        "kp,pc,kpo->kco", mag, spatial, ori_w,
        preferred_element_type=jnp.float32,
    )
    desc = hist.reshape(-1, DESC_DIM)

    # SIFT normalization: L2 -> clip 0.2 -> L2
    desc = desc / jnp.maximum(
        jnp.linalg.norm(desc, axis=-1, keepdims=True), 1e-9
    )
    desc = jnp.minimum(desc, 0.2)
    desc = desc / jnp.maximum(
        jnp.linalg.norm(desc, axis=-1, keepdims=True), 1e-9
    )
    return jnp.where(valid[:, None], desc, 0.0)
