"""Keypoint detection: Harris response + 3x3 NMS + top-k table.

The on-device replacement for the reference's OpenCV SIFT detector
(``slam_system/image_process.py`` ``detect_compute_sift`` — SURVEY.md §2
layer 3, §8.5). We use a Harris corner response rather than a DoG pyramid:
broadcast PTZ video has no in-plane rotation and modest per-frame scale
change, so single-scale corners + the descriptor's normalization carry the
matching load, and one response pass is a short chain of elementwise
stencils that XLA fuses, where a variable-octave pyramid is not.

``harris_response`` / ``_nms3`` are plain jax.numpy; the tests check them
against a NumPy oracle (``tests/oracle/harris_np.py``).

The detector is masked (player boxes / static overlays): masked pixels get
response -inf, mirroring the reference's keypoint masking behavior.

Output is a fixed-capacity keypoint table (xy, score, valid) — static
shapes for everything downstream (SURVEY.md §10 "hard parts").
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_NEG = -1e30


class KeypointTable(NamedTuple):
    """Fixed-capacity detector output.

    Attributes:
      xy: (K, 2) fp32 pixel coordinates (x, y), subpixel-refined.
      score: (K,) fp32 response at the keypoint.
      valid: (K,) bool.
    """

    xy: jax.Array
    score: jax.Array
    valid: jax.Array


# --- reference (pure jax) ----------------------------------------------------


def _smooth5(x: jax.Array) -> jax.Array:
    """Separable 5-tap binomial smoothing (approx Gaussian sigma~1)."""
    # python-float taps fold into the fused stencil as literals
    k = (1 / 16.0, 4 / 16.0, 6 / 16.0, 4 / 16.0, 1 / 16.0)

    def conv1d(a, axis):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (2, 2)
        a = jnp.pad(a, pad, mode="edge")
        out = jnp.zeros_like(x)
        for i in range(5):
            sl = [slice(None), slice(None)]
            sl[axis] = slice(i, i + x.shape[axis])
            out = out + k[i] * a[tuple(sl)]
        return out

    return conv1d(conv1d(x, 0), 1)


def _gradients(img: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Central-difference gradients with edge replication."""
    p = jnp.pad(img, 1, mode="edge")
    ix = 0.5 * (p[1:-1, 2:] - p[1:-1, :-2])
    iy = 0.5 * (p[2:, 1:-1] - p[:-2, 1:-1])
    return ix, iy


def harris_response(img: jax.Array, k: float = 0.04) -> jax.Array:
    """Harris corner response R = det(M) - k tr(M)^2 on a (H, W) image.

    M is the 5x5-binomial-smoothed gradient structure tensor.
    """
    ix, iy = _gradients(img.astype(jnp.float32))
    ixx = _smooth5(ix * ix)
    iyy = _smooth5(iy * iy)
    ixy = _smooth5(ix * iy)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - k * tr * tr


def _nms3(resp: jax.Array) -> jax.Array:
    """Suppress non-maxima: keep value only where it is the strict max of
    its 3x3 neighborhood (ties broken toward the top-left by the >= / >
    split, so a plateau yields exactly one winner)."""
    p = jnp.pad(resp, 1, mode="constant", constant_values=_NEG)
    neigh_prev = jnp.stack(
        [
            p[:-2, :-2], p[:-2, 1:-1], p[:-2, 2:],
            p[1:-1, :-2],
        ]
    ).max(0)
    neigh_next = jnp.stack(
        [
            p[1:-1, 2:],
            p[2:, :-2], p[2:, 1:-1], p[2:, 2:],
        ]
    ).max(0)
    keep = (resp > neigh_prev) & (resp >= neigh_next)
    return jnp.where(keep, resp, _NEG)


def _subpixel(resp: jax.Array, ys: jax.Array, xs: jax.Array):
    """Quadratic 1D fits along x and y through the NMS winners."""
    h, w = resp.shape
    yc = jnp.clip(ys, 1, h - 2)
    xc = jnp.clip(xs, 1, w - 2)
    c = resp[yc, xc]
    dx = 0.5 * (resp[yc, xc + 1] - resp[yc, xc - 1])
    dxx = resp[yc, xc + 1] + resp[yc, xc - 1] - 2.0 * c
    dy = 0.5 * (resp[yc + 1, xc] - resp[yc - 1, xc])
    dyy = resp[yc + 1, xc] + resp[yc - 1, xc] - 2.0 * c
    off_x = jnp.where(jnp.abs(dxx) > 1e-12, -dx / dxx, 0.0)
    off_y = jnp.where(jnp.abs(dyy) > 1e-12, -dy / dyy, 0.0)
    return jnp.clip(off_x, -0.5, 0.5), jnp.clip(off_y, -0.5, 0.5)


@partial(jax.jit, static_argnames=("max_keypoints", "exact_topk"))
def detect_keypoints(
    img: jax.Array,
    max_keypoints: int,
    threshold: float = 1e-4,
    mask: jax.Array | None = None,
    border: int = 8,
    exact_topk: bool = False,
) -> KeypointTable:
    """Detect up to ``max_keypoints`` Harris corners.

    Args:
      img: (H, W) grayscale, any float dtype (values ~[0, 1]).
      threshold: response floor relative to the image's max response
        (scale-free: real thresholding is on ``resp > threshold * max``).
      mask: optional (H, W) bool, True where detection is ALLOWED (the
        complement of the reference's player boxes).
      border: pixels to ignore at the image edge.
      exact_topk: select candidates with ``lax.top_k``. The default,
        ``lax.approx_max_k`` at recall_target=0.99, is an approximate
        selection only on backends that implement it; on the GPU and the CPU
        XLA lowers it to an exact sort-and-slice, so both settings keep the
        same keypoints there (equal scores may come in another order).

    Returns:
      KeypointTable sorted by descending score.
    """
    h, w = img.shape
    resp = harris_response(img)
    sup = _nms3(resp)

    if mask is not None:
        sup = jnp.where(mask, sup, _NEG)
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    inb = (
        (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
    )
    sup = jnp.where(inb, sup, _NEG)

    floor = threshold * jnp.maximum(sup.max(), 1e-20)
    flat = sup.reshape(-1)
    if exact_topk:
        score, idx = jax.lax.top_k(flat, max_keypoints)
    else:
        score, idx = jax.lax.approx_max_k(
            flat, max_keypoints, recall_target=0.99
        )
    ys = idx // w
    xs = idx % w
    valid = score > floor

    # subpixel refinement reads the raw (unsuppressed) response map
    off_x, off_y = _subpixel(resp, ys, xs)
    xy = jnp.stack(
        [xs.astype(jnp.float32) + off_x, ys.astype(jnp.float32) + off_y],
        axis=-1,
    )
    return KeypointTable(
        xy=jnp.where(valid[:, None], xy, 0.0),
        score=jnp.where(valid, score, 0.0),
        valid=valid,
    )
