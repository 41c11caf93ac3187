"""Image frontend: raw frames -> fixed-capacity ``FrameFeatures``.

The on-device analogue of the reference's per-frame OpenCV call sequence
(``slam_system/image_process.py`` ``detect_compute_sift`` + masking —
SURVEY.md §2 layer 3, §4.1/§4.2): one jitted pipeline running the Harris
detector, the upright-SIFT descriptor, and the padding/mask logic on
device. The output plugs straight into ``PTZSlam.step`` /
``run_segment`` — the SLAM loop is agnostic to whether features came from
here, from OpenCV ingestion (``ptzjax.io``), or from the synthetic oracle.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ptzjax.config import SLAMConfig
from ptzjax.kernels.descriptor import describe_keypoints
from ptzjax.kernels.detect import detect_keypoints


def _desc_scale(cfg: SLAMConfig, focal) -> jax.Array | None:
    """Per-frame descriptor sample spacing from the current focal estimate
    (zoom normalization). None when disabled or no
    focal estimate is available.

    ``descriptor_f_ref = -1`` (AUTO) must be resolved to a concrete focal
    before this point — ``PTZSlam.init`` does it from the bootstrap pose,
    and the CLI from the run's init pose. Hitting the sentinel here with a
    live focal means a library caller skipped that step; warn (at trace
    time) instead of silently dropping zoom normalization."""
    if focal is None:
        return None
    if cfg.descriptor_f_ref < 0:
        import warnings

        warnings.warn(
            "descriptor_f_ref=-1 (AUTO) reached the frontend unresolved: "
            "zoom normalization is DISABLED for this trace. Resolve it "
            "first (cfg.replace(descriptor_f_ref=<init focal>)) or drive "
            "the loop through PTZSlam.init, which resolves AUTO from the "
            "bootstrap pose.",
            stacklevel=2,
        )
        return None
    if cfg.descriptor_f_ref == 0:
        return None
    return jnp.asarray(focal, jnp.float32) / cfg.descriptor_f_ref


@partial(jax.jit, static_argnames=("cfg",))
def extract_features(
    img: jax.Array,
    cfg: SLAMConfig,
    mask: jax.Array | None = None,
    focal: jax.Array | None = None,
):
    """Detect + describe one grayscale frame.

    Args:
      img: (H, W) float grayscale.
      mask: optional (H, W) bool, True where detection is allowed (the
        complement of the reference's player bounding boxes).
      focal: optional current focal-length estimate; with
        cfg.descriptor_f_ref set, descriptors sample at f/f_ref spacing so
        their angular footprint is zoom-invariant.

    Returns:
      (xy (K, 2), desc (K, D), valid (K,)) with K = cfg.max_keypoints.
    """
    kp = detect_keypoints(
        img,
        max_keypoints=cfg.max_keypoints,
        threshold=cfg.detector_threshold,
        mask=mask,
    )
    desc = describe_keypoints(
        img, kp.xy, kp.valid, scale=_desc_scale(cfg, focal)
    )
    return kp.xy, desc, kp.valid


@partial(jax.jit, static_argnames=("cfg",))
def track_features(
    img_prev: jax.Array,
    img_next: jax.Array,
    xy: jax.Array,
    valid: jax.Array,
    cfg: SLAMConfig,
    mask: jax.Array | None = None,
    focal: jax.Array | None = None,
):
    """KLT-mode frontend step: track the existing keypoint table into the
    next frame, refill dead slots with fresh detections, refresh descriptors.

    The flow analogue of the reference's per-frame
    ``optical_flow_matching`` + re-detection loop (SURVEY.md §4.2): LK flow
    carries keypoints between frames (cheap — no full detect pass needed for
    surviving points' positions), fresh corners claim the freed slots, and
    descriptors are recomputed at the new positions so the SLAM loop's gated
    descriptor re-match re-associates tracked points with their EKF slots
    essentially for free (same descriptor content, within-gate positions).

    Args:
      img_prev, img_next: (H, W) float grayscale frames.
      xy: (K, 2) keypoint table from the previous frame.
      valid: (K,) bool table mask.
      mask: optional (H, W) bool detection mask for the refill pass (True
        where detection is allowed — player-box complement).

    Returns:
      (xy (K, 2), desc (K, D), valid (K,), tracked (K,)) — ``tracked`` marks
      rows that survived flow (vs. freshly detected or dead).
    """
    from ptzjax.kernels.flow import lk_track

    k = xy.shape[0]
    res = lk_track(
        img_prev, img_next, xy, valid,
        levels=cfg.flow_levels, patch=cfg.flow_patch, iters=cfg.flow_iters,
        fb_tol=cfg.track_gate_px / 4.0,
    )
    tracked = res.tracked

    # refill: detect on the next frame, drop detections that landed on a
    # surviving track (min-distance suppression), pack into free slots
    kp = detect_keypoints(
        img_next,
        max_keypoints=k,
        threshold=cfg.detector_threshold,
        mask=mask,
    )
    d2 = ((kp.xy[:, None, :] - res.xy[None, :, :]) ** 2).sum(-1)
    near_track = (d2 < cfg.min_refill_dist_px**2) & tracked[None, :]
    fresh = kp.valid & ~near_track.any(axis=1)

    free = ~tracked
    free_rank = jnp.cumsum(free.astype(jnp.int32)) - 1
    slot_of_rank = jnp.full((k,), k, jnp.int32).at[
        jnp.where(free, free_rank, k)
    ].set(jnp.arange(k, dtype=jnp.int32), mode="drop")
    fresh_rank = jnp.cumsum(fresh.astype(jnp.int32)) - 1
    num_free = free.sum()
    fresh_ok = fresh & (fresh_rank < num_free)
    target = jnp.where(fresh_ok, slot_of_rank[jnp.clip(fresh_rank, 0, k - 1)], k)

    new_xy = res.xy.at[target].set(kp.xy, mode="drop")
    new_valid = tracked.at[target].set(True, mode="drop")
    desc = describe_keypoints(
        img_next, new_xy, new_valid, scale=_desc_scale(cfg, focal)
    )
    return new_xy, desc, new_valid, tracked


def extract_sequence(imgs, cfg: SLAMConfig, masks=None):
    """Batch feature extraction over a (T, H, W) stack via ``lax.map``
    (sequential on device: one frame's maps live in device memory at a
    time)."""
    imgs = jnp.asarray(imgs)
    if masks is None:
        return jax.lax.map(lambda im: extract_features(im, cfg), imgs)
    return jax.lax.map(
        lambda args: extract_features(args[0], cfg, mask=args[1]),
        (imgs, jnp.asarray(masks)),
    )
