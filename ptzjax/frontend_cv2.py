"""OpenCV-features ingestion: the reference-parity frontend.

BASELINE.md config 1 runs the tracker on "reference feature matches" — SIFT
keypoints/descriptors as the reference's own vision layer produces them
(``slam_system/image_process.py`` ``detect_compute_sift``). This module
produces exactly that: cv2 SIFT on the host, padded into the same
``FrameFeatures`` tables the on-device kernels emit, so accuracy comparisons
isolate the SLAM math from detector quality (SURVEY.md §10 "hard parts":
SIFT parity is judged at the trajectory level).

Host-side and optional: import fails cleanly without OpenCV.
"""

from __future__ import annotations

import numpy as np

from ptzjax.config import SLAMConfig
from ptzjax.features import FrameFeatures

try:
    import cv2  # type: ignore

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


def has_cv2() -> bool:
    return _HAS_CV2


def extract_features_cv2(
    img: np.ndarray,
    cfg: SLAMConfig,
    mask: np.ndarray | None = None,
) -> FrameFeatures:
    """cv2 SIFT detect+compute -> padded FrameFeatures.

    Args:
      img: (H, W) grayscale in [0, 1] float or uint8.
      mask: (H, W) bool, True where detection is allowed.

    Returns:
      FrameFeatures with capacity cfg.max_keypoints; descriptors
      L2-normalized (SIFT's 0.2-clipped histograms, matching the unit-norm
      convention of the matcher).
    """
    if not _HAS_CV2:
        raise RuntimeError("OpenCV not available")
    if img.dtype != np.uint8:
        img8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    else:
        img8 = img
    m8 = None if mask is None else (mask.astype(np.uint8) * 255)
    sift = cv2.SIFT_create(nfeatures=cfg.max_keypoints)
    kps, desc = sift.detectAndCompute(img8, m8)

    cap = cfg.max_keypoints
    xy = np.zeros((cap, 2), np.float32)
    d = np.zeros((cap, 128), np.float32)
    valid = np.zeros((cap,), bool)
    if kps:
        order = np.argsort([-k.response for k in kps])[:cap]
        n = len(order)
        xy[:n] = np.array([kps[i].pt for i in order], np.float32)
        dn = desc[order].astype(np.float32)
        d[:n] = dn / np.maximum(np.linalg.norm(dn, axis=-1, keepdims=True), 1e-9)
        valid[:n] = True
    if d.shape[1] != cfg.kf_desc_dim:
        raise ValueError(
            f"cv2 SIFT is 128-d; cfg.kf_desc_dim={cfg.kf_desc_dim}"
        )
    return FrameFeatures(xy=xy, desc=d, valid=valid)


def _to_u8(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img
    lo, hi = float(img.min()), float(img.max())
    scale = 255.0 / (hi - lo) if hi > lo else 1.0
    return np.clip((img - lo) * scale, 0, 255).astype(np.uint8)


def track_features_cv2(
    img_prev: np.ndarray,
    img_next: np.ndarray,
    xy: np.ndarray,
    desc: np.ndarray,
    valid: np.ndarray,
    cfg: SLAMConfig,
    mask: np.ndarray | None = None,
    fb_tol: float = 1.0,
):
    """The reference's exact tracking-mode frontend: pyramidal KLT via
    ``cv2.calcOpticalFlowPyrLK`` with a forward-backward check
    (``slam_system/image_process.py`` ``optical_flow_matching`` — SURVEY.md
    §4.2), SIFT refill of dead slots. Surviving rows keep their previous
    descriptors (the reference carries positions only between detections).

    Returns:
      (xy (K, 2), desc (K, D), valid (K,), tracked (K,)) — same contract as
      ``frontend.track_features``.
    """
    if not _HAS_CV2:
        raise RuntimeError("OpenCV not available")
    xy = np.asarray(xy, np.float32).copy()
    desc = np.asarray(desc, np.float32).copy()
    valid = np.asarray(valid, bool)
    k = xy.shape[0]
    prev8, next8 = _to_u8(np.asarray(img_prev)), _to_u8(np.asarray(img_next))

    tracked = np.zeros((k,), bool)
    rows = np.flatnonzero(valid)
    if len(rows):
        pts = xy[rows].reshape(-1, 1, 2)
        lk = dict(
            winSize=(cfg.flow_patch, cfg.flow_patch),
            maxLevel=cfg.flow_levels - 1,
        )
        nxt, st, _ = cv2.calcOpticalFlowPyrLK(prev8, next8, pts, None, **lk)
        back, st2, _ = cv2.calcOpticalFlowPyrLK(next8, prev8, nxt, None, **lk)
        fb = np.linalg.norm((back - pts).reshape(-1, 2), axis=-1)
        h, w = next8.shape
        p = nxt.reshape(-1, 2)
        ok = (
            (st.reshape(-1) == 1) & (st2.reshape(-1) == 1) & (fb < fb_tol)
            & (p[:, 0] >= 2) & (p[:, 0] <= w - 3)
            & (p[:, 1] >= 2) & (p[:, 1] <= h - 3)
        )
        tracked[rows[ok]] = True
        xy[rows[ok]] = p[ok]

    # refill dead slots with fresh SIFT detections away from live tracks
    fresh = extract_features_cv2(img_next, cfg, mask=mask)
    if fresh.valid.any() and (~tracked).any():
        live = xy[tracked]
        cand = np.flatnonzero(fresh.valid)
        if len(live):
            d2 = ((fresh.xy[cand, None, :] - live[None, :, :]) ** 2).sum(-1)
            cand = cand[d2.min(axis=1) > cfg.min_refill_dist_px**2]
        free = np.flatnonzero(~tracked)
        take = min(len(free), len(cand))
        xy[free[:take]] = fresh.xy[cand[:take]]
        desc[free[:take]] = fresh.desc[cand[:take]]
        new_valid = tracked.copy()
        new_valid[free[:take]] = True
    else:
        new_valid = tracked.copy()
    return xy, desc, new_valid, tracked
