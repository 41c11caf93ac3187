"""Single dataclass config for the whole engine (SURVEY.md §7: the reference
hard-codes thresholds in scripts; we centralize them)."""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    """All tunable thresholds and capacities.

    Capacities are static so every jitted computation has fixed shapes
    (SURVEY.md §10 "hard parts": fixed capacities + masks).
    """

    # --- image / detector ---
    image_width: int = 1280
    image_height: int = 720
    max_keypoints: int = 512          # per-frame detector cap (padded table)
    detector_threshold: float = 0.01  # Harris/DoG response floor

    # --- descriptor zoom normalization (SURVEY.md §8.5) ---
    # focal is EKF state, so descriptors can keep a constant ANGULAR
    # footprint by sampling at scale = f / descriptor_f_ref instead of
    # building a scale pyramid (the reference gets this from SIFT octaves).
    # -1 = AUTO (the default): resolved to a concrete focal before tracing
    # — the CLI uses the run's init pose, PTZSlam.init the bootstrap pose —
    # so every product run is zoom-normalized with no config file. Direct
    # frontend calls with an UNRESOLVED sentinel warn and disable
    # normalization (frontend._desc_scale). 0 disables (fixed 1-px
    # spacing); > 0 pins an explicit reference focal.
    descriptor_f_ref: float = -1.0

    # --- matching ---
    ratio_test: float = 0.8           # Lowe ratio (squared-distance form used)
    max_matches: int = 512
    ransac_iters: int = 128
    ransac_inlier_px: float = 3.0

    # --- association constants (configurable, probed
    # at sigma_obs = 1..3 px in tests/test_outliers.py) ---
    track_ratio: float = 0.95         # gated re-match ratio on the frame path
                                      # (looser than ratio_test: the pixel
                                      # gate already removes most confusers)
    track_consensus: bool = True      # pan-tilt RANSAC consensus pre-gate on
                                      # tracking matches: rejects spatially
                                      # coherent wrong-motion groups (moving
                                      # players) that per-slot gates admit
                                      # one by one
    track_consensus_px: float = -1.0  # consensus inlier radius; -1 = AUTO
                                      # (3 * sigma_obs + 5 px)
    kf_ratio: float = 0.95            # keyframe association re-match ratio
    kf_gate_sigma: float = 3.0        # keyframe gate = kf_gate_sigma *
    kf_gate_base_px: float = 5.0      #   sigma_obs + kf_gate_base_px (px)

    # --- optical flow (KLT frontend mode) ---
    flow_levels: int = 4              # LK pyramid levels
    flow_patch: int = 13              # LK window side (odd)
    flow_iters: int = 8               # Newton iterations per level
    min_refill_dist_px: float = 8.0   # keep fresh detections off live tracks

    # --- EKF (SURVEY.md §8.3) ---
    max_rays: int = 256               # N_max tracked rays in the EKF state
    dt: float = 1.0                   # frame interval (state velocities per-frame)
    sigma_pan: float = 0.001          # process noise std (rad / frame^2)
    sigma_tilt: float = 0.001
    sigma_focal: float = 1.0          # pixels / frame^2
    sigma_obs: float = 1.0            # measurement noise std (pixels)
    init_ray_std: float = 5e-4        # extra new-ray prior std (rad) on top of
                                      # the propagated pose+pixel covariance
    init_vel_std: float = 0.01        # pan/tilt velocity prior std (rad/frame)
    init_vel_std_f: float = 8.0       # focal velocity prior std (px/frame)
    min_inliers: int = 12             # below this => tracking lost
    gate_maha2: float = 9.21          # chi2(2, 0.99) Mahalanobis innovation gate
    gate_rescue_factor: float = 9.0   # widened-gate factor when the tight gate
                                      # starves but many matches agree (see
                                      # ekf.update gate rescue)
    innovation_gate_px: float = 50.0  # absolute innovation ceiling (outliers)
    track_gate_px: float = 60.0       # association search radius (tracking)
    max_missed: int = 10              # frames unobserved before a slot is freed
    max_rejected: int = 3             # frames MATCHED-but-gate-rejected before
                                      # a slot is freed: rejection is positive
                                      # wrong-motion evidence (a mover), unlike
                                      # mere absence (occlusion), so it burns
                                      # the missed budget max_missed/max_rejected
                                      # times faster: mover slots must not
                                      # crowd out statics

    # --- keyframes / map ---
    max_keyframes: int = 64
    max_map_rays: int = 4096
    keyframe_overlap: float = 0.55    # insert keyframe when view overlap drops
    keyframe_zoom_ratio: float = 1.12 # ALSO insert when the focal differs by
                                      # this ratio from EVERY stored keyframe
                                      # (the reference's pan/ZOOM criterion:
                                      # view_overlap normalizes by the
                                      # narrower FOV, so zoom-in reads as
                                      # overlap 1.0 and a zoom sweep never
                                      # triggered inserts — a 10k-frame soak
                                      # then ran pure-EKF and gauge-drifted
                                      # the focal to NaN; r5). <= 1 disables
    keyframe_interval: int = 120      # ALSO insert a keyframe every N frames
                                      # regardless of overlap/zoom: the
                                      # windowed BA + covariance-gated pose
                                      # re-seed at insert time are the ONLY
                                      # drift-bounding events, and a near-
                                      # stationary camera can otherwise run
                                      # thousands of frames without one —
                                      # long enough for the focal/scale
                                      # gauge random walk to turn into a
                                      # runaway (r5 soak). The bounded store
                                      # evicts redundant keyframes, so the
                                      # cadence costs capacity churn, not
                                      # capacity. 0 disables
    kf_desc_dim: int = 128

    # --- map ray lifecycle (cull/merge — reference scene_map.py, SURVEY §3) ---
    ray_cull_age: int = 90            # frames a views==0 ray may go unseen
    merge_angle_tol: float = 1.5e-3   # rad: duplicate-ray merge radius
    merge_desc_min: float = 0.85      # min descriptor cosine to merge/dedupe
    anchor_snap_tol: float = 5e-4     # rad: frame-path re-claim radius —
                                      # TIGHTER than merge_angle_tol (a
                                      # genuine re-detection back-projects
                                      # within ~pixel-noise/f ~ 2.5e-4 rad;
                                      # the reloc-scale 1.5e-3 tolerance
                                      # merged distinct landmarks and
                                      # contaminated BA tracks with ~3 px
                                      # biased observations)
    anchor_snap_desc_min: float = 0.9 # min descriptor cosine for a frame-
                                      # path re-claim
    map_anchor: bool = True           # keyframe-observed rays (views > 0)
                                      # are gauge anchors: per-frame slot
                                      # writeback skips them (only BA moves
                                      # them) and fresh slot claims snap to
                                      # existing map rays instead of re-
                                      # back-projecting through the current
                                      # pose. Without this, hour-scale runs
                                      # random-walk the focal/angular-scale
                                      # near-gauge until the focal collapses
                                      # (r5 10k soak: exponential runaway at
                                      # ~frame 1800). False = r1-r4 behavior

    # --- bundle adjustment (SURVEY.md §8.4) ---
    ba_max_views_per_ray: int = 8     # C: observation-table columns per ray
    ba_iters: int = 20
    ba_huber_px: float = 0.0          # > 0: Huber-IRLS robust BA with this
                                      # kernel width (px); 0 = pure quadratic
    ba_irls_rounds: int = 2           # reweight/re-solve rounds when robust

    # --- online (keyframe-time) windowed BA (SURVEY.md §4.2 -> §4.3) ---
    # runs IN-GRAPH on keyframe insertion over the newest window keyframes;
    # the refined newest pose re-seeds the EKF camera (mid-sequence drift
    # correction — the paper's headline mechanism). 0 iters disables.
    online_ba_iters: int = 8
    online_ba_window: int = 8
    online_ba_views: int = 4          # observation columns per ray in-window
    ba_lambda0: float = 1e-3
    ba_lambda_up: float = 4.0
    ba_lambda_down: float = 0.5
    ba_focal_scale: float = 1e-3      # parameter scaling: f * scale ~ O(1)
    ba_tol: float = 1e-8

    # --- relocalization ---
    reloc_mode: str = "map"           # "map": match the global ray store;
                                      # "keyframe": nearest-keyframe lookup
                                      # (reference path A / BASELINE config 2)
    reloc_min_matches: int = 10
    reloc_iters: int = 20

    # --- distributed ---
    mesh_shape: tuple = (1,)
    mesh_axis: str = "obs"

    def replace(self, **kw: Any) -> "SLAMConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "SLAMConfig":
        d = json.loads(s)
        if "mesh_shape" in d:
            d["mesh_shape"] = tuple(d["mesh_shape"])
        # unknown keys (e.g. fields retired between versions, like the old
        # nms_cell) get an actionable warning instead of a bare TypeError
        # from the dataclass constructor
        known = {f.name for f in dataclasses.fields(SLAMConfig)}
        unknown = sorted(set(d) - known)
        if unknown:
            import warnings

            warnings.warn(
                "SLAMConfig.from_json: ignoring unknown key(s) "
                f"{unknown} — retired or misspelled config fields",
                stacklevel=2,
            )
            d = {k: v for k, v in d.items() if k in known}
        return SLAMConfig(**d)
