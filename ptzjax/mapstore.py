"""Global map: keyframe registry + ray store, and the map<->BA bridge.

A static-shape redesign of the reference's ``slam_system/scene_map.py`` /
``key_frame.py`` (SURVEY.md §2 layer 4): instead of Python lists of KeyFrame
objects, fixed-capacity padded arrays (a pytree) so that map maintenance,
keyframe-overlap queries, and BA-problem assembly are all jittable with
static shapes.

Design notes:
- every landmark has a *global ray id* = its row in RayStore; EKF slots and
  keyframe feature tables refer to rays by id (-1 = none);
- keyframe insertion policy = angular view-overlap threshold against the
  nearest stored keyframe (reference policy: pan/zoom overlap — SURVEY.md
  §4.2);
- ``build_ba_problem`` converts the keyframe observation tables into the
  ray-major BA layout with a sort + segmented-rank, all static shapes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ptzjax.ba import BAProblem
from ptzjax.config import SLAMConfig


class RayStore(NamedTuple):
    """Global ray landmarks.

    Rows are a free list: ``valid`` marks live rays, and ``add_rays`` claims
    invalid rows (in deterministic slot order), so rows recycled by
    ``cull_rays``/``merge_rays`` are reused — the store never "fills up" as
    long as the lifecycle retires dead rays (reference ``scene_map.py`` ray
    lifecycle add/merge/cull — SURVEY.md §3).

    Attributes:
      rays: (M, 2) current estimates.
      desc: (M, D) representative unit descriptor (first observation's).
      valid: (M,) bool.
      views: (M,) int32 number of keyframes observing the ray.
      count: () int32 number of live rays (== valid.sum()).
      last_seen: (M,) int32 frame index of the last confirmed observation.
    """

    rays: jax.Array
    desc: jax.Array
    valid: jax.Array
    views: jax.Array
    count: jax.Array
    last_seen: jax.Array


class KeyframeStore(NamedTuple):
    """Keyframe records (reference ``KeyFrame`` — SURVEY.md §2 layer 4).

    Attributes:
      poses: (K, 3); frame_idx: (K,) int32; valid: (K,) bool;
      xy: (K, F, 2); desc: (K, F, D); ray_ids: (K, F) int32 (-1 = none);
      feat_valid: (K, F) bool; count: () int32.
    """

    poses: jax.Array
    frame_idx: jax.Array
    valid: jax.Array
    xy: jax.Array
    desc: jax.Array
    ray_ids: jax.Array
    feat_valid: jax.Array
    count: jax.Array


def init_ray_store(cfg: SLAMConfig) -> RayStore:
    m, d = cfg.max_map_rays, cfg.kf_desc_dim
    return RayStore(
        rays=jnp.zeros((m, 2), jnp.float32),
        desc=jnp.zeros((m, d), jnp.float32),
        valid=jnp.zeros((m,), bool),
        views=jnp.zeros((m,), jnp.int32),
        count=jnp.asarray(0, jnp.int32),
        last_seen=jnp.zeros((m,), jnp.int32),
    )


def init_keyframe_store(cfg: SLAMConfig) -> KeyframeStore:
    k, f, d = cfg.max_keyframes, cfg.max_keypoints, cfg.kf_desc_dim
    return KeyframeStore(
        poses=jnp.zeros((k, 3), jnp.float32),
        frame_idx=jnp.full((k,), -1, jnp.int32),
        valid=jnp.zeros((k,), bool),
        xy=jnp.zeros((k, f, 2), jnp.float32),
        desc=jnp.zeros((k, f, d), jnp.float32),
        ray_ids=jnp.full((k, f), -1, jnp.int32),
        feat_valid=jnp.zeros((k, f), bool),
        count=jnp.asarray(0, jnp.int32),
    )


def add_rays(
    store: RayStore,
    rays: jax.Array,
    desc: jax.Array,
    mask: jax.Array,
    frame_idx: jax.Array | int = 0,
) -> tuple[RayStore, jax.Array]:
    """Allocate rows for new rays from the free list (invalid rows, in slot
    order — the j-th accepted candidate claims the j-th free row), so culled
    and merged rows are recycled.

    Args:
      rays: (B, 2); desc: (B, D); mask: (B,) candidates to allocate.
      frame_idx: current frame (stamps ``last_seen``).

    Returns:
      (store, ids): ids (B,) int32, -1 where not allocated (masked out or
      capacity exhausted).
    """
    m = store.rays.shape[0]
    b = rays.shape[0]
    free = ~store.valid
    csf = jnp.cumsum(free.astype(jnp.int32))              # (M,) nondecreasing
    free_rank = csf - 1
    cand_csum = jnp.cumsum(mask.astype(jnp.int32))        # (B,)
    cand_rank = cand_csum - 1
    ok = mask & (cand_rank < csf[-1])
    num_ok = ok.sum()
    # scatter-free (see ekf.claim_slots): rank->index via searchsorted over
    # the cumsums, payload writes as row-gathers + masked selects instead
    # of per-row scatters of rays/desc/valid/views/last_seen.
    ids = jnp.where(
        ok,
        jnp.searchsorted(
            csf, jnp.arange(1, b + 1, dtype=jnp.int32),
            method="compare_all",
        ).astype(jnp.int32)[jnp.clip(cand_rank, 0, b - 1)],
        -1,
    )
    write = free & (free_rank < num_ok)                   # (M,) rows written
    cand_of_row = jnp.searchsorted(
        cand_csum, jnp.clip(csf, 1, None), method="compare_all"
    ).astype(jnp.int32)                                   # (M,), b = none
    src = jnp.clip(cand_of_row, 0, b - 1)
    new = RayStore(
        rays=jnp.where(write[:, None], rays[src], store.rays),
        desc=jnp.where(write[:, None], desc[src], store.desc),
        valid=store.valid | write,
        views=jnp.where(write, 0, store.views),
        count=store.count + num_ok.astype(jnp.int32),
        last_seen=jnp.where(
            write, jnp.asarray(frame_idx, jnp.int32), store.last_seen
        ),
    )
    return new, ids


def update_rays(
    store: RayStore,
    ids: jax.Array,
    rays: jax.Array,
    mask: jax.Array,
    frame_idx: jax.Array | int | None = None,
    respect_anchors: bool = False,
) -> RayStore:
    """Write refined ray estimates (EKF slots or BA output) back by id.

    ``mask`` must only admit slots whose observation was actually confirmed
    this frame (gate-passed) — writing gate-rejected slot estimates lets a
    corrupted slot poison the map ray later used by reloc/BA.

    ``respect_anchors=True`` (the per-frame tracking path) skips the VALUE
    write for keyframe-observed rays (views > 0): those are the map's
    gauge anchors — dragging them with the filter every frame lets the
    whole map+pose system random-walk its unobservable modes (the focal/
    angular-scale near-gauge), which a 10k-frame soak turned into an
    exponential focal collapse (r5). Anchored rays move ONLY through
    bundle adjustment (windowed or offline). ``last_seen`` is stamped for
    every confirmed observation either way (lifecycle bookkeeping).
    """
    m = store.rays.shape[0]
    ok = mask & (ids >= 0)
    # a non-finite estimate must NEVER reach the map: one NaN frame
    # otherwise poisons every ray it observed, and relocalization against
    # a NaN-laced store can never succeed again (r5 soak death mode)
    vmask = ok & jnp.isfinite(rays).all(-1)
    if respect_anchors:
        vmask = vmask & (store.views[jnp.clip(ids, 0, m - 1)] == 0)
    new_rays = store.rays.at[jnp.where(vmask, ids, m)].set(rays, mode="drop")
    if frame_idx is None:
        return store._replace(rays=new_rays)
    seen = store.last_seen.at[jnp.where(ok, ids, m)].set(
        jnp.asarray(frame_idx, jnp.int32), mode="drop"
    )
    return store._replace(rays=new_rays, last_seen=seen)


def cull_rays(
    store: RayStore,
    protected_ids: jax.Array,
    frame_idx: jax.Array,
    max_age: int,
) -> RayStore:
    """Retire dead map rays: never promoted to a keyframe (views == 0),
    not currently tracked by the EKF, and unobserved for ``max_age`` frames.
    Freed rows return to the free list (reference ``scene_map.py`` cull).

    Args:
      protected_ids: (N,) int32 ray ids currently held by EKF slots (-1 = none).
    """
    m = store.rays.shape[0]
    in_ekf = jnp.zeros((m,), bool).at[
        jnp.where(protected_ids >= 0, protected_ids, m)
    ].set(True, mode="drop")
    stale = (frame_idx - store.last_seen) > max_age
    drop = store.valid & (store.views <= 0) & ~in_ekf & stale
    return store._replace(
        valid=store.valid & ~drop,
        count=store.count - drop.sum().astype(jnp.int32),
    )


def merge_rays(
    store: RayStore,
    angle_tol: float,
    desc_min: float,
    protected_ids: jax.Array | None = None,
) -> tuple[RayStore, jax.Array]:
    """Merge duplicate landmarks: pairs of live rays within ``angle_tol``
    (radians, Euclidean over (theta, phi)) whose descriptors agree
    (cosine >= ``desc_min``) collapse into the lower-indexed ray.

    Single canonical pass (no chains): ray j merges into the smallest-index
    mergeable partner i < j only if i is itself a root; repeated calls (one
    per keyframe insertion) converge. Returns (store, remap) where
    remap: (M,) int32 maps old ids -> surviving ids; callers must remap
    every ray-id table they hold (keyframes, EKF slots).

    ``protected_ids`` (e.g. the EKF slots' current ray ids) marks rays that
    may absorb others but are never merged away themselves — an EKF slot's
    id must stay live mid-track.

    All-pairs (M, M) work — one matmul for the descriptor Gram plus two
    broadcast subtractions — so it belongs in a rare branch (keyframe
    insertion), not the per-frame path.
    """
    m = store.rays.shape[0]
    idx = jnp.arange(m, dtype=jnp.int32)
    live2 = store.valid[:, None] & store.valid[None, :]
    if protected_ids is not None:
        prot = jnp.zeros((m,), bool).at[
            jnp.where(protected_ids >= 0, protected_ids, m)
        ].set(True, mode="drop")
        live2 = live2 & ~prot[None, :]       # protected rays can't be children
    d_ang2 = ((store.rays[:, None, :] - store.rays[None, :, :]) ** 2).sum(-1)
    cos = jnp.matmul(
        store.desc, store.desc.T, precision=jax.lax.Precision.HIGHEST
    )
    mergeable = (
        live2
        & (d_ang2 < angle_tol * angle_tol)
        & (cos >= desc_min)
        & (idx[:, None] < idx[None, :])      # partner strictly below
    )
    # smallest-index mergeable partner per ray (self if none)
    partner = jnp.where(
        mergeable.any(axis=0),
        jnp.argmax(mergeable, axis=0).astype(jnp.int32),
        idx,
    )
    is_root = partner == idx
    target = jnp.where(is_root[partner], partner, idx)   # only merge into roots
    merged = target != idx

    views = jax.ops.segment_sum(
        jnp.where(store.valid, store.views, 0), target, num_segments=m
    )
    seen = jnp.maximum(
        store.last_seen,
        jnp.zeros((m,), jnp.int32).at[target].max(
            jnp.where(merged, store.last_seen, 0), mode="drop"
        ),
    )
    new = store._replace(
        valid=store.valid & ~merged,
        views=jnp.where(store.valid & ~merged, views, 0),
        count=store.count - (store.valid & merged).sum().astype(jnp.int32),
        last_seen=seen,
    )
    return new, target


def add_keyframe(
    store: KeyframeStore,
    pose: jax.Array,
    frame_idx: jax.Array,
    xy: jax.Array,
    desc: jax.Array,
    ray_ids: jax.Array,
    feat_valid: jax.Array,
    width: float | None = None,
    height: float | None = None,
) -> tuple[KeyframeStore, jax.Array]:
    """Insert a keyframe; at capacity, evict the most REDUNDANT one.

    Redundancy = a keyframe's max view-overlap with any other stored
    keyframe: the one best covered by its neighbors loses least map
    coverage when dropped. Slot 0 (the BA gauge anchor) is never evicted.
    Requires ``width``/``height`` for the overlap geometry; without them the
    store falls back to the old behavior (silently drop at capacity).

    Returns (store, evicted_slot): evicted_slot is the replaced row index,
    or -1 when a free row was used / the insert was dropped. Callers must
    decrement the evicted keyframe's ray view counts (see
    ``slam._insert_keyframe``).
    """
    k = store.poses.shape[0]
    at_cap = store.count >= k
    if width is None:
        tgt = jnp.where(at_cap, k, jnp.minimum(store.count, k - 1))
        evicted = jnp.asarray(-1, jnp.int32)
    else:
        ov = view_overlap(
            store.poses[:, None, :], store.poses[None, :, :], width, height
        )
        both = store.valid[:, None] & store.valid[None, :]
        off_diag = ~jnp.eye(k, dtype=bool)
        redundancy = jnp.max(
            jnp.where(both & off_diag, ov, -1.0), axis=1
        )
        redundancy = redundancy.at[0].set(-jnp.inf)       # keep the anchor
        evict_slot = jnp.argmax(redundancy).astype(jnp.int32)
        tgt = jnp.where(at_cap, evict_slot, jnp.minimum(store.count, k - 1))
        evicted = jnp.where(at_cap, evict_slot, -1).astype(jnp.int32)
    new = KeyframeStore(
        poses=store.poses.at[tgt].set(pose, mode="drop"),
        frame_idx=store.frame_idx.at[tgt].set(frame_idx, mode="drop"),
        valid=store.valid.at[tgt].set(True, mode="drop"),
        xy=store.xy.at[tgt].set(xy, mode="drop"),
        desc=store.desc.at[tgt].set(desc, mode="drop"),
        ray_ids=store.ray_ids.at[tgt].set(ray_ids, mode="drop"),
        feat_valid=store.feat_valid.at[tgt].set(feat_valid, mode="drop"),
        count=jnp.minimum(store.count + 1, k),
    )
    return new, evicted


def view_overlap(
    pose_a: jax.Array, pose_b: jax.Array, width: float, height: float
) -> jax.Array:
    """Angular view-overlap in [0, 1] between two PTZ poses.

    Product of horizontal and vertical interval overlaps (relative to the
    narrower view). Zoom differences shrink the FOV and therefore the
    overlap automatically.
    """

    def interval_overlap(c1, h1, c2, h2):
        lo = jnp.maximum(c1 - h1, c2 - h2)
        hi = jnp.minimum(c1 + h1, c2 + h2)
        inter = jnp.maximum(hi - lo, 0.0)
        return inter / jnp.maximum(2 * jnp.minimum(h1, h2), 1e-9)

    ha = jnp.arctan2(width / 2, pose_a[..., 2])
    hb = jnp.arctan2(width / 2, pose_b[..., 2])
    va = jnp.arctan2(height / 2, pose_a[..., 2])
    vb = jnp.arctan2(height / 2, pose_b[..., 2])
    h_ov = interval_overlap(pose_a[..., 0], ha, pose_b[..., 0], hb)
    v_ov = interval_overlap(pose_a[..., 1], va, pose_b[..., 1], vb)
    return h_ov * v_ov


def max_overlap_with_keyframes(
    store: KeyframeStore, pose: jax.Array, width: float, height: float
) -> jax.Array:
    """Max view overlap of ``pose`` against all stored keyframes (0 if none).
    Insertion policy: insert a keyframe when this drops below
    cfg.keyframe_overlap (SURVEY.md §4.2)."""
    ov = view_overlap(store.poses, pose[None, :], width, height)
    return jnp.max(jnp.where(store.valid, ov, 0.0))


def min_zoom_departure(store: KeyframeStore, pose: jax.Array) -> jax.Array:
    """Smallest focal ratio (>= 1) between ``pose`` and any stored
    keyframe — the ZOOM half of the reference's pan/zoom insertion
    criterion (SURVEY.md §1.3/§4.2). ``view_overlap`` normalizes by the
    narrower FOV, so a zoom-IN is fully contained (overlap 1.0) and a
    pure zoom sweep never departs by overlap alone; this metric does:
    insert when it exceeds cfg.keyframe_zoom_ratio, i.e. the current
    focal differs by that factor from EVERY keyframe. Returns +inf with
    no valid keyframes (callers insert immediately)."""
    f = jnp.maximum(pose[2], 1e-6)
    fk = jnp.maximum(store.poses[:, 2], 1e-6)
    ratio = jnp.maximum(f / fk, fk / f)
    return jnp.min(jnp.where(store.valid, ratio, jnp.inf))


def build_ba_problem(
    kf: KeyframeStore,
    rays: RayStore,
    max_views_per_ray: int,
    anchor_first: bool = True,
) -> BAProblem:
    """Assemble the ray-major BA problem from keyframe observation tables.

    Static-shape algorithm: flatten all (keyframe, feature) observations,
    sort by global ray id, compute each observation's rank within its ray
    (index - first-occurrence index via searchsorted), and scatter into the
    (M, C) table, dropping ranks >= C.
    """
    k, f = kf.ray_ids.shape
    m = rays.rays.shape[0]
    c = max_views_per_ray

    flat_ids = jnp.where(
        kf.feat_valid & (kf.ray_ids >= 0) & kf.valid[:, None], kf.ray_ids, m
    ).reshape(-1)
    flat_cam = jnp.broadcast_to(
        jnp.arange(k, dtype=jnp.int32)[:, None], (k, f)
    ).reshape(-1)
    flat_xy = kf.xy.reshape(-1, 2)

    order = jnp.argsort(flat_ids)
    s_ids = flat_ids[order]
    first = jnp.searchsorted(s_ids, s_ids, side="left")
    rank = jnp.arange(s_ids.shape[0], dtype=jnp.int32) - first.astype(jnp.int32)
    ok = (s_ids < m) & (rank < c)

    row = jnp.where(ok, s_ids, m)
    col = jnp.where(ok, rank, 0)
    obs_pix = jnp.zeros((m, c, 2), jnp.float32).at[row, col].set(
        flat_xy[order], mode="drop"
    )
    obs_cam = jnp.zeros((m, c), jnp.int32).at[row, col].set(
        flat_cam[order], mode="drop"
    )
    obs_w = jnp.zeros((m, c), jnp.float32).at[row, col].set(1.0, mode="drop")

    cam_free = kf.valid.copy()
    if anchor_first:
        cam_free = cam_free.at[0].set(False)
    return BAProblem(
        cams=kf.poses,
        rays=rays.rays,
        obs_pix=obs_pix,
        obs_cam=obs_cam,
        obs_w=obs_w,
        cam_free=cam_free,
    )


def apply_ba_result(
    kf: KeyframeStore, rays: RayStore, cams: jax.Array, new_rays: jax.Array,
    obs_w: jax.Array,
) -> tuple[KeyframeStore, RayStore]:
    """Write BA-refined poses/rays back into the stores. Rays with no BA
    observations (row weight 0) keep their previous estimate."""
    observed = obs_w.sum(axis=1) > 0
    merged = jnp.where(observed[:, None], new_rays, rays.rays)
    return (
        kf._replace(poses=jnp.where(kf.valid[:, None], cams, kf.poses)),
        rays._replace(rays=merged),
    )
