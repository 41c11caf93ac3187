"""Online PTZ-SLAM loop: tracking, map growth, keyframes, relocalization, BA.

A static-shape redesign of the reference's system driver
(``slam_system/ptz_slam.py`` ``PtzSlam.init_system/.tracking/.relocalize`` —
SURVEY.md §2 layer 5, §4.1-§4.4). The per-frame hot path is one jitted
``track_frame`` with static shapes; rare, data-dependent events (keyframe
insertion, relocalization, BA) are separate jitted functions dispatched by a
thin host-side policy — the SURVEY.md §10 recipe for data-dependent control
flow under jit.

Per-frame flow (§4.2):
  predict -> project active slots -> gated descriptor re-match (the KLT
  analogue, §8.5) -> joint EKF update -> slot lifecycle (retire lost rays,
  back-project fresh keypoints into free slots, allocate global ray ids) ->
  lost check / keyframe-overlap check.
"""

from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ptzjax import ba as balib
from ptzjax import ekf as ekflib
from ptzjax import mapstore
from ptzjax import match as matchlib
from ptzjax import reloc as reloclib
from ptzjax.config import SLAMConfig
from ptzjax.geometry import Intrinsics, in_view_mask, project_rays


class SlamState(NamedTuple):
    """Full online state (a pytree; everything fixed-capacity)."""

    ekf: ekflib.EKFState
    slot_desc: jax.Array          # (N, D) descriptor per EKF slot
    kf: mapstore.KeyframeStore
    rays: mapstore.RayStore
    lost: jax.Array               # () bool
    frame_idx: jax.Array          # () int32


class FrameInfo(NamedTuple):
    """Per-frame observability record (SURVEY.md §7 metrics/logging).

    ``event``: 0 = tracked, 1 = relocalization attempted.
    """

    pose: jax.Array
    num_matches: jax.Array
    num_used: jax.Array
    innovation_rms: jax.Array
    lost: jax.Array
    num_active_slots: jax.Array
    max_kf_overlap: jax.Array
    event: jax.Array
    keyframe: jax.Array
    reloc_success: jax.Array


class PTZSlam:
    """Host-side orchestrator owning the jitted stages.

    Typical use::

        slam = PTZSlam(cfg, intr)
        state = slam.init(xy0, desc0, valid0, pose0)
        for frame in frames:
            state, info = slam.process(state, frame.xy, frame.desc, frame.valid)
    """

    def __init__(self, cfg: SLAMConfig, intr: Intrinsics):
        self.cfg = cfg
        self.intr = intr
        self._build_jits()

    def _build_jits(self) -> None:
        # ONE jitted step per frame: track/reloc selected by lax.cond,
        # keyframe insertion by lax.cond — no host round-trips in the loop.
        cfg, intr = self.cfg, self.intr
        self._step = jax.jit(partial(_frame_step, cfg=cfg, intr=intr))
        self._segment = jax.jit(partial(_run_segment, cfg=cfg, intr=intr))
        self._ba = jax.jit(partial(_run_ba, cfg=cfg, intr=intr))
        self._px_fns: dict = {}
        if hasattr(self, "_apply_reloc"):
            del self._apply_reloc

    def init(self, xy, desc, valid, pose0) -> SlamState:
        """First-frame bootstrap from a known pose (SURVEY.md §4.1).

        Resolves ``descriptor_f_ref = -1`` (AUTO) to the bootstrap pose's
        focal, so every from-pixels run through this object is
        zoom-normalized without a config file (the sentinel must
        not leak past the library boundary)."""
        if self.cfg.descriptor_f_ref < 0:
            self.cfg = self.cfg.replace(
                descriptor_f_ref=float(np.asarray(pose0)[2])
            )
            self._build_jits()
        cfg = self.cfg
        state = SlamState(
            ekf=ekflib.init_state(jnp.asarray(pose0, jnp.float32), cfg),
            slot_desc=jnp.zeros((cfg.max_rays, cfg.kf_desc_dim), jnp.float32),
            kf=mapstore.init_keyframe_store(cfg),
            rays=mapstore.init_ray_store(cfg),
            lost=jnp.asarray(False),
            frame_idx=jnp.asarray(0, jnp.int32),
        )
        state = jax.jit(partial(_bootstrap, cfg=cfg, intr=self.intr))(
            state, jnp.asarray(xy), jnp.asarray(desc), jnp.asarray(valid)
        )
        return state

    def step(self, state: SlamState, xy, desc, valid) -> tuple[SlamState, FrameInfo]:
        """One frame, fully on device. FrameInfo fields are device scalars —
        pull them with a single jax.device_get when needed."""
        return self._step(
            state, jnp.asarray(xy), jnp.asarray(desc), jnp.asarray(valid)
        )

    def process(
        self, state: SlamState, xy, desc, valid
    ) -> tuple[SlamState, dict[str, Any]]:
        """One frame + host info dict (one device->host transfer)."""
        state, finfo = self.step(state, xy, desc, valid)
        return state, info_to_dict(finfo)

    def run_segment(
        self, state: SlamState, xy_seq, desc_seq, valid_seq, frame_ok=None
    ) -> tuple[SlamState, FrameInfo]:
        """Process a whole chunk of frames as one lax.scan on device — the
        broadcast-rate online path (amortizes all dispatch overhead).

        ``frame_ok`` (T,) masks padding frames: a False entry is a pure
        no-op (state passes through untouched), letting callers pad every
        chunk to ONE static length — each distinct chunk length costs a
        full host-side retrace (~seconds), far more than the masked frames.
        """
        t = jnp.asarray(xy_seq).shape[0]
        if frame_ok is None:
            frame_ok = jnp.ones((t,), bool)
        return self._segment(
            state,
            jnp.asarray(xy_seq),
            jnp.asarray(desc_seq),
            jnp.asarray(valid_seq),
            jnp.asarray(frame_ok),
        )

    def run_segment_pixels(
        self, state: SlamState, imgs, masks=None, frame_ok=None,
    ) -> tuple[SlamState, FrameInfo]:
        """From-pixels chunk: frames (T, H, W) -> detect/describe -> SLAM
        step, all inside ONE scanned device program (BASELINE config 4's
        honest shape — the vision frontend is inside the clock)."""
        imgs = jnp.asarray(imgs)
        t = imgs.shape[0]
        if frame_ok is None:
            frame_ok = jnp.ones((t,), bool)
        key = ("px", masks is not None)
        if key not in self._px_fns:
            self._px_fns[key] = jax.jit(
                partial(_run_segment_pixels, cfg=self.cfg, intr=self.intr)
            )
        if masks is None:
            return self._px_fns[key](state, imgs, None, jnp.asarray(frame_ok))
        return self._px_fns[key](
            state, imgs, jnp.asarray(masks), jnp.asarray(frame_ok)
        )

    def run_segment_pixels_klt(
        self, state: SlamState, imgs, prev_img, prev_xy, prev_valid,
        frame_ok=None, masks=None,
    ) -> tuple[SlamState, FrameInfo, jax.Array, jax.Array]:
        """KLT-mode from-pixels chunk: LK flow carries the keypoint table
        between frames inside the scan; pass the previous chunk's last
        frame + table as the carry seed. ``masks`` (T, H, W) bool restricts
        the refill detections (player-box complement), same as the
        re-detect path. Returns (state, infos, last_xy, last_valid)."""
        imgs = jnp.asarray(imgs)
        t = imgs.shape[0]
        if frame_ok is None:
            frame_ok = jnp.ones((t,), bool)
        key = ("klt", masks is not None)
        if key not in self._px_fns:
            self._px_fns[key] = jax.jit(
                partial(_run_segment_pixels_klt, cfg=self.cfg, intr=self.intr)
            )
        return self._px_fns[key](
            state, imgs, jnp.asarray(frame_ok), jnp.asarray(prev_img),
            jnp.asarray(prev_xy), jnp.asarray(prev_valid),
            None if masks is None else jnp.asarray(masks),
        )

    def bundle_adjust(self, state: SlamState) -> tuple[SlamState, dict[str, Any]]:
        """Offline/keyframe-time BA over the whole map (SURVEY.md §4.3)."""
        state, cost0, cost1 = self._ba(state)
        return state, {"ba_cost_before": float(cost0), "ba_cost_after": float(cost1)}

    def apply_reloc_result(
        self, state: SlamState, xy, desc, valid, res
    ) -> SlamState:
        """Apply an externally-computed relocalization (e.g. the native
        forest path, ``ptzjax.reloc_forest.relocalize_rf`` — SURVEY.md §4.4
        path B): on success, re-init the EKF around the recovered pose and
        re-seed slots by back-projecting the inlier keypoints; on failure,
        stay lost. The host decides WHEN to call this; the apply is jitted."""
        if not hasattr(self, "_apply_reloc"):
            self._apply_reloc = jax.jit(
                partial(_apply_external_reloc, cfg=self.cfg, intr=self.intr)
            )
        return self._apply_reloc(
            state, jnp.asarray(xy), jnp.asarray(desc), jnp.asarray(valid),
            jnp.asarray(res.pose), jnp.asarray(res.matched_ok),
            jnp.asarray(res.success),
        )


# --- jitted stages -----------------------------------------------------------


def _bootstrap(state: SlamState, xy, desc, valid, *, cfg, intr) -> SlamState:
    state, _ = _grow_map(state, xy, desc, valid, cfg=cfg, intr=intr)
    return _insert_keyframe(state, xy, desc, valid, cfg=cfg, intr=intr)


def _grow_map(
    state: SlamState, xy, desc, cand_mask, *, cfg, intr, dedupe=False,
    dedupe_tol=None, dedupe_desc_min=None,
):
    """Insert candidate keypoints as new EKF slots + global rays.

    With ``dedupe=True``, candidates whose back-projected ray lands within
    ``dedupe_tol`` (default cfg.merge_angle_tol) of a live map ray with
    agreeing descriptor REUSE that ray's id — and its VALUE — instead of
    allocating a duplicate. Two callers, two tolerances: the reloc re-seed
    uses the wide merge_angle_tol (post-reloc pose error is large); the
    per-frame map-anchoring path uses the tight cfg.anchor_snap_tol (a
    genuine re-detection back-projects within ~pixel-noise/f).
    """
    from ptzjax.geometry import back_project_pixels

    new_rays = back_project_pixels(state.ekf.pose, xy, intr)
    reuse_ids = jnp.full((xy.shape[0],), -1, jnp.int32)
    if dedupe:
        tol = cfg.merge_angle_tol if dedupe_tol is None else dedupe_tol
        dmin = (
            cfg.merge_desc_min if dedupe_desc_min is None else dedupe_desc_min
        )
        store = state.rays
        mcap_s = store.rays.shape[0]
        d2 = ((new_rays[:, None, :] - store.rays[None, :, :]) ** 2).sum(-1)
        # HIGH is TF32 on the H100 (unit roundoff ~4.9e-4): unit-norm
        # descriptor cosines land within ~1e-3 of fp32, far inside the
        # margin of the merge_desc_min / anchor_snap_desc_min cuts
        cos = jnp.matmul(
            desc, store.desc.T, precision=jax.lax.Precision.HIGH
        )
        # a ray currently held by an ACTIVE slot must not be re-claimed by
        # a second slot (double writeback + double view bookkeeping); its
        # near-duplicates are also dropped from fresh allocation below
        act_ids = jnp.where(state.ekf.active, state.ekf.ray_ids, -1)
        held = (
            jnp.arange(mcap_s, dtype=jnp.int32)[:, None] == act_ids[None, :]
        ).any(1)
        near_any = (
            store.valid[None, :]
            & (d2 < tol**2)
            & (cos >= dmin)
        )
        near = near_any & ~held[None, :]
        has = near.any(axis=1)
        has_any = near_any.any(axis=1)
        nearest = jnp.argmin(
            jnp.where(near, d2, jnp.inf), axis=1
        ).astype(jnp.int32)
        # one candidate per reused ray: several candidates in this batch can
        # share a nearest ray, and claiming it twice would leave two EKF
        # slots writing (and pinning) the same map row — keep only the
        # lowest-index claimant (scatter-min, then gather back)
        q = xy.shape[0]
        mcap = store.rays.shape[0]
        winner = jnp.full((mcap,), q, jnp.int32).at[
            jnp.where(cand_mask & has, nearest, mcap)
        ].min(jnp.arange(q, dtype=jnp.int32), mode="drop")
        is_first = winner[nearest] == jnp.arange(q, dtype=jnp.int32)
        reuse_ids = jnp.where(cand_mask & has & is_first, nearest, -1)
        # losers are still duplicates of an existing ray (including rays a
        # live slot already holds) — drop them from fresh allocation too,
        # don't clone the landmark
        cand_mask = cand_mask & ~has_any
    # only allocate map rows for candidates that will claim a free EKF slot —
    # otherwise every frame's unmatched features leak permanent map rays and
    # exhaust the store within seconds of video
    num_free = (~state.ekf.active).sum() - (reuse_ids >= 0).sum()
    cand_rank = jnp.cumsum(cand_mask.astype(jnp.int32)) - 1
    cand_sel = cand_mask & (cand_rank < num_free)
    rays_store, ids = mapstore.add_rays(
        state.rays, new_rays, desc, cand_sel, frame_idx=state.frame_idx
    )
    ids = jnp.where(reuse_ids >= 0, reuse_ids, ids)
    accept = ids >= 0
    ekf_state = ekflib.insert_rays(
        state.ekf, xy, accept, ids, intr, cfg
    )
    if dedupe:
        # snap newly claimed slots to the MAP value (for fresh allocations
        # this equals the back-projection they were seeded with): re-
        # claimed anchored rays re-enter the filter at their anchored
        # estimates, which is what arrests the slot-churn gauge ratchet
        # (every fresh back-projection inherits the current pose error;
        # map values do not). Same precedent as the reloc re-seed.
        claim0 = ekflib.claim_slots(state.ekf.active, accept)
        snap = claim0.newly & (ekf_state.ray_ids >= 0)
        ekf_state = ekf_state._replace(
            rays=jnp.where(
                snap[:, None],
                rays_store.rays[jnp.clip(ekf_state.ray_ids, 0, None)],
                ekf_state.rays,
            )
        )
    # record descriptors on the slots that were just claimed (same
    # deterministic claim as insert_rays; gather + select, no scatter)
    claim = ekflib.claim_slots(state.ekf.active, accept)
    safe = jnp.clip(claim.cand_of_slot, 0, desc.shape[0] - 1)
    slot_desc = jnp.where(claim.newly[:, None], desc[safe], state.slot_desc)
    return state._replace(ekf=ekf_state, slot_desc=slot_desc, rays=rays_store), accept


def _track_frame(
    state: SlamState, xy, desc, valid, *, cfg, intr
) -> tuple[SlamState, FrameInfo]:
    # 1. predict
    ekf_state = ekflib.predict(state.ekf, cfg)
    pose = ekf_state.pose

    # 2. project active slots to predicted pixels
    pred_pix = project_rays(pose, ekf_state.rays, intr)
    slot_visible = ekf_state.active & in_view_mask(
        pose, ekf_state.rays, intr, cfg.image_width, cfg.image_height,
        margin=cfg.innovation_gate_px,
    )

    # 3. gated re-match (tracking-mode association, SURVEY.md §8.5)
    m = matchlib.match_gated(
        desc, xy, state.slot_desc, pred_pix, valid, slot_visible,
        gate_px=cfg.track_gate_px, ratio=cfg.track_ratio,
    )
    if cfg.track_consensus:
        # pan-tilt consensus pre-gate: per-slot gates
        # admit a coherent wrong-motion group (players) one feature at a
        # time; a single-match (pan, tilt) vote scored against ALL matches
        # keeps only the camera-motion-consistent majority. Static scene
        # features dominate in any trackable frame, so the consensus set is
        # the background even when >20% of pixels belong to movers. Applied
        # only when the winner is a CLEAR majority of the matches — a split
        # consensus (focal error spreads static votes radially) falls back
        # to per-slot EKF gating instead of starving the filter.
        px = (
            cfg.track_consensus_px
            if cfg.track_consensus_px > 0
            else 3.0 * cfg.sigma_obs + 5.0
        )
        inl, best_count = matchlib.consensus_pan_tilt(
            ekf_state.rays[m.idx], xy, m.ok, pose[2], intr.cx, intr.cy,
            inlier_px=px, score=m.score,
        )
        dominant = best_count * 2 >= m.ok.sum()
        matched_any = m.ok  # pre-consensus: still a SLOT's observation
        m = m._replace(ok=jnp.where(dominant, inl, m.ok))
        # consensus rejection is WRONG-MOTION evidence (the match exists
        # and is confident; its motion disagrees with the camera majority)
        consensus_rej = matched_any & ~m.ok
    else:
        matched_any = m.ok
        consensus_rej = jnp.zeros_like(m.ok)
    obs, obs_mask = matchlib.scatter_to_slots(m, xy, ekf_state.capacity)

    # 4. joint EKF update + slot lifecycle
    ekf_state, stats = ekflib.update(ekf_state, obs, obs_mask, intr, cfg)
    # a slot whose observation failed the CONSENSUS gate carries positive
    # wrong-motion evidence (a mover, or corrupted): count CONSECUTIVE
    # consensus rejections per slot and retire at cfg.max_rejected, so junk
    # slots can't crowd out statics in the bounded table (the mover-stress
    # death mode: static matches starve as mover slots churn through
    # capacity). Strict consecutiveness keeps i.i.d. outliers harmless
    # (p^3 per slot-frame), and EKF-maha rejections deliberately do NOT
    # count: a chi2(0.99) gate falsely rejects ~1% of good observations
    # per frame, and fast-retiring those measurably degrades the map under
    # plain i.i.d. outliers (r4 sigma-1 regression).
    n = ekf_state.capacity
    slot_iota = jnp.arange(n, dtype=jnp.int32)
    rejected = (
        (jnp.where(consensus_rej, m.idx, n)[None, :] == slot_iota[:, None])
        .any(axis=1)
        & ekf_state.active
    )
    ekf_state = ekf_state._replace(
        rej=jnp.where(rejected, ekf_state.rej + 1, 0)
    )
    ekf_state = ekflib.retire_lost(ekf_state, cfg)
    state = state._replace(ekf=ekf_state)

    # refresh slot descriptors from gate-confirmed observations: appearance
    # drifts under zoom (even with f-normalized sampling, the underlying
    # texture resolves differently), so the slot tracks the CURRENT look of
    # its landmark instead of the look at insertion time
    q = desc.shape[0]
    tgt = jnp.where(m.ok, m.idx, n)
    onehot = tgt[None, :] == slot_iota[:, None]           # (N, Q), unique/slot
    cand_of_slot = jnp.argmax(onehot, axis=1).astype(jnp.int32)
    refresh = stats.used_mask & onehot.any(axis=1)
    slot_desc = jnp.where(
        refresh[:, None], desc[cand_of_slot], state.slot_desc
    )
    state = state._replace(slot_desc=slot_desc)

    # refresh global ray estimates from the filter (per-frame ray refinement)
    # — ONLY for slots whose observation passed the gate this frame: writing
    # gate-rejected slots would let a corrupted slot poison the map ray that
    # reloc/BA later trust
    state = state._replace(
        rays=mapstore.update_rays(
            state.rays,
            ekf_state.ray_ids,
            ekf_state.rays,
            # a LOST frame (starved or non-finite filter) must not write
            # anything back — its estimates are exactly the ones not to
            # trust (update_rays additionally drops non-finite values)
            ekf_state.active & stats.used_mask & ~stats.lost,
            frame_idx=state.frame_idx,
            respect_anchors=cfg.map_anchor,
        )
    )

    # cull dead rays EVERY frame (O(M) elementwise — cheap): revisit phases
    # insert no keyframes, so a keyframe-time-only cull lets slot-churn rays
    # leak ~1 row/frame until the store exhausts
    state = state._replace(
        rays=mapstore.cull_rays(
            state.rays, ekf_state.ray_ids, state.frame_idx, cfg.ray_cull_age
        )
    )

    # 5. grow: unmatched fresh keypoints become new rays (only when healthy).
    # A consensus-REJECTED match is not fresh: it already has a slot (the
    # rejection says its motion is wrong, not that it is unseen) — re-
    # inserting it every frame would churn duplicate rays through the
    # bounded slot table and crowd out durable statics
    fresh = valid & ~matched_any & ~stats.lost
    state, _ = _grow_map(
        state, xy, desc, fresh, cfg=cfg, intr=intr, dedupe=cfg.map_anchor,
        dedupe_tol=cfg.anchor_snap_tol,
        dedupe_desc_min=cfg.anchor_snap_desc_min,
    )

    max_ov = mapstore.max_overlap_with_keyframes(
        state.kf, pose, cfg.image_width, cfg.image_height
    )
    state = state._replace(
        lost=stats.lost, frame_idx=state.frame_idx + 1
    )
    info = FrameInfo(
        pose=state.ekf.pose,
        num_matches=m.ok.sum(),
        num_used=stats.num_used,
        innovation_rms=stats.innovation_rms,
        lost=stats.lost,
        num_active_slots=state.ekf.active.sum(),
        max_kf_overlap=max_ov,
        event=jnp.asarray(0, jnp.int32),
        keyframe=jnp.asarray(False),
        reloc_success=jnp.asarray(False),
    )
    return state, info


def _insert_keyframe(state: SlamState, xy, desc, valid, *, cfg, intr) -> SlamState:
    """Store the current frame as a keyframe: features + their ray ids.

    Feature->ray association: descriptor match against the EKF slots, gated
    by the slots' predicted pixel positions. The gate is tight (the filter
    just updated on this frame, so linked slots project within a few sigma);
    an ungated descriptor match leaks rare high-cosine coincidences into the
    keyframe tables, whose huge residuals then dominate and derail BA.

    Keyframe insertion is also where the map lifecycle runs (it is the rare
    event on the frame path — SURVEY.md §3 scene_map.py add/merge/cull):
    evict the most redundant keyframe at capacity (adjusting ray view
    counts), cull dead rays, and merge duplicate rays (remapping every
    ray-id table).
    """
    pred_pix = project_rays(state.ekf.pose, state.ekf.rays, intr)
    m = matchlib.match_gated(
        desc, xy, state.slot_desc, pred_pix, valid, state.ekf.active,
        gate_px=cfg.kf_gate_sigma * cfg.sigma_obs + cfg.kf_gate_base_px,
        ratio=cfg.kf_ratio,
    )
    ray_ids = jnp.where(m.ok, state.ekf.ray_ids[m.idx], -1)
    feat_valid = valid & m.ok & (ray_ids >= 0)
    kf, evicted = mapstore.add_keyframe(
        state.kf, state.ekf.pose, state.frame_idx, xy, desc, ray_ids,
        feat_valid, width=cfg.image_width, height=cfg.image_height,
    )
    mcap = state.rays.views.shape[0]
    # the evicted keyframe's observations no longer pin their rays
    ev = jnp.clip(evicted, 0, state.kf.ray_ids.shape[0] - 1)
    ev_ids = state.kf.ray_ids[ev]
    ev_fv = state.kf.feat_valid[ev] & (evicted >= 0)
    views = state.rays.views.at[
        jnp.where(ev_fv, ev_ids, mcap)
    ].add(-1, mode="drop")
    views = views.at[
        jnp.where(feat_valid, ray_ids, mcap)
    ].add(1, mode="drop")
    rays = state.rays._replace(views=views)

    # cull dead rays, then merge duplicates and remap every id table
    rays = mapstore.cull_rays(
        rays, state.ekf.ray_ids, state.frame_idx, cfg.ray_cull_age
    )
    rays, remap = mapstore.merge_rays(
        rays, cfg.merge_angle_tol, cfg.merge_desc_min,
        protected_ids=state.ekf.ray_ids,
    )
    kf_ids = jnp.where(
        kf.ray_ids >= 0, remap[jnp.clip(kf.ray_ids, 0, mcap - 1)], -1
    )
    ekf_ids = jnp.where(
        state.ekf.ray_ids >= 0,
        remap[jnp.clip(state.ekf.ray_ids, 0, mcap - 1)],
        -1,
    )
    return state._replace(
        kf=kf._replace(ray_ids=kf_ids),
        rays=rays,
        ekf=state.ekf._replace(ray_ids=ekf_ids),
    )


def _relocalize(state: SlamState, xy, desc, valid, *, cfg, intr):
    """Recover from lost tracking (SURVEY.md §4.4), then rebuild the EKF
    around the recovered pose with the inlier rays. cfg.reloc_mode selects
    the backend statically at trace time: "map" matches the global ray
    store; "keyframe" does the reference's nearest-keyframe lookup."""
    if cfg.reloc_mode == "keyframe":
        res = reloclib.relocalize_keyframes(
            desc, xy, valid, state.kf, state.rays, intr, cfg
        )
    else:
        res = reloclib.relocalize(desc, xy, valid, state.rays, intr, cfg)

    def recover(_):
        ekf_state = ekflib.init_state(res.pose, cfg)
        # seed slots with the reloc inlier rays at their map positions
        ids = jnp.where(res.matched_ok, res.matched_ray_ids, -1)
        ekf_state = ekflib.insert_rays(
            ekf_state, xy, res.matched_ok, ids, intr, cfg
        )
        # use map ray values (better than back-projection through new pose)
        n = ekf_state.capacity
        slot_ray = jnp.where(
            (ekf_state.ray_ids >= 0)[:, None],
            state.rays.rays[jnp.clip(ekf_state.ray_ids, 0, None)],
            ekf_state.rays,
        )
        ekf_state = ekf_state._replace(rays=slot_ray)
        # slot descriptors: all slots were free pre-insert, so the claim is
        # the same deterministic assignment insert_rays used
        claim = ekflib.claim_slots(jnp.zeros((n,), bool), res.matched_ok)
        safe = jnp.clip(claim.cand_of_slot, 0, desc.shape[0] - 1)
        slot_desc = jnp.where(claim.newly[:, None], desc[safe], 0.0)
        return state._replace(
            ekf=ekf_state, slot_desc=slot_desc, lost=jnp.asarray(False),
            frame_idx=state.frame_idx + 1,
        )

    def stay_lost(_):
        return state._replace(frame_idx=state.frame_idx + 1)

    new_state = jax.lax.cond(res.success, recover, stay_lost, None)
    info = FrameInfo(
        pose=new_state.ekf.pose,
        num_matches=res.inliers,
        num_used=res.inliers,
        innovation_rms=jnp.asarray(0.0, jnp.float32),
        lost=~res.success,
        num_active_slots=new_state.ekf.active.sum(),
        max_kf_overlap=jnp.asarray(1.0, jnp.float32),
        event=jnp.asarray(1, jnp.int32),
        keyframe=jnp.asarray(False),
        reloc_success=res.success,
    )
    return new_state, info


def _apply_external_reloc(
    state: SlamState, xy, desc, valid, pose, inlier_mask, success, *, cfg, intr
):
    """Re-init around an externally recovered pose (forest path): fresh EKF
    at ``pose``, inlier keypoints back-projected into new slots + map rays.
    The map/keyframe stores survive (they are the long-term memory)."""

    def recover(_):
        st = state._replace(
            ekf=ekflib.init_state(pose, cfg),
            slot_desc=jnp.zeros_like(state.slot_desc),
            lost=jnp.asarray(False),
            frame_idx=state.frame_idx + 1,
        )
        # dedupe: repeated forest relocalizations must reuse the map rays
        # they re-observe, not append clones until the store exhausts
        st, _ = _grow_map(
            st, xy, desc, valid & inlier_mask, cfg=cfg, intr=intr, dedupe=True
        )
        return st

    def stay_lost(_):
        return state._replace(frame_idx=state.frame_idx + 1)

    return jax.lax.cond(success, recover, stay_lost, None)


def _windowed_ba(state: SlamState, *, cfg, intr) -> SlamState:
    """In-graph local BA over the newest ``online_ba_window`` keyframes
    (SURVEY.md §4.2 "keyframe check ... optionally trigger §4.3 BA").

    The just-inserted keyframe IS the current frame, so its refined pose
    re-seeds the EKF camera — mid-sequence drift correction without waiting
    for an offline pass. The oldest in-window keyframe is frozen as the
    local gauge anchor; rays outside the window keep their estimates.
    """
    kf = state.kf
    k = kf.poses.shape[0]
    w = min(cfg.online_ba_window, k)
    mcap = state.rays.rays.shape[0]

    # newest w keyframes by frame index (the fresh insert ranks first)
    order_key = jnp.where(kf.valid, kf.frame_idx, -1)
    _, top_idx = jax.lax.top_k(order_key, w)
    sel_valid = kf.valid[top_idx]
    sub = mapstore.KeyframeStore(
        poses=kf.poses[top_idx],
        frame_idx=kf.frame_idx[top_idx],
        valid=sel_valid,
        xy=kf.xy[top_idx],
        desc=kf.desc[top_idx],
        ray_ids=kf.ray_ids[top_idx],
        feat_valid=kf.feat_valid[top_idx] & sel_valid[:, None],
        count=sel_valid.sum().astype(jnp.int32),
    )
    prob = mapstore.build_ba_problem(
        sub, state.rays, max_views_per_ray=cfg.online_ba_views,
        anchor_first=False,
    )
    # gauge: freeze the OLDEST VALID in-window keyframe (top_k sorts valid
    # rows — key >= 0 — ahead of invalid ones, so that's row n_valid - 1;
    # freezing a padding row would leave the gauge free and let the whole
    # window slide)
    n_valid = sel_valid.sum()
    oldest = jnp.maximum(n_valid - 1, 0)
    prob = prob._replace(cam_free=sel_valid.at[oldest].set(False))
    res = balib.run(prob, intr, cfg.replace(ba_iters=cfg.online_ba_iters))

    new_poses = kf.poses.at[
        jnp.where(sel_valid, top_idx, k)
    ].set(res.cams, mode="drop")
    # only trust rays the window actually constrains (>= 2 views): a 1-view
    # ray moves to explain that view's noise exactly, which would overwrite
    # a converged estimate with raw observation noise
    constrained = prob.obs_w.sum(axis=1) >= 2
    new_rays = jnp.where(constrained[:, None], res.rays, state.rays.rays)

    # drift correction, covariance-gated: the windowed BA sees far fewer
    # observations than the filter has fused, so on a healthy track its
    # pose is NOISIER than the EKF's — only re-seed when the BA pose
    # disagrees beyond the filter's own 3-sigma (the signature of drift:
    # an overconfident, biased filter). Healthy runs make this a no-op.
    # Guards (r5 soak): the variance floor keeps the gate meaningful, the
    # finite check keeps a diverged BA from seeding garbage, and a firing
    # re-seed must also INFLATE the pose covariance — jumping the pose
    # while P still claims sub-pixel certainty lets the filter's drifted
    # ray field pull the camera straight back to the drifted solution
    # within a few frames (observed: partial corrections that never stuck).
    delta = res.cams[0] - state.ekf.pose
    p_diag = jnp.maximum(jnp.diagonal(state.ekf.cov)[0:3], 1e-8)
    drifted = jnp.any(delta * delta > 9.0 * p_diag) & jnp.isfinite(
        res.cams[0]
    ).all()
    cam = jnp.where(
        drifted, state.ekf.cam.at[0:3].set(res.cams[0]), state.ekf.cam
    )
    d_state = 6 + 2 * state.ekf.capacity
    pose_rows = jnp.arange(d_state) < 3
    # zero pose cross-covariances, set a BA-accuracy pose prior
    cov_inflated = jnp.where(
        pose_rows[:, None] | pose_rows[None, :], 0.0, state.ekf.cov
    ) + jnp.diag(
        jnp.concatenate(
            [
                jnp.asarray([1e-5, 1e-5, 25.0], jnp.float32),
                jnp.zeros((d_state - 3,), jnp.float32),
            ]
        )
    )
    cov = jnp.where(drifted, cov_inflated, state.ekf.cov)
    ekf = state.ekf._replace(cam=cam, cov=cov)
    # DRIFT WATCHDOG (r5 soak): a BA disagreement beyond the 3-sigma gate
    # AND beyond hard absolute bounds means the filter's whole ray field
    # is corrupted, not just the pose — a pose re-seed alone gets pulled
    # back to the drifted solution within frames (observed: the focal
    # runaway doubles every ~3 frames once established). Declare LOST:
    # the relocalization path re-initializes filter + slots against the
    # ANCHORED map, which recovers to sub-pixel focal error (probed).
    # The just-inserted keyframe's pose was already BA-corrected above.
    watchdog = drifted & (
        (jnp.abs(delta[2]) > 30.0)
        | (jnp.abs(delta[0]) > 5e-3)
        | (jnp.abs(delta[1]) > 5e-3)
    )
    return state._replace(
        kf=kf._replace(poses=new_poses),
        rays=state.rays._replace(rays=new_rays),
        ekf=ekf,
        lost=state.lost | watchdog,
    )


def _frame_step(state: SlamState, xy, desc, valid, *, cfg, intr):
    """The whole per-frame pipeline as one traced function: reloc-or-track
    selected by lax.cond on the lost flag, keyframe insertion (+ in-graph
    windowed BA) by lax.cond on the overlap policy. Zero host decisions
    (SURVEY.md §10 hard parts)."""

    def do_reloc(_):
        return _relocalize(state, xy, desc, valid, cfg=cfg, intr=intr)

    def do_track(_):
        s2, info = _track_frame(state, xy, desc, valid, cfg=cfg, intr=intr)
        insert = (~info.lost) & (info.max_kf_overlap < cfg.keyframe_overlap)
        if cfg.keyframe_zoom_ratio > 1.0:
            # zoom half of the pan/zoom criterion: overlap alone reads
            # zoom-in as full containment (see mapstore.min_zoom_departure)
            insert = insert | (
                (~info.lost)
                & (
                    mapstore.min_zoom_departure(s2.kf, s2.ekf.pose)
                    > cfg.keyframe_zoom_ratio
                )
            )
        if cfg.keyframe_interval > 0:
            # temporal cadence: the insert-time windowed BA + 3-sigma pose
            # re-seed are the drift-bounding events; never run more than
            # keyframe_interval frames without one (config.py rationale)
            last_kf = jnp.max(jnp.where(s2.kf.valid, s2.kf.frame_idx, -1))
            insert = insert | (
                (~info.lost)
                & ((s2.frame_idx - last_kf) >= cfg.keyframe_interval)
            )

        def do_insert(s):
            s = _insert_keyframe(s, xy, desc, valid, cfg=cfg, intr=intr)
            if cfg.online_ba_iters > 0:
                # local BA needs >= 2 keyframes for a meaningful system
                s = jax.lax.cond(
                    s.kf.count >= 2,
                    lambda st: _windowed_ba(st, cfg=cfg, intr=intr),
                    lambda st: st,
                    s,
                )
            return s

        s3 = jax.lax.cond(insert, do_insert, lambda s: s, s2)
        return s3, info._replace(keyframe=insert)

    return jax.lax.cond(state.lost, do_reloc, do_track, None)


def _skip_info(s: SlamState) -> FrameInfo:
    return FrameInfo(
        pose=s.ekf.pose,
        num_matches=jnp.asarray(0, jnp.int32),
        num_used=jnp.asarray(0, jnp.int32),
        innovation_rms=jnp.asarray(0.0, jnp.float32),
        lost=s.lost,
        num_active_slots=s.ekf.active.sum(),
        max_kf_overlap=jnp.asarray(1.0, jnp.float32),
        event=jnp.asarray(2, jnp.int32),  # 2 = padding no-op
        keyframe=jnp.asarray(False),
        reloc_success=jnp.asarray(False),
    )


def _run_segment_pixels(
    state: SlamState, imgs, masks, frame_ok, *, cfg, intr
):
    """Raw frames -> features -> SLAM step, ONE scanned device program
    (no per-frame host dispatch; the frontend runs
    inside the loop, so the descriptor scale uses the LIVE focal estimate).
    ``masks`` is (T, H, W) bool or None (static)."""
    from ptzjax.frontend import extract_features

    def body(s, frame):
        if masks is None:
            img, ok = frame
            mask = None
        else:
            img, mask, ok = frame

        def do(_):
            # sanitized focal for descriptor scaling: after a numerical
            # blowout the pose can be non-finite for a frame or two — a
            # NaN focal would NaN every descriptor and make even
            # RELOCALIZATION impossible (r5 soak: one NaN frame => 4k
            # permanently-lost frames). Fall back to the bootstrap f_ref.
            f_est = s.ekf.pose[2]
            f_safe = jnp.where(
                jnp.isfinite(f_est) & (f_est > 1.0), f_est,
                jnp.asarray(
                    cfg.descriptor_f_ref if cfg.descriptor_f_ref > 0
                    else 1000.0,
                    jnp.float32,
                ),
            )
            xy, desc, valid = extract_features(
                img, cfg, mask=mask, focal=f_safe,
            )
            return _frame_step(s, xy, desc, valid, cfg=cfg, intr=intr)

        return jax.lax.cond(ok, do, lambda _: (s, _skip_info(s)), None)

    xs = (imgs, frame_ok) if masks is None else (imgs, masks, frame_ok)
    return jax.lax.scan(body, state, xs)


def _run_segment_pixels_klt(
    state: SlamState, imgs, frame_ok, prev_img, prev_xy, prev_valid, masks,
    *, cfg, intr
):
    """KLT-mode fused loop: LK flow carries the keypoint table between
    consecutive frames inside the scan (the previous frame rides the scan
    carry); fresh detections refill freed rows (SURVEY.md §4.2). ``masks``
    (T, H, W) bool or None (static) gates the refill detections so they
    respect the player boxes like the re-detect path does."""
    from ptzjax.frontend import track_features

    def body(carry, frame):
        s, pimg, pxy, pvalid = carry
        if masks is None:
            img, ok = frame
            mask = None
        else:
            img, mask, ok = frame

        def do(_):
            f_est = s.ekf.pose[2]
            f_safe = jnp.where(
                jnp.isfinite(f_est) & (f_est > 1.0), f_est,
                jnp.asarray(
                    cfg.descriptor_f_ref if cfg.descriptor_f_ref > 0
                    else 1000.0,
                    jnp.float32,
                ),
            )
            xy, desc, valid, _tracked = track_features(
                pimg, img, pxy, pvalid, cfg, mask=mask, focal=f_safe,
            )
            s2, info = _frame_step(s, xy, desc, valid, cfg=cfg, intr=intr)
            return (s2, img, xy, valid), info

        def skip(_):
            return (s, pimg, pxy, pvalid), _skip_info(s)

        return jax.lax.cond(ok, do, skip, None)

    xs = (imgs, frame_ok) if masks is None else (imgs, masks, frame_ok)
    (s, _, xy_t, valid_t), infos = jax.lax.scan(
        body, (state, prev_img, prev_xy, prev_valid), xs
    )
    # final keypoint table rides out so chunked callers can seed the next
    # chunk's carry (padding frames skip, so it belongs to the last REAL
    # frame)
    return s, infos, xy_t, valid_t


def _run_segment(
    state: SlamState, xy_seq, desc_seq, valid_seq, frame_ok, *, cfg, intr
):
    def body(s, frame):
        xy, desc, valid, ok = frame
        return jax.lax.cond(
            ok,
            lambda _: _frame_step(s, xy, desc, valid, cfg=cfg, intr=intr),
            lambda _: (s, _skip_info(s)),
            None,
        )

    return jax.lax.scan(body, state, (xy_seq, desc_seq, valid_seq, frame_ok))


def info_to_dict(finfo: FrameInfo) -> dict[str, Any]:
    """One device->host transfer; mirrors the reference's per-frame logging
    (SURVEY.md §7 metrics/observability). A per-frame transfer stalls the
    host until the frame is done; where throughput matters prefer
    ``run_segment`` + ``infos_to_dicts`` (one transfer per chunk)."""
    h = jax.device_get(finfo)
    track = int(h.event) == 0
    return {
        "event": "track" if track else "reloc",
        "pose": np.asarray(h.pose),
        "num_matches": int(h.num_matches),
        "num_used": int(h.num_used),
        "innovation_rms": float(h.innovation_rms),
        "lost": bool(h.lost),
        "active_slots": int(h.num_active_slots),
        "max_kf_overlap": float(h.max_kf_overlap),
        "keyframe": bool(h.keyframe),
        "reloc_success": bool(h.reloc_success),
        "reloc_inliers": int(h.num_used),
    }


def infos_to_dicts(infos: FrameInfo, frame0: int = 1) -> list[dict[str, Any]]:
    """Stacked FrameInfo (from ``run_segment``) -> per-frame dicts, with ONE
    device->host transfer for the whole chunk."""
    h = jax.device_get(infos)
    out = []
    for k in range(len(np.asarray(h.pose))):
        track = int(h.event[k]) == 0
        out.append(
            {
                "frame": frame0 + k,
                "event": "track" if track else "reloc",
                "pose": np.asarray(h.pose[k]),
                "num_matches": int(h.num_matches[k]),
                "num_used": int(h.num_used[k]),
                "innovation_rms": float(h.innovation_rms[k]),
                "lost": bool(h.lost[k]),
                "active_slots": int(h.num_active_slots[k]),
                "max_kf_overlap": float(h.max_kf_overlap[k]),
                "keyframe": bool(h.keyframe[k]),
                "reloc_success": bool(h.reloc_success[k]),
                "reloc_inliers": int(h.num_used[k]),
            }
        )
    return out


def _run_ba(state: SlamState, *, cfg, intr):
    prob = mapstore.build_ba_problem(
        state.kf, state.rays, max_views_per_ray=cfg.ba_max_views_per_ray
    )
    if cfg.ba_huber_px > 0:
        res = balib.run_robust(prob, intr, cfg)
    else:
        res = balib.run(prob, intr, cfg)
    kf, rays = mapstore.apply_ba_result(
        state.kf, state.rays, res.cams, res.rays, prob.obs_w
    )
    return state._replace(kf=kf, rays=rays), res.initial_cost, res.cost
