"""Map lifecycle under capacity pressure (reference ``scene_map.py`` ray
add/merge/cull — SURVEY.md §3): unit tests for cull/merge/evict plus a long
pan-sweep run that must never exhaust the bounded stores and must keep
relocalization working across the whole map."""

import jax.numpy as jnp
import numpy as np
import pytest

from ptzjax import mapstore, synth
from ptzjax.config import SLAMConfig
from ptzjax.features import synth_features
from ptzjax.slam import PTZSlam, infos_to_dicts


def _store(cfg, rays, desc, views=None, last_seen=None):
    st = mapstore.init_ray_store(cfg)
    n = rays.shape[0]
    st = st._replace(
        rays=st.rays.at[:n].set(rays),
        desc=st.desc.at[:n].set(desc),
        valid=st.valid.at[:n].set(True),
        count=jnp.asarray(n, jnp.int32),
    )
    if views is not None:
        st = st._replace(views=st.views.at[:n].set(views))
    if last_seen is not None:
        st = st._replace(last_seen=st.last_seen.at[:n].set(last_seen))
    return st


CFG8 = SLAMConfig(max_map_rays=8, kf_desc_dim=4)


def test_add_rays_reuses_freed_rows():
    rays = np.array([[0.1, 0.0], [0.2, 0.0], [0.3, 0.0]], np.float32)
    desc = np.eye(3, 4, dtype=np.float32)
    st = _store(CFG8, rays, desc, views=np.zeros(3, np.int32),
                last_seen=np.zeros(3, np.int32))
    # cull ray 1 (views 0, stale, unprotected)
    st = mapstore.cull_rays(
        st, jnp.asarray([0, 2], jnp.int32), jnp.asarray(100, jnp.int32),
        max_age=10,
    )
    assert int(st.count) == 2
    # next allocation must claim the freed row (row 1 is the first free)
    st2, ids = mapstore.add_rays(
        st,
        jnp.asarray([[0.9, 0.1]], jnp.float32),
        jnp.asarray([[0, 0, 0, 1.0]], jnp.float32),
        jnp.asarray([True]),
        frame_idx=101,
    )
    assert int(ids[0]) == 1
    assert int(st2.count) == 3
    assert int(st2.last_seen[1]) == 101
    assert int(st2.views[1]) == 0


def test_cull_protects_ekf_and_viewed_rays():
    rays = np.array([[0.1, 0.0], [0.2, 0.0], [0.3, 0.0], [0.4, 0.0]], np.float32)
    desc = np.eye(4, dtype=np.float32)
    st = _store(
        CFG8, rays, desc,
        views=np.array([1, 0, 0, 0], np.int32),
        last_seen=np.zeros(4, np.int32),
    )
    st2 = mapstore.cull_rays(
        st, jnp.asarray([2], jnp.int32), jnp.asarray(100, jnp.int32),
        max_age=10,
    )
    v = np.asarray(st2.valid)
    assert v[0]          # has a keyframe view
    assert not v[1]      # dead: no views, not tracked, stale
    assert v[2]          # protected: live EKF slot
    assert not v[3]
    assert int(st2.count) == 2


def test_cull_keeps_recently_seen():
    rays = np.array([[0.1, 0.0]], np.float32)
    st = _store(CFG8, rays, np.eye(1, 4, dtype=np.float32),
                views=np.zeros(1, np.int32),
                last_seen=np.array([95], np.int32))
    st2 = mapstore.cull_rays(
        st, jnp.asarray([-1], jnp.int32), jnp.asarray(100, jnp.int32),
        max_age=10,
    )
    assert bool(st2.valid[0])


def test_merge_collapses_duplicates_and_remaps():
    # rays 0 and 2 are near-duplicates with agreeing descriptors
    rays = np.array(
        [[0.1, 0.0], [0.5, 0.1], [0.1001, 0.0], [0.5, -0.3]], np.float32
    )
    d = np.zeros((4, 4), np.float32)
    d[0] = d[2] = [1, 0, 0, 0]
    d[1] = [0, 1, 0, 0]
    d[3] = [0, 0, 1, 0]
    st = _store(CFG8, rays, d, views=np.array([2, 1, 3, 1], np.int32))
    st2, remap = mapstore.merge_rays(st, angle_tol=1e-3, desc_min=0.9)
    remap = np.asarray(remap)
    assert remap[2] == 0                  # 2 merged into 0
    assert remap[0] == 0 and remap[1] == 1 and remap[3] == 3
    v = np.asarray(st2.valid)
    assert list(v[:4]) == [True, True, False, True]
    assert int(st2.views[0]) == 5         # 2 + 3 views combined
    assert int(st2.count) == 3


def test_merge_respects_protection():
    rays = np.array([[0.1, 0.0], [0.1001, 0.0]], np.float32)
    d = np.tile(np.array([[1, 0, 0, 0]], np.float32), (2, 1))
    st = _store(CFG8, rays, d, views=np.array([1, 1], np.int32))
    # ray 1 is held by an EKF slot: it must survive
    st2, remap = mapstore.merge_rays(
        st, angle_tol=1e-3, desc_min=0.9,
        protected_ids=jnp.asarray([1], jnp.int32),
    )
    assert bool(st2.valid[1])
    assert int(remap[1]) == 1


def test_merge_requires_descriptor_agreement():
    rays = np.array([[0.1, 0.0], [0.1001, 0.0]], np.float32)
    d = np.eye(2, 4, dtype=np.float32)    # orthogonal descriptors
    st = _store(CFG8, rays, d)
    st2, remap = mapstore.merge_rays(st, angle_tol=1e-3, desc_min=0.9)
    assert bool(st2.valid[0]) and bool(st2.valid[1])


def test_keyframe_eviction_replaces_most_redundant():
    cfg = SLAMConfig(max_keyframes=4, max_keypoints=8, kf_desc_dim=4)
    kf = mapstore.init_keyframe_store(cfg)
    xy = jnp.zeros((8, 2), jnp.float32)
    desc = jnp.zeros((8, 4), jnp.float32)
    ids = jnp.full((8,), -1, jnp.int32)
    fv = jnp.zeros((8,), bool)
    # poses 1 and 2 are nearly identical -> one of them is the redundant pair
    poses = [
        [0.00, 0.0, 2000.0],
        [0.30, 0.0, 2000.0],
        [0.301, 0.0, 2000.0],
        [0.60, 0.0, 2000.0],
    ]
    for i, p in enumerate(poses):
        kf, ev = mapstore.add_keyframe(
            kf, jnp.asarray(p, jnp.float32), jnp.asarray(i, jnp.int32),
            xy, desc, ids, fv, width=1280.0, height=720.0,
        )
        assert int(ev) == -1
    # store is full: the next insert must evict slot 1 or 2, never 0
    kf2, ev = mapstore.add_keyframe(
        kf, jnp.asarray([0.9, 0.0, 2000.0], jnp.float32),
        jnp.asarray(9, jnp.int32), xy, desc, ids, fv,
        width=1280.0, height=720.0,
    )
    assert int(ev) in (1, 2)
    assert bool(kf2.valid[0])
    fi = sorted(int(x) for x in np.asarray(kf2.frame_idx))
    assert 9 in fi and 0 in fi


def test_long_pan_sweeps_never_exhaust_stores():
    """5 full-range pan sweeps over 1500 frames with a map store far too
    small to hold every ray ever seen: the lifecycle must recycle rows.
    Also drops frames late in the run to confirm
    relocalization still works against the aged map."""
    # max_map_rays must cover the keyframes' own observational footprint
    # (8 keyframes x 96 features, ~60% distinct after sharing) plus the
    # cull-age churn buffer — but is far below the ~7500 allocations the
    # sweeps attempt without cull/merge recycling.
    cfg = SLAMConfig(
        max_rays=48,
        max_keypoints=96,
        max_map_rays=768,
        max_keyframes=8,
        kf_desc_dim=16,
        sigma_obs=0.7,
        min_inliers=8,
        ray_cull_age=30,
    )
    t = 1500
    seq = synth.make_sequence(
        num_frames=t, num_rays=2500, pan_amp=0.35, tilt_amp=0.03,
        f_amp=250.0, period=300.0, seed=11,
    )
    rng = np.random.default_rng(11)
    desc = rng.normal(size=(2500, 16)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    seq = seq._replace(descriptors=desc)

    slam = PTZSlam(cfg, seq.intr)
    feats = [
        synth_features(seq, k, cfg.max_keypoints, noise_px=0.5,
                       desc_noise=0.05)[0]
        for k in range(t)
    ]
    state = slam.init(feats[0].xy, feats[0].desc, feats[0].valid,
                      seq.cameras[0])
    drop = set(range(1200, 1207))        # blackout against the aged map
    xy = np.stack([f.xy for f in feats])
    ds = np.stack([f.desc for f in feats])
    valid = np.stack([
        f.valid & (k not in drop) for k, f in enumerate(feats)
    ])

    infos = []
    chunk = 250
    for s in range(1, t, chunk):
        e = min(s + chunk, t)
        pad = chunk - (e - s)
        ok = np.concatenate([np.ones(e - s, bool), np.zeros(pad, bool)])
        state, finfo = slam.run_segment(
            state,
            np.concatenate([xy[s:e], np.zeros((pad, *xy.shape[1:]), np.float32)]),
            np.concatenate([ds[s:e], np.zeros((pad, *ds.shape[1:]), np.float32)]),
            np.concatenate([valid[s:e], np.zeros((pad, valid.shape[1]), bool)]),
            frame_ok=ok,
        )
        infos.extend(infos_to_dicts(finfo, frame0=s)[: e - s])
        # the store must never exhaust: free rows remain after every chunk
        n_live = int(state.rays.count)
        assert n_live < cfg.max_map_rays, f"ray store exhausted at frame {e}"
        assert n_live == int(np.asarray(state.rays.valid).sum())

    # tracking healthy at the end (post-blackout recovery included)
    tail = [i for i in infos if i["frame"] >= 1250]
    assert tail and not any(i["lost"] for i in tail)
    err = [
        abs(i["pose"][0] - seq.cameras[i["frame"]][0])
        for i in tail if i["event"] == "track"
    ]
    assert np.mean(err) < 2e-3, f"tail pan err {np.mean(err)}"
    # keyframes stay bounded and cover the sweep range (revisits correctly
    # insert nothing once coverage exists — eviction is unit-tested above)
    assert int(state.kf.count) <= cfg.max_keyframes
    n_kf = int(state.kf.count)
    kf_pans = np.asarray(state.kf.poses)[:n_kf, 0]
    assert kf_pans.max() - kf_pans.min() > 0.4, "keyframes don't span the sweep"
