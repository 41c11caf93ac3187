"""Sub-stage breakdown of the per-frame SLAM step.

This tool splits the slam_step into: predict, association (project +
gated match + consensus + scatter), joint EKF update, lifecycle (retire /
descriptor refresh / ray store writeback / cull), map growth, and the
cond-dispatch overhead of `_frame_step` (reloc branch + keyframe branch)
over the bare `_track_frame`.

Each stage is slope-timed inside its own lax.scan over per-frame inputs
(inputs vary per iteration so XLA cannot hoist the body out of the loop),
using the same amortized two-point method as the rest of the suite.

Usage:
  python benchmarks/profile_slam.py            # bench config (128 rays/256 kp)
  python benchmarks/profile_slam.py --caps 256 512   # product default caps
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--caps", nargs=2, type=int, default=[128, 256],
                    metavar=("MAX_RAYS", "MAX_KP"))
    args = ap.parse_args()

    import jax

    import jax.numpy as jnp
    import numpy as np

    from benchmarks.bench_suite import _timeit
    from ptzjax import ekf as ekflib
    from ptzjax import mapstore
    from ptzjax import match as matchlib
    from ptzjax import compile_cache, synth
    from ptzjax.config import SLAMConfig
    from ptzjax.frontend import extract_features
    from ptzjax.geometry import Intrinsics, in_view_mask, project_rays
    from ptzjax.slam import PTZSlam, _frame_step, _grow_map, _track_frame

    compile_cache.setup()
    w, h = 1280, 720
    n_rays, n_kp = args.caps
    cfg = SLAMConfig(
        image_width=w, image_height=h, max_rays=n_rays, max_keypoints=n_kp,
        max_map_rays=2048, max_keyframes=32, kf_desc_dim=128, sigma_obs=1.0,
        descriptor_f_ref=2000.0,
    )
    intr = Intrinsics.create(w / 2.0, h / 2.0)

    pano = synth.make_panorama(seed=0)
    cams = synth.make_trajectory(
        24, pan_amp=0.12, tilt0=-0.05, tilt_amp=0.02,
        f0=2000.0, f_amp=250.0, period=40.0, seed=0,
    )
    imgs = jnp.asarray(
        np.stack(
            [synth.render_image(pano, c, intr, w, h) for c in cams]
        ).astype(np.float32)
    )

    slam = PTZSlam(cfg, intr)
    f0 = extract_features(
        imgs[0], cfg, focal=jnp.asarray(cams[0][2])
    )
    state0 = slam.init(*f0, cams[0])

    feats = jax.jit(
        lambda xs: jax.lax.map(
            lambda im: extract_features(
                im, cfg, focal=jnp.asarray(2000.0)
            ),
            xs,
        )
    )(imgs)
    jax.block_until_ready(feats)
    xy_all, desc_all, valid_all = feats

    # steady-state: run the real loop over the 24 frames once
    state, _ = slam.run_segment(state0, xy_all, desc_all, valid_all)
    jax.block_until_ready(state)

    # precompute per-frame association outputs (obs tables) for the
    # ekf_update / lifecycle stages, using the REAL association
    def assoc_one(s, xy, desc, valid):
        es = ekflib.predict(s.ekf, cfg)
        pose = es.pose
        pred_pix = project_rays(pose, es.rays, intr)
        vis = es.active & in_view_mask(
            pose, es.rays, intr, cfg.image_width, cfg.image_height,
            margin=cfg.innovation_gate_px,
        )
        m = matchlib.match_gated(
            desc, xy, s.slot_desc, pred_pix, valid, vis,
            gate_px=cfg.track_gate_px, ratio=cfg.track_ratio,
        )
        obs, obs_mask = matchlib.scatter_to_slots(m, xy, es.capacity)
        return obs, obs_mask

    obs_all, mask_all = jax.jit(
        lambda s, xs, ds, vs: jax.vmap(
            lambda x, d, v: assoc_one(s, x, d, v)
        )(xs, ds, vs)
    )(state, xy_all, desc_all, valid_all)
    jax.block_until_ready((obs_all, mask_all))


    def slope_ms(make, n_small=8, n_big=64, retries=2):
        t_start = time.perf_counter()
        for _ in range(retries + 1):
            f_s, a_s = make(n_small)
            f_b, a_b = make(n_big)
            t_s = _timeit(f_s, *a_s)
            t_b = _timeit(f_b, *a_b)
            slope = t_b - t_s
            if slope > 0:
                print(
                    f"  [done {time.perf_counter() - t_start:.1f}s "
                    f"t_s={t_s:.2f} t_b={t_b:.2f}]",
                    file=sys.stderr, flush=True,
                )
                return slope / (n_big - n_small)
            n_big *= 4
        return 0.0  # below timer noise — report as ~0

    def tile(a, n):
        reps = (n + a.shape[0] - 1) // a.shape[0]
        return jnp.tile(a, (reps,) + (1,) * (a.ndim - 1))[:n]

    stages = {}

    # 1. predict only
    def mk_predict(n):
        def run(s, dummy):
            def body(es, _):
                return ekflib.predict(es, cfg), 0.0
            es, _ = jax.lax.scan(body, s.ekf, dummy)
            return es.cam
        return jax.jit(run), (state, jnp.zeros((n,)))

    stages["predict"] = slope_ms(mk_predict)

    # 2. association: project + in-view + gated match + consensus + scatter
    def mk_assoc(n):
        xs = (tile(xy_all, n), tile(desc_all, n), tile(valid_all, n))

        def run(s, xy_s, desc_s, valid_s):
            es = s.ekf

            def body(acc, fr):
                xy, desc, valid = fr
                pose = es.pose + acc * 1e-30  # serialize on the carry
                pred_pix = project_rays(pose, es.rays, intr)
                vis = es.active & in_view_mask(
                    pose, es.rays, intr, cfg.image_width, cfg.image_height,
                    margin=cfg.innovation_gate_px,
                )
                m = matchlib.match_gated(
                    desc, xy, s.slot_desc, pred_pix, valid, vis,
                    gate_px=cfg.track_gate_px, ratio=cfg.track_ratio,
                )
                if cfg.track_consensus:
                    px = 3.0 * cfg.sigma_obs + 5.0
                    inl, bc = matchlib.consensus_pan_tilt(
                        es.rays[m.idx], xy, m.ok, pose[2], intr.cx, intr.cy,
                        inlier_px=px, score=m.score,
                    )
                    m = m._replace(
                        ok=jnp.where(bc * 2 >= m.ok.sum(), inl, m.ok)
                    )
                obs, obs_mask = matchlib.scatter_to_slots(m, xy, es.capacity)
                return acc + obs.sum() + obs_mask.sum(), 0.0

            acc, _ = jax.lax.scan(body, jnp.asarray(0.0), (xy_s, desc_s, valid_s))
            return acc

        return jax.jit(run), (state, *xs)

    stages["assoc_match"] = slope_ms(mk_assoc)

    # 3. joint EKF update
    def mk_update(n):
        xs = (tile(obs_all, n), tile(mask_all, n))

        def run(es, obs_s, mask_s):
            def body(e, fr):
                o, mk = fr
                e2, _ = ekflib.update(e, o, mk, intr, cfg)
                return e2, 0.0
            es2, _ = jax.lax.scan(body, es, (obs_s, mask_s))
            return es2.cam

        return jax.jit(run), (state.ekf, *xs)

    stages["ekf_update"] = slope_ms(mk_update)

    # 4. lifecycle: retire + slot-desc refresh + ray writeback + cull
    def mk_lifecycle(n):
        xs = (tile(desc_all, n), tile(mask_all, n))

        def run(s, desc_s, mask_s):
            def body(carry, fr):
                ekf_s, rays_s, sd = carry
                desc, used = fr
                ekf_s = ekflib.retire_lost(ekf_s, cfg)
                q = desc.shape[0]
                nn = ekf_s.capacity
                cand = jnp.arange(nn, dtype=jnp.int32) % q
                refresh = used & ekf_s.active
                sd = jnp.where(refresh[:, None], desc[cand], sd)
                rays_s = mapstore.update_rays(
                    rays_s, ekf_s.ray_ids, ekf_s.rays,
                    ekf_s.active & used, frame_idx=jnp.asarray(1, jnp.int32),
                )
                rays_s = mapstore.cull_rays(
                    rays_s, ekf_s.ray_ids, jnp.asarray(1, jnp.int32),
                    cfg.ray_cull_age,
                )
                return (ekf_s, rays_s, sd), 0.0

            carry, _ = jax.lax.scan(
                body, (s.ekf, s.rays, s.slot_desc), (desc_s, mask_s)
            )
            return carry[0].cam

        return jax.jit(run), (state, *xs)

    stages["lifecycle"] = slope_ms(mk_lifecycle)

    # 5. map growth (back-project + claim + covariance augmentation)
    def mk_grow(n):
        xs = (tile(xy_all, n), tile(desc_all, n), tile(valid_all, n))

        def run(s, xy_s, desc_s, valid_s):
            def body(st, fr):
                xy, desc, valid = fr
                st2, _ = _grow_map(st, xy, desc, valid, cfg=cfg, intr=intr)
                return st2, 0.0
            st, _ = jax.lax.scan(body, s, (xy_s, desc_s, valid_s))
            return st.ekf.cam

        return jax.jit(run), (state, *xs)

    stages["grow_map"] = slope_ms(mk_grow)

    # 6. bare _track_frame (no reloc / keyframe conds)
    def mk_track(n):
        xs = (tile(xy_all, n), tile(desc_all, n), tile(valid_all, n))

        def run(s, xy_s, desc_s, valid_s):
            def body(st, fr):
                xy, desc, valid = fr
                st2, _ = _track_frame(st, xy, desc, valid, cfg=cfg, intr=intr)
                return st2, 0.0
            st, _ = jax.lax.scan(body, s, (xy_s, desc_s, valid_s))
            return st.ekf.cam

        return jax.jit(run), (state, *xs)

    stages["track_frame"] = slope_ms(mk_track)

    # 7. full _frame_step (adds reloc cond + keyframe-insert cond + windowed BA)
    def mk_step(n):
        xs = (tile(xy_all, n), tile(desc_all, n), tile(valid_all, n),
              jnp.ones((n,), bool))

        def run(s, xy_s, desc_s, valid_s, ok_s):
            return slam._segment(s, xy_s, desc_s, valid_s, ok_s)[0].ekf.cam

        return run, (state, *xs)

    stages["frame_step_total"] = slope_ms(mk_step)

    for k, v in stages.items():
        print(json.dumps({
            "stage": k, "ms_per_frame": round(v, 4),
            "caps": f"{n_rays}r/{n_kp}kp",
        }))
    total = stages["frame_step_total"]
    sub = (stages["predict"] + stages["assoc_match"] + stages["ekf_update"]
           + stages["lifecycle"] + stages["grow_map"])
    print(f"\nslam-step breakdown @ {n_rays} rays / {n_kp} kp "
          f"({jax.default_backend()}):")
    for k, v in stages.items():
        print(f"  {k:>18}: {v:8.4f} ms  ({v / max(total, 1e-9):6.1%})")
    print(f"  sum(1-5 stages) = {sub:.4f} ms; "
          f"cond/dispatch overhead = {total - stages['track_frame']:.4f} ms")


if __name__ == "__main__":
    main()
