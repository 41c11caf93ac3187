"""Keyframe-insert frame cost itemization + online-BA knee sweep
("what does a keyframe frame cost, and where is the
accuracy/cost knee of the in-graph windowed BA?").

Part 1 — itemize one frame's cost by forcing the per-frame policy:
  steady        keyframe_overlap = -1 (the insert branch never fires)
  +insert       keyframe_overlap = 2, online_ba_iters = 0 (insert every
                frame, windowed BA off)
  +insert+BA    keyframe_overlap = 2, online_ba_iters = default (insert
                AND windowed BA every frame)
The deltas are the per-event costs that explain the gap between the
steady-state ms/frame and the headline chunk fps (which contains a few
keyframe frames).

Part 2 — knee sweep: tracking accuracy (pan MAE vs GT) and the
insert-frame cost across online_ba_iters in {0, 2, 4, 8, 16}, on a
240-frame oracle-feature sequence with 0.7 px observation noise and a
wide pan sweep (keyframes insert naturally). This is the data behind the
config.py online_ba_iters default.

Usage: python benchmarks/profile_keyframe.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax

    import jax.numpy as jnp
    import numpy as np

    from benchmarks.bench_suite import _timeit
    from ptzjax import compile_cache, synth
    from ptzjax.config import SLAMConfig
    from ptzjax.features import synth_features
    from ptzjax.slam import PTZSlam

    compile_cache.setup()
    base = SLAMConfig(
        max_rays=128, max_keypoints=256, max_map_rays=2048, max_keyframes=32,
        kf_desc_dim=128, sigma_obs=0.7,
    )
    frames = 240
    seq = synth.make_sequence(
        num_frames=frames, num_rays=2500, pan_amp=0.28, tilt_amp=0.03,
        f_amp=300.0, period=frames * 1.4, seed=5,
    )
    feats = [
        synth_features(seq, k, base.max_keypoints, noise_px=0.7)[0]
        for k in range(frames)
    ]
    xy = jnp.asarray(np.stack([f.xy for f in feats]))
    desc = jnp.asarray(np.stack([f.desc for f in feats]))
    valid = jnp.asarray(np.stack([f.valid for f in feats]))

    def run_cfg(cfg):
        slam = PTZSlam(cfg, seq.intr)
        state = slam.init(
            feats[0].xy, feats[0].desc, feats[0].valid, seq.cameras[0]
        )
        s2, infos = slam.run_segment(state, xy[1:], desc[1:], valid[1:])
        jax.block_until_ready(s2)
        return slam, state, infos

    def time_cfg(slam, state, reps=3):
        ts = []
        for _ in range(reps):
            ts.append(_timeit(
                lambda: slam.run_segment(
                    state, xy[1:], desc[1:], valid[1:]
                )[0].ekf.cam
            ))
        return sorted(ts)[1] / (frames - 1)


    # ---- part 1: itemized frame cost --------------------------------------
    rows = {}
    for name, cfg in (
        ("steady", base.replace(keyframe_overlap=-1.0)),
        ("insert_noba", base.replace(keyframe_overlap=2.0, online_ba_iters=0)),
        ("insert_ba", base.replace(keyframe_overlap=2.0)),
    ):
        slam, state, _ = run_cfg(cfg)
        rows[name] = time_cfg(slam, state)
        print(json.dumps(
            {"row": name, "ms_per_frame": round(rows[name], 4)}
        ), flush=True)
    print(json.dumps({
        "row": "insert_delta_ms", "value": round(
            rows["insert_noba"] - rows["steady"], 4),
    }), flush=True)
    print(json.dumps({
        "row": "windowed_ba_delta_ms", "value": round(
            rows["insert_ba"] - rows["insert_noba"], 4),
    }), flush=True)

    # ---- part 2: online-BA knee -------------------------------------------
    gt = np.asarray(seq.cameras[1:])
    for iters in (0, 2, 4, 8, 16):
        cfg = base.replace(online_ba_iters=iters)
        slam, state, infos = run_cfg(cfg)
        h = jax.device_get(infos)
        pose = np.asarray(h.pose)
        pan_mae = float(np.degrees(np.abs(pose[:, 0] - gt[:, 0]).mean()))
        f_mae = float(np.abs(pose[:, 2] - gt[:, 2]).mean())
        kf = int(np.asarray(h.keyframe).sum())
        lost = bool(np.asarray(h.lost).any())
        # insert-frame cost at THIS iters setting (forced insert)
        slam2, state2, _ = run_cfg(
            cfg.replace(keyframe_overlap=2.0)
        )
        ms_ins = time_cfg(slam2, state2)
        print(json.dumps({
            "row": f"knee_iters_{iters}", "pan_mae_deg": round(pan_mae, 6),
            "f_mae_px": round(f_mae, 3), "keyframes": kf, "lost": lost,
            "forced_insert_ms_per_frame": round(ms_ins, 4),
        }), flush=True)


if __name__ == "__main__":
    main()
