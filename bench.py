"""Headline benchmark: online from-pixels SLAM throughput on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.

Config matches BASELINE.json config 4 ("Online SLAM loop ... at broadcast
frame-rate on 1 chip"): the clock covers the WHOLE pipeline from raw 720p
pixels — Harris+NMS detection, upright-SIFT description (zoom-normalized by
the live focal estimate), gated matching, the joint camera x 128-ray EKF
update, slot/map lifecycle, keyframe policy with in-graph windowed BA, and
the reloc branch — one scanned device program per chunk
(ptzjax.slam.run_segment_pixels).

Timing: after a warm-up call compiles the chunk, each rep times one
119-frame chunk from dispatch to ``jax.block_until_ready``; the value is
frames over the median rep.

vs_baseline: the reference implementation is offline-speed Python with no
published throughput (BASELINE.md: published == {}; reference mount empty),
so the ratio is against the 30 fps broadcast real-time bar that defines the
north star's "online ... at broadcast frame-rate". vs_baseline = fps / 30.
"""

import json
import sys
import time

import numpy as np


def main() -> None:
    import jax
    import jax.numpy as jnp

    from ptzjax import compile_cache, synth
    from ptzjax.config import SLAMConfig
    from ptzjax.frontend import extract_features
    from ptzjax.geometry import Intrinsics
    from ptzjax.slam import PTZSlam

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"BENCH INVALID: no GPU (first device {dev})", file=sys.stderr)
        sys.exit(2)
    compile_cache.setup()

    w, h = 1280, 720
    frames = 120
    cfg = SLAMConfig(
        image_width=w,
        image_height=h,
        max_rays=128,
        max_keypoints=256,
        max_map_rays=2048,
        max_keyframes=32,
        kf_desc_dim=128,
        sigma_obs=1.0,
        descriptor_f_ref=2000.0,
    )
    intr = Intrinsics.create(w / 2.0, h / 2.0)
    pano = synth.make_panorama(seed=0)
    cams = synth.make_trajectory(
        frames, pan_amp=0.12, tilt0=-0.05, tilt_amp=0.02,
        f0=2000.0, f_amp=250.0, period=frames * 1.6, seed=0,
    )
    imgs = np.stack(
        [synth.render_image(pano, c, intr, w, h) for c in cams]
    ).astype(np.float32)

    slam = PTZSlam(cfg, intr)
    f0 = extract_features(
        jnp.asarray(imgs[0]), cfg, focal=jnp.asarray(cams[0][2])
    )
    state = slam.init(*f0, cams[0])
    imgs_d = jnp.asarray(imgs[1:])

    _, infos = jax.block_until_ready(slam.run_segment_pixels(state, imgs_d))
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(slam.run_segment_pixels(state, imgs_d))
        reps.append(time.perf_counter() - t0)
    fps = (frames - 1) / float(np.median(reps))

    # sanity: the run must actually track (from real pixels)
    hh = jax.device_get(infos)
    err = np.abs(np.asarray(hh.pose) - cams[1:])
    ok = (not hh.lost.any()) and err[:, 0].mean() < 3e-3
    if not ok:
        print(
            f"BENCH INVALID: lost={int(hh.lost.sum())} pan_err={err[:, 0].mean()}",
            file=sys.stderr,
        )
        sys.exit(1)

    print(
        json.dumps(
            {
                "metric": "online_slam_from_pixels_fps_1chip",
                "value": round(fps, 1),
                "unit": "frames/s, median of 5 fenced 119-frame chunks "
                        "(720p, full pipeline)",
                "vs_baseline": round(fps / 30.0, 2),
                "device": {
                    "platform": dev.platform, "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
