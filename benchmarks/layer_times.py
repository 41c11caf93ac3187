"""Device time of the frontend layers, from a profiler trace on the GPU.

At 1280x720 and the SLAMConfig defaults (512 keypoints) it times:

  detect    Harris response + 3x3 NMS + top-k + subpixel (detect_keypoints)
  describe  zoom-normalized 46x46 window gather + descriptor
  klt_pair  one lk_track frame pair (4 levels, forward-backward check)

Each layer runs ``REPS`` times under ``jax.profiler.trace``; the device
time per call is the union of the kernel intervals on each device line,
summed over lines, divided by the reps. The host wall from dispatch to
``block_until_ready`` (median) is printed beside it. The script also checks
the optimized HLO: the vmapped ``dynamic_slice`` window gathers of the
descriptor and of LK must lower to gather ops with no ``while`` loop.

Usage: python benchmarks/layer_times.py [--out DIR]
Prints one JSON line per layer; the per-line trace summary goes to
``DIR/trace_lines.json``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REPS = 20


def trace_lines(trace_dir: str) -> dict[str, dict]:
    """Per device-plane line of the newest trace under ``trace_dir``: the
    number of events, their summed duration and the union of their
    intervals (ns)."""
    from jax.profiler import ProfileData

    path = max(
        glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True),
        key=os.path.getmtime,
    )
    out = {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            iv = sorted((e.start_ns, e.end_ns) for e in line.events)
            union, end = 0.0, -1.0
            for a, b in iv:
                if b > end:
                    union += b - max(a, end)
                    end = b
            out[f"{plane.name} | {line.name}"] = {
                "events": len(iv),
                "sum_ns": sum(b - a for a, b in iv),
                "union_ns": union,
            }
    return out


def hlo_counts(fn, *args) -> dict[str, int]:
    text = fn.lower(*args).compile().as_text()
    return {
        op: len(re.findall(rf"\b{op}\(", text))
        for op in ("while", "gather", "dynamic-slice")
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--out", default=os.path.join(ROOT, "chiprun_out", "layer_times")
    )
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ptzjax import compile_cache, synth
    from ptzjax.config import SLAMConfig
    from ptzjax.geometry import Intrinsics
    from ptzjax.kernels import flow as flowlib
    from ptzjax.kernels.descriptor import describe_keypoints
    from ptzjax.kernels.detect import detect_keypoints

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev}")
    compile_cache.setup()
    os.makedirs(args.out, exist_ok=True)

    w, h = 1280, 720
    cfg = SLAMConfig()
    k = cfg.max_keypoints
    intr = Intrinsics.create(w / 2.0, h / 2.0)
    pano = synth.make_panorama(seed=0)
    cam0 = np.array([0.05, -0.05, 2200.0], np.float32)
    cam1 = cam0 + np.array([0.004, -0.001, 3.0], np.float32)
    img0 = jnp.asarray(synth.render_image(pano, cam0, intr, w, h))
    img1 = jnp.asarray(synth.render_image(pano, cam1, intr, w, h))

    detect = jax.jit(lambda im: detect_keypoints(
        im, max_keypoints=k, threshold=cfg.detector_threshold))
    kp = jax.block_until_ready(detect(img0))
    scale = jnp.asarray(1.1, jnp.float32)
    describe = jax.jit(describe_keypoints)
    klt = jax.jit(lambda a, b, xy, v: flowlib.lk_track(
        a, b, xy, v, levels=cfg.flow_levels, patch=cfg.flow_patch,
        iters=cfg.flow_iters, fb_tol=cfg.track_gate_px / 4.0))
    layers = {
        "detect": (detect, (img0,)),
        "describe": (describe, (img0, kp.xy, kp.valid, scale)),
        "klt_pair": (klt, (img0, img1, kp.xy, kp.valid)),
    }

    # the window gathers alone: descriptor (47x47) and LK (24x24) windows
    pad = jnp.pad(img0, 48, mode="edge")
    ys = jnp.clip(kp.xy[:, 1].astype(jnp.int32), 0, h)
    xs = jnp.clip(kp.xy[:, 0].astype(jnp.int32), 0, w)
    hlo = {
        "describe": hlo_counts(describe, img0, kp.xy, kp.valid, scale),
        "gather_47": hlo_counts(
            jax.jit(flowlib._gather, static_argnums=3), pad, ys, xs, 47),
        "gather_24": hlo_counts(
            jax.jit(flowlib._gather, static_argnums=3), pad, ys, xs, 24),
    }
    print(json.dumps({"hlo_op_counts": hlo}))
    for name in ("gather_47", "gather_24"):
        c = hlo[name]
        if c["while"] or not c["gather"]:
            raise SystemExit(f"{name}: window gather lowered to {c}")

    lines = {}
    for name, (fn, a) in layers.items():
        jax.block_until_ready(fn(*a))
        walls = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*a))
            walls.append(time.perf_counter() - t0)
        tdir = os.path.join(args.out, f"trace_{name}")
        with jax.profiler.trace(tdir):
            for _ in range(REPS):
                jax.block_until_ready(fn(*a))
        lines[name] = trace_lines(tdir)
        busy = sum(v["union_ns"] for v in lines[name].values())
        print(json.dumps({
            "layer": name,
            "device_ms_per_call": busy / REPS / 1e6,
            "host_wall_ms_median": float(np.median(walls)) * 1e3,
            "reps": REPS,
            "device": {"platform": dev.platform, "kind": dev.device_kind},
        }))
    with open(os.path.join(args.out, "trace_lines.json"), "w") as f:
        json.dump(lines, f, indent=1)


if __name__ == "__main__":
    main()
