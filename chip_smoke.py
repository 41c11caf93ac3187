"""Quickest proof that ptzjax runs on an NVIDIA GPU: the main path, end to end.

    python chip_smoke.py               # phases a-c on one GPU
    python chip_smoke.py --four-cards  # the offline path on 4 GPUs vs 1

Everything runs in this one process (a JAX process reserves most of a card's
memory, so a second one could not start). Phase 0 fails unless JAX's first
device is a GPU, prints the card's name and power limit as nvidia-smi reports
them, and prints where the compile cache lives. Then, on one card:

  a. online from pixels: ``python -m ptzjax.run --synthetic-images --ba``
     through ``ptzjax.run.main``, 1280x720, SLAMConfig defaults (512
     keypoints, 256 EKF ray slots, 4096 map rays, 64 keyframes), 240
     rendered frames of a pan and zoom sweep, then bundle adjustment;
  b. the same with the KLT tracker (``--klt``);
  c. one joint EKF update at 256 ray slots against an fp64 dense-H oracle.

Phases a and b must lose no frame, lower the BA cost, and stay within twice
the pan/tilt/focal error the same phase reached with JAX on the CPU (plus
1e-3 deg, 0.1 px). Phase c keeps the camera and covariance errors under 5e-3.

``--four-cards`` runs only the offline path and its one-card reference:
sharded BA (32 cameras, 16,384 rays, plain and Huber) on a 1-D mesh of four
GPUs against one GPU, and the frame-sharded frontend on four against one.
BA costs must agree to 1e-3 relative, and the feature tables must be equal.

A failing gate exits non-zero. The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Phases a and b with JAX on the CPU (same commands, same seeds; JAX 0.9.0,
# XLA's CPU backend in fp32): the GPU run is held to at most 2x these plus
# SLACK. Both CPU runs lost no frame and inserted 4 keyframes.
CPU_REF = {
    "online": {"pan_mae_deg": 0.000670, "tilt_mae_deg": 0.000321,
               "focal_mae_px": 0.157},
    "klt": {"pan_mae_deg": 0.002834, "tilt_mae_deg": 0.001169,
            "focal_mae_px": 0.208},
}
SLACK = {"pan_mae_deg": 1e-3, "tilt_mae_deg": 1e-3, "focal_mae_px": 0.1}
EKF_TOL = 5e-3
BA_PARITY = 1e-3


class GateError(RuntimeError):
    """A phase's result is outside its gate."""


def phase_argv(name: str, out: str) -> list[str]:
    """``python -m ptzjax.run`` arguments of phase a ("online") or b
    ("klt"). 720p, the SLAMConfig defaults and the trajectory (pan sweep,
    focal 2500 +- 600 px) are the CLI's own defaults."""
    argv = [
        "--synthetic-images", "--frames", "240", "--ba",
        "--out", os.path.join(out, name),
    ]
    return argv + (["--klt"] if name == "klt" else [])


def run_phase(name: str, out: str) -> dict:
    from ptzjax import run

    return run.main(phase_argv(name, out))


def check_tracking(name: str, s: dict, ref: dict) -> list[str]:
    """Gate of phases a and b; returns the violations."""
    bad = []
    if s["frames_lost"] != 0:
        bad.append(f"{s['frames_lost']} frames lost")
    if not s["ba_cost_after"] < s["ba_cost_before"]:
        bad.append(
            f"BA cost {s['ba_cost_before']} -> {s['ba_cost_after']}"
        )
    for key, slack in SLACK.items():
        bound = 2.0 * ref[key] + slack
        if not s[key] <= bound:
            bad.append(f"{key} {s[key]} > {bound}")
    return bad


def phase0() -> str:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX's first device is {dev}", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"jax devices: {len(jax.devices())} x {dev.device_kind}")
    from ptzjax import compile_cache

    print(f"compile cache: {compile_cache.setup()}")
    return card


def one_card(card: str, out: str) -> None:
    from ptzjax.eval import ekf_update_oracle_errors

    for label, name in (("a", "online"), ("b", "klt")):
        s = run_phase(name, out)
        print(
            f"phase {label} ({name}) [{card}]: {s['fps']:.1f} frames/s, "
            f"compile {s['compile_s']:.1f} s, pan MAE "
            f"{s['pan_mae_deg']:.6f} deg, tilt MAE {s['tilt_mae_deg']:.6f} "
            f"deg, focal MAE {s['focal_mae_px']:.3f} px, lost "
            f"{s['frames_lost']}, BA cost {s['ba_cost_before']:.1f} -> "
            f"{s['ba_cost_after']:.1f}"
        )
        bad = check_tracking(name, s, CPU_REF[name])
        if bad:
            raise GateError(f"phase {label} ({name}): " + "; ".join(bad))

    cam_err, cov_err = ekf_update_oracle_errors(n=256)
    print(
        f"phase c (EKF update vs fp64 oracle, N=256) [{card}]: cam err "
        f"{cam_err:.3e}, cov rel err {cov_err:.3e}"
    )
    if not (cam_err < EKF_TOL and cov_err < EKF_TOL):
        raise GateError(f"phase c: EKF errors {cam_err}, {cov_err} >= {EKF_TOL}")


def four_cards(card: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ptzjax import dist, synth
    from ptzjax.config import SLAMConfig
    from ptzjax.geometry import Intrinsics

    if len(jax.devices()) < 4:
        raise GateError(f"--four-cards needs 4 GPUs, found {jax.devices()}")
    mesh1, mesh4 = dist.make_mesh(1), dist.make_mesh(4)

    prob, intr = synth.make_ba_problem(k=32, m=16384, c=6)
    for huber in (0.0, 3.0):
        cfg = SLAMConfig(ba_huber_px=huber)
        res, secs = {}, {}
        for n, mesh in ((1, mesh1), (4, mesh4)):
            jax.block_until_ready(dist.run_sharded(prob, intr, cfg, mesh))
            t0 = time.perf_counter()
            res[n] = jax.block_until_ready(
                dist.run_sharded(prob, intr, cfg, mesh)
            )
            secs[n] = time.perf_counter() - t0
        c1, c4 = float(res[1].cost), float(res[4].cost)
        rel = abs(c4 - c1) / max(abs(c1), 1e-12)
        kind = f"huber {huber} px" if huber else "plain"
        print(
            f"sharded BA ({kind}, 32 cams, 16384 rays) [{card}]: cost "
            f"{float(res[1].initial_cost):.1f} -> 1 GPU {c1:.4f} "
            f"({secs[1]:.3f} s), 4 GPUs {c4:.4f} ({secs[4]:.3f} s), "
            f"rel diff {rel:.2e}"
        )
        if not (rel <= BA_PARITY and c4 < float(res[4].initial_cost)):
            raise GateError(f"sharded BA ({kind}): 4-GPU cost {c4} vs {c1}")

    w, h, frames = 1280, 720, 16
    cfg = SLAMConfig(image_width=w, image_height=h, descriptor_f_ref=2500.0)
    intr = Intrinsics.create(w / 2.0, h / 2.0)
    pano = synth.make_panorama(seed=0)
    cams = synth.make_trajectory(frames, f0=2500.0, f_amp=600.0, seed=0)
    imgs = np.stack([synth.render_image(pano, c, intr, w, h) for c in cams])
    focals = jnp.asarray(cams[:, 2], jnp.float32)
    tables = {
        n: [np.asarray(a) for a in dist.extract_features_sharded(
            imgs, cfg, mesh, focals=focals)]
        for n, mesh in ((1, mesh1), (4, mesh4))
    }
    equal = [np.array_equal(a, b) for a, b in zip(tables[1], tables[4])]
    diffs = [
        float(np.abs(a.astype(np.float64) - b).max())
        for a, b in zip(tables[1], tables[4])
    ]
    print(
        f"sharded frontend ({frames} frames 720p, 512 kp) [{card}]: "
        f"xy/desc/valid equal 1 vs 4 GPUs: {equal}, max diffs {diffs}, "
        f"{int(tables[4][2].sum())} keypoints"
    )
    if not all(equal):
        raise GateError("sharded frontend: 4-GPU tables differ from 1-GPU")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the offline path: 4 GPUs against 1",
    )
    ap.add_argument(
        "--out", default=os.path.join(ROOT, "chiprun_out", "chip_smoke"),
        help="directory for the runs' artifacts",
    )
    args = ap.parse_args()
    card = phase0()
    if args.four_cards:
        four_cards(card)
    else:
        one_card(card, args.out)

    import jax

    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))


if __name__ == "__main__":
    try:
        main()
    except GateError as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
