"""Smoke test for the experiment CLI (reference layer 8 analogue)."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = str(Path(__file__).resolve().parents[1])


def test_cli_synthetic_run(tmp_path):
    out = str(tmp_path / "run")
    r = subprocess.run(
        [
            sys.executable, "-m", "ptzjax.run", "--synthetic",
            "--frames", "30", "--out", out, "--platform", "cpu",
            "--checkpoint-every", "10",
        ],
        capture_output=True, text=True, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    summary = json.load(open(os.path.join(out, "summary.json")))
    assert summary["frames_lost"] == 0
    assert summary["pan_mae_deg"] < 0.1
    assert os.path.exists(os.path.join(out, "frames.jsonl"))
    assert os.path.exists(os.path.join(out, "trajectory.npz"))
    assert os.path.exists(os.path.join(out, "state_000010.npz"))
    # jsonl has one record per processed frame
    lines = open(os.path.join(out, "frames.jsonl")).read().strip().splitlines()
    assert len(lines) == 29


def test_cli_klt_images_run(tmp_path):
    """--synthetic-images --klt: the optical-flow frontend drives the full
    loop end-to-end from rendered pixels."""
    out = str(tmp_path / "klt")
    r = subprocess.run(
        [
            sys.executable, "-m", "ptzjax.run", "--synthetic-images", "--klt",
            "--frames", "12", "--out", out, "--platform", "cpu",
            "--width", "480", "--height", "270",
        ],
        capture_output=True, text=True, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    summary = json.load(open(os.path.join(out, "summary.json")))
    assert summary["frames_lost"] == 0
    assert summary["pan_mae_deg"] < 0.2


def test_cli_reloc_backends(tmp_path):
    """--reloc keyframe / forest: both alternative relocalization backends
    drive the CLI loop (forest also trains online from keyframes)."""
    for mode in ("keyframe", "forest"):
        out = str(tmp_path / mode)
        r = subprocess.run(
            [
                sys.executable, "-m", "ptzjax.run", "--synthetic",
                "--frames", "20", "--out", out, "--platform", "cpu",
                "--reloc", mode,
            ],
            capture_output=True, text=True, cwd=REPO,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        assert r.returncode == 0, r.stderr[-2000:]
        summary = json.load(open(os.path.join(out, "summary.json")))
        assert summary["frames_lost"] == 0
        assert summary["pan_mae_deg"] < 0.1


def test_cli_plot_artifact(tmp_path):
    """--plot writes the trajectory/error figure (reference eval plots)."""
    pytest = __import__("pytest")
    pytest.importorskip("matplotlib")
    out = str(tmp_path / "plotted")
    r = subprocess.run(
        [
            sys.executable, "-m", "ptzjax.run", "--synthetic",
            "--frames", "20", "--out", out, "--platform", "cpu", "--plot",
        ],
        capture_output=True, text=True, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    png = os.path.join(out, "trajectory.png")
    assert os.path.exists(png) and os.path.getsize(png) > 10_000


def test_cli_homography_baseline(tmp_path):
    """--tracker homography: the drift-comparison baseline runs end-to-end."""
    out = str(tmp_path / "homog")
    r = subprocess.run(
        [
            sys.executable, "-m", "ptzjax.run", "--synthetic",
            "--frames", "30", "--out", out, "--platform", "cpu",
            "--tracker", "homography",
        ],
        capture_output=True, text=True, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    summary = json.load(open(os.path.join(out, "summary.json")))
    assert summary["tracker"] == "homography"
    assert summary["pan_mae_deg"] < 0.1


def test_cli_fused_images_run(tmp_path):
    """--synthetic-images with the device frontend runs the FUSED on-device
    pipeline (frames -> features -> step inside one scan per chunk)."""
    out = str(tmp_path / "fused")
    r = subprocess.run(
        [
            sys.executable, "-m", "ptzjax.run", "--synthetic-images",
            "--frames", "12", "--out", out, "--platform", "cpu",
            "--width", "480", "--height", "270", "--chunk", "8",
        ],
        capture_output=True, text=True, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    summary = json.load(open(os.path.join(out, "summary.json")))
    assert summary["frontend"] == "fused"
    # the device the numbers were taken on, beside them
    assert summary["platform"] == "cpu" and summary["device_count"] >= 1
    assert summary["device_kind"] and summary["compile_s"] > 0
    assert summary["frames_lost"] == 0
    assert summary["pan_mae_deg"] < 0.2
    lines = open(os.path.join(out, "frames.jsonl")).read().strip().splitlines()
    assert len(lines) == 11


def test_cli_zoom_sweep_default_normalization(tmp_path):
    """A ~2x focal sweep tracks with NO config file:
    descriptor zoom normalization must be the DEFAULT product behavior
    (descriptor_f_ref auto-resolves to the init pose's focal)."""
    out = str(tmp_path / "zoom")
    r = subprocess.run(
        [
            sys.executable, "-m", "ptzjax.run", "--synthetic-images",
            "--frames", "40", "--out", out, "--platform", "cpu",
            "--width", "480", "--height", "270", "--chunk", "10",
            "--f0", "1300", "--f-amp", "430", "--period", "30",
            "--pan-amp", "0.05",
        ],
        capture_output=True, text=True, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    summary = json.load(open(os.path.join(out, "summary.json")))
    assert summary["frames_lost"] == 0, summary
    assert summary["pan_mae_deg"] < 0.2, summary
    # the sweep really was ~2x
    import numpy as np

    gt = np.load(os.path.join(out, "trajectory.npz"))["gt"]
    assert gt[:, 2].max() / gt[:, 2].min() > 1.8, gt[:, 2]


def test_cli_resume_from_checkpoint(tmp_path):
    """--resume continues a checkpointed run: the resumed half must pick up
    at the right frame and stay accurate."""
    out1 = str(tmp_path / "part1")
    r = subprocess.run(
        [
            sys.executable, "-m", "ptzjax.run", "--synthetic",
            "--frames", "40", "--out", out1, "--platform", "cpu",
            "--checkpoint-every", "20", "--seed", "3",
        ],
        capture_output=True, text=True, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    ck = os.path.join(out1, "state_000020.npz")
    assert os.path.exists(ck)

    out2 = str(tmp_path / "part2")
    r = subprocess.run(
        [
            sys.executable, "-m", "ptzjax.run", "--synthetic",
            "--frames", "40", "--out", out2, "--platform", "cpu",
            "--seed", "3", "--resume", ck,
        ],
        capture_output=True, text=True, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [
        json.loads(ln)
        for ln in open(os.path.join(out2, "frames.jsonl")).read().splitlines()
    ]
    assert lines[0]["frame"] == 21          # resumed exactly after frame 20
    assert lines[-1]["frame"] == 39
    summary = json.load(open(os.path.join(out2, "summary.json")))
    assert summary["frames_lost"] == 0
    assert summary["pan_mae_deg"] < 0.1


def test_cli_movers(tmp_path):
    """--movers N: the mover stress is a product
    surface. Masked run must track cleanly and record mover metadata."""
    from ptzjax.config import SLAMConfig

    cfg = SLAMConfig(
        image_width=640, image_height=360, max_keypoints=160, max_rays=96,
        max_map_rays=1024, max_keyframes=16, kf_desc_dim=128, sigma_obs=1.0,
        min_inliers=10,
    )
    cfg_path = str(tmp_path / "cfg.json")
    open(cfg_path, "w").write(cfg.to_json())
    out = str(tmp_path / "movers")
    r = subprocess.run(
        [
            sys.executable, "-m", "ptzjax.run", "--synthetic-images",
            "--movers", "8", "--frames", "20", "--out", out,
            "--platform", "cpu", "--width", "640", "--height", "360",
            "--f0", "1100", "--f-amp", "60", "--pan-amp", "0.12",
            "--config", cfg_path, "--chunk", "10",
        ],
        capture_output=True, text=True, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    summary = json.load(open(os.path.join(out, "summary.json")))
    assert summary["movers"] == 8
    assert summary["movers_masked"] is True
    assert summary["mover_pixel_frac_mid"] > 0.03
    assert summary["frames_lost"] == 0
    assert summary["pan_mae_deg"] < 0.2, summary


def test_cli_offline_mode(tmp_path):
    """--offline: sharded frontend over a virtual
    8-device mesh -> tracking -> sharded robust BA, emitting the standard
    artifacts plus BA cost before/after."""
    out = str(tmp_path / "offline")
    r = subprocess.run(
        [
            sys.executable, "-m", "ptzjax.run", "--synthetic-images",
            "--offline", "--mesh-devices", "8", "--frames", "14",
            "--out", out, "--platform", "cpu",
            "--width", "480", "--height", "270", "--ba-huber", "3.0",
        ],
        capture_output=True, text=True, cwd=REPO,
        env={
            **os.environ,
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        },
    )
    assert r.returncode == 0, r.stderr[-2000:]
    summary = json.load(open(os.path.join(out, "summary.json")))
    assert summary["mode"] == "offline"
    assert summary["mesh_devices"] == 8
    assert summary["frames_lost"] == 0
    assert summary["pan_mae_deg"] < 0.05
    assert summary["ba_robust"] is True
    assert summary["ba_cost_after"] <= summary["ba_cost_before"]
    # The product offline path must NOT zoom-normalize
    # with per-frame GT focals — only the frame-0 anchor (same information
    # the online bootstrap consumes). The accuracy assertions above hold
    # WITHOUT the oracle, proving the leak removal costs nothing here.
    assert summary["frontend_focals"] == "f_ref_frame0"
    lines = open(os.path.join(out, "frames.jsonl")).read().strip().splitlines()
    assert len(lines) == 13
    assert os.path.exists(os.path.join(out, "trajectory.npz"))
