"""Closed-loop tracking with the matmul rounding of the H100.

On the H100, f32 matrix products at ``Precision.HIGH`` run on the tensor
cores as TF32: each operand keeps a 10-bit mantissa (unit roundoff ~4.9e-4)
and the products accumulate in fp32. The CPU computes the same products in
full fp32, so here both operands are rounded to TF32 inside the two products
that rely on HIGH — the EKF gain path (``ekf._mmh``) and LK's bilinear
sampling (``flow._select``) — and the loop from pixels has to track a
rendered 480x270 sequence in re-detect and in KLT mode with no NaN, inside
the same bounds as the fp32 loop (tests/test_frontend.py), and within twice
the fp32 loop's own error on the same sequence plus 1e-3 deg (the bound
chip_smoke.py holds the card to).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptzjax import ekf as ekflib
from ptzjax import synth
from ptzjax.config import SLAMConfig
from ptzjax.frontend import extract_features
from ptzjax.geometry import Intrinsics
from ptzjax.kernels import flow as flowlib
from ptzjax.slam import PTZSlam

W, H = 480, 270
_HIGHEST = jax.lax.Precision.HIGHEST
_SLACK_RAD = np.deg2rad(1e-3)


def tf32(x: jax.Array) -> jax.Array:
    """Round fp32 to the nearest TF32 value (10-bit mantissa, ties to
    even), kept in an fp32 container."""
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    bits = bits + jnp.uint32(0xFFF) + ((bits >> 13) & jnp.uint32(1))
    return jax.lax.bitcast_convert_type(
        bits & jnp.uint32(0xFFFFE000), jnp.float32
    )


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = jnp.asarray([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11,
                     -1234.567, 3.0e-5], jnp.float32)
    got = np.asarray(tf32(x))
    # exactly representable values pass; halfway cases round to even
    assert got[0] == 1.0 and got[1] == 1.0 + 2.0**-10
    assert got[2] == 1.0 and got[3] == 1.0 + 2.0**-9
    rel = np.abs(got[4:] - np.asarray(x[4:])) / np.abs(np.asarray(x[4:]))
    assert (rel <= 2.0**-11).all(), rel


@pytest.fixture
def tf32_products(monkeypatch):
    """A function that patches the HIGH products to TF32 operands and
    returns the counts of their calls."""
    calls = {"mmh": 0, "select": 0}

    def mmh(a, b):
        calls["mmh"] += 1
        return jnp.matmul(tf32(a), tf32(b), precision=_HIGHEST)

    def select(sy, windows, sx):
        calls["select"] += 1
        t = jnp.einsum("kpw,kwv->kpv", tf32(sy), tf32(windows),
                       precision=_HIGHEST)
        return jnp.einsum("kpv,kqv->kpq", tf32(t), tf32(sx),
                          precision=_HIGHEST)

    def enable():
        # jitted callees keep their traces: drop them so the patch is traced
        jax.clear_caches()
        monkeypatch.setattr(ekflib, "_mmh", mmh)
        monkeypatch.setattr(flowlib, "_select", select)
        return calls

    yield enable
    monkeypatch.undo()
    jax.clear_caches()


def _cfg():
    return SLAMConfig(
        image_width=W, image_height=H, max_keypoints=160, max_rays=96,
        max_map_rays=1024, max_keyframes=16, kf_desc_dim=128,
        sigma_obs=1.0, min_inliers=10,
    )


def _render(num_frames, f0, pan_amp, f_amp, seed):
    pano = synth.make_panorama(
        theta_range=(-0.6, 0.6), phi_range=(-0.35, 0.2),
        texels_per_rad=2200.0, seed=seed,
    )
    cams = synth.make_trajectory(
        num_frames, pan_amp=pan_amp, tilt0=-0.05, tilt_amp=0.02,
        f0=f0, f_amp=f_amp, period=num_frames * 1.6, seed=seed,
    )
    intr = Intrinsics.create(W / 2.0, H / 2.0)
    imgs = np.stack([synth.render_image(pano, c, intr, W, H) for c in cams])
    return imgs, cams, intr


def _track(mode, imgs, cams, intr):
    cfg = _cfg()
    slam = PTZSlam(cfg, intr)
    xy, desc, valid = extract_features(jnp.asarray(imgs[0]), cfg)
    state = slam.init(xy, desc, valid, cams[0])
    if mode == "redetect":
        return slam.run_segment_pixels(state, jnp.asarray(imgs[1:]))
    state, infos, _, _ = slam.run_segment_pixels_klt(
        state, jnp.asarray(imgs[1:]), jnp.asarray(imgs[0]), xy, valid
    )
    return state, infos


def _check(state, infos, cams):
    """Asserts the loop tracked; returns its pan and tilt MAE (rad)."""
    lost = np.asarray(infos.lost)
    assert not lost.any(), f"lost at frames {np.nonzero(lost)[0]}"
    pose = np.asarray(infos.pose)
    assert np.isfinite(pose).all()
    assert np.isfinite(np.asarray(state.ekf.cov)).all()
    mae = np.abs(pose[:, :2] - cams[1:, :2]).mean(axis=0)
    assert (mae < 2.5e-3).all(), mae
    return mae


@pytest.mark.parametrize("mode", ["redetect", "klt"])
def test_closed_loop_with_tf32_products(tf32_products, mode):
    if mode == "redetect":
        imgs, cams, intr = _render(30, 830.0, 0.12, 45.0, seed=1)
    else:
        imgs, cams, intr = _render(20, 830.0, 0.02, 6.0, seed=4)
    mae_fp32 = _check(*_track(mode, imgs, cams, intr), cams)
    calls = tf32_products()
    mae_tf32 = _check(*_track(mode, imgs, cams, intr), cams)
    assert calls["mmh"] > 0
    if mode == "klt":
        assert calls["select"] > 0
    bound = 2.0 * mae_fp32 + _SLACK_RAD
    assert (mae_tf32 <= bound).all(), (mae_tf32, mae_fp32)
