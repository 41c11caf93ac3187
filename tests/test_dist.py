"""Distributed BA tests on the virtual 8-device CPU mesh (SURVEY.md §6
item 5): shard-count invariance and parity with the single-device solver."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptzjax import ba, dist
from ptzjax.config import SLAMConfig
from tests.test_ba import build_problem


@pytest.fixture(scope="module")
def problem():
    return build_problem(num_kf=6, num_rays_cap=160, noise=0.5, seed=7)


def test_eight_devices_available():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"


def test_sharded_matches_single_device(problem):
    prob, intr, gt_cams, _, _ = problem
    cfg = SLAMConfig(ba_iters=20)
    res1 = ba.run(prob, intr, cfg)

    mesh = dist.make_mesh(8)
    res8 = dist.run_sharded(prob, intr, cfg, mesh)

    # same minimum; the accepted COUNT can differ by float-level ties at the
    # plateau (per-shard partial sums reduce in a different order than the
    # single-device contraction), so parity is on parameters and cost
    np.testing.assert_allclose(
        np.asarray(res8.cams), np.asarray(res1.cams), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(float(res8.cost), float(res1.cost), rtol=1e-4)
    assert abs(int(res8.accepted) - int(res1.accepted)) <= 3
    m = prob.rays.shape[0]
    np.testing.assert_allclose(
        np.asarray(res8.rays)[:m], np.asarray(res1.rays), rtol=1e-4, atol=1e-5
    )


def test_shard_count_invariance(problem):
    prob, intr, _, _, _ = problem
    cfg = SLAMConfig(ba_iters=10)
    costs = []
    for n in (1, 2, 4, 8):
        mesh = dist.make_mesh(n)
        res = dist.run_sharded(prob, intr, cfg, mesh)
        costs.append(float(res.cost))
    assert max(costs) - min(costs) < 1e-3 * (1 + max(costs)), costs


def test_sharded_converges_to_gt(problem):
    prob, intr, gt_cams, gt_rays, n_real = problem
    cfg = SLAMConfig(ba_iters=25)
    mesh = dist.make_mesh(8)
    res = dist.run_sharded(prob, intr, cfg, mesh)
    cams = np.asarray(res.cams)
    assert np.abs(cams[:, 0] - gt_cams[:, 0]).max() < 5e-4
    assert float(res.cost) < float(res.initial_cost)


def test_padding_to_shard_multiple():
    prob, intr, _, _, _ = build_problem(num_kf=4, num_rays_cap=150, noise=0.0, seed=9)
    assert prob.rays.shape[0] == 150  # not divisible by 8
    cfg = SLAMConfig(ba_iters=8)
    mesh = dist.make_mesh(8)
    res = dist.run_sharded(prob, intr, cfg, mesh)
    assert res.rays.shape[0] % 8 == 0
    assert float(res.cost) < float(res.initial_cost)


def test_two_axis_host_chip_mesh(problem):
    """("host", "chip") 2-axis mesh (SURVEY.md §5, multi-host layout): the
    psum reduces over both axes and must match the 1-axis result."""
    prob, intr, _, _, _ = problem
    cfg = SLAMConfig(ba_iters=15)
    res1 = dist.run_sharded(prob, intr, cfg, dist.make_mesh(8))
    mesh2 = dist.make_mesh_2d(num_hosts=2, chips_per_host=4,
                              devices=jax.devices()[:8])
    assert mesh2.axis_names == ("host", "chip")
    res2 = dist.run_sharded(prob, intr, cfg, mesh2)
    np.testing.assert_allclose(
        np.asarray(res2.cams), np.asarray(res1.cams), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(float(res2.cost), float(res1.cost), rtol=1e-4)


@pytest.fixture(scope="module")
def rendered_frames():
    from ptzjax import synth
    from ptzjax.geometry import Intrinsics

    w, h = 320, 180
    intr = Intrinsics.create(w / 2.0, h / 2.0)
    pano = synth.make_panorama(
        theta_range=(-0.6, 0.6), phi_range=(-0.3, 0.15),
        texels_per_rad=1500.0, seed=4,
    )
    cams = synth.make_trajectory(
        8, pan_amp=0.04, tilt0=-0.04, tilt_amp=0.01,
        f0=900.0, f_amp=40.0, period=24.0, seed=4,
    )
    imgs = np.stack(
        [synth.render_image(pano, c, intr, w, h) for c in cams]
    ).astype(np.float32)
    return imgs, cams, intr


def test_sharded_frontend_invariance(rendered_frames):
    """Frame-parallel feature extraction over the mesh (SURVEY.md §3
    'sharded Pallas feature kernels'): identical tables at every shard
    count, and identical to the per-frame frontend."""
    from ptzjax.frontend import extract_features

    imgs, cams, intr = rendered_frames
    cfg = SLAMConfig(
        image_width=320, image_height=180, max_keypoints=96,
        descriptor_f_ref=900.0,
    )
    focals = cams[:, 2]
    ref = [
        extract_features(
            jnp.asarray(imgs[k]), cfg, focal=jnp.asarray(focals[k]),
        )
        for k in range(len(imgs))
    ]
    for n in (1, 2, 8):
        xy, desc, valid = dist.extract_features_sharded(
            imgs, cfg, dist.make_mesh(n), focals=focals
        )
        for k in range(len(imgs)):
            np.testing.assert_array_equal(
                np.asarray(xy[k]), np.asarray(ref[k][0])
            )
            np.testing.assert_array_equal(
                np.asarray(desc[k]), np.asarray(ref[k][1])
            )
            np.testing.assert_array_equal(
                np.asarray(valid[k]), np.asarray(ref[k][2])
            )


def test_offline_pipeline_sharded(rendered_frames):
    """The offline execution mode end-to-end (SURVEY.md §3): sharded
    frontend -> tracking scan -> SHARDED BA over the resulting map, with
    the BA result invariant to the frontend's shard count."""
    from ptzjax import mapstore
    from ptzjax.slam import PTZSlam

    imgs, cams, intr = rendered_frames
    cfg = SLAMConfig(
        image_width=320, image_height=180, max_keypoints=96,
        max_rays=96, max_map_rays=1024, max_keyframes=16,
        descriptor_f_ref=900.0, keyframe_overlap=0.98,
        online_ba_iters=0, sigma_obs=1.0,
    )
    xy, desc, valid = dist.extract_features_sharded(
        imgs, cfg, dist.make_mesh(8), focals=cams[:, 2]
    )
    slam = PTZSlam(cfg, intr)
    state = slam.init(xy[0], desc[0], valid[0], cams[0])
    state, infos = slam.run_segment(state, xy[1:], desc[1:], valid[1:])
    assert not bool(np.asarray(infos.lost).any())
    assert int(state.kf.count) >= 2

    prob = mapstore.build_ba_problem(
        state.kf, state.rays, max_views_per_ray=cfg.ba_max_views_per_ray
    )
    res = dist.run_sharded(prob, intr, SLAMConfig(ba_iters=10),
                           dist.make_mesh(8))
    assert float(res.cost) <= float(res.initial_cost)
    ref = ba.run(prob, intr, SLAMConfig(ba_iters=10))
    np.testing.assert_allclose(
        float(res.cost), float(ref.cost), rtol=1e-4, atol=1e-6
    )


def test_lm_state_checkpoint_resume(problem, tmp_path):
    """BA restartability per LM iteration (SURVEY.md §7): 20 straight
    iterations == 10 + checkpoint roundtrip + 10, bitwise."""
    from ptzjax import checkpoint as ckpt

    prob, intr, _, _, _ = problem
    cfg = SLAMConfig(ba_iters=20)
    straight = ba.run(prob, intr, cfg)

    lm = ba.init_lm_state(prob, intr, cfg)
    lm = ba.run_lm(prob, intr, cfg, lm, num_iters=10)
    path = str(tmp_path / "lm_state.npz")
    ckpt.save_pytree(path, lm)
    lm2 = ckpt.load_pytree(path, like=lm)
    lm2 = ba.run_lm(prob, intr, cfg, lm2, num_iters=10)

    np.testing.assert_array_equal(
        np.asarray(lm2.cams), np.asarray(straight.cams)
    )
    np.testing.assert_array_equal(
        np.asarray(lm2.rays), np.asarray(straight.rays)
    )
    assert int(lm2.iterations) == 20
    np.testing.assert_allclose(float(lm2.cost), float(straight.cost), rtol=0)
