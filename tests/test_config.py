"""Config-surface behavior: JSON round-trip, retired-key handling, and
AUTO descriptor_f_ref resolution at the library boundary."""

import json
import warnings

import numpy as np
import pytest

from ptzjax.config import SLAMConfig


def test_json_roundtrip():
    cfg = SLAMConfig(max_rays=64, sigma_obs=2.0, mesh_shape=(2, 4))
    cfg2 = SLAMConfig.from_json(cfg.to_json())
    assert cfg2 == cfg


def test_from_json_warns_and_drops_unknown_keys():
    d = json.loads(SLAMConfig().to_json())
    d["nms_cell"] = 8          # retired field (pre-r3 config files)
    d["tpyo_field"] = 1.0
    with pytest.warns(UserWarning, match="nms_cell"):
        cfg = SLAMConfig.from_json(json.dumps(d))
    assert cfg == SLAMConfig()


def test_ptzslam_init_resolves_auto_f_ref():
    from ptzjax.geometry import Intrinsics
    from ptzjax.slam import PTZSlam

    cfg = SLAMConfig(max_rays=16, max_keypoints=16, max_map_rays=64,
                     max_keyframes=4)
    assert cfg.descriptor_f_ref < 0  # AUTO is the default
    intr = Intrinsics(
        cx=640.0, cy=360.0, center=np.zeros(3, np.float32),
        base_rotation=np.eye(3, dtype=np.float32),
    )
    slam = PTZSlam(cfg, intr)
    xy = np.zeros((16, 2), np.float32)
    desc = np.zeros((16, 128), np.float32)
    valid = np.zeros((16,), bool)
    slam.init(xy, desc, valid, np.asarray([0.0, 0.0, 1234.5], np.float32))
    assert slam.cfg.descriptor_f_ref == pytest.approx(1234.5)


def test_desc_scale_warns_on_unresolved_sentinel():
    import jax.numpy as jnp

    from ptzjax.frontend import _desc_scale

    cfg = SLAMConfig()  # AUTO, unresolved
    with pytest.warns(UserWarning, match="AUTO"):
        assert _desc_scale(cfg, jnp.asarray(2000.0)) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert _desc_scale(cfg, None) is None  # no focal: silent no-op
        resolved = cfg.replace(descriptor_f_ref=2000.0)
        s = _desc_scale(resolved, jnp.asarray(1000.0))
    assert float(s) == pytest.approx(0.5)
