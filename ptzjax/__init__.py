"""ptzjax — pan-tilt-zoom SLAM in JAX, on one GPU.

A from-scratch JAX re-architecture of the capabilities of
lulufa390/Pan-tilt-zoom-SLAM (BMVC 2019, arXiv:1907.08816). See SURVEY.md for
the structural analysis and BASELINE.md for targets.
"""

from ptzjax.config import SLAMConfig
from ptzjax.geometry import (
    Intrinsics,
    back_project_pixels,
    in_view_mask,
    project_jacobians,
    project_rays,
    rays_from_points,
    residuals,
)
from ptzjax.slam import PTZSlam, SlamState, FrameInfo, info_to_dict

__version__ = "0.1.0"
