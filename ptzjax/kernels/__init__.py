"""Feature kernels in plain jax: detector, descriptor and LK flow.

The on-device replacement for the reference's OpenCV C++ vision layer
(``slam_system/image_process.py`` — SURVEY.md §2 layer 3, §8.5). Each is
written in ``jax.numpy``/``lax`` and left to XLA to fuse; the matcher lives
in ``ptzjax.match``.
"""

from ptzjax.kernels.detect import detect_keypoints, harris_response
from ptzjax.kernels.descriptor import describe_keypoints
from ptzjax.kernels.flow import lk_track

__all__ = [
    "detect_keypoints",
    "harris_response",
    "describe_keypoints",
    "lk_track",
]
