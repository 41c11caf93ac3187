"""PTZ camera geometry core: the 3-DoF pan/tilt/focal camera model over 2-DoF
ray landmarks.

This is the static-shape re-derivation of the reference's camera model
(reference: ``slam_system/ptz_camera.py`` — see SURVEY.md §2 layer 2 and §8.1;
the reference mount was empty so citations are to the survey's derived spec,
which follows Lu, Chen & Little, "Pan-tilt-zoom SLAM for Sports Videos",
BMVC 2019, arXiv:1907.08816).

Model
-----
The camera center ``C`` and base rotation ``Rb`` are fixed per sequence; only
``(pan, tilt, focal)`` vary per frame. Landmarks are rays through ``C``
parameterized by two angles ``(theta, phi)`` in the camera-base frame.

Projection of ray (theta, phi) under camera (p, t, f)  [SURVEY.md §8.1]::

    u = theta - p ;  v = phi - t
    x = f * tan(u) + cx
    y = -f * tan(v) / cos(u) + cy

All functions are pure ``jax.numpy`` on arrays, vectorized over leading batch
dimensions, fp32 by default, and safe to ``jit``/``vmap``/``grad``. Angles are
radians; focal length is in pixels.

Numerical safety: ``tan``/``sec`` explode near ``|u| = pi/2``; rays that far
outside the view are never legitimate observations, so `clip_angle` clamps
``u, v`` to ``+/- ANGLE_CLIP`` (callers additionally mask by field of view —
see SURVEY.md §10 "hard parts").
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Maximum |angle difference| fed to tan(); ~85.9 degrees. Observations beyond
# the FOV margin are masked out by callers; the clip only guards NaN/Inf
# propagation through masked-out lanes under jit.
ANGLE_CLIP = 1.5


class Intrinsics(NamedTuple):
    """Per-sequence shared camera constants (reference: SURVEY.md §8.1).

    Leaves are HOST numpy values on purpose: jitted closures embed them as
    HLO literals (free), and host code can read them without a device->host
    transfer, which would stall the host until the device catches up.

    Attributes:
      cx, cy: principal point (pixels).
      center: camera center ``C`` in world coordinates, shape (3,).
      base_rotation: world -> camera-base rotation ``Rb``, shape (3, 3).
    """

    cx: np.ndarray
    cy: np.ndarray
    center: np.ndarray
    base_rotation: np.ndarray

    @staticmethod
    def create(cx, cy, center=None, base_rotation=None, dtype=None):
        dtype = np.float32 if dtype is None else np.dtype(dtype)
        if center is None:
            center = np.zeros((3,), dtype)
        if base_rotation is None:
            base_rotation = np.eye(3, dtype=dtype)
        return Intrinsics(
            cx=np.asarray(cx, dtype),
            cy=np.asarray(cy, dtype),
            center=np.asarray(center, dtype),
            base_rotation=np.asarray(base_rotation, dtype),
        )


def clip_angle(a: jax.Array) -> jax.Array:
    """Clamp an angle difference before tan(); keeps masked lanes finite."""
    return jnp.clip(a, -ANGLE_CLIP, ANGLE_CLIP)


def project_rays(camera: jax.Array, rays: jax.Array, intr: Intrinsics) -> jax.Array:
    """Project rays to pixels under a PTZ camera.

    Args:
      camera: (..., 3) array (pan, tilt, focal).
      rays: (..., N, 2) array of (theta, phi) ray angles.
      intr: shared intrinsics.

    Returns:
      (..., N, 2) pixel coordinates (x, y).
    """
    pan = camera[..., 0:1]
    tilt = camera[..., 1:2]
    f = camera[..., 2:3]
    u = clip_angle(rays[..., 0] - pan)
    v = clip_angle(rays[..., 1] - tilt)
    x = f * jnp.tan(u) + intr.cx
    y = -f * jnp.tan(v) / jnp.cos(u) + intr.cy
    return jnp.stack([x, y], axis=-1)


def back_project_pixels(
    camera: jax.Array, pixels: jax.Array, intr: Intrinsics
) -> jax.Array:
    """Back-project pixels to rays (theta, phi) under a PTZ camera.

    Inverse of `project_rays` (exact round trip inside the angle clip).

    Args:
      camera: (..., 3) (pan, tilt, focal).
      pixels: (..., N, 2) pixel coordinates.

    Returns:
      (..., N, 2) ray angles.
    """
    pan = camera[..., 0:1]
    tilt = camera[..., 1:2]
    f = camera[..., 2:3]
    x = pixels[..., 0]
    y = pixels[..., 1]
    u = jnp.arctan2(x - intr.cx, f)
    theta = pan + u
    phi = tilt + jnp.arctan2(-(y - intr.cy) * jnp.cos(u), f)
    return jnp.stack([theta, phi], axis=-1)


def project_jacobians(
    camera: jax.Array, rays: jax.Array, intr: Intrinsics
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Closed-form projection + Jacobians wrt camera and ray parameters.

    Implements SURVEY.md §8.2. Note the identity d/d(theta,phi) =
    -d/d(pan,tilt): the ray Jacobian's first two columns are the negated
    camera columns, which we exploit (also a built-in self-test hook).

    Args:
      camera: (3,) or (..., 3).
      rays: (..., N, 2).

    Returns:
      (pix, J_cam, J_ray):
        pix:   (..., N, 2) projected pixels,
        J_cam: (..., N, 2, 3) d(x,y)/d(pan,tilt,f),
        J_ray: (..., N, 2, 2) d(x,y)/d(theta,phi).
    """
    pan = camera[..., 0:1]
    tilt = camera[..., 1:2]
    f = camera[..., 2:3]
    u = clip_angle(rays[..., 0] - pan)
    v = clip_angle(rays[..., 1] - tilt)
    tu = jnp.tan(u)
    tv = jnp.tan(v)
    su = 1.0 / jnp.cos(u)  # sec(u)
    sv = 1.0 / jnp.cos(v)  # sec(v)

    x = f * tu + intr.cx
    y = -f * tv * su + intr.cy
    pix = jnp.stack([x, y], axis=-1)

    zero = jnp.zeros_like(tu)
    # d(x,y)/d(pan, tilt, f)   [SURVEY.md §8.2]
    dx_dp = -f * su * su
    dx_dt = zero
    dx_df = tu
    dy_dp = f * tv * su * tu
    dy_dt = f * sv * sv * su
    dy_df = -tv * su
    j_cam = jnp.stack(
        [
            jnp.stack([dx_dp, dx_dt, dx_df], axis=-1),
            jnp.stack([dy_dp, dy_dt, dy_df], axis=-1),
        ],
        axis=-2,
    )
    # d(x,y)/d(theta, phi) = -d(x,y)/d(pan, tilt)
    j_ray = -j_cam[..., :2]
    return pix, j_cam, j_ray


def rays_from_points(points: jax.Array, intr: Intrinsics) -> jax.Array:
    """Convert 3D world points to rays in the camera-base frame.

    d = Rb (X - C); theta = atan2(dx, dz); phi = atan2(-dy, hypot(dx, dz)).
    Used for court-model synthesis/eval only (SURVEY.md §8.1), not in the
    SLAM loop.

    Args:
      points: (..., 3) world points.

    Returns:
      (..., 2) ray angles.
    """
    # precision=HIGHEST: full fp32. The default on the H100 is TF32
    # (10-bit mantissa), ~5e-4 relative on world coordinates of tens of
    # metres, which ground-truth angles cannot afford; this 3x3
    # contraction is not hot.
    d = jnp.einsum(
        "ij,...j->...i",
        intr.base_rotation,
        points - intr.center,
        precision=jax.lax.Precision.HIGHEST,
    )
    theta = jnp.arctan2(d[..., 0], d[..., 2])
    phi = jnp.arctan2(-d[..., 1], jnp.hypot(d[..., 0], d[..., 2]))
    return jnp.stack([theta, phi], axis=-1)


def in_view_mask(
    camera: jax.Array,
    rays: jax.Array,
    intr: Intrinsics,
    width: float,
    height: float,
    margin: float = 0.0,
) -> jax.Array:
    """Boolean mask of rays whose projection lands inside the image.

    Also rejects rays outside the tan() validity region (|u|,|v| within the
    clip), so masked EKF/BA lanes never see exploded values.
    """
    pan = camera[..., 0:1]
    tilt = camera[..., 1:2]
    u = rays[..., 0] - pan
    v = rays[..., 1] - tilt
    ok_angle = (jnp.abs(u) < ANGLE_CLIP) & (jnp.abs(v) < ANGLE_CLIP)
    pix = project_rays(camera, rays, intr)
    x, y = pix[..., 0], pix[..., 1]
    ok_img = (
        (x >= -margin)
        & (x < width + margin)
        & (y >= -margin)
        & (y < height + margin)
    )
    return ok_angle & ok_img


def residuals(
    camera: jax.Array,
    rays: jax.Array,
    observations: jax.Array,
    intr: Intrinsics,
) -> jax.Array:
    """Reprojection residuals r = project(camera, rays) - observations."""
    return project_rays(camera, rays, intr) - observations
