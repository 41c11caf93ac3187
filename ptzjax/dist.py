"""Distributed execution: device mesh + observation-sharded bundle adjustment.

The reference has NO distributed anything (SURVEY.md §3, §5) — this layer is
new design, not a port. The workload's long axis is the map (rays and their
observations), so BA shards the ray-major observation table across a 1-D
device mesh:

- per LM iteration each shard builds its rays' normal terms and Schur
  corrections locally (``ba.schur_local``);
- ONE psum all-reduces the (3K,3K) reduced camera system + rhs (+ the cost
  scalar) over the mesh axis — the only collective on the critical path,
  over NVLink between the GPUs of one host and the network across hosts;
- the small camera solve runs replicated; per-ray back-substitution is
  shard-local.

Multi-host: call ``initialize_multihost`` before ``make_mesh()``;
``jax.devices()`` then spans all hosts and the same code runs unchanged
(the mesh axis follows the default device order, host-major).

Shard-count invariance is tested on a virtual 8-device CPU mesh
(SURVEY.md §6 item 5).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ptzjax import ba as balib
from ptzjax.ba import BAProblem, BAResult
from ptzjax.config import SLAMConfig
from ptzjax.geometry import Intrinsics

from jax import shard_map

AXIS = "obs"
HOST_AXIS = "host"
CHIP_AXIS = "chip"


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host entry point (SURVEY.md §5): call ONCE per process before
    any mesh construction; afterwards ``jax.devices()`` spans all hosts and
    ``make_mesh``/``make_mesh_2d`` lay the global device set out unchanged.
    On GPU and CPU clusters pass all three arguments: nothing discovers the
    coordinator."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(num_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the observation/ray axis (SURVEY.md §5)."""
    if devices is None:
        devices = jax.devices()
        if num_devices is not None:
            devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (AXIS,))


def make_mesh_2d(
    num_hosts: int | None = None,
    chips_per_host: int | None = None,
    devices=None,
) -> Mesh:
    """2-axis ("host", "chip") mesh for several hosts: the outer axis
    crosses the network between hosts, the inner axis the NVLink fabric
    within one (SURVEY.md §5). jax.devices() orders devices host-major, so
    the natural reshape puts each row of the mesh on one host — the BA psum
    can then reduce within a host first and send one small
    (3K,3K)+K*3-float message between hosts.
    """
    if devices is None:
        devices = jax.devices()
    devices = list(devices)
    if num_hosts is None:
        num_hosts = max(1, jax.process_count())
    if chips_per_host is None:
        chips_per_host = len(devices) // num_hosts
    devices = devices[: num_hosts * chips_per_host]
    arr = np.asarray(devices).reshape(num_hosts, chips_per_host)
    return Mesh(arr, (HOST_AXIS, CHIP_AXIS))


def _ray_axes(mesh: Mesh) -> tuple[str, ...]:
    """The mesh axes the ray dimension shards over (all of them: a 2-axis
    mesh flattens host x chip onto the single long axis of this workload)."""
    return tuple(mesh.axis_names)


def pad_problem_for_mesh(prob: BAProblem, num_shards: int) -> BAProblem:
    """Pad the ray axis to a multiple of the shard count (weights 0)."""
    m = prob.rays.shape[0]
    pad = (-m) % num_shards
    if pad == 0:
        return prob
    return prob._replace(
        rays=jnp.pad(prob.rays, ((0, pad), (0, 0))),
        obs_pix=jnp.pad(prob.obs_pix, ((0, pad), (0, 0), (0, 0))),
        obs_cam=jnp.pad(prob.obs_cam, ((0, pad), (0, 0))),
        obs_w=jnp.pad(prob.obs_w, ((0, pad), (0, 0))),
    )


def shard_problem(prob: BAProblem, mesh: Mesh) -> BAProblem:
    """Place the ray-major arrays sharded over the mesh (over ALL its axes
    — host x chip flattens onto the ray dimension), cams replicated."""
    axes = _ray_axes(mesh)
    ray_sharded = NamedSharding(mesh, P(axes))
    replicated = NamedSharding(mesh, P())
    return BAProblem(
        cams=jax.device_put(prob.cams, replicated),
        rays=jax.device_put(prob.rays, ray_sharded),
        obs_pix=jax.device_put(prob.obs_pix, ray_sharded),
        obs_cam=jax.device_put(prob.obs_cam, ray_sharded),
        obs_w=jax.device_put(prob.obs_w, ray_sharded),
        cam_free=jax.device_put(prob.cam_free, replicated),
    )


def extract_features_sharded(
    imgs,
    cfg: SLAMConfig,
    mesh: Mesh,
    masks=None,
    focals=None,
):
    """Offline multi-device feature extraction: frames data-parallel over
    the mesh (SURVEY.md §3 "Batched/sharded Pallas feature kernels ...
    per-chip data parallel"). Each device runs the fused detect+describe
    pipeline (``frontend.extract_features``) over
    its shard of the (T, H, W) frame stack via ``lax.map``; there is no
    cross-frame dependence, so the only communication is the initial
    scatter. Results are shard-count invariant (tested on the virtual CPU
    mesh) and feed ``run_sharded`` BA directly — the offline half of
    SURVEY.md §3's execution modes.

    Args:
      imgs: (T, H, W) float frames.
      masks: optional (T, H, W) bool detection masks.
      focals: optional (T,) per-frame focal estimates (zoom-normalized
        descriptors; e.g. annotation priors in offline mode).

    Returns:
      (xy (T, K, 2), desc (T, K, D), valid (T, K)), sharded over frames.
    """
    from ptzjax.frontend import extract_features

    imgs = jnp.asarray(imgs)
    t = imgs.shape[0]
    num = mesh.devices.size
    axes = _ray_axes(mesh)
    pad = (-t) % num
    if pad:
        imgs = jnp.concatenate([imgs, jnp.repeat(imgs[-1:], pad, 0)])
        if masks is not None:
            masks = jnp.concatenate(
                [jnp.asarray(masks), jnp.repeat(jnp.asarray(masks)[-1:], pad, 0)]
            )
        if focals is not None:
            focals = jnp.concatenate(
                [jnp.asarray(focals), jnp.repeat(jnp.asarray(focals)[-1:], pad)]
            )

    def one(im, mask, focal):
        return extract_features(im, cfg, mask=mask, focal=focal)

    def local(ims, msks, fs):
        if masks is None and focals is None:
            return jax.lax.map(lambda im: one(im, None, None), ims)
        if masks is None:
            return jax.lax.map(lambda a: one(a[0], None, a[1]), (ims, fs))
        if focals is None:
            return jax.lax.map(lambda a: one(a[0], a[1], None), (ims, msks))
        return jax.lax.map(lambda a: one(a[0], a[1], a[2]), (ims, msks, fs))

    in_specs = (
        P(axes),
        P(axes) if masks is not None else P(),
        P(axes) if focals is not None else P(),
    )
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(axes), P(axes), P(axes)),
        check_vma=False,
    )
    m_arg = (
        jnp.asarray(masks)
        if masks is not None
        else jnp.zeros((), jnp.float32)
    )
    f_arg = (
        jnp.asarray(focals, jnp.float32)
        if focals is not None
        else jnp.zeros((), jnp.float32)
    )
    xy, desc, valid = jax.jit(fn)(imgs, m_arg, f_arg)
    return xy[:t], desc[:t], valid[:t]


def run_sharded(
    prob: BAProblem, intr: Intrinsics, cfg: SLAMConfig, mesh: Mesh
) -> BAResult:
    """Distributed LM/Schur BA over ray shards. Same math as ``ba.run`` —
    the single-device path is the num_shards=1 special case, and results are
    shard-count invariant (tested). Accepts a 1-axis ("obs") or 2-axis
    ("host", "chip") mesh: the psum reduces over every mesh axis."""
    num = mesh.devices.size
    axes = _ray_axes(mesh)
    prob = pad_problem_for_mesh(prob, num)
    prob = shard_problem(prob, mesh)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(),         # cams
            P(axes),     # rays
            P(axes),     # obs_pix
            P(axes),     # obs_cam
            P(axes),     # obs_w
            P(),         # cam_free
        ),
        out_specs=BAResult(
            cams=P(), rays=P(axes), cost=P(), initial_cost=P(),
            iterations=P(), accepted=P(),
        ),
        check_vma=False,
    )
    def _run(cams, rays, obs_pix, obs_cam, obs_w, cam_free):
        local = BAProblem(cams, rays, obs_pix, obs_cam, obs_w, cam_free)
        if cfg.ba_huber_px > 0:
            # robust IRLS sharded the same way (ba.run_robust psums the
            # reweighted normal terms over the mesh axes per round)
            return balib.run_robust(local, intr, cfg, axis_name=axes)
        return balib.run(local, intr, cfg, axis_name=axes)

    return jax.jit(_run)(
        prob.cams, prob.rays, prob.obs_pix, prob.obs_cam, prob.obs_w,
        prob.cam_free,
    )
