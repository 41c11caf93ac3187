"""Experiment runner CLI: ``python -m ptzjax.run``.

The engine's counterpart to the reference's per-dataset driver scripts
(SURVEY.md §2 layer 8, §4.5): run the online SLAM loop over a sequence,
optionally bundle-adjust at the end, and emit the §7 observability
artifacts — per-frame JSONL, an eval-summary JSON against ground truth,
and a final trajectory .npz.

Modes:
  --synthetic          keypoint-oracle sequence (no images; EKF/map/BA path)
  --synthetic-court    court-model oracle: landmarks from 3D basketball-court
                       geometry via the base-rotation camera (the reference's
                       synthesized/ experiments)
  --synthetic-images   panorama-rendered video through the vision kernels
  --annotation/--images  dataset mode (.mat/.npz annotations + frames)

Example:
  python -m ptzjax.run --synthetic --frames 240 --out out/run1
  python -m ptzjax.run --annotation seq.mat --images frames/ --out out/run2
"""

from __future__ import annotations

import argparse
import json
import os
import time


def _parse(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="ptzjax SLAM experiment runner")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-court", action="store_true")
    p.add_argument("--synthetic-images", action="store_true")
    p.add_argument("--annotation", type=str, default=None)
    p.add_argument("--images", type=str, default=None)
    p.add_argument("--frames", type=int, default=240)
    p.add_argument("--config", type=str, default=None, help="SLAMConfig JSON")
    p.add_argument("--out", type=str, required=True, help="output directory")
    p.add_argument("--ba", action="store_true", help="final bundle adjustment")
    p.add_argument(
        "--ba-huber", type=float, default=None,
        help="Huber kernel width (px) for robust IRLS bundle adjustment "
             "(ba.run_robust); overrides cfg.ba_huber_px. 0 = pure "
             "quadratic. Use ~3 when matches may contain outliers",
    )
    p.add_argument(
        "--klt", action="store_true",
        help="image modes: carry keypoints between frames with pyramidal LK "
             "optical flow (detect only to refill) instead of re-detecting "
             "every frame — the reference's optical_flow_matching mode",
    )
    p.add_argument(
        "--reloc", type=str, default="map",
        choices=["map", "keyframe", "forest"],
        help="relocalization backend: 'map' matches the global ray store, "
             "'keyframe' does the reference's nearest-keyframe lookup, "
             "'forest' uses the native C++ BTDTR regressor trained online "
             "from keyframes (the reference's rf_map variant)",
    )
    p.add_argument(
        "--frontend", type=str, default="device", choices=["device", "cv2"],
        help="image modes: 'device' = the on-device Harris/SIFT/LK kernels; "
             "'cv2' = OpenCV SIFT + calcOpticalFlowPyrLK ingestion (the "
             "reference's own vision layer — BASELINE.md config 1)",
    )
    p.add_argument(
        "--tracker", type=str, default="slam", choices=["slam", "homography"],
        help="'slam' = the full keyframe+map system; 'homography' = the "
             "frame-to-frame homography-EKF baseline (the reference's "
             "deprecated/ tracker, the paper's drift comparison)",
    )
    p.add_argument(
        "--plot", action="store_true",
        help="write trajectory/error curves (trajectory.png) — the "
             "reference's matplotlib eval plots",
    )
    p.add_argument(
        "--chunk", type=int, default=64,
        help="frames per on-device lax.scan segment (all paths run chunked "
             "at ONE static shape, so compile time and device memory are "
             "bounded regardless of --frames); interactive modes pull "
             "per-frame info once per chunk, the default path only at the "
             "end, so the host never waits on the device inside the loop",
    )
    p.add_argument(
        "--offline", action="store_true",
        help="offline execution mode (SURVEY.md §3): frame-parallel feature "
             "extraction over the device mesh (dist.extract_features_sharded), "
             "sequential tracking scan, then SHARDED bundle adjustment over "
             "the mesh (robust when --ba-huber > 0). Emits the standard "
             "artifacts plus ba_cost_before/after in summary.json",
    )
    p.add_argument(
        "--oracle-focals", action="store_true",
        help="--offline: EXPLICIT oracle mode — zoom-normalize descriptors "
             "with per-frame GROUND-TRUTH focals instead of the frame-0 "
             "anchor. Leaks GT into the frontend; for kernel-quality "
             "ablations only, never for accuracy claims",
    )
    p.add_argument(
        "--mesh-devices", type=int, default=0,
        help="--offline: devices in the 1-D mesh (0 = all visible; test on "
             "CPU with XLA_FLAGS=--xla_force_host_platform_device_count=8)",
    )
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument(
        "--resume", type=str, default=None,
        help="resume from a state checkpoint (.npz written by "
             "--checkpoint-every); continues at the frame after the "
             "checkpoint's frame_idx",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument(
        "--desc-f-ref", type=float, default=None,
        help="descriptor zoom-normalization reference focal: descriptors "
             "sample at f/f_ref spacing so their angular footprint is "
             "zoom-invariant. Default: AUTO (the init pose's focal); "
             "0 disables; > 0 pins an explicit value",
    )
    p.add_argument(
        "--f0", type=float, default=2500.0,
        help="--synthetic-images: trajectory mean focal (px)",
    )
    p.add_argument(
        "--f-amp", type=float, default=600.0,
        help="--synthetic-images: trajectory focal sweep amplitude (px); "
             "f0=2000 --f-amp 670 is a ~2x zoom sweep",
    )
    p.add_argument(
        "--pan-amp", type=float, default=0.35,
        help="--synthetic-images: trajectory pan amplitude (rad)",
    )
    p.add_argument(
        "--period", type=float, default=240.0,
        help="--synthetic-images: trajectory base period (frames); "
             "period ~ frames/2 makes the focal sine sweep its full range "
             "within the run",
    )
    p.add_argument(
        "--movers", type=int, default=0,
        help="--synthetic-images: composite N textured moving blobs (player "
             "analogues with coherent non-camera motion) into the rendered "
             "frames; detection masks from their bounding boxes are applied "
             "by default (the reference's player-box masking)",
    )
    p.add_argument(
        "--movers-unmasked", action="store_true",
        help="--movers: do NOT mask the blobs out of detection — the "
             "robustness stress: consensus pre-gate + wrong-motion slot "
             "retirement must carry tracking (or fail loudly as 'lost')",
    )
    p.add_argument(
        "--platform", type=str, default=None,
        help="force a jax platform (e.g. cpu); default is the environment's",
    )
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); returns the
    summary it writes to ``<out>/summary.json``."""
    args = _parse(argv)
    os.makedirs(args.out, exist_ok=True)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp
    import numpy as np

    from ptzjax import checkpoint as ckpt
    from ptzjax import compile_cache
    from ptzjax import eval as evallib
    from ptzjax import io as iolib
    from ptzjax import synth
    from ptzjax.config import SLAMConfig
    from ptzjax.geometry import Intrinsics
    from ptzjax.slam import PTZSlam, infos_to_dicts

    compile_cache.setup()
    cfg = SLAMConfig()
    if args.config:
        cfg = SLAMConfig.from_json(open(args.config).read())
    cfg = cfg.replace(
        image_width=args.width, image_height=args.height, reloc_mode=args.reloc
    )
    if args.ba_huber is not None:
        cfg = cfg.replace(ba_huber_px=float(args.ba_huber))

    # --- assemble (features, gt, intr) per mode -----------------------------
    gt = None
    mover_meta = {}
    if args.synthetic_court:
        from ptzjax.features import synth_features

        seq, _points = synth.make_court_sequence(
            num_frames=args.frames, width=args.width, height=args.height,
            f0=1800.0, f_amp=150.0, period=args.frames * 1.5, seed=args.seed,
        )
        feats = [
            synth_features(seq, k, cfg.max_keypoints, seed=args.seed)[0]
            for k in range(args.frames)
        ]
        feats = [(f.xy, f.desc, f.valid) for f in feats]
        gt = seq.cameras
        intr = seq.intr
    elif args.synthetic:
        seq = synth.make_sequence(
            num_frames=args.frames, num_rays=2500,
            width=args.width, height=args.height, seed=args.seed,
        )
        rng = np.random.default_rng(args.seed)
        desc = rng.normal(size=(2500, cfg.kf_desc_dim)).astype(np.float32)
        desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
        seq = seq._replace(descriptors=desc)
        from ptzjax.features import synth_features

        feats = [
            synth_features(seq, k, cfg.max_keypoints, seed=args.seed)[0]
            for k in range(args.frames)
        ]
        feats = [(f.xy, f.desc, f.valid) for f in feats]
        gt = seq.cameras
        intr = Intrinsics.create(float(seq.intr.cx), float(seq.intr.cy))
    elif args.synthetic_images:
        intr = Intrinsics.create(args.width / 2.0, args.height / 2.0)
        pano = synth.make_panorama(seed=args.seed)
        gt = synth.make_trajectory(
            args.frames, pan_amp=args.pan_amp, f0=args.f0, f_amp=args.f_amp,
            period=args.period, seed=args.seed,
        )
        movers = None
        if args.movers > 0:
            movers = synth.make_moving_blobs(
                args.frames, num_blobs=args.movers, seed=args.seed,
            )
        imgs_all = np.stack(
            [
                synth.render_image(
                    pano, c, intr, args.width, args.height,
                    movers=movers, frame=k,
                )
                for k, c in enumerate(gt)
            ]
        )
        masks_all = None
        if movers is not None and not args.movers_unmasked:
            masks_all = np.stack(
                [
                    iolib.boxes_to_mask(
                        synth.mover_boxes(
                            movers, k, gt[k], intr, args.width, args.height
                        ),
                        args.height, args.width,
                    )
                    for k in range(args.frames)
                ]
            )
        if movers is not None:
            mid = args.frames // 2
            mover_meta = {
                "movers": args.movers,
                "movers_masked": not args.movers_unmasked,
                "mover_pixel_frac_mid": round(
                    synth.mover_pixel_fraction(
                        movers, mid, gt[mid], intr, args.width, args.height
                    ),
                    4,
                ),
            }
        cfg = _resolve_f_ref(cfg, args, gt)
        feats = _stage_image_features(args, cfg, imgs_all, masks_all)
    else:
        if not args.annotation or not args.images:
            raise SystemExit("dataset mode needs --annotation and --images")
        seqm = iolib.SequenceManager(args.annotation, args.images)
        intr = seqm.ann.intr
        gt = seqm.ann.cameras[: args.frames]
        n = min(args.frames, seqm.length)
        imgs_all = np.stack([seqm.get_image(k) for k in range(n)])
        masks_all = np.stack(
            [
                seqm.get_mask(k, imgs_all.shape[1], imgs_all.shape[2])
                for k in range(n)
            ]
        )
        cfg = _resolve_f_ref(cfg, args, gt)
        feats = _stage_image_features(args, cfg, imgs_all, masks_all)

    # --- run ------------------------------------------------------------------
    if args.offline:
        return _run_offline(
            args, cfg, intr,
            imgs_all if feats is None else None,
            masks_all if feats is None else None,
            feats, gt,
        )
    if args.tracker == "homography":
        return _run_homography_baseline(args, cfg, intr, feats, gt)

    # fused from-pixels path: images stay on device and
    # the frontend runs INSIDE the scanned program, so the descriptor scale
    # uses the live focal estimate and no per-frame host dispatch happens
    fused = feats is None
    slam = PTZSlam(cfg, intr)
    if fused:
        from ptzjax.frontend import extract_features

        mask0 = None if masks_all is None else jnp.asarray(masks_all[0])
        feats0 = extract_features(
            jnp.asarray(imgs_all[0]), cfg, mask=mask0,
            focal=jnp.asarray(gt[0][2]),
        )
        state = slam.init(*feats0, gt[0])
        total = len(imgs_all)
        klt_carry = [imgs_all[0], feats0[0], feats0[2]]  # img, xy, valid
    else:
        state = slam.init(*feats[0], gt[0])
        total = len(feats)

    start_k = 1
    if args.resume:
        state = ckpt.load_pytree(args.resume, like=state)
        start_k = int(np.asarray(state.frame_idx)) + 1
        print(f"resumed from {args.resume} at frame {start_k}")
        if fused and args.klt and start_k > 1:
            from ptzjax.frontend import extract_features

            f_prev = extract_features(
                jnp.asarray(imgs_all[start_k - 1]), cfg,
                mask=(
                    None if masks_all is None
                    else jnp.asarray(masks_all[start_k - 1])
                ),
                focal=jnp.asarray(np.asarray(state.ekf.cam)[2]),
            )
            klt_carry = [imgs_all[start_k - 1], f_prev[0], f_prev[2]]

    forest = None
    trained_kf = 0

    def _train_forest_on_new_keyframes(state):
        """Feed keyframes inserted since the last call to the native forest
        (SURVEY.md §4.1/§4.2 'rf_map.add_keyframe': online training)."""
        nonlocal trained_kf
        n_kf = int(state.kf.count)
        if n_kf <= trained_kf:
            return
        kf = jax.device_get(state.kf)
        rays = jax.device_get(state.rays.rays)
        for i in range(trained_kf, n_kf):
            keep = kf.feat_valid[i] & (kf.ray_ids[i] >= 0)
            ids = np.clip(kf.ray_ids[i], 0, None)
            forest.add_keyframe(kf.desc[i], rays[ids], valid=keep)
        trained_kf = n_kf

    if args.reloc == "forest":
        from ptzjax.reloc_forest import RelocForest, relocalize_rf

        # async_train: rebuilds run on a native
        # background thread, so keyframe-time training never stalls the
        # host loop; lost-frame queries serve the previous trees until the
        # new build swaps in
        forest = RelocForest(async_train=True)
        _train_forest_on_new_keyframes(state)

    chunk = max(1, args.chunk)

    if not fused:
        # stacked feature tables: chunks run as single on-device lax.scans
        # and per-frame info is pulled at most ONCE per chunk (a d2h
        # transfer per frame would make the host wait on every frame)
        xy_all = np.stack([np.asarray(f[0]) for f in feats])
        desc_all = np.stack([np.asarray(f[1]) for f in feats])
        valid_all = np.stack([np.asarray(f[2]) for f in feats])

    def _pad(arr, end, pad):
        return np.concatenate([arr, np.repeat(arr[-1:], pad, 0)]) if pad else arr

    def run_chunk(state, k, end, warmup=False):
        """Run frames [k, end) as one scan, padded to the SAME static
        length (each distinct chunk shape costs a full host-side retrace);
        padding frames are masked no-ops. ``warmup=True`` masks EVERY frame
        (pure no-op chunk: same trace, zero state effect) for compile
        warm-up. Returns (state, infos)."""
        n = end - k
        pad = chunk - n
        ok = np.zeros(chunk, bool) if warmup else np.arange(chunk) < n
        if fused:
            imgs_c = _pad(imgs_all[k:end], end, pad)
            masks_c = (
                None if masks_all is None else _pad(masks_all[k:end], end, pad)
            )
            if args.klt:
                state, infos, xy_t, valid_t = slam.run_segment_pixels_klt(
                    state, imgs_c, klt_carry[0], klt_carry[1], klt_carry[2],
                    frame_ok=ok, masks=masks_c,
                )
                klt_carry[0] = imgs_all[end - 1]
                klt_carry[1], klt_carry[2] = xy_t, valid_t
                return state, infos
            return slam.run_segment_pixels(state, imgs_c, masks_c, ok)
        xy_c = _pad(xy_all[k:end], end, pad)
        desc_c = _pad(desc_all[k:end], end, pad)
        valid_c = np.concatenate(
            [valid_all[k:end], np.zeros((pad,) + valid_all.shape[1:], bool)]
        )
        return slam.run_segment(state, xy_c, desc_c, valid_c, ok)

    def host_features(k):
        """Features for one frame on the host (forest reloc needs them)."""
        if not fused:
            return feats[k]
        from ptzjax.frontend import extract_features

        mask = None if masks_all is None else jnp.asarray(masks_all[k])
        return extract_features(
            jnp.asarray(imgs_all[k]), cfg, mask=mask,
            focal=state.ekf.pose[2],
        )

    if start_k >= total:
        raise SystemExit(
            f"nothing to do: start frame {start_k} >= sequence length {total}"
        )

    # warm up trace+compile with an all-masked (pure no-op) chunk so the
    # reported fps is the loop, not the one-time jit cost
    t_warm = time.perf_counter()
    pre_warm = list(klt_carry) if fused and args.klt else None
    state_w, _ = run_chunk(
        state, start_k, min(start_k + chunk, total), warmup=True
    )
    if pre_warm is not None:
        klt_carry[:] = pre_warm  # undo the warmup's carry advance
    jax.block_until_ready(state_w)
    del state_w
    compile_s = time.perf_counter() - t_warm

    records = []
    interactive = forest is not None or args.checkpoint_every
    pending = []  # (k, end, infos) for the non-interactive path
    lost_host = False
    t0 = time.perf_counter()
    k = start_k
    while k < total:
        if forest is not None and lost_host:
            # forest path: the host resolves frames the in-graph reloc
            # could not recover through the native regressor (SURVEY.md
            # §4.4 path B), one frame at a time until tracking resumes
            xy, desc, valid = host_features(k)
            res = relocalize_rf(forest, desc, xy, valid, intr, cfg)
            state = slam.apply_reloc_result(state, xy, desc, valid, res)
            lost_host = not bool(res.success)
            records.append({
                "frame": k, "event": "reloc", "lost": lost_host,
                "reloc_success": bool(res.success),
                "reloc_inliers": int(res.inliers),
                "pose": np.asarray(jax.device_get(state.ekf.pose)),
                "num_matches": int(res.inliers), "num_used": int(res.inliers),
                "innovation_rms": 0.0, "keyframe": False,
                "active_slots": int(jax.device_get(state.ekf.active.sum())),
                "max_kf_overlap": 1.0,
            })
            k += 1
            continue
        end = min(k + chunk, total)
        if args.checkpoint_every:
            # stop chunks exactly on checkpoint frames
            next_ckpt = (
                (k - 1) // args.checkpoint_every + 1
            ) * args.checkpoint_every
            end = min(end, next_ckpt + 1)
        pre_state = state
        pre_carry = list(klt_carry) if fused and args.klt else None
        state, infos = run_chunk(pre_state, k, end)
        if not interactive:
            pending.append((k, end, infos))
            k = end
            continue
        recs = infos_to_dicts(infos, frame0=k)[: end - k]
        if forest is not None:
            first_lost = next(
                (j for j, r in enumerate(recs) if r["lost"]), None
            )
            if first_lost is not None and k + first_lost + 1 < end:
                # rewind to the first lost frame so the forest engages
                # immediately instead of after up to chunk-1 wasted frames
                end = k + first_lost + 1
                if pre_carry is not None:
                    klt_carry[:] = pre_carry
                state, infos = run_chunk(pre_state, k, end)
                recs = infos_to_dicts(infos, frame0=k)[: end - k]
        records.extend(recs)
        if forest is not None:
            if any(r["keyframe"] for r in recs):
                _train_forest_on_new_keyframes(state)
            lost_host = recs[-1]["lost"]
        if args.checkpoint_every and (end - 1) % args.checkpoint_every == 0:
            ckpt.save_pytree(
                os.path.join(args.out, f"state_{end - 1:06d}.npz"), state
            )
        k = end
    jax.block_until_ready(state)
    wall = time.perf_counter() - t0
    for k0, end0, infos in pending:
        records.extend(infos_to_dicts(infos, frame0=k0)[: end0 - k0])

    ba_info = {}
    if args.ba:
        state, ba_info = slam.bundle_adjust(state)
        print("BA:", json.dumps(ba_info))

    # --- artifacts --------------------------------------------------------------
    iolib.write_trajectory_jsonl(os.path.join(args.out, "frames.jsonl"), records)
    pose = np.stack([r["pose"] for r in records])
    fidx = np.array([r["frame"] for r in records])
    gt_r = gt[fidx]
    np.savez(os.path.join(args.out, "trajectory.npz"), pose=pose, gt=gt_r)
    summary = {
        **evallib.trajectory_errors(pose, gt_r).as_dict(),
        "reprojection_rmse_px": evallib.reprojection_rmse(
            pose, gt_r, intr, args.width, args.height
        ),
        "fps": (total - start_k) / wall,
        # trace + compile + one all-masked chunk, before the timed loop
        "compile_s": compile_s,
        "frames_lost": sum(r["lost"] for r in records),
        "keyframes": sum(r["keyframe"] for r in records),
        "frontend": "fused" if fused else ("cv2" if args.frontend == "cv2" else "staged"),
        **ba_info,
        **mover_meta,
        **_device_meta(),
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    if args.plot:
        from ptzjax.plots import plot_run

        plot_run(
            pose, gt_r, os.path.join(args.out, "trajectory.png"),
            records=records, title=os.path.basename(args.out.rstrip("/")),
        )
    print(json.dumps(summary, indent=2))
    return summary


def _device_meta() -> dict:
    """The device the run's numbers were taken on, as JAX reports it."""
    import jax

    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "device_kind": d.device_kind,
        "device_count": len(jax.devices()),
    }


def _resolve_f_ref(cfg, args, gt):
    """Resolve descriptor zoom normalization for image modes (the
    default product behavior). --desc-f-ref overrides; the AUTO
    sentinel (-1) anchors to the init pose's focal."""
    if args.desc_f_ref is not None:
        cfg = cfg.replace(descriptor_f_ref=float(args.desc_f_ref))
    if cfg.descriptor_f_ref < 0:
        cfg = cfg.replace(descriptor_f_ref=float(gt[0][2]))
    return cfg


def _stage_image_features(args, cfg, imgs_all, masks_all):
    """Pre-extract features frame-by-frame on the host for the paths that
    need a staged table (cv2 frontend, homography tracker); returns None
    when the fused on-device pipeline applies (device frontend + slam
    tracker)."""
    if args.frontend == "device" and args.tracker == "slam":
        return None
    extract, track = _make_frontend(args, cfg)
    feats = []
    for k in range(len(imgs_all)):
        img = imgs_all[k]
        mask = None if masks_all is None else masks_all[k]
        if args.klt and k > 0:
            feats.append(track(imgs_all[k - 1], img, feats[-1], mask=mask))
        else:
            feats.append(extract(img, mask=mask))
    return feats


def _make_frontend(args, cfg):
    """Return (extract(img, mask=None), track(prev_img, img, prev_feats,
    mask=None)) -> (xy, desc, valid) for the selected --frontend."""
    import jax.numpy as jnp
    import numpy as np

    if args.frontend == "cv2":
        from ptzjax.frontend_cv2 import extract_features_cv2, track_features_cv2

        def extract(img, mask=None):
            f = extract_features_cv2(
                np.asarray(img), cfg,
                mask=None if mask is None else np.asarray(mask),
            )
            return f.xy, f.desc, f.valid

        def track(prev_img, img, prev_feats, mask=None):
            xy, desc, valid, _ = track_features_cv2(
                np.asarray(prev_img), np.asarray(img),
                prev_feats[0], prev_feats[1], prev_feats[2], cfg,
                mask=None if mask is None else np.asarray(mask),
            )
            return xy, desc, valid

        return extract, track

    from ptzjax.frontend import extract_features, track_features

    def extract(img, mask=None):
        return extract_features(
            jnp.asarray(img), cfg,
            mask=None if mask is None else jnp.asarray(mask),
        )

    def track(prev_img, img, prev_feats, mask=None):
        xy, desc, valid, _ = track_features(
            jnp.asarray(prev_img), jnp.asarray(img),
            prev_feats[0], prev_feats[2], cfg,
            mask=None if mask is None else jnp.asarray(mask),
        )
        return xy, desc, valid

    return extract, track


def _run_offline(args, cfg, intr, imgs_all, masks_all, feats, gt) -> dict:
    """Offline execution mode (SURVEY.md §3): the
    library pipeline tests/test_dist.py exercises, as a product surface.

    1. Frame-parallel feature extraction over a 1-D device mesh
       (``dist.extract_features_sharded``) — shard-count invariant, so the
       tables equal the online frontend's bit for bit.
    2. Sequential tracking scan (state is inherently sequential) building
       the keyframe/map stores.
    3. SHARDED bundle adjustment over the mesh (one psum per LM iteration;
       Huber-IRLS when cfg.ba_huber_px > 0), refined poses written back.

    Artifacts match the online path (frames.jsonl, trajectory.npz,
    summary.json) plus ba_cost_before/after and mesh metadata.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ptzjax import dist, mapstore
    from ptzjax import eval as evallib
    from ptzjax import io as iolib
    from ptzjax.slam import PTZSlam, infos_to_dicts

    mesh = dist.make_mesh(args.mesh_devices or None)
    t0 = time.perf_counter()
    if feats is None:
        n = len(imgs_all)
        # Descriptor zoom-normalization focal: the product path anchors on
        # the FRAME-0 focal only — the same information the online
        # bootstrap has (slam.init consumes gt[0]); per-frame GT focals
        # are an oracle leak and require the explicit
        # --oracle-focals opt-in.
        oracle = bool(getattr(args, "oracle_focals", False))
        if oracle:
            focals = np.asarray(gt[:n, 2], np.float32)
        else:
            focals = np.full((n,), float(gt[0, 2]), np.float32)
        xy_all, desc_all, valid_all = dist.extract_features_sharded(
            imgs_all, cfg, mesh,
            masks=None if masks_all is None else jnp.asarray(masks_all),
            focals=focals,
        )
        xy_all = np.asarray(xy_all)
        desc_all = np.asarray(desc_all)
        valid_all = np.asarray(valid_all)
    else:
        xy_all = np.stack([np.asarray(f[0]) for f in feats])
        desc_all = np.stack([np.asarray(f[1]) for f in feats])
        valid_all = np.stack([np.asarray(f[2]) for f in feats])
    t_frontend = time.perf_counter() - t0

    slam = PTZSlam(cfg, intr)
    state = slam.init(xy_all[0], desc_all[0], valid_all[0], gt[0])
    total = len(xy_all)
    chunk = max(1, args.chunk)
    records = []
    k = 1
    t1 = time.perf_counter()
    while k < total:
        end = min(k + chunk, total)
        pad = chunk - (end - k)
        ok = np.arange(chunk) < (end - k)

        def _p(a):
            return (
                np.concatenate([a[k:end], np.repeat(a[end - 1 : end], pad, 0)])
                if pad
                else a[k:end]
            )

        state, infos = slam.run_segment(
            state, _p(xy_all), _p(desc_all), _p(valid_all), ok
        )
        records.extend(infos_to_dicts(infos, frame0=k)[: end - k])
        k = end
    t_track = time.perf_counter() - t1

    # sharded BA over the final map; refined poses/rays written back
    t2 = time.perf_counter()
    prob = mapstore.build_ba_problem(
        state.kf, state.rays, max_views_per_ray=cfg.ba_max_views_per_ray
    )
    res = dist.run_sharded(prob, intr, cfg, mesh)
    m = prob.rays.shape[0]
    kf, rays = mapstore.apply_ba_result(
        state.kf, state.rays, res.cams, res.rays[:m], prob.obs_w
    )
    state = state._replace(kf=kf, rays=rays)
    jax.block_until_ready(state.kf.poses)
    t_ba = time.perf_counter() - t2

    iolib.write_trajectory_jsonl(os.path.join(args.out, "frames.jsonl"), records)
    pose = np.stack([r["pose"] for r in records])
    fidx = np.array([r["frame"] for r in records])
    gt_r = gt[fidx]
    np.savez(os.path.join(args.out, "trajectory.npz"), pose=pose, gt=gt_r)
    summary = {
        **evallib.trajectory_errors(pose, gt_r).as_dict(),
        "reprojection_rmse_px": evallib.reprojection_rmse(
            pose, gt_r, intr, args.width, args.height
        ),
        "fps": (total - 1) / (t_frontend + t_track),
        "frames_lost": sum(r["lost"] for r in records),
        "keyframes": sum(r["keyframe"] for r in records),
        "mode": "offline",
        "frontend_focals": (
            "oracle_per_frame_gt"
            if (feats is None and bool(getattr(args, "oracle_focals", False)))
            else ("precomputed" if feats is not None else "f_ref_frame0")
        ),
        "mesh_devices": int(mesh.devices.size),
        "frontend_s": t_frontend,
        "tracking_s": t_track,
        "ba_s": t_ba,
        "ba_cost_before": float(res.initial_cost),
        "ba_cost_after": float(res.cost),
        "ba_robust": cfg.ba_huber_px > 0,
        **_device_meta(),
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    if args.plot:
        from ptzjax.plots import plot_run

        plot_run(
            pose, gt_r, os.path.join(args.out, "trajectory.png"),
            records=records,
            title=f"{os.path.basename(args.out.rstrip('/'))} (offline)",
        )
    print(json.dumps(summary, indent=2))
    return summary


def _run_homography_baseline(args, cfg, intr, feats, gt) -> dict:
    """Baseline-tracker path of the CLI: one lax.scan over the sequence,
    same artifacts as the SLAM path (summary.json, trajectory.npz, plot)."""
    import json
    import os
    import time

    import jax
    import numpy as np

    from ptzjax import eval as evallib
    from ptzjax import io as iolib
    from ptzjax.baselines import init_vo, track_homography_ekf

    xy = np.stack([np.asarray(f[0]) for f in feats])
    desc = np.stack([np.asarray(f[1]) for f in feats])
    valid = np.stack([np.asarray(f[2]) for f in feats])
    state = init_vo(gt[0], xy[0], desc[0], valid[0], cfg)
    # warm-up (compile), then timed run
    _, infos = track_homography_ekf(
        state, xy[1:], desc[1:], valid[1:], intr=intr, cfg=cfg
    )
    jax.block_until_ready(infos)
    t0 = time.perf_counter()
    _, infos = track_homography_ekf(
        state, xy[1:], desc[1:], valid[1:], intr=intr, cfg=cfg
    )
    jax.block_until_ready(infos)
    wall = time.perf_counter() - t0

    h = jax.device_get(infos)
    pose = np.asarray(h.pose)
    records = [
        {
            "frame": k + 1, "event": "track", "pose": pose[k],
            "num_matches": int(h.num_inliers[k]),
            "lost": not bool(h.updated[k]), "keyframe": False,
        }
        for k in range(len(pose))
    ]
    iolib.write_trajectory_jsonl(os.path.join(args.out, "frames.jsonl"), records)
    np.savez(
        os.path.join(args.out, "trajectory.npz"), pose=pose, gt=gt[1 : len(pose) + 1]
    )
    summary = {
        **evallib.trajectory_errors(pose, gt[1 : len(pose) + 1]).as_dict(),
        "reprojection_rmse_px": evallib.reprojection_rmse(
            pose, gt[1 : len(pose) + 1], intr, args.width, args.height
        ),
        "fps": len(pose) / wall,
        "frames_lost": sum(r["lost"] for r in records),
        "tracker": "homography",
        **_device_meta(),
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    if args.plot:
        from ptzjax.plots import plot_run

        plot_run(
            pose, gt[1 : len(pose) + 1], os.path.join(args.out, "trajectory.png"),
            records=records, title=f"{os.path.basename(args.out.rstrip('/'))} (homography baseline)",
        )
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
