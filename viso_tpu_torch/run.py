"""CLI runner: visual odometry / SLAM over datasets (port of
`viso_tpu/run.py`).

  python -m viso_tpu_torch.run --dataset kitti --root /data/kitti \\
      --sequence 00 --mode stereo --max-frames 500 --out-dir out/
  python -m viso_tpu_torch.run --dataset synthetic --mode mono --device cpu

Writes the trajectory (KITTI format), a JSONL per-frame log
(`frames.jsonl`: each frame's engine numbers, and its host ms by span and
its counters from the frame recorder, `utils/profiling.RECORDER`), the
summary JSON, a top-down trajectory and map plot (skipped, and said so in the
summary, where matplotlib is not installed), a 3-D map viewer (HTML) and,
when the dataset ships ground truth, ATE/RPE. The engine runs on
`--device` (default `cuda`); without a CUDA device the run stops unless
`--device cpu` is given.

`--distribute` solves the window BA landmark-sharded over the
`torch.distributed` world (north-star config 5), in every mode. Under
`torchrun` (`WORLD_SIZE` set) the runner joins the group itself, NCCL for
CUDA with one card per rank, gloo for the CPU, and writes rank r's
outputs into `--out-dir/rank<r>` (rank 0's into `--out-dir`); otherwise
the world is this one process. Over more than one rank every rank
consumes its per-frame stats at a fixed lag (`stats_deterministic`), so
that the ranks make the same keyframe decisions; in the SLAM modes each
rank runs its own loop layer on the same keyframes:

  torchrun --nproc-per-node 2 -m viso_tpu_torch.run --distribute --mode stereo
  torchrun --nproc-per-node 4 -m viso_tpu_torch.run --distribute --mode slam

The summary of a SLAM mode counts the loop layer's failed keyframe hooks
(`hook_errors`).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os

import numpy as np
import torch
import torch.distributed as dist

# Modes that step one image per frame (and align their ATE with a scale),
# and modes with a loop layer (a full SLAM checkpoint).
MONO_MODES = ("mono", "mono-slam")
SLAM_MODES = ("slam", "mono-slam")


def _loop_params(args):
    from viso_tpu_torch.slam.loop_closure import LoopParams

    lp = LoopParams()
    return dataclasses.replace(
        lp,
        min_inliers=args.loop_min_inliers or lp.min_inliers,
        min_matches=args.loop_min_matches or lp.min_matches,
        guard=args.loop_guard or lp.guard,
        max_correction_m=args.loop_max_correction_m or lp.max_correction_m,
        trans_drift_rate=args.loop_trans_drift_rate or lp.trans_drift_rate,
        rot_drift_rate=args.loop_rot_drift_rate or lp.rot_drift_rate,
    )


def build_engine(seq, args, device):
    from viso_tpu_torch.slam.engine import MonocularVO, StereoVO, VOConfig

    intr = seq.intrinsics
    cfg = VOConfig(
        height=args.height,
        width=args.width,
        fx=float(intr.fx),
        fy=float(intr.fy),
        cx=float(intr.cx),
        cy=float(intr.cy),
        baseline=seq.baseline or 0.537,
        num_features=args.num_features,
        max_landmarks=args.max_landmarks,
        max_keyframes=args.max_keyframes,
        fast_threshold=args.fast_threshold,
        ba_backend=args.ba_backend,
        distribute_ba=args.distribute,
        mesh_devices=args.mesh_devices,
    )
    if args.distribute and dist.is_initialized() and dist.get_world_size() > 1:
        # Every rank must make the same keyframe decisions: consume the
        # per-frame stats at a fixed lag, not when they happen to land.
        cfg = dataclasses.replace(cfg, stats_deterministic=True)
    if args.init_disparity_px:
        cfg = dataclasses.replace(cfg, disparity_squared_thresh=args.init_disparity_px ** 2)
    if args.detect_levels:
        cfg = dataclasses.replace(cfg, detect_levels=args.detect_levels)
    if args.mode == "mono":
        return MonocularVO(cfg, device)
    if args.mode == "stereo":
        return StereoVO(cfg, device)
    if args.mode == "slam":
        from viso_tpu_torch.slam.full import StereoSLAM

        return StereoSLAM(cfg, _loop_params(args), device=device)
    if args.mode == "mono-slam":
        from viso_tpu_torch.slam.mono_full import MonoSLAM

        return MonoSLAM(cfg, _loop_params(args), device=device)
    raise ValueError(args.mode)


def _device(name: str):
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available (pass --device cpu "
            "to run on the CPU)"
        )
    return device


def _join_group(device):
    """Under torchrun: join the world (NCCL on CUDA, one card per local
    rank; gloo on the CPU) and return this rank's device. Returns None
    outside torchrun."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return None
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return device


def _synthetic(args):
    """The smoke sequence: a 240x320 corridor driven forward at 0.4 m per
    frame, stereo pairs with a 0.4 m baseline and exact ground truth."""
    from viso_tpu_torch.data import datasets, synthetic
    from viso_tpu_torch.geometry import camera

    h, w = 240, 320
    intr = camera.Intrinsics.create(260.0, 260.0, w / 2 - 0.5, h / 2 - 0.5)
    scene = synthetic.corridor_scene(np.random.default_rng(0))
    Rs, ts = synthetic.forward_trajectory(args.max_frames or 30, step=0.4)
    if args.mode in MONO_MODES and not args.init_disparity_px:
        # Forward motion yields small radial flow; the reference's 15 px
        # lateral-motion gate would never accept an init here.
        args.init_disparity_px = 5.0

    def gen():
        for i, (R, t) in enumerate(zip(Rs, ts)):
            il, ir, _ = synthetic.make_stereo_pair(scene, intr, R, t, h, w, 0.4)
            yield datasets.Frame(index=i, image=il, image_right=ir)

    return datasets.Sequence(frames=gen(), intrinsics=intr, baseline=0.4,
                             gt_R=Rs, gt_t=ts, name="synthetic")


def _load_sequence(args):
    from viso_tpu_torch.data import datasets
    from viso_tpu_torch.geometry import camera

    if args.dataset == "kitti":
        return datasets.load_kitti(args.root, args.sequence, stereo=args.mode != "mono",
                                   max_frames=args.max_frames)
    if args.dataset == "tum":
        return datasets.load_tum(args.root, max_frames=args.max_frames)
    if args.dataset == "euroc":
        return datasets.load_euroc(args.root, max_frames=args.max_frames,
                                   stereo=args.mode != "mono")
    if args.dataset == "dir":
        return datasets.Sequence(
            frames=datasets.load_image_dir(args.root),
            intrinsics=camera.Intrinsics.create(**datasets.TUM_FREIBURG1),
            name="dir",
        )
    return _synthetic(args)


def main(argv=None):
    ap = argparse.ArgumentParser(description="viso_tpu_torch VO/SLAM runner")
    ap.add_argument("--dataset", choices=["kitti", "tum", "euroc", "dir", "synthetic"],
                    default="synthetic")
    ap.add_argument("--root", default="")
    ap.add_argument("--sequence", default="00")
    ap.add_argument("--mode", choices=["mono", "stereo", "slam", "mono-slam"], default="stereo")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--num-features", type=int, default=512)
    ap.add_argument("--max-landmarks", type=int, default=2048)
    ap.add_argument("--max-keyframes", type=int, default=8)
    ap.add_argument("--fast-threshold", type=float, default=20.0)
    # Two-view init disparity gate in px (0 = the config default).
    ap.add_argument("--init-disparity-px", type=float, default=0.0)
    # Window-BA residuals; "auto" = photometric for mono, reprojection
    # for stereo and slam.
    ap.add_argument("--ba-backend", choices=["auto", "reprojection", "photometric"],
                    default="auto")
    # Distributed window BA over the torch.distributed world, in every
    # mode (see the module docstring); --mesh-devices 0 = the whole world.
    ap.add_argument("--distribute", action="store_true")
    ap.add_argument("--mesh-devices", type=int, default=0)
    ap.add_argument("--height", type=int, default=0)
    ap.add_argument("--width", type=int, default=0)
    # Multi-scale FAST levels (0 = config default of 3; 1 = single-scale).
    ap.add_argument("--detect-levels", type=int, default=0)
    # Loop-closure knobs (slam mode; 0 = LoopParams default).
    ap.add_argument("--loop-min-inliers", type=int, default=0)
    ap.add_argument("--loop-min-matches", type=int, default=0)
    ap.add_argument("--loop-guard", type=int, default=0)
    ap.add_argument("--loop-max-correction-m", type=float, default=0.0)
    ap.add_argument("--loop-trans-drift-rate", type=float, default=0.0)
    ap.add_argument("--loop-rot-drift-rate", type=float, default=0.0)
    # Every N frames write out-dir/overlays/frame_XXXXXX.png with the
    # tracked landmarks drawn on the image (one image pull from the device
    # each; 0 = off).
    ap.add_argument("--viz-every", type=int, default=0)
    ap.add_argument("--out-dir", default="out")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = _device(args.device)
    joined = _join_group(device) if args.distribute else None
    try:
        return _run(args, joined or device)
    finally:
        if joined is not None:
            dist.destroy_process_group()


def _run(args, device):
    if dist.is_initialized() and dist.get_rank() > 0:
        args.out_dir = os.path.join(args.out_dir, f"rank{dist.get_rank()}")

    from viso_tpu_torch.utils import checkpoint, metrics, viz
    from viso_tpu_torch.utils import logging as vlog
    from viso_tpu_torch.utils.profiling import RECORDER

    os.makedirs(args.out_dir, exist_ok=True)
    seq = _load_sequence(args)
    frames_iter = iter(seq.frames)
    first = next(frames_iter)
    if not args.height:
        args.height, args.width = first.image.shape
    vo = build_engine(seq, args, device)
    if args.resume:
        if args.mode in SLAM_MODES:
            # Full SLAM restore (map, pose graph, loop database).
            vo.close()
            vo, extra = checkpoint.load_slam(args.resume, vo.cfg, vo.loop_params, device=device)
        else:
            vo.map, extra = checkpoint.load_map(args.resume, device=device)
        print(f"resumed from {args.resume}: {extra}")

    log = vlog.RunLogger(path=os.path.join(args.out_dir, "frames.jsonl"))
    log.tick()
    overlay_dir = os.path.join(args.out_dir, "overlays")
    if args.viz_every:
        os.makedirs(overlay_dir, exist_ok=True)
        vo.debug_overlay = True

    def write_overlay(index):
        # Skip stale overlays: init and re-init frames record no track.
        if vo._last_track is None or vo._last_track[3] != vo.frame_idx:
            return
        from viso_tpu_torch.data import png_io

        ok, uv, img = (a.cpu().numpy() for a in vo._last_track[:3])
        png_io.write_rgb_png(os.path.join(overlay_dir, f"frame_{index:06d}.png"),
                             viz.draw_keypoints(img, uv, ok))

    # Source indices of processed frames: readers may skip unreadable
    # frames, so ground truth pairs by Frame.index, not by position.
    processed_idx: list[int] = []
    try:
        for frame in itertools.chain([first], frames_iter):
            if args.mode in MONO_MODES:
                r = vo.process(frame.image)
            else:
                r = vo.process(frame.image, frame.image_right)
            processed_idx.append(frame.index)
            # The frame's spans (host ms) and counters from the recorder.
            recorded = RECORDER.frame(vo.engine_id, vo.frame_idx)
            log.log_frame(
                frame.index,
                num_tracked=r.num_tracked,
                num_landmarks=r.num_landmarks,
                num_keyframes=len(vo.kf_order),
                is_keyframe=r.is_keyframe,
                state=r.state,
                extra=recorded.summary() if recorded is not None else {},
            )
            if args.viz_every and frame.index % args.viz_every == 0:
                write_overlay(frame.index)
            if args.checkpoint_every and frame.index and frame.index % args.checkpoint_every == 0:
                if args.mode in SLAM_MODES:
                    checkpoint.save_slam(os.path.join(args.out_dir, "slam.npz"), vo,
                                         extra={"frame": frame.index})
                else:
                    checkpoint.save_map(os.path.join(args.out_dir, "map.npz"), vo.map,
                                        extra={"frame": frame.index})
        R_est, t_est = vo.trajectory()
        points = vo.map.points.cpu().numpy()
        point_mask = vo.map.point_mask.cpu().numpy()
        kf_R = vo.map.kf_R.cpu().numpy()[list(vo.kf_order)] if vo.kf_order else None
        kf_t = vo.map.kf_t.cpu().numpy()[list(vo.kf_order)] if vo.kf_order else None
    finally:
        vo.close()
        log.close()

    checkpoint.save_trajectory(os.path.join(args.out_dir, "trajectory.txt"), R_est, t_est)
    summary = log.summary()
    if args.mode in SLAM_MODES:
        summary["hook_errors"] = len(vo.hook_errors)
    summary["sequence"] = seq.name
    summary["device"] = str(device)
    title = seq.name
    gt_R = gt_t = None
    if seq.gt_R is not None:
        sel = np.asarray(processed_idx[: len(R_est)])
        gt_R = np.asarray(seq.gt_R)[sel]
        gt_t = np.asarray(seq.gt_t)[sel]
        summary["ate_rmse_m"] = metrics.ate_rmse(
            metrics.camera_centers(R_est, t_est), metrics.camera_centers(gt_R, gt_t),
            align=True, with_scale=args.mode in MONO_MODES,
        )
        summary["rpe_trans_m"], summary["rpe_rot_deg"] = metrics.rpe(R_est, t_est, gt_R, gt_t)
        title = f"{seq.name} ATE={summary['ate_rmse_m']:.3f} m"
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        summary["plots_skipped"] = "matplotlib not installed"
    else:
        viz.plot_trajectory(R_est, t_est, gt_R, gt_t,
                            path=os.path.join(args.out_dir, "trajectory.png"), title=title)
        viz.plot_map_topdown(points, point_mask, kf_R=kf_R, kf_t=kf_t,
                             path=os.path.join(args.out_dir, "map_topdown.png"))
    viz.export_map_html(points, point_mask, metrics.camera_centers(R_est, t_est),
                        path=os.path.join(args.out_dir, "map.html"))

    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
