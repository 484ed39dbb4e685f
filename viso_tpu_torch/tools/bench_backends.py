"""Window-BA backends side by side: reprojection against photometric
(port of `tools/bench_backends.py`).

    python -m viso_tpu_torch.tools.bench_backends [--frames 40] [--reps 16]
        [--device cuda|cpu]

Runs the same synthetic stereo corridor (240x768, rng 42, 0.5 m/frame)
through StereoVO once per backend and prints one JSON line each: the ATE
(no scale alignment), the ms of one keyframe's window BA (the engine's ba
program called `--reps` (16) times back to back on the final map, ending in one
synchronise) and the wall time of the run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

H, W = 240, 768


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_backend(backend, frames, cfg_kw, device, reps: int = 16):
    from viso_tpu_torch.slam.engine import StereoVO, VOConfig
    from viso_tpu_torch.utils import metrics

    vo = StereoVO(VOConfig(ba_backend=backend, **cfg_kw), device=device)
    t0 = time.perf_counter()
    for il, ir in frames:
        vo.process(il, ir)
    _sync(device)
    wall = time.perf_counter() - t0
    ba_ms = None
    if len(vo.kf_order) >= 2:
        cam_fixed = torch.zeros(vo.cfg.max_keyframes, dtype=torch.bool, device=device)
        cam_fixed[vo.kf_order[0]] = True
        args = (vo.map, cam_fixed, vo.kf_order[-1], vo.R, vo.t)
        vo._ba_program(*args)
        _sync(device)
        tb = time.perf_counter()
        for _ in range(reps):
            vo._ba_program(*args)
        _sync(device)
        ba_ms = 1e3 * (time.perf_counter() - tb) / reps
    R_est, t_est = vo.trajectory()
    vo.close()
    return metrics.camera_centers(R_est, t_est), ba_ms, wall


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--reps", type=int, default=16, help="timed window-BA calls")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from viso_tpu_torch.data import synthetic
    from viso_tpu_torch.geometry import camera
    from viso_tpu_torch.utils import metrics

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device (pass --device cpu)")
    intr_kw = dict(fx=360.0, fy=360.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5)
    cfg_kw = dict(
        height=H, width=W, baseline=0.5, num_features=256,
        max_landmarks=1024, detect_grid=(4, 8), fast_threshold=15.0,
        max_disparity=96, kf_min_gap=2, kf_max_gap=6, **intr_kw,
    )
    scene = synthetic.corridor_scene(np.random.default_rng(42), tex_size=1024)
    intr = camera.Intrinsics.create(**intr_kw)
    Rs, ts = synthetic.forward_trajectory(args.frames, step=0.5, yaw_rate=0.003)
    frames = [synthetic.make_stereo_pair(scene, intr, R, t, H, W, baseline=0.5)[:2]
              for R, t in zip(Rs, ts)]
    c_gt = metrics.camera_centers(Rs, ts)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    for backend in ("reprojection", "photometric"):
        c_est, ba_ms, wall = run_backend(backend, frames, cfg_kw, device, args.reps)
        print(json.dumps({
            "backend": backend,
            "ate_rmse_m": metrics.ate_rmse(c_est, c_gt, align=True, with_scale=False),
            "ba_ms_per_keyframe": ba_ms,
            "wall_s": wall,
            "device": name,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
