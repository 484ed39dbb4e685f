"""The reference's monocular VO cell (`bench.py:329-449`, BASELINE config
1) run once per RANSAC seed: the spread of its accuracy.

    python -m viso_tpu_torch.tools.mono_cell [--seeds 0 1 2] [--frames 500]
        [--device cuda|cpu]

The cell: 184x616, half-KITTI intrinsics, 256 features, 1024 landmarks,
grid 4x8, FAST 8, `kf_max_gap=8`, `kf_min_gap=2`, stats lag 2 / hard 4
(deterministic), `kf_min_visible_frac=0.45`, init disparity 5 px, BA
"auto" (photometric); `corridor_scene(default_rng(5), tex_size=1024,
far_z=90)` along `forward_trajectory(500, step=0.15, yaw_rate=0.002)`,
rendered once and quantised to uint8. A seed is `VOConfig.seed`, the seed
of the engine's generator, from which the two-view bootstrap draws its
RANSAC hypotheses; the CPU's and CUDA's generators give different streams
for one seed. Prints one line per seed (scale-aligned ATE, scale drift
end/start, end rotation error, keyframes, re-inits, the first tracking
frame), then one JSON line with every seed's numbers. The default device
is the card; without one it raises unless `--device cpu` is given.
`chip_smoke.py` phase 7 runs this cell at seed 0.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

H, W = 184, 616
FRAMES = 500
KITTI_HALF = dict(fx=718.856 / 2, fy=718.856 / 2, cx=607.1928 / 2, cy=185.2157 / 2)


def config(seed: int = 0):
    """bench.py's monocular VO configuration (bench.py:375-393)."""
    from viso_tpu_torch.slam.engine import VOConfig

    return VOConfig(
        height=H, width=W, **KITTI_HALF,
        num_features=256, max_landmarks=1024, detect_grid=(4, 8), fast_threshold=8.0,
        kf_max_gap=8, kf_min_gap=2, stats_max_lag=2, stats_hard_lag=4,
        stats_deterministic=True, kf_min_visible_frac=0.45, disparity_squared_thresh=25.0,
        seed=seed,
    )


def render(frames: int = FRAMES):
    """The cell's uint8 frames and ground-truth poses (Rs, ts)."""
    from viso_tpu_torch.data import synthetic
    from viso_tpu_torch.geometry import camera

    scene = synthetic.corridor_scene(np.random.default_rng(5), tex_size=1024, far_z=90.0)
    intr = camera.Intrinsics.create(**KITTI_HALF)
    Rs, ts = synthetic.forward_trajectory(FRAMES, step=0.15, yaw_rate=0.002)
    Rs, ts = Rs[:frames], ts[:frames]
    imgs = [np.clip(img, 0, 255).astype(np.uint8)
            for img in synthetic.render_sequence(scene, intr, Rs, ts, H, W)]
    return imgs, Rs, ts


def accuracy(R_est, t_est, Rs, ts):
    """bench.py's mono breakdown: scale-aligned ATE (m), step-scale drift
    (the median step scale of the last quarter over the first) and the end
    rotation error relative to the first frame (deg)."""
    from viso_tpu_torch.utils import metrics

    c_est = metrics.camera_centers(R_est, t_est)
    c_gt = metrics.camera_centers(Rs, ts)
    ate = metrics.ate_rmse(c_est, c_gt, align=True, with_scale=True)
    d_est = np.linalg.norm(np.diff(c_est, axis=0), axis=-1)
    d_gt = np.linalg.norm(np.diff(c_gt, axis=0), axis=-1)
    sc = (d_est / np.maximum(d_gt, 1e-9))[d_gt > 1e-6]
    q = len(sc) // 4
    drift = float(np.median(sc[-q:]) / max(np.median(sc[:q]), 1e-9)) if q >= 8 else float("nan")
    R_rel = (R_est[-1] @ R_est[0].T) @ (Rs[-1] @ Rs[0].T).T
    rot = float(np.degrees(np.arccos(np.clip((np.trace(R_rel) - 1) / 2, -1, 1))))
    return float(ate), drift, rot


def run_seed(imgs, Rs, ts, seed: int, device):
    """One MonocularVO run over the frames: its accuracy and schedule."""
    from viso_tpu_torch.slam.engine import MonocularVO

    vo = MonocularVO(config(seed), device=device)
    try:
        for img in imgs:
            vo.process(img)
        R_est, t_est = vo.trajectory()
        states = [r.state for r in vo.results]
        out = dict(seed=seed, keyframes=sum(r.is_keyframe for r in vo.results),
                   reinits=vo.num_reinits,
                   first_tracking=states.index("tracking") if "tracking" in states else None)
    finally:
        vo.close()
    finite = bool(np.isfinite(R_est).all() and np.isfinite(t_est).all())
    ate, drift, rot = accuracy(R_est, t_est, Rs, ts) if finite else (float("nan"),) * 3
    out.update(ate_m=ate, scale_drift=drift, rot_err_deg=rot)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5])
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("mono_cell: no CUDA device (pass --device cpu to run on the CPU)")
    t0 = time.perf_counter()
    imgs, Rs, ts = render(args.frames)
    print(f"rendered {len(imgs)} frames {H}x{W} (uint8) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if device.type == "cuda":
        from viso_tpu_torch.tools import bench_extract

        where = bench_extract.card_line()
    else:
        where = "cpu"
    runs = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = run_seed(imgs, Rs, ts, seed, device)
        runs.append(r)
        print(f"seed {seed}: scale-aligned ATE {r['ate_m']:.6f} m, scale drift "
              f"{r['scale_drift']:.3f}, end rotation error {r['rot_err_deg']:.3f} deg, "
              f"{r['keyframes']} keyframes, {r['reinits']} re-inits, first tracking frame "
              f"{r['first_tracking']}, {time.perf_counter() - t0:.1f} s [{where}]", flush=True)
    print(json.dumps({"device": where, "frames": len(imgs), "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
