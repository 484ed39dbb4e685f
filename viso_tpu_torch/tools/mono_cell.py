"""The reference's monocular cells run once per RANSAC seed: the spread
of their accuracy.

    python -m viso_tpu_torch.tools.mono_cell [--slam [--cycles N] [--hold]]
        [--seeds 0 1 2] [--frames 500] [--device cuda|cpu]

Without `--slam`, the monocular VO cell (`bench.py:329-449`, BASELINE
config 1): 184x616, half-KITTI intrinsics, 256 features, 1024 landmarks,
grid 4x8, FAST 8, `kf_max_gap=8`, `kf_min_gap=2`, stats lag 2 / hard 4
(deterministic), `kf_min_visible_frac=0.45`, init disparity 5 px, BA
"auto" (photometric); `corridor_scene(default_rng(5), tex_size=1024,
far_z=90)` along `forward_trajectory(500, step=0.15, yaw_rate=0.002)`,
rendered once and quantised to uint8. Prints per seed the scale-aligned
ATE, the scale drift end/start, the end rotation error, keyframes,
re-inits and the first tracking frame.

With `--slam`, the monocular SLAM cell (`bench.py:452-534`): MonoSLAM
with the same configuration but FAST 6, `LoopParams(min_inliers=40,
max_correction_m=4.0)`, on the left images of the stereo SLAM cell's
500-frame loop orbit (`room_scene(default_rng(11), tex_size=768,
half=5.5)`, `orbit_trajectory(500, radius=2.5, total_angle=4 pi)`,
uint8). Prints per seed the scale-aligned keyframe ATE after the Sim(3)
correction and of the raw odometry nodes, the loops (from, to, inliers,
s_rel, and the s_rel that ground truth implies: `loop_scale_truth`), the
range of node scales, keyframes, nodes and re-inits. `--cycles N` runs
the frames N times over (6: chip_smoke phase 15(c)'s 3,000 frames);
`--hold` installs `diag_loops.Funnel` and `diag_loops.LoopRecorder`,
prints the funnel and holds every loop detection: run again on the
device (equal to the run) and held on the CPU given its PnP pose (within
1 inlier and `diag_loops.HOLD_LOG_TOL` in |log s_rel|, phase 9's bounds).

A seed is `VOConfig.seed`, the seed of the engine's generator (the
two-view bootstrap's RANSAC hypotheses) and, plus one, of the loop
database's (PnP RANSAC); the CPU's and CUDA's generators give different
streams for one seed. Ends with one JSON line with every seed's numbers.
The default device is the card; without one it raises unless `--device
cpu` is given. `chip_smoke.py` runs both cells at seed 0 (phases 7 and 9).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from viso_tpu_torch.tools import target

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


def slam_config(seed: int = 0):
    """bench.py's monocular SLAM configuration (bench.py:472-481)."""
    import dataclasses

    return dataclasses.replace(config(seed), fast_threshold=6.0)


def slam_loop_params():
    """bench.py's mono SLAM loop parameters (bench.py:482-484)."""
    from viso_tpu_torch.slam.loop_closure import LoopParams

    return LoopParams(min_inliers=40, max_correction_m=4.0)


def orbit():
    """The loop orbit of the stereo and mono SLAM cells (bench.py:604-692):
    its scene, intrinsics and 500 ground-truth poses (Rs, ts)."""
    from viso_tpu_torch.data import synthetic
    from viso_tpu_torch.geometry import camera

    scene = synthetic.room_scene(np.random.default_rng(11), tex_size=768, half=5.5)
    intr = camera.Intrinsics.create(**KITTI_HALF)
    Rs, ts = synthetic.orbit_trajectory(FRAMES, radius=2.5, total_angle=4 * np.pi)
    return scene, intr, Rs, ts


def render_orbit(frames: int = FRAMES):
    """The mono SLAM cell's uint8 frames (the left images of the orbit)
    and ground-truth poses (Rs, ts)."""
    from viso_tpu_torch.data import synthetic

    scene, intr, Rs, ts = orbit()
    Rs, ts = Rs[:frames], ts[:frames]
    imgs = [np.clip(img, 0, 255).astype(np.uint8)
            for img in synthetic.render_sequence(scene, intr, Rs, ts, H, W)]
    return imgs, Rs, ts


def slam_accuracy(slam, Rs, ts):
    """bench.py's mono SLAM comparison: scale-aligned keyframe ATE (m) of
    the Sim(3)-corrected graph and of the raw odometry nodes."""
    from viso_tpu_torch.utils import metrics

    pg_R, pg_t, frames = slam.graph_trajectory()
    c_gt = metrics.camera_centers(Rs[frames], ts[frames])
    raw = metrics.camera_centers(np.stack(slam.pg_raw_R), np.stack(slam.pg_raw_t))
    return (float(metrics.ate_rmse(metrics.camera_centers(pg_R, pg_t), c_gt, align=True,
                                   with_scale=True)),
            float(metrics.ate_rmse(raw, c_gt, align=True, with_scale=True)))


def loop_scale_truth(slam, Rs, ts, half_window: int = 3):
    """Each loop's relative scale as ground truth has it: the raw
    odometry's local scale (its camera-centre path over +-half_window
    nodes against ground truth's) at the candidate node over that at the
    current node, the ratio a perfect Umeyama fit would measure."""
    frames = np.asarray(slam.pg_frame)
    c = -np.einsum("nji,nj->ni", np.stack(slam.pg_raw_R), np.stack(slam.pg_raw_t))
    c_gt = -np.einsum("nji,nj->ni", Rs[frames], ts[frames])

    def local(k):
        a, b = max(0, k - half_window), min(len(frames) - 1, k + half_window)
        return np.linalg.norm(c[b] - c[a]) / max(np.linalg.norm(c_gt[b] - c_gt[a]), 1e-9)

    return [float(local(lo["to"]) / local(lo["from"])) for lo in slam.loops]


def corridor():
    """The mono VO cell's scene, intrinsics and 500 ground-truth poses
    (Rs, ts) (bench.py:329-449)."""
    from viso_tpu_torch.data import synthetic
    from viso_tpu_torch.geometry import camera

    scene = synthetic.corridor_scene(np.random.default_rng(5), tex_size=1024, far_z=90.0)
    intr = camera.Intrinsics.create(**KITTI_HALF)
    Rs, ts = synthetic.forward_trajectory(FRAMES, step=0.15, yaw_rate=0.002)
    return scene, intr, Rs, ts


def render(frames: int = FRAMES):
    """The cell's uint8 frames and ground-truth poses (Rs, ts)."""
    from viso_tpu_torch.data import synthetic

    scene, intr, Rs, ts = corridor()
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


def run_slam_seed(imgs, Rs, ts, seed: int, device, hold: bool = False):
    """One MonoSLAM run over the orbit frames: its accuracy and loops; with
    `hold`, also its loop funnel and every loop detection run again on
    `device` and held on the CPU (`diag_loops.LoopRecorder.holds`, phase
    9's bounds)."""
    from viso_tpu_torch.slam.mono_full import MonoSLAM
    from viso_tpu_torch.tools import diag_loops

    slam = MonoSLAM(slam_config(seed), slam_loop_params(), device=device)
    recorder = diag_loops.LoopRecorder(slam) if hold else None
    funnel = diag_loops.Funnel(slam) if hold else None
    try:
        for img in imgs:
            slam.process(img)
        slam.join()
        nan = float("nan")
        ate, ate_raw = slam_accuracy(slam, Rs, ts) if slam.pg_s else (nan, nan)
        s_gt = loop_scale_truth(slam, Rs, ts)
        out = dict(seed=seed, ate_m=ate, ate_raw_m=ate_raw,
                   loops=[(lo["from"], lo["to"], lo["inliers"], lo["s_rel"], g)
                          for lo, g in zip(slam.loops, s_gt)],
                   s_min=min(slam.pg_s, default=nan), s_max=max(slam.pg_s, default=nan),
                   keyframes=sum(r.is_keyframe for r in slam.results),
                   nodes=len(slam.pg_s), reinits=slam.num_reinits,
                   hook_errors=len(slam.hook_errors))
        if hold:
            t0 = time.perf_counter()
            holds = recorder.holds(device, diag_loops.HOLD_LOG_TOL)
            cap = slam.loop_params.capacity
            out.update(funnel=funnel.counts(), held=sum(g["held"] for g in holds),
                       holds=len(holds), holds_after_wrap=sum(g["node"] >= cap for g in holds),
                       hold_max_inlier_gap=max(
                           (abs(g["inliers"][0] - g["inliers"][1]) for g in holds), default=0),
                       hold_max_log_gap=max((g["log_gap"] for g in holds), default=0.0),
                       not_held=[g for g in holds if not g["held"]],
                       hold_s=time.perf_counter() - t0)
        return out
    finally:
        if recorder is not None:
            recorder.close()
        slam.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slam", action="store_true",
                    help="the mono SLAM cell (MonoSLAM on the loop orbit)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5])
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--cycles", type=int, default=1,
                    help="with --slam: the frames run this many times over (6: phase 15(c))")
    ap.add_argument("--hold", action="store_true",
                    help="with --slam: the loop funnel, and every loop detection run again "
                         "and held on the CPU")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if (args.cycles != 1 or args.hold) and not args.slam:
        ap.error("--cycles and --hold need --slam")
    device, where = target("mono_cell", args.device)
    from viso_tpu_torch.tools import diag_loops

    t0 = time.perf_counter()
    imgs, Rs, ts = (render_orbit if args.slam else render)(args.frames)
    print(f"rendered {len(imgs)} frames {H}x{W} (uint8) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    imgs = imgs * args.cycles
    Rs, ts = (np.concatenate([x] * args.cycles) for x in (Rs, ts))
    runs = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.slam:
            r = run_slam_seed(imgs, Rs, ts, seed, device, hold=args.hold)
            print(f"seed {seed}: scale-aligned keyframe ATE {r['ate_m']:.6f} m after the "
                  f"Sim(3) correction, {r['ate_raw_m']:.6f} m raw; {len(r['loops'])} loops "
                  f"(from, to, inliers, s_rel, s_rel from ground truth) "
                  f"{[(a, b, c, round(d, 4), round(g, 4)) for a, b, c, d, g in r['loops']]}; "
                  f"node scales "
                  f"{r['s_min']:.4f}-{r['s_max']:.4f}; {r['keyframes']} keyframes, "
                  f"{r['nodes']} nodes, {r['reinits']} re-inits, {r['hook_errors']} hook "
                  f"errors, {time.perf_counter() - t0:.1f} s [{where}]", flush=True)
            if args.hold:
                print(f"seed {seed}: loop funnel {r['funnel']}; {r['held']} of {r['holds']} "
                      f"detections held ({r['holds_after_wrap']} after the database's wrap): "
                      f"the replay on {where} equal to the run, the CPU within 1 inlier "
                      f"(largest gap {r['hold_max_inlier_gap']}) and |log s_rel| "
                      f"{diag_loops.HOLD_LOG_TOL} (largest {r['hold_max_log_gap']:.3g}); "
                      f"{r['hold_s']:.1f} s [{where}]", flush=True)
        else:
            r = run_seed(imgs, Rs, ts, seed, device)
            print(f"seed {seed}: scale-aligned ATE {r['ate_m']:.6f} m, scale drift "
                  f"{r['scale_drift']:.3f}, end rotation error {r['rot_err_deg']:.3f} deg, "
                  f"{r['keyframes']} keyframes, {r['reinits']} re-inits, first tracking "
                  f"frame {r['first_tracking']}, {time.perf_counter() - t0:.1f} s [{where}]",
                  flush=True)
        runs.append(r)
    print(json.dumps({"device": where, "cell": "mono_slam" if args.slam else "mono",
                      "frames": len(imgs), "cycles": args.cycles, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
