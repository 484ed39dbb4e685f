"""Per-frame drift bisection on the 500-frame orbit (port of
`tools/diag_drift.py`).

    python -m viso_tpu_torch.tools.diag_drift [--frames 260] [--no-ba]
        [--kf-max-gap 8] [--png DIR] [--dump out.npz] [--device cuda|cpu]

Runs pure StereoVO (no loop closure) on the loop cell's sequence and
configuration (`diag_loops.render_stereo`, `bench.py:604-692`, with the
reference tool's options: 10 direct and 10 align iterations by default)
and reports the per-frame relative-pose error against the renderer's
ground truth, split by frame kind: a tracked-frame bias implicates
direct tracking, alignment or the PnP refine; a keyframe-step bias
implicates the window BA or stereo triangulation. `drift_report` is the
report: signed yaw bias per frame (tracked, keyframe), total and mean
rotation error, translation error, the end rotation drift, `n_tracked`
and the ATE (no scale alignment).

Frames come from the orbit render as uint8 arrays in memory; with
`--png DIR` they are written there as PNGs once and read back through the
native prefetcher (`data/native.py`), as the bench ingests them. The
default device is the card; without one the tool raises unless `--device
cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

from viso_tpu_torch.tools import diag_loops, target


def rot_angle(R):
    return float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))


def rel(Ra, ta, Rb, tb):
    """T_a o T_b^-1."""
    R = Ra @ Rb.T
    return R, ta - R @ tb


def drift_report(R_est, t_est, kf, n_tracked, Rs_gt, ts_gt) -> dict:
    """The reference tool's report (`tools/diag_drift.py:99-136`) of a
    trajectory: per-frame errors E_i = rel_est_i rel_gt_i^-1 split into
    tracked and keyframe frames, and the ATE. Also returns the per-frame
    arrays (`yaw_err`, `rot_err`, `trans_err`) under "_arrays"."""
    from viso_tpu_torch.utils import metrics

    n = len(R_est)
    Rs_gt, ts_gt = Rs_gt[:n], ts_gt[:n]
    yaw_err, rot_err, trans_err = np.zeros(n), np.zeros(n), np.zeros(n)
    for i in range(1, n):
        Re, te = rel(R_est[i], t_est[i], R_est[i - 1], t_est[i - 1])
        Rg, tg = rel(Rs_gt[i], ts_gt[i], Rs_gt[i - 1], ts_gt[i - 1])
        E = Re @ Rg.T
        rot_err[i] = rot_angle(E)
        # Signed rotation about the camera y axis: the axis-angle vector's
        # y component.
        yaw_err[i] = 0.5 * (E[0, 2] - E[2, 0])
        trans_err[i] = np.linalg.norm(te - tg)
    # Accumulated world-yaw drift at the end (what the loop gate sees).
    E_end = R_est[n - 1] @ Rs_gt[n - 1].T @ (R_est[0] @ Rs_gt[0].T).T
    kf = np.asarray(kf, bool)
    tr = ~kf
    n_tracked = np.asarray(n_tracked)
    ate = metrics.ate_rmse(metrics.camera_centers(R_est, t_est),
                           metrics.camera_centers(Rs_gt, ts_gt), align=True, with_scale=False)
    return {
        "frames": n,
        "keyframes": int(kf.sum()),
        "total_rot_drift_rad": rot_angle(E_end),
        "sum_signed_yaw_err_rad": float(yaw_err.sum()),
        "per_frame_rot_err_mean_rad": float(rot_err[1:].mean()),
        "tracked_yaw_bias_rad_per_frame":
            float(yaw_err[tr][1:].mean()) if tr.sum() > 1 else 0.0,
        "keyframe_yaw_bias_rad_per_frame": float(yaw_err[kf].mean()) if kf.sum() else 0.0,
        "tracked_trans_err_mean_m": float(trans_err[tr][1:].mean()),
        "keyframe_trans_err_mean_m": float(trans_err[kf].mean()) if kf.sum() else 0.0,
        "mean_n_tracked": float(n_tracked[5:].mean()),
        "min_n_tracked": int(n_tracked[5:].min()),
        "ate_rmse_m": float(ate),
        "_arrays": dict(yaw_err=yaw_err, rot_err=rot_err, trans_err=trans_err),
    }


def png_frames(pairs, root):
    """The pairs written as L%04d.png / R%04d.png under `root` (once) and
    read back through the native prefetcher, as uint8 pairs."""
    from viso_tpu_torch.data import native, png_io

    os.makedirs(root, exist_ok=True)
    paths = []
    for i, (il, ir) in enumerate(pairs):
        for side, img in (("L", il), ("R", ir)):
            path = os.path.join(root, f"{side}{i:04d}.png")
            if not os.path.exists(path):
                png_io.write_gray_png(path, img)
            paths.append(path)
    pre = native.Prefetcher(paths, ring=16, threads=3)
    try:
        return [(np.clip(next(pre), 0, 255).astype(np.uint8),
                 np.clip(next(pre), 0, 255).astype(np.uint8)) for _ in pairs]
    finally:
        pre.close()


def config(args=None):
    """The loop cell's configuration with the tool's options (its
    defaults without `args`)."""
    if args is None:
        args = parser().parse_args([])
    return dataclasses.replace(
        diag_loops.stereo_config(),
        num_features=args.features, max_landmarks=args.landmarks,
        fast_threshold=args.fast_threshold, kf_max_gap=args.kf_max_gap,
        kf_min_gap=args.kf_min_gap, run_ba=not args.no_ba, ba_iters=args.ba_iters,
        direct_iters=args.direct_iters, align_iters=args.align_iters,
    )


def run(pairs, Rs_gt, ts_gt, cfg, device):
    """Pure StereoVO over the stereo pairs: the drift report of its
    trajectory (its per-frame arrays, keyframe flags, `n_tracked` and the
    trajectory under "_arrays") and the run's seconds."""
    from viso_tpu_torch.slam.engine import StereoVO

    vo = StereoVO(cfg, device=device)
    try:
        t0 = time.perf_counter()
        for il, ir in pairs:
            vo.process(il, ir)
        R_est, t_est = vo.trajectory()
        seconds = time.perf_counter() - t0
        kf = np.array([r.is_keyframe for r in vo.results])
        n_tracked = np.array([r.num_tracked for r in vo.results])
    finally:
        vo.close()
    out = drift_report(R_est, t_est, kf, n_tracked, Rs_gt, ts_gt)
    out["_arrays"].update(kf=kf, n_tracked=n_tracked, R_est=R_est, t_est=t_est)
    out["seconds"] = seconds
    return out


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=260)
    ap.add_argument("--no-ba", action="store_true")
    ap.add_argument("--kf-max-gap", type=int, default=8)
    ap.add_argument("--kf-min-gap", type=int, default=2)
    ap.add_argument("--features", type=int, default=256)
    ap.add_argument("--landmarks", type=int, default=1024)
    ap.add_argument("--fast-threshold", type=float, default=6.0)
    ap.add_argument("--ba-iters", type=int, default=8)
    ap.add_argument("--direct-iters", type=int, default=10)
    ap.add_argument("--align-iters", type=int, default=10)
    ap.add_argument("--png", default="", help="directory of the sequence as PNGs")
    ap.add_argument("--dump", default="", help="npz path for per-frame data")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device, where = target("diag_drift", args.device)
    pairs, Rs_gt, ts_gt = diag_loops.render_stereo(args.frames)
    if args.png:
        pairs = png_frames(pairs, args.png)
    out = run(pairs, Rs_gt, ts_gt, config(args), device)
    arrays = out.pop("_arrays")
    out["device"] = where
    print(json.dumps(out))
    if args.dump:
        np.savez(args.dump, R_gt=Rs_gt, t_gt=ts_gt, **arrays)
    return 0


if __name__ == "__main__":
    sys.exit(main())
