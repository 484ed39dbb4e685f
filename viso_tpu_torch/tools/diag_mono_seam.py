"""The monocular Sim(3) scale seam: realized or under-measured? (port of
`tools/diag_mono_seam.py`)

    python -m viso_tpu_torch.tools.diag_mono_seam [--frames 120] [--no-ba]
        [--hi-iters] [--wait N] [--device cuda|cpu]

Reruns the scenario of `tests/test_slam.py::test_mono_slam_closes_loop`
on the port's MonoSLAM: 160x224, the rng-11 room (half 6) along an orbit
of radius 2 over 2.4 pi in 120 frames, frames 46-57 replaced by noise
(rng 3) to force a re-init, and a re-init whose scale priors (recent speed
and map median depth) are biased 1.5x, so the segment after the seam runs
at the wrong scale. It records, per pose-graph node, the realized local
scale (the raw odometry's inter-node camera-centre distance over ground
truth's) and, per loop, the scale ratio the nodes' local scales imply
beside the edge's measured `s_rel`. That splits a failure into (a) the
engineered 1.5x seam not realized by the engine, and (b) a seam realized
but under-measured by the loop edge's Umeyama fit.

`--wait N` refuses a re-init bootstrap until the reference-to-current gap
reaches N frames (a parallax test); `--hi-iters` runs 12 direct and 10
align iterations; `--no-ba` turns the window BA off. Prints the gate
records, the per-frame table, the per-node scales, the loops and the
solved node scales, then one JSON line. The default device is the card;
without one the tool raises unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from viso_tpu_torch.tools import target

H, W = 160, 224
INTR = dict(fx=180.0, fy=180.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5)
FRAMES = 120
NOISE = range(46, 58)
SEAM = 1.5


def scenario(frames: int = FRAMES):
    """The test's frames (float32, noise frames included) and ground truth
    of the first `frames` frames."""
    from viso_tpu_torch.data import synthetic
    from viso_tpu_torch.geometry import camera

    room = synthetic.room_scene(np.random.default_rng(11), tex_size=512, half=6.0)
    intr = camera.Intrinsics.create(**INTR)
    Rs, ts = synthetic.orbit_trajectory(FRAMES, radius=2.0, total_angle=2.4 * np.pi)
    Rs, ts = Rs[:frames], ts[:frames]
    imgs = [room.render(intr, R, t, H, W)[0] for R, t in zip(Rs, ts)]
    noise_rng = np.random.default_rng(3)
    for i in NOISE[:max(0, len(imgs) - NOISE[0])]:
        imgs[i] = noise_rng.uniform(0, 255, imgs[i].shape).astype(np.float32)
    return imgs, Rs, ts


def seam_slam(device, run_ba: bool = True, hi_iters: bool = False, wait: int = 0):
    """The test's MonoSLAM with both re-init scale priors biased by SEAM."""
    from viso_tpu_torch.slam.engine import VOConfig
    from viso_tpu_torch.slam.loop_closure import LoopParams
    from viso_tpu_torch.slam.mono_full import MonoSLAM

    class SeamMonoSLAM(MonoSLAM):
        def _recent_speed(self):
            s = super()._recent_speed()
            return None if s is None else SEAM * s

        def _map_median_depth(self):
            d = super()._map_median_depth()
            return None if d is None else SEAM * d

        def _try_initialize(self, pyr):
            ir = self.init_ref
            if (wait and ir is not None and self.num_reinits > 0
                    and self.frame_idx - ir[-1] < wait):
                return
            super()._try_initialize(pyr)

    cfg = VOConfig(
        height=H, width=W, max_keyframes=6, max_landmarks=768, num_features=192,
        detect_grid=(4, 6), fast_threshold=10.0, kf_min_gap=1, kf_max_gap=3,
        kf_min_visible_frac=0.6, min_init_tracks=25, disparity_squared_thresh=25.0,
        run_ba=run_ba, direct_iters=12 if hi_iters else 6,
        align_iters=10 if hi_iters else 5, **INTR,
    )
    lp = LoopParams(capacity=64, num_features=128, guard=8, min_matches=25, min_inliers=15,
                    max_correction_m=6.0, max_correction_rad=2.5)
    return SeamMonoSLAM(cfg, lp, device=device)


def step_scales(c_est, c_gt):
    """Per step: estimated over ground-truth camera-centre distance."""
    d_est = np.linalg.norm(np.diff(c_est, axis=0), axis=-1)
    d_gt = np.linalg.norm(np.diff(c_gt, axis=0), axis=-1)
    return d_est / np.maximum(d_gt, 1e-9)


def seam_report(slam, Rs, ts) -> dict:
    """Per frame (state, tracked, keyframe, step scale), per node the
    realized local scale from the raw odometry (the frame loop edges are
    measured in), per loop the implied and measured scale ratios, and the
    solved node scales."""
    from viso_tpu_torch.slam.engine import _pull_poses
    from viso_tpu_torch.utils import metrics

    Rf, tf = _pull_poses(slam.results)
    sc_f = step_scales(metrics.camera_centers(Rf, tf),
                       metrics.camera_centers(Rs[:len(Rf)], ts[:len(Rf)]))
    per_frame = [dict(frame=i, state=r.state, tracked=int(r.num_tracked),
                      keyframe=bool(r.is_keyframe), step_scale=float(sc_f[i - 1]) if i else 0.0)
                 for i, r in enumerate(slam.results)]
    fr = np.asarray(slam.pg_frame)
    scale = step_scales(
        metrics.camera_centers(np.stack(slam.pg_raw_R), np.stack(slam.pg_raw_t)),
        metrics.camera_centers(Rs[fr], ts[fr])) if len(fr) > 1 else np.zeros(0)

    def local(k):
        # The median of the realized scale over +-2 steps around node k.
        return float(np.median(scale[max(0, k - 2):min(len(scale), k + 2)]))

    loops = [dict(cur=lo["from"], cur_frame=int(fr[lo["from"]]), cur_scale=local(lo["from"]),
                  cand=lo["to"], cand_frame=int(fr[lo["to"]]), cand_scale=local(lo["to"]),
                  s_rel=float(lo["s_rel"]), expected=local(lo["to"]) / local(lo["from"]),
                  inliers=int(lo["inliers"]))
             for lo in slam.loops]
    return dict(per_frame=per_frame,
                nodes=[dict(node=k + 1, frame=int(fr[k + 1]), step_scale=float(s))
                       for k, s in enumerate(scale)],
                loops=loops, node_scales=[float(s) for s in slam.pg_s],
                reinits=int(slam.num_reinits), hook_errors=[repr(e) for e in slam.hook_errors])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--no-ba", action="store_true")
    ap.add_argument("--hi-iters", action="store_true")
    ap.add_argument("--wait", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device, where = target("diag_mono_seam", args.device)
    imgs, Rs, ts = scenario(args.frames)
    slam = seam_slam(device, run_ba=not args.no_ba, hi_iters=args.hi_iters, wait=args.wait)
    slam.loop_db.debug = []
    try:
        for img in imgs:
            slam.process(img)
        slam.join()
        rep = seam_report(slam, Rs, ts)
        records = list(slam.loop_db.debug)
    finally:
        slam.close()
    for rec in records:
        print(f"[loop-gate] {rec}")
    print(f"hook_errors: {rep['hook_errors']}\nnum_reinits: {rep['reinits']}")
    print("\nframe  state     tracked  kf  step_scale")
    for r in rep["per_frame"]:
        print(f"{r['frame']:5d}  {r['state']:9s} {r['tracked']:6d}  "
              f"{'K' if r['keyframe'] else ' '}  {r['step_scale']:8.3f}")
    print("\nnode  frame  step_scale (est/gt)")
    for r in rep["nodes"]:
        print(f"{r['node']:4d}  {r['frame']:5d}  {r['step_scale']:7.3f}")
    print("\nloops:")
    for lo in rep["loops"]:
        print(f"  {lo['cur']}(f{lo['cur_frame']}, loc_scale {lo['cur_scale']:.3f}) -> "
              f"{lo['cand']}(f{lo['cand_frame']}, loc_scale {lo['cand_scale']:.3f})  "
              f"s_rel={lo['s_rel']:.4f} expected~{lo['expected']:.4f}  inliers={lo['inliers']}")
    print("\npg_s (solved node scales):", np.round(np.asarray(rep["node_scales"]), 3))
    print(json.dumps(dict(device=where, frames=len(imgs), reinits=rep["reinits"],
                          hook_errors=len(rep["hook_errors"]), loops=rep["loops"],
                          s_min=min(rep["node_scales"], default=None),
                          s_max=max(rep["node_scales"], default=None))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
