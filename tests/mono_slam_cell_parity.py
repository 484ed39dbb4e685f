"""The monocular SLAM cell through the JAX package's MonoSLAM and the
port's, on the CPU: whether the Sim(3) correction's result on the cell is
the reference's own.

    JAX_PLATFORMS=cpu python tests/mono_slam_cell_parity.py --package jax --seeds 0 1
    JAX_PLATFORMS=cpu python tests/mono_slam_cell_parity.py --package port --seeds 0

The cell is `bench.py:452-534`'s (`viso_tpu_torch/tools/mono_cell.py
--slam`): the left images of the 500-frame loop orbit at 184x616, the
bench's VOConfig, `LoopParams(min_inliers=40, max_correction_m=4.0)`. A
seed is `VOConfig.seed`. The port runs with the JAX package's draws of
that seed replayed (the two-view bootstrap's and the loop database's PnP
hypotheses, as tests/test_torch_mono_slam.py replays them), so both
packages draw the same hypotheses; the JAX package draws its own.

Prints per run the scale-aligned keyframe ATE after the Sim(3) correction
and of the raw odometry nodes, each loop (from, to, inliers, s_rel, the
s_rel ground truth implies: `mono_cell.loop_scale_truth`), the node
scales' range, the pose-graph solves accepted and rejected, then one JSON
line with every run. With `--fits`, also each loop's scale seen other ways
over the same points (the detection's inputs recorded and its PnP run
again with the same draws, through the port's functions, which match the
JAX package's on identical inputs): the Umeyama fit the detection makes
(current keyframe's landmarks onto the candidate's), the reverse fit
inverted, the median over points of their distance-to-centroid ratios
and of their depth ratios. Where the port's PnP finds no pose on the
JAX package's inputs (its float32 DLT, ROADMAP Queue 3) these rest on 1-2
points. Takes 100-300 s per run on a CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))



def _counting(cls):
    class Counting(cls):
        """Counts the pose-graph solves the health gate accepts and those
        it rejects (a rejection drops the pending loops)."""

        solves_accepted = 0
        solves_rejected = 0

        def _optimize_pose_graph(self):
            n_loops, n_edges = len(self.loops), len(self.pg_edges)
            ran = len(self.pg_R) >= 3 and n_edges > 0
            super()._optimize_pose_graph()
            if not ran:
                return
            if len(self.loops) < n_loops:
                self.solves_rejected += 1
            else:
                self.solves_accepted += 1

    return Counting


def loop_fits(rec, intr, params):
    """A recorded detection's scale ratio seen four ways (see the module
    docstring)."""
    import jax
    import numpy as np
    from test_torch_mono_slam import jax_draw, kernel_inputs

    from viso_tpu_torch.geometry import se3, sim3
    from viso_tpu_torch.slam import loop_closure

    q, d = kernel_inputs(rec, "port")
    sub = jax.random.split(rec["key"])[1]
    thresh = (params.pnp_threshold_px / float(intr.fx)) ** 2
    _, _, res, ok, pts3d = loop_closure._verify(
        q[0], q[1], q[2], *d[:4], d[4], intr, thresh, params.min_matches,
        params.min_inliers, lambda m: jax_draw(sub, m))
    p_cand, p_cur = se3.transform(res.R, res.t, pts3d), se3.transform(q[5], q[6], q[3])
    m = res.inliers & ok & q[4]
    a, b = (x.numpy()[m.numpy()].astype(np.float64) for x in (p_cur, p_cand))
    da, db = a - a.mean(0), b - b.mean(0)
    return dict(
        umeyama=float(sim3.umeyama_masked(p_cur, p_cand, m)[0]),
        reverse=1.0 / float(sim3.umeyama_masked(p_cand, p_cur, m)[0]),
        median_ratio=float(np.median(np.linalg.norm(db, axis=1)
                                     / np.maximum(np.linalg.norm(da, axis=1), 1e-9))),
        median_depth_ratio=float(np.median(b[:, 2] / a[:, 2])),
        points=int(m.sum()))


def run(package: str, seed: int, imgs, Rs, ts, fits=False, funnel=False):
    import pytest
    from test_torch_mono_slam import record_detections

    from viso_tpu_torch.tools import diag_loops, mono_cell

    mp = pytest.MonkeyPatch()
    if package == "jax":
        from viso_tpu.slam.engine import VOConfig
        from viso_tpu.slam.loop_closure import LoopParams
        from viso_tpu.slam.mono_full import MonoSLAM

        port_cfg = mono_cell.slam_config(seed)
        cfg = VOConfig(**{f: getattr(port_cfg, f) for f in port_cfg.__dataclass_fields__
                          if f in VOConfig.__dataclass_fields__})
        slam = _counting(MonoSLAM)(cfg, LoopParams(min_inliers=40, max_correction_m=4.0))
        key_of = (lambda: slam.loop_db.key)
    else:
        from test_torch_mono import ReplayJaxDraws
        from test_torch_mono_slam import ReplayLoopDraws

        from viso_tpu_torch.ops import ransac
        from viso_tpu_torch.slam import loop_closure
        from viso_tpu_torch.slam.mono_full import MonoSLAM

        replay = ReplayLoopDraws(seed + 1)
        mp.setattr(ransac, "draw_indices", ReplayJaxDraws(seed))
        mp.setattr(loop_closure.pnp, "draw_hypotheses", replay)
        slam = _counting(MonoSLAM)(mono_cell.slam_config(seed), mono_cell.slam_loop_params(),
                                   device="cpu")
        key_of = (lambda: replay.key)
    calls = record_detections(slam, key_of) if fits else []
    counter = diag_loops.Funnel(slam) if funnel else None
    t0 = time.perf_counter()
    try:
        for img in imgs:
            slam.process(img)
        slam.join()
        ate, ate_raw = mono_cell.slam_accuracy(slam, Rs, ts)
        s_gt = mono_cell.loop_scale_truth(slam, Rs, ts)
        if fits:
            from viso_tpu_torch.slam.loop_closure import LoopParams as PortLoopParams

            params = PortLoopParams(min_inliers=40, max_correction_m=4.0)
            fitted = [loop_fits(rec, mono_cell.slam_config(seed).intrinsics(), params)
                      for rec in calls]
        return dict(fits=fitted if fits else None,package=package, seed=seed, ate_m=ate, ate_raw_m=ate_raw,
                    loops=[(lo["from"], lo["to"], int(lo["inliers"]), float(lo["s_rel"]), g)
                           for lo, g in zip(slam.loops, s_gt)],
                    s_min=float(min(slam.pg_s)), s_max=float(max(slam.pg_s)),
                    solves_accepted=slam.solves_accepted,
                    solves_rejected=slam.solves_rejected,
                    nodes=len(slam.pg_s), reinits=int(slam.num_reinits),
                    hook_errors=len(slam.hook_errors),
                    funnel=counter.counts() if funnel else None,
                    seconds=time.perf_counter() - t0)
    finally:
        mp.undo()
        slam.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--fits", action="store_true",
                    help="each loop's scale ratio seen four ways (module docstring)")
    args = ap.parse_args(argv)
    import torch

    from viso_tpu_torch.tools import mono_cell

    torch.set_num_threads(2)
    imgs, Rs, ts = mono_cell.render_orbit(args.frames)
    runs = []
    for seed in args.seeds:
        r = run(args.package, seed, imgs, Rs, ts, args.fits)
        print(f"{r['package']} seed {seed}: scale-aligned keyframe ATE {r['ate_m']:.6f} m "
              f"corrected, {r['ate_raw_m']:.6f} m raw; {len(r['loops'])} loops (from, to, "
              f"inliers, s_rel, s_rel from ground truth) "
              f"{[(a, b, c, round(d, 4), round(g, 4)) for a, b, c, d, g in r['loops']]}; "
              f"node scales {r['s_min']:.4f}-{r['s_max']:.4f}; solves accepted "
              f"{r['solves_accepted']}, rejected {r['solves_rejected']}; {r['nodes']} nodes, "
              f"{r['reinits']} re-inits, {r['hook_errors']} hook errors, "
              f"{r['seconds']:.1f} s [cpu]", flush=True)
        for lo, f in zip(r["loops"], r["fits"] or []):
            print(f"  loop {lo[0]}->{lo[1]}: s_rel {lo[3]:.4f}, ground truth {lo[4]:.4f}; over "
                  f"its {f['points']} points: Umeyama {f['umeyama']:.4f}, reverse "
                  f"{f['reverse']:.4f}, median distance ratio {f['median_ratio']:.4f}, "
                  f"median depth ratio {f['median_depth_ratio']:.4f}", flush=True)
        runs.append(r)
    print(json.dumps({"cell": "mono_slam", "frames": len(imgs), "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
