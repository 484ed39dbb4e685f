"""Loop-gate diagnostics and the loop funnel on the 500-frame orbit (port of
`tools/diag_loops.py`).

    python -m viso_tpu_torch.tools.diag_loops [--mono] [--frames 500]
        [--seed 0] [--device cuda|cpu]

Without `--mono`, StereoSLAM at the reference's loop cell
(`tools/diag_loops.py:36-50`, `bench.py:604-692`): 184x616, half-KITTI
intrinsics, 256 features, 1024 landmarks, grid 4x8, FAST 6, disparity
96, stats lag 8, `kf_max_gap=8`, `kf_min_gap=2`, `LoopParams(min_inliers=
40, max_correction_m=4.0)`, on the two-lap room orbit rendered as uint8
stereo pairs. With `--mono`, MonoSLAM on the orbit's left images with
`mono_cell.slam_config`.

Prints, as the reference does, every candidate's gate record from
`LoopDatabase.debug` (one JSON line each) and the ATE with and without
the accepted corrections (stereo: every frame, no scale alignment; mono:
the keyframe nodes, scale-aligned), then the worst pose-graph edges of
the solved and the raw graph (stderr), and last one JSON line with the
funnel.

The funnel (`Funnel`) counts, per run, how far each keyframe's loop
query gets: keyframes (graph nodes); queries (detections run: the loop
layer skips keyframes just after a recovery or with too few tracks);
queries with an eligible database slot (outside the temporal guard);
candidates with at least `min_matches` descriptor matches, with at least
`min_inliers` of those matches on a 3-D landmark, with at least
`min_inliers` PnP inliers; those that pass the drift-scaled gate; for
mono, those that pass the |log s| scale gate; and the loops the graph
keeps (`len(slam.loops)`: the solve-health gate rolls back the loop edges
of a rejected solve). It wraps `detect_fused` / `detect_fused_sim3` and
`_gate_packed` of the slam's loop database from outside and classifies
each exit by the packed values the gate receives, so it installs the same
way on the JAX package's engines (the tests do so). The default device
is the card; without one the tool raises unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from viso_tpu_torch.tools import mono_cell, target

H, W = mono_cell.H, mono_cell.W
FRAMES = mono_cell.FRAMES
# A loop detection held on the CPU (`LoopRecorder.holds`): chip_smoke
# phase 9's bound on |log s_rel| between the device's result and the CPU's
# (MONO_SLAM_HOLD_LOG_TOL).
HOLD_LOG_TOL = 1e-3
STAGES = ("keyframes", "queries", "eligible", "matches", "points_3d", "pnp_inliers",
          "drift_gate", "scale_gate", "loops")


def stereo_config(seed: int = 0):
    """The reference's 500-frame loop configuration (`bench.py:604-692`)."""
    from viso_tpu_torch.slam.engine import VOConfig

    return VOConfig(
        height=H, width=W, baseline=0.537, **mono_cell.KITTI_HALF,
        num_features=256, max_landmarks=1024, detect_grid=(4, 8),
        fast_threshold=6.0, max_disparity=96,
        stats_max_lag=8, kf_max_gap=8, kf_min_gap=2, seed=seed,
    )


def render_stereo(frames: int = FRAMES):
    """The orbit's first `frames` uint8 stereo pairs and ground truth."""
    from viso_tpu_torch.data import synthetic

    scene, intr, Rs, ts = mono_cell.orbit()
    Rs, ts = Rs[:frames], ts[:frames]
    pairs = []
    for R, t in zip(Rs, ts):
        il, ir, _ = synthetic.make_stereo_pair(scene, intr, R, t, H, W, baseline=0.537)
        pairs.append((np.clip(il, 0, 255).astype(np.uint8),
                      np.clip(ir, 0, 255).astype(np.uint8)))
    return pairs, Rs, ts


class Funnel:
    """The loop funnel of one SLAM run (StereoSLAM or MonoSLAM of either
    package). Installs its counters on `slam.loop_db` at construction,
    around whatever `detect_fused` / `detect_fused_sim3` and
    `_gate_packed` are bound there; `counts()` reads the funnel so far."""

    def __init__(self, slam):
        self.slam = slam
        self.mono = hasattr(slam, "pg_s")
        self.n = dict.fromkeys(STAGES[1:-1], 0)
        db = slam.loop_db
        name = "detect_fused_sim3" if self.mono else "detect_fused"
        real_detect, real_gate = getattr(db, name), db._gate_packed
        n, p = self.n, db.params

        def detect(*a, **kw):
            n["queries"] += 1
            cand = real_detect(*a, **kw)
            if cand is not None and self.mono:
                n["scale_gate"] += 1
            return cand

        def gate(packed, *a, **kw):
            # The gate's exits in its order: matches, matches on a 3-D
            # landmark, PnP inliers, then the drift-scaled bound.
            n["eligible"] += 1
            if int(packed[0]) >= p.min_matches:
                n["matches"] += 1
                if int(packed[2]) >= p.min_inliers:
                    n["points_3d"] += 1
                    if int(packed[3]) >= p.min_inliers:
                        n["pnp_inliers"] += 1
            cand = real_gate(packed, *a, **kw)
            if cand is not None:
                n["drift_gate"] += 1
            return cand

        setattr(db, name, detect)
        db._gate_packed = gate

    def counts(self) -> dict:
        """The funnel in stage order (call after `slam.join()`): each stage
        at most the one before; no `scale_gate` for stereo."""
        out = {"keyframes": len(self.slam.pg_frame), **self.n,
               "loops": len(self.slam.loops)}
        if not self.mono:
            del out["scale_gate"]
        return out


class LoopRecorder:
    """Records each loop detection of a MonoSLAM run that gives a
    candidate, so that it can be run again on any device and held on the
    CPU: its query and pose, the database's eligible mask and the PnP
    hypotheses drawn for it (cloned where the engine made them), and how
    many inserts the database had taken. Each `LoopDatabase.add` logs the
    rows it wrote (a copy of one slot's descriptors and landmarks, not of
    the whole database), so a detection's database is rebuilt from the
    log. Installs itself on `slam.loop_db` (`add`,
    `detect_fused_sim3`) and on `loop_closure.pnp.draw_hypotheses`
    (process-wide) at construction; `close()` gives the draw back."""

    def __init__(self, slam):
        import torch

        from viso_tpu_torch.slam import loop_closure

        self.slam, self.lc = slam, loop_closure
        self.calls, self.inserts = [], []
        self.real_draw = loop_closure.pnp.draw_hypotheses
        db, drawn = slam.loop_db, []
        real_add, real_detect = db.add, db.detect_fused_sim3
        self.rows = (db.desc, db.desc_mask, db.points_w_dev, db.points_ok_dev)

        def draw(*a, **k):
            drawn.append(self.real_draw(*a, **k))
            return drawn[-1]

        def add(*a, **kw):
            slot = real_add(*a, **kw)
            self.inserts.append((slot, [x[slot].clone() for x in self.rows]))
            return slot

        def detect(desc_q, kps, kp_mask, pts_q, pts_q_ok, R_cur, t_cur, intr, **kw):
            drawn.clear()
            cand = real_detect(desc_q, kps, kp_mask, pts_q, pts_q_ok, R_cur, t_cur, intr, **kw)
            if cand is not None:
                self.calls.append(dict(
                    node=len(slam.pg_raw_R) - 1, s_rel=float(cand.s_rel),
                    inliers=int(cand.inliers), idx=drawn[-1], inserts=len(self.inserts),
                    query=[x.clone() for x in (desc_q, kp_mask, kps, pts_q, pts_q_ok)]
                    + [torch.as_tensor(np.array(R_cur)), torch.as_tensor(np.array(t_cur))],
                    eligible=torch.from_numpy(db._eligible())))
            return cand

        db.add, db.detect_fused_sim3 = add, detect
        loop_closure.pnp.draw_hypotheses = draw

    def close(self):
        self.lc.pnp.draw_hypotheses = self.real_draw

    def databases(self, device):
        """Each recorded call with its database on `device` as the
        detection read it (rebuilt from the insert log, in call order; the
        tensors are reused from one call to the next)."""
        import torch

        rows = [torch.zeros_like(x, device=device) for x in self.rows]
        done = 0
        for rec in self.calls:
            for slot, written in self.inserts[done:rec["inserts"]]:
                for dst, x in zip(rows, written):
                    dst[slot].copy_(x)
            done = rec["inserts"]
            yield rec, rows + [rec["eligible"].to(device)]

    def replay(self, rec, db, device):
        """The packed 29 floats of a recorded detection on `device`, given
        its database there (`databases`)."""
        p = self.slam.loop_params
        thresh = (p.pnp_threshold_px / float(self.slam.intr.fx)) ** 2
        idx = rec["idx"].to(device)
        return self.lc._detect_fused_sim3_kernel(
            *(x.to(device) for x in rec["query"]), *db, self.slam.intr, thresh,
            p.min_matches, p.min_inliers, lambda mask: idx).cpu().numpy()

    def hold_on_cpu(self, rec, db, packed):
        """A detection's packed result (from any device) held on the CPU,
        given its database on the CPU: the inlier count of its PnP pose
        over the CPU's own matches and the Umeyama s over those inliers."""
        import torch

        from viso_tpu_torch.geometry import camera, se3, sim3

        p, intr = self.slam.loop_params, self.slam.intr
        thresh = (p.pnp_threshold_px / float(intr.fx)) ** 2
        desc_q, kp_mask, kps, pts_q, pts_q_ok, R_cur, t_cur = (x.cpu() for x in rec["query"])
        _, _, ok, pts3d, x = self.lc._match_stage(
            desc_q, kp_mask, kps, *db, intr=intr, min_matches=p.min_matches,
            min_inliers=p.min_inliers)
        R = torch.from_numpy(packed[4:13].reshape(3, 3).copy())
        t = torch.from_numpy(packed[13:16].copy())
        inl = (self.lc.pnp.reprojection_residual(R, t, pts3d, x) < thresh) & ok
        s = sim3.umeyama_masked(se3.transform(R_cur, t_cur, pts_q), se3.transform(R, t, pts3d),
                                inl & pts_q_ok)[0]
        return int(inl.sum()), float(s)

    def holds(self, device, hold_log_tol, select=None, cpu_pnp=False):
        """The recorded detections that `select(index, rec)` picks (every
        one by default), each run again on `device` and held on the CPU:
        one dict each with the node, whether the replay equals the run
        (inliers and s_rel bit for bit), the inliers and s_rel of the
        replay and of the hold, their |log| gap, and `held` (the replay
        equal to the run, the hold within 1 inlier and `hold_log_tol`);
        with `cpu_pnp`, also the CPU's own detection on the same inputs and
        hypotheses (inliers, s_rel)."""
        out = []
        pairs = zip(self.databases(device), self.databases("cpu"))
        for i, ((rec, db), (_, db_cpu)) in enumerate(pairs):
            if select is not None and not select(i, rec):
                continue
            packed = self.replay(rec, db, device)
            inl, s = self.hold_on_cpu(rec, db_cpu, packed)
            same = bool(int(packed[3]) == rec["inliers"] and packed[16] == rec["s_rel"])
            log_gap = abs(float(np.log(packed[16] / s)))
            g = dict(node=rec["node"], same_as_run=same, inliers=(int(packed[3]), inl),
                     s=(float(packed[16]), s), log_gap=log_gap,
                     held=same and abs(int(packed[3]) - inl) <= 1 and log_gap <= hold_log_tol)
            if cpu_pnp:
                p_cpu = self.replay(rec, db_cpu, "cpu")
                g["cpu_pnp"] = (int(p_cpu[3]), round(float(p_cpu[16]), 6))
            out.append(g)
        return out


def worst_edges(slam, device, k: int = 8):
    """Per graph (solved, raw): the k edges of largest residual norm at
    that graph's poses, and the median, as the reference's post-mortem."""
    from viso_tpu_torch.backend import pose_graph, pose_graph_sim3

    n = len(slam.pg_raw_R)
    graphs = {"solved": (slam.pg_R, slam.pg_t), "raw": (slam.pg_raw_R, slam.pg_raw_t)}
    out = {}
    for name, (R, t) in graphs.items():
        if slam.pg_edges:
            if hasattr(slam, "pg_s"):
                s = slam.pg_s if name == "solved" else [1.0] * n
                g, _ = pose_graph_sim3.solve_padded(s, R, t, slam.pg_edges,
                                                    pose_graph_sim3.PGParams(iters=0),
                                                    device=device)
                r = pose_graph_sim3.residuals(g)
            else:
                g, _ = pose_graph.solve_padded(R, t, slam.pg_edges,
                                               pose_graph.PGParams(iters=0), device=device)
                r = pose_graph.residuals(g)
            rn = np.linalg.norm(r.cpu().numpy(), axis=-1)[: len(slam.pg_edges)]
        else:
            rn = np.zeros(0)
        edges = [dict(edge=int(w), i=int(slam.pg_edges[w][0]), j=int(slam.pg_edges[w][1]),
                      kind="seq" if abs(slam.pg_edges[w][0] - slam.pg_edges[w][1]) == 1
                      else "loop", weight=float(slam.pg_edges[w][-1]), resid=float(rn[w]))
                 for w in np.argsort(-rn)[:k]]
        out[name] = dict(median=float(np.median(rn)) if len(rn) else 0.0, worst=edges)
    return out


def run(mono: bool, frames: int, seed: int, device) -> dict:
    """One SLAM run on the orbit with the gate records and the funnel
    installed: its records, funnel, loops, accuracy and edge post-mortem."""
    from viso_tpu_torch.slam.engine import _pull_poses
    from viso_tpu_torch.utils import metrics

    if mono:
        from viso_tpu_torch.slam.mono_full import MonoSLAM

        imgs, Rs, ts = mono_cell.render_orbit(frames)
        slam = MonoSLAM(mono_cell.slam_config(seed), mono_cell.slam_loop_params(),
                        device=device)
    else:
        from viso_tpu_torch.slam.full import StereoSLAM

        imgs, Rs, ts = render_stereo(frames)
        # bench.py gives both SLAM cells the same loop parameters.
        slam = StereoSLAM(stereo_config(seed), mono_cell.slam_loop_params(), device=device)
    slam.loop_db.debug = []
    funnel = Funnel(slam)
    try:
        t0 = time.perf_counter()
        for img in imgs:
            slam.process(*(img if isinstance(img, tuple) else (img,)))
        slam.join()
        seconds = time.perf_counter() - t0
        out = dict(records=list(slam.loop_db.debug), funnel=funnel.counts(),
                   loops=[(lp["from"], lp["to"], lp["inliers"]) for lp in slam.loops],
                   hook_errors=len(slam.hook_errors), seconds=seconds)
        if mono:
            if slam.pg_s:
                out["ate_m"], out["ate_raw_m"] = mono_cell.slam_accuracy(slam, Rs, ts)
            out["ate"] = "keyframe nodes, scale-aligned"
        else:
            c_gt = metrics.camera_centers(Rs, ts)
            for key, (R, t) in (("ate_m", slam.trajectory()),
                                ("ate_raw_m", _pull_poses(slam.results))):
                out[key] = float(metrics.ate_rmse(metrics.camera_centers(R, t), c_gt,
                                                  align=True, with_scale=False))
            out["ate"] = "every frame, no scale alignment"
        out["edges"] = worst_edges(slam, device)
    finally:
        slam.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mono", action="store_true", help="MonoSLAM on the orbit's left images")
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device, where = target("diag_loops", args.device)
    r = run(args.mono, args.frames, args.seed, device)
    for rec in r["records"]:
        print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in rec.items()}))
    for name, g in r["edges"].items():
        for e in g["worst"]:
            print(json.dumps(dict(config=name, **e)), file=sys.stderr)
        print(f"[{name}] median edge residual {g['median']:.4f}", file=sys.stderr)
    print(json.dumps(dict(
        device=where, cell="mono_slam" if args.mono else "stereo_slam", frames=args.frames,
        seed=args.seed, ate=r["ate"], ate_m=r.get("ate_m"), ate_raw_m=r.get("ate_raw_m"),
        loops=r["loops"], candidates=len(r["records"]), hook_errors=r["hook_errors"],
        funnel=r["funnel"], seconds=r["seconds"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
