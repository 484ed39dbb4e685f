"""Where the port's loop scale ratios part from the JAX package's on
tests/test_torch_mono_slam.py's run, loop by loop, on the CPU.

    JAX_PLATFORMS=cpu python tests/loop_scale_divergence.py [--seeds 0 1 2]

Runs both MonoSLAM engines as that test's fixture does (the JAX draws
replayed in the port; a seed is `VOConfig.seed`, 0 in the test) and
prints the gaps between their runs that the test's bands cover. It records the inputs of every
`detect_fused_sim3` call: the query (descriptors, keypoints, the current
keyframe's landmarks, its odometry pose), a copy of the database and the
draw key. For each loop that both engines close it prints:

  - the gap between the two engines' inputs (landmarks, pose);
  - s_rel of each engine as run, and of both packages' detection
    kernels on the port's inputs with the same key;
  - on those identical inputs, the PnP RANSAC of each package: the
    hypotheses whose DLT pose differs between the packages, the MSAC
    winner of each, for each winner the two smallest eigenvalues of
    A^T A and |cos| between the packages' float32 `eigh` null vectors,
    and the final inlier sets (sizes, how many differ) with the Umeyama
    scale over each.

Ends with one JSON line. Takes about 2 minutes per seed on a CPU.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from test_torch_mono import ReplayJaxDraws  # noqa: E402
from test_torch_mono_slam import (  # noqa: E402
    CFG, LOOP, ReplayLoopDraws, _ates, _seam, detect_both, jax_draw, kernel_inputs,
    orbit_frames, record_detections)

from viso_tpu.ops import pnp as j_pnp  # noqa: E402
from viso_tpu.slam import loop_closure as j_lc  # noqa: E402
from viso_tpu.slam.engine import VOConfig as JVOConfig  # noqa: E402
from viso_tpu.slam.mono_full import MonoSLAM as JMonoSLAM  # noqa: E402
from viso_tpu_torch.geometry import camera as t_cam  # noqa: E402
from viso_tpu_torch.geometry import se3 as t_se3  # noqa: E402
from viso_tpu_torch.geometry import sim3 as t_sim3  # noqa: E402
from viso_tpu_torch.ops import pnp as t_pnp  # noqa: E402
from viso_tpu_torch.ops import ransac as t_ransac  # noqa: E402
from viso_tpu_torch.slam import loop_closure as t_lc  # noqa: E402
from viso_tpu_torch.slam.engine import VOConfig  # noqa: E402
from viso_tpu_torch.slam.mono_full import MonoSLAM  # noqa: E402


def _null_vectors(pts, x):
    """A^T A of the DLT (float32, built once) and each package's eigh."""
    k = len(pts)
    Xh = np.concatenate([pts, np.ones((k, 1), np.float32)], -1)
    z = np.zeros((k, 4), np.float32)
    A = np.concatenate([np.concatenate([Xh, z, -x[:, :1] * Xh], -1),
                        np.concatenate([z, Xh, -x[:, 1:2] * Xh], -1)], 0)
    AtA = (A.T @ A).astype(np.float32)
    wj, vj = jnp.linalg.eigh(jnp.asarray(AtA))
    wt, vt = torch.linalg.eigh(torch.from_numpy(AtA))
    cos = abs(float(np.dot(np.asarray(vj[:, 0]), vt[:, 0].numpy())))
    return dict(eig_jax=[float(wj[0]), float(wj[1])], eig_port=[float(wt[0]), float(wt[1])],
                null_cos=cos, eig_f64=[float(v) for v in np.linalg.eigvalsh(
                    AtA.astype(np.float64))[:2]])


def analyse(rec, t_intr, j_intr, params):
    """Both packages' detections and PnP on the port's recorded inputs."""
    thresh = (params.pnp_threshold_px / float(t_intr.fx)) ** 2
    min_matches, min_inliers = params.min_matches, params.min_inliers
    sub = jax.random.split(rec["key"])[1]
    q, d = kernel_inputs(rec, "port")
    packed_t, packed_j = detect_both(rec, t_intr, j_intr, params)
    idx = []
    _, _, _, ok, pts3d = t_lc._verify(
        q[0], q[1], q[2], *d[:4], d[4], t_intr, thresh, min_matches, min_inliers,
        lambda m: idx.append(jax_draw(sub, m)) or idx[-1])
    idx = idx[0]
    x = t_cam.normalize(q[2], t_intr)
    pts_n, x_n, ok_n, idx_n = pts3d.numpy(), x.numpy(), ok.numpy(), idx.numpy()
    # Every hypothesis's DLT pose and MSAC score, in each package.
    Rj, tj = jax.vmap(j_pnp._dlt_pnp)(jnp.asarray(pts_n[idx_n]), jnp.asarray(x_n[idx_n]))
    Rt, tt = t_pnp._dlt_pnp(pts3d[idx], x[idx])
    dR = np.abs(np.asarray(Rj) - Rt.numpy()).max(axis=(1, 2))
    dt = np.abs(np.asarray(tj) - tt.numpy()).max(axis=1)

    def score(res):
        return np.sum(np.minimum(np.where(ok_n[None], res, thresh), thresh), axis=-1)

    res_j = np.asarray(jax.vmap(lambda R, t: j_pnp.reprojection_residual(
        R, t, jnp.asarray(pts_n), jnp.asarray(x_n)))(Rj, tj))
    res_t = t_pnp.reprojection_residual(Rt[:, None], tt[:, None], pts3d, x).numpy()
    sc_j, sc_t = score(res_j), score(res_t)
    best_j, best_t = int(np.argmin(sc_j)), int(np.argmin(sc_t))
    # The final inlier sets, and the Umeyama scale over each.
    rj = j_pnp.pnp_ransac(sub, jnp.asarray(pts_n), jnp.asarray(x_n), jnp.asarray(ok_n),
                          threshold=thresh)
    rt = t_pnp.pnp_ransac_from_indices(idx, pts3d, x, ok, threshold=thresh)
    p_j = t_se3.transform(q[5], q[6], q[3])

    def s_over(inl, R, t):
        m = inl & ok & q[4]
        return float(t_sim3.umeyama_masked(p_j, t_se3.transform(R, t, pts3d), m)[0])

    inl_j = torch.from_numpy(np.array(rj.inliers))
    return dict(
        s_kernel_port=float(packed_t[16]), s_kernel_jax=float(packed_j[16]),
        packed_max_gap=float(np.abs(packed_t - packed_j).max()),
        n_hyp_differ=int(np.sum((dR > 1e-3) | (dt > 1e-3))),
        best_jax=best_j, best_port=best_t,
        score_jax=[float(sc_j[best_j]), float(sc_j[best_t])],
        score_port=[float(sc_t[best_j]), float(sc_t[best_t])],
        winner_jax=_null_vectors(pts_n[idx_n[best_j]], x_n[idx_n[best_j]]),
        winner_port=_null_vectors(pts_n[idx_n[best_t]], x_n[idx_n[best_t]]),
        inliers_jax=int(rj.num_inliers), inliers_port=int(rt.num_inliers),
        inliers_differ=int((inl_j != rt.inliers).sum()),
        s_umeyama_jax_inliers=s_over(inl_j, torch.from_numpy(np.asarray(rj.R)),
                                     torch.from_numpy(np.asarray(rj.t))),
        s_umeyama_port_inliers=s_over(rt.inliers, rt.R, rt.t),
    )


def run_seed(seed, frames, Rs, ts):
    """Both engines at one seed (the port replaying the JAX draws); the
    engine-level gaps and the per-loop analysis."""
    mp = pytest.MonkeyPatch()
    replay = ReplayLoopDraws(seed + 1)
    mp.setattr(t_ransac, "draw_indices", ReplayJaxDraws(seed))
    mp.setattr(t_lc.pnp, "draw_hypotheses", replay)
    jslam = _seam(JMonoSLAM)(JVOConfig(**CFG, seed=seed), j_lc.LoopParams(**LOOP))
    tslam = _seam(MonoSLAM)(VOConfig(**CFG, seed=seed), t_lc.LoopParams(**LOOP), device="cpu")
    j_calls = record_detections(jslam, lambda: jslam.loop_db.key)
    t_calls = record_detections(tslam, lambda: replay.key)
    try:
        for img in frames:
            jslam.process(img)
        jslam.join()
        for img in frames:
            tslam.process(img)
        tslam.join()
    finally:
        mp.undo()
    j_by_node = {r["node"]: r for r in j_calls}
    pairs_t = [(lo["from"], lo["to"]) for lo in tslam.loops]
    pairs_j = [(lo["from"], lo["to"]) for lo in jslam.loops]
    same_nodes = tslam.pg_frame == jslam.pg_frame
    (pg_t, raw_t), (pg_j, raw_j) = _ates(tslam, Rs, ts), _ates(jslam, Rs, ts)
    common = [(lt["s_rel"], lj["s_rel"]) for lt in tslam.loops for lj in jslam.loops
              if (lt["from"], lt["to"]) == (lj["from"], lj["to"])]
    reading = dict(
        seed=seed, same_states=[r.state for r in tslam.results] == [r.state for r in jslam.results],
        same_nodes=same_nodes, reinits=(tslam.num_reinits, jslam.num_reinits),
        loops_port=pairs_t, loops_jax=pairs_j,
        s_rel_log_gap=max((abs(float(np.log(a / b))) for a, b in common), default=None),
        node_scale_log_gap=float(np.abs(np.log(np.asarray(tslam.pg_s) / np.asarray(
            jslam.pg_s))).max()) if same_nodes else None,
        graph_ate=(pg_t, pg_j), raw_ate=(raw_t, raw_j), loops=[])
    for lo in tslam.loops:
        rec_t = next(r for r in t_calls if r["node"] == lo["from"])
        rec_j = j_by_node.get(lo["from"])
        a = analyse(rec_t, tslam.intr, jslam.intr, t_lc.LoopParams(**LOOP))
        gap = None if rec_j is None else np.abs(rec_j["query"][3] - rec_t["query"][3])[
            rec_t["query"][4] > 0].max(axis=-1)
        a.update(loop=(lo["from"], lo["to"]), s_run_port=rec_t["s_rel"],
                 s_run_jax=None if rec_j is None else rec_j["s_rel"],
                 landmark_gap_max=None if gap is None else float(gap.max()),
                 landmark_gap_median=None if gap is None else float(np.median(gap)),
                 pose_gap=None if rec_j is None else float(max(
                     np.abs(rec_j["R_cur"] - rec_t["R_cur"]).max(),
                     np.abs(rec_j["t_cur"] - rec_t["t_cur"]).max())))
        reading["loops"].append(a)
    jslam.close()
    tslam.close()
    return reading


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    frames, Rs, ts = orbit_frames()
    readings = []
    for seed in args.seeds:
        r = run_seed(seed, frames, Rs, ts)
        print(f"seed {seed}: same states {r['same_states']}, same nodes {r['same_nodes']}, "
              f"re-inits port/jax {r['reinits']}, loops port {r['loops_port']} jax "
              f"{r['loops_jax']}; max |log s_rel ratio| over common loops "
              f"{r['s_rel_log_gap']}, max |log node scale ratio| {r['node_scale_log_gap']}; "
              f"graph ATE port/jax {r['graph_ate']}, raw {r['raw_ate']}", flush=True)
        for a in r["loops"]:
            print(f"  loop {a['loop']}: s_rel as run port {a['s_run_port']:.4f} jax "
                  f"{a['s_run_jax']}; input gap landmarks max {a['landmark_gap_max']} "
                  f"median {a['landmark_gap_median']}, pose {a['pose_gap']}; on the port's "
                  f"inputs: kernel s port {a['s_kernel_port']:.4f} jax {a['s_kernel_jax']:.4f} "
                  f"(packed gap {a['packed_max_gap']:.3g}); {a['n_hyp_differ']}/512 DLT poses "
                  f"differ > 1e-3; MSAC winner jax {a['best_jax']} port {a['best_port']}; "
                  f"winners' eigh jax {a['winner_jax']} port {a['winner_port']}; inliers jax "
                  f"{a['inliers_jax']} port {a['inliers_port']} ({a['inliers_differ']} differ); "
                  f"Umeyama s over jax's {a['s_umeyama_jax_inliers']:.4f} over port's "
                  f"{a['s_umeyama_port_inliers']:.4f}", flush=True)
        readings.append(r)
    print(json.dumps({"readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
