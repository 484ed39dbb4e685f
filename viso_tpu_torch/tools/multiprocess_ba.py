"""Multi-process check of the distributed window BA (port of
`tools/multiprocess_ba.py`).

    python -m viso_tpu_torch.tools.multiprocess_ba [--procs 2] [--engine | --slam]
        [--device cuda|cpu]

Starts N ranks with `torch.multiprocessing` (spawn) that form a group
over a `file://` store (no port), each on `--device`: NCCL with one card
per rank when there are as many cards as ranks, else gloo with every
rank on the first card (`bench_dist_ba.backend_for`), in three modes:

  (default)  the landmark-sharded BA solve of a C=5, L=96 window; every
             rank's final cost must match its own single-rank solve within
             1e-3 relative;
  --engine   a StereoVO run with `distribute_ba=True` (120x160, 14 frames,
             window BA of 4 iterations over 256 landmark slots): tracking
             and keyframes run replicated on each rank, the window BA
             rides the group. Every rank's camera centres must be within
             0.05 m of a single-rank run of the same frames and both ATEs
             below 0.08 m. Keyframe cadence is pinned (kf_min_gap ==
             kf_max_gap) so that every rank issues the same collectives;
  --slam     the mesh dryrun (`__graft_entry__.py` `dryrun_multichip`):
             its StereoSLAM (240x320, C=8, L=2048, 10 frames) with
             `distribute_ba=True` and `stats_deterministic=True` on every
             rank, under the dryrun's assertions (>= 3 nodes and
             keyframes, a finite pose moved > 0.2 m forward, the window
             BA on the group, no hook error); every rank's raw trajectory
             equal to rank 0's and its corrected one within
             SLAM_RANK_GAP_M.

`launch` is the spawner the tests, `bench_dist_ba` and chip_smoke.py use:
each rank sets one CPU thread, joins the group with a 60 s timeout, and
the parent kills every rank still running after `timeout` seconds.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from viso_tpu_torch.tools import target

# The engine mode's run (the reference tool's).
ENGINE_H, ENGINE_W = 120, 160
ENGINE_FRAMES = 14
ENGINE_ATE_M = 0.08
ENGINE_DIFF_M = 0.05
COST_RTOL = 1e-3
# The ranks' corrected camera centres (m): each rank solves its own pose
# graph, whose LM accumulates with atomics on CUDA (slam/full.py), so
# only the raw trajectories are held equal.
SLAM_RANK_GAP_M = 1e-3


def _rank_main(rank, world, store, out_dir, backend, device, fn, args):
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        result = fn(dev, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def launch(fn, nprocs: int, args=(), device="cuda", backend="gloo", timeout=120.0):
    """Run `fn(device, *args)` on `nprocs` ranks of one `backend` group and
    return each rank's result, in rank order. `fn` must be a module-level
    function; its result is passed back through `torch.save`. Raises if a
    rank fails or is still running after `timeout` seconds (then every
    rank is killed). The default device is the card: without one it
    raises unless `device="cpu"` is given."""
    target("multiprocess_ba", device)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="viso_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [
            ctx.Process(target=_rank_main,
                        args=(r, nprocs, store, tmp, backend, str(device), fn, tuple(args)))
            for r in range(nprocs)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"ranks exited with {codes} (None: killed after {timeout} s)")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(nprocs)]


def tool_problem(device, C: int = 5, L: int = 96, seed: int = 0):
    """The reference tool's window: C cameras on a 0.4 m/step arc looking
    at L points, 1e-3 observation noise, cameras 2.. perturbed by 0.02."""
    from viso_tpu_torch.geometry import se3

    rng = np.random.default_rng(seed)
    pts = np.stack(
        [rng.uniform(-4, 4, L), rng.uniform(-3, 3, L), rng.uniform(8, 16, L)], axis=-1
    ).astype(np.float32)

    def exp(xi):
        R, t = se3.se3_exp(torch.as_tensor(np.asarray(xi, np.float32)))
        return R.numpy(), t.numpy()

    Rs, ts, obs, mask = [], [], [], []
    for c in range(C):
        R_c, t_c = exp([0.4 * c, 0.05 * c, 0.02 * c, 0.01 * c, -0.02 * c, 0.005 * c])
        Rs.append(R_c)
        ts.append(t_c)
        pc = pts @ R_c.T + t_c
        obs.append(pc[:, :2] / pc[:, 2:3] + rng.normal(0, 1e-3, (L, 2)))
        mask.append(pc[:, 2] > 1.0)
    R0, t0 = np.stack(Rs), np.stack(ts)
    for c in range(2, C):
        dR, dt = exp(rng.normal(0, 0.02, 6))
        R0[c] = dR @ R0[c]
        t0[c] = dR @ t0[c] + dt
    points = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    return problem_from_numpy(dict(R=R0, t=t0, points=points, obs_uv=np.stack(obs),
                                   obs_mask=np.stack(mask)), device)


def problem_from_numpy(a: dict, device):
    """A BAProblem on `device` from numpy arrays (float32 / bool); all
    cameras and points in use."""
    from viso_tpu_torch.backend import ba

    def T(x, dtype):
        return torch.tensor(np.asarray(x, dtype), device=device)

    C, L = a["obs_mask"].shape
    return ba.BAProblem(
        R=T(a["R"], np.float32), t=T(a["t"], np.float32),
        points=T(a["points"], np.float32), obs_uv=T(a["obs_uv"], np.float32),
        obs_mask=T(a["obs_mask"], bool),
        cam_mask=torch.ones(C, dtype=torch.bool, device=device),
        point_mask=torch.ones(L, dtype=torch.bool, device=device),
    )


def ba_rank(device, arrays=None, iters: int = 8, num_fixed: int = 2):
    """One rank of the default mode: the single-rank and the sharded solve
    of the tool's window (or of `arrays`, see `problem_from_numpy`)."""
    from viso_tpu_torch.backend import ba
    from viso_tpu_torch.parallel import dist_ba, mesh as mesh_mod

    prob = tool_problem(device) if arrays is None else problem_from_numpy(arrays, device)
    params = ba.BAParams(iters=iters, num_fixed=num_fixed)
    out_local, info_local = ba.solve_impl(prob, params)
    mesh = mesh_mod.make_mesh(device=device)
    solver = dist_ba.make_sharded_solver(mesh, params)
    out, info = dist_ba.solve_sharded(prob, params, mesh)
    host = lambda x: x.detach().cpu().numpy()  # noqa: E731
    return {
        "world": mesh.size, "rank": mesh.rank,
        "R": host(out.R), "t": host(out.t), "points": host(out.points),
        "final_cost": float(info["final_cost"]), "initial_cost": float(info["initial_cost"]),
        "num_obs": int(info["num_obs"]),
        "local_R": host(out_local.R), "local_t": host(out_local.t),
        "local_points": host(out_local.points),
        "local_final_cost": float(info_local["final_cost"]),
        "sizes": list(solver.stats.sizes), "gather_bytes": solver.stats.gather_bytes,
    }


def engine_frames():
    """The engine mode's frames (rng 7 corridor, 0.25 m/frame, 0.3 m
    baseline), ground truth and camera keywords."""
    from viso_tpu_torch.data import synthetic
    from viso_tpu_torch.geometry import camera

    H, W = ENGINE_H, ENGINE_W
    intr_kw = dict(fx=140.0, fy=140.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5)
    intr = camera.Intrinsics.create(**intr_kw)
    scene = synthetic.corridor_scene(np.random.default_rng(7), tex_size=512)
    Rs, ts = synthetic.forward_trajectory(ENGINE_FRAMES, step=0.25)
    frames = [synthetic.make_stereo_pair(scene, intr, R, t, H, W, baseline=0.3)[:2]
              for R, t in zip(Rs, ts)]
    return frames, Rs, ts, intr_kw


def engine_config(intr_kw, **kw):
    from viso_tpu_torch.slam.engine import VOConfig

    return VOConfig(
        height=ENGINE_H, width=ENGINE_W, baseline=0.3, max_keyframes=4,
        max_landmarks=256, num_features=96, detect_grid=(3, 4),
        fast_threshold=8.0, max_disparity=48, ba_iters=4,
        # Pinned cadence: keyframe decisions must not depend on when the
        # per-frame stats reach the host, so every rank issues the same
        # collectives.
        kf_min_gap=4, kf_max_gap=4,
        **intr_kw, **kw,
    )


# The mesh dryrun (`__graft_entry__.py` `dryrun_multichip`): 240x320.
DRYRUN_H, DRYRUN_W = 240, 320
DRYRUN_INTR = dict(fx=260.0, fy=260.0, cx=DRYRUN_W / 2 - 0.5, cy=DRYRUN_H / 2 - 0.5)


def dryrun_frames():
    """The mesh dryrun's frames (the rng 0 corridor, 10 frames at 0.15
    m/frame, 0.3 m baseline) and ground truth."""
    from viso_tpu_torch.data import synthetic
    from viso_tpu_torch.geometry import camera

    intr = camera.Intrinsics.create(**DRYRUN_INTR)
    scene = synthetic.corridor_scene(np.random.default_rng(0), tex_size=256)
    Rs, ts = synthetic.forward_trajectory(10, step=0.15, yaw_rate=0.004)
    frames = [synthetic.make_stereo_pair(scene, intr, R, t, DRYRUN_H, DRYRUN_W,
                                         baseline=0.3)[:2]
              for R, t in zip(Rs, ts)]
    return frames, Rs, ts


def dryrun_slam(device, **kw):
    """The mesh dryrun's StereoSLAM: C=8 keyframes, L=2048 landmark slots,
    192 features, `LoopParams(capacity=16, num_features=64, guard=4)`;
    `kw` overrides the configuration."""
    from viso_tpu_torch.slam.engine import VOConfig
    from viso_tpu_torch.slam.full import StereoSLAM
    from viso_tpu_torch.slam.loop_closure import LoopParams

    cfg = VOConfig(
        height=DRYRUN_H, width=DRYRUN_W, baseline=0.3, max_keyframes=8, max_landmarks=2048,
        num_features=192, detect_grid=(4, 6), fast_threshold=12.0, max_disparity=48,
        kf_min_gap=1, kf_max_gap=3, **DRYRUN_INTR, **kw,
    )
    return StereoSLAM(cfg, LoopParams(capacity=16, num_features=64, guard=4), device=device)


def engine_rank(device):
    """One rank of --engine: the single-rank and the distributed StereoVO
    run. Returns centres, ATEs, K1's launches (CUDA only) and how the
    distributed run's solve ran (`program_listing`)."""
    from viso_tpu_torch.geometry import extract
    from viso_tpu_torch.slam.engine import StereoVO
    from viso_tpu_torch.utils import metrics

    frames, Rs, ts, intr_kw = engine_frames()

    def run(**kw):
        vo = StereoVO(engine_config(intr_kw, **kw), device=device)
        for il, ir in frames:
            vo.process(il, ir)
        R_est, t_est = vo.trajectory()
        listing = vo.program_listing()
        vo.close()
        return metrics.camera_centers(R_est, t_est), listing.get("ba_solve")

    c_single, _ = run()
    extract.launch.launches = 0
    c_dist, ba_solve = run(distribute_ba=True)
    launches = extract.launch.launches
    c_gt = metrics.camera_centers(Rs, ts)
    return {
        "rank": dist.get_rank(), "world": dist.get_world_size(),
        "c_single": c_single, "c_dist": c_dist,
        "ate_single": metrics.ate_rmse(c_single, c_gt, align=True, with_scale=False),
        "ate_dist": metrics.ate_rmse(c_dist, c_gt, align=True, with_scale=False),
        "max_diff": float(np.abs(c_single - c_dist).max()), "k1_launches": launches,
        "ba_solve": ba_solve,
    }


def slam_rank(device, frames=None, config=None, loop_params=None, sync_first_rank=False):
    """One rank of a StereoSLAM run with its window BA on the world: the
    mesh dryrun's (`dryrun_slam(distribute_ba=True,
    stats_deterministic=True)` on `dryrun_frames()`) by default, else the
    engine of `config` and `loop_params` on `frames` ((left, right) uint8
    pairs). With `sync_first_rank`, rank 0 synchronises the whole device
    after every `process()` call. Returns the raw and the corrected
    camera centres, the dryrun's checks, the loops, hook errors (as
    text), K1's launches during the run, how the solve ran and the host
    seconds of each `process()`."""
    from viso_tpu_torch.geometry import extract
    from viso_tpu_torch.slam.engine import StereoVO
    from viso_tpu_torch.slam.full import StereoSLAM
    from viso_tpu_torch.utils import metrics

    if frames is None:
        frames = dryrun_frames()[0]
        vo = dryrun_slam(device, distribute_ba=True, stats_deterministic=True)
    else:
        vo = StereoSLAM(config, loop_params, device=device)
    mesh = vo._mesh()
    sync = sync_first_rank and mesh.rank == 0 and torch.device(device).type == "cuda"
    extract.launch.launches = 0
    per_frame = []
    try:
        for il, ir in frames:
            t0 = time.perf_counter()
            vo.process(il, ir)
            if sync:
                torch.cuda.synchronize()
            per_frame.append(time.perf_counter() - t0)
        vo.join()
        launches = extract.launch.launches
        R_raw, t_raw = StereoVO.trajectory(vo)
        R, t = vo.trajectory()
        t_fin = vo.t.cpu().numpy()
        result = {
            "rank": mesh.rank, "world": mesh.size,
            "c_raw": metrics.camera_centers(R_raw, t_raw), "c": metrics.camera_centers(R, t),
            "nodes": len(vo.pg_raw_R), "keyframes": len(vo.kf_order), "t_fin": t_fin,
            "window_bas": vo._kernels["ba_prep"].calls if "ba_prep" in vo._kernels else 0,
            "loops": [(lp["from"], lp["to"], lp["inliers"]) for lp in vo.loops],
            "hook_errors": [repr(e) for e in vo.hook_errors], "k1_launches": launches,
            "ba_solve": vo.program_listing().get("ba_solve"), "per_frame_s": per_frame,
            "drained": list(vo._loop_programs.captures),
        }
    finally:
        vo.close()
    return result


def slam_ok(r) -> bool:
    """`dryrun_multichip`'s assertions on one rank's `slam_rank` result."""
    return (r["nodes"] >= 3 and r["keyframes"] >= 3 and r["window_bas"] > 0
            and bool(np.isfinite(r["t_fin"]).all()) and abs(float(r["t_fin"][2])) > 0.2
            and not r["hook_errors"])


def slam_ranks_gap(ranks):
    """(raw trajectories all equal to rank 0's, largest corrected centre
    gap to rank 0's in m)."""
    raw = all(np.array_equal(r["c_raw"], ranks[0]["c_raw"]) for r in ranks)
    return raw, max(float(np.abs(r["c"] - ranks[0]["c"]).max()) for r in ranks)


def cli_rank(device, argv):
    """One rank of the CLI, `run.main(argv)`, on `device` in the world
    `launch` made (rank r > 0 writes into `--out-dir/rank<r>`), its
    printed summary kept off stdout; returns the summary and K1's
    launches during the run."""
    import contextlib
    import io

    from viso_tpu_torch import run
    from viso_tpu_torch.geometry import extract

    extract.launch.launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        summary = run.main([*argv, "--device", str(device)])
    return {"summary": summary, "k1_launches": extract.launch.launches}


def engine_ok(r) -> bool:
    return r["ate_single"] < ENGINE_ATE_M and r["ate_dist"] < ENGINE_ATE_M \
        and r["max_diff"] < ENGINE_DIFF_M


def ba_ok(r) -> bool:
    c, ref = r["final_cost"], r["local_final_cost"]
    return abs(c - ref) <= COST_RTOL * max(abs(ref), 1e-9)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--engine", action="store_true",
                      help="run the StereoVO engine with distribute_ba")
    mode.add_argument("--slam", action="store_true",
                      help="run the mesh dryrun's StereoSLAM with distribute_ba")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from viso_tpu_torch.tools.bench_dist_ba import backend_for

    fn = slam_rank if args.slam else engine_rank if args.engine else ba_rank
    backend = backend_for(args.procs, args.device)
    results = launch(fn, args.procs, device=args.device, backend=backend,
                     timeout=300.0 if args.slam else 120.0)
    print(f"{args.procs} ranks over {backend}", flush=True)
    ok = True
    if args.slam:
        raw_equal, gap = slam_ranks_gap(results)
        print(f"SLAM ranks: raw trajectories equal {raw_equal}, corrected centres "
              f"within {gap:.3g} m of rank 0's (limit {SLAM_RANK_GAP_M})", flush=True)
        ok = raw_equal and gap <= SLAM_RANK_GAP_M
    for r in results:
        if args.slam:
            good = slam_ok(r)
            print(f"[rank {r['rank']}] SLAM world={r['world']} nodes={r['nodes']} "
                  f"keyframes={r['keyframes']} window_bas={r['window_bas']} "
                  f"solve={r['ba_solve']} t={r['t_fin'].tolist()} loops={r['loops']} "
                  f"K1={r['k1_launches']} hook_errors={r['hook_errors']} ok={good}",
                  flush=True)
        elif args.engine:
            good = engine_ok(r)
            print(f"[rank {r['rank']}] ENGINE world={r['world']} ate_single="
                  f"{r['ate_single']:.4f} ate_dist={r['ate_dist']:.4f} "
                  f"max_diff={r['max_diff']:.4f} ok={good}", flush=True)
        else:
            good = ba_ok(r)
            print(f"[rank {r['rank']}] world={r['world']} local={r['local_final_cost']:.6g} "
                  f"dist={r['final_cost']:.6g} ok={good}", flush=True)
        ok &= good
    if ok:
        kind = "SLAM" if args.slam else "ENGINE" if args.engine else "BA"
        print(f"MULTIPROCESS {kind} OK ({args.procs} processes, {args.device})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
