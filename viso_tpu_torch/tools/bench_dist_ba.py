"""The distributed window BA per world size (port of
`tools/bench_dist_ba.py`).

    python -m viso_tpu_torch.tools.bench_dist_ba [--cams 16] [--landmarks 65536]
        [--iters 10] [--worlds 1 2 4] [--device cuda|cpu]

For each world size, spawns that many ranks (`multiprocess_ba.launch`)
that solve the same C x L window landmark-sharded, and prints one JSON
line from rank 0: LM iterations/s (host clock over solves that end in a
synchronise) of the solve as the engine runs it (`timed`: a replayed CUDA
graph over NCCL, `ShardedSolver.program`, as the reference times its
jitted solve; eager over gloo, whose collectives cannot be captured; eager
on the CPU) and of eager calls (`eager_lm_iters_per_s`), the bytes and
calls handed to `all_reduce` per LM iteration beside
`dist_ba.psum_bytes_per_iter`, the all-reduce stream time per iteration
(CUDA events around the eager solves' calls; "not measured" on the CPU),
landmarks per rank and the final cost.

Backend: NCCL where every rank has a card of its own, else gloo. On one
card, ranks beyond the first share it (gloo on CUDA tensors) and the line
says so: such a line checks the sharded path and its traffic, it is not a
scaling number, and the tool models none.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

REPS = 3   # timed solves per world size, after a warm one

def build_problem(C: int, L: int, device, seed: int = 0, obs_noise: float = 0.0,
                  pose_noise: float = 0.0):
    """The reference benches' window: C cameras 0.5 m apart along x with a
    slow yaw, L points 5-60 m ahead, observations where a point is in
    front and within 0.9 of the optical axis in x, points perturbed by
    0.1 m. `tools/bench_dist_ba.py` and `calib_ba_iter.py` observe exactly;
    `tools/bench_ba.py` adds `obs_noise` (normalized units) to the
    observations and perturbs cameras 2.. by `pose_noise`, drawing from
    the same generator in the same order."""
    from viso_tpu_torch.geometry import se3
    from viso_tpu_torch.tools.multiprocess_ba import problem_from_numpy

    def exp(xi):
        R, t = se3.se3_exp(torch.as_tensor(np.asarray(xi, np.float32)))
        return R.numpy(), t.numpy()

    rng = np.random.default_rng(seed)
    pts = np.stack(
        [rng.uniform(-10, 10, L), rng.uniform(-4, 4, L), rng.uniform(5, 60, L)], axis=-1
    ).astype(np.float32)
    Rs = np.zeros((C, 3, 3), np.float32)
    ts = np.zeros((C, 3), np.float32)
    obs = np.zeros((C, L, 2), np.float32)
    mask = np.zeros((C, L), bool)
    for c in range(C):
        Rs[c], ts[c] = exp([0.5 * c, 0.01 * c, 0.0, 0.0, 0.002 * c, 0.0])
        pc = pts @ Rs[c].T + ts[c]
        mask[c] = (pc[:, 2] > 1.0) & (np.abs(pc[:, 0] / pc[:, 2]) < 0.9)
        obs[c] = pc[:, :2] / np.maximum(pc[:, 2:3], 1e-3)
        if obs_noise:
            obs[c] += rng.normal(0, obs_noise, (L, 2))
    if pose_noise:
        for c in range(2, C):
            dR, dt = exp(rng.normal(0, pose_noise, 6))
            Rs[c] = dR @ Rs[c]
            ts[c] = dR @ ts[c] + dt
    points = pts + rng.normal(0, 0.1, pts.shape).astype(np.float32)
    return problem_from_numpy(dict(R=Rs, t=ts, points=points, obs_uv=obs, obs_mask=mask),
                              device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(solve, prob, device, warm: int = 1):
    """(seconds per solve, the last result): `warm` calls, then REPS timed
    ones ending in a synchronise."""
    for _ in range(warm):
        solve(prob)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = solve(prob)
    _sync(device)
    return (time.perf_counter() - t0) / REPS, out


def rank_bench(device, C: int, L: int, iters: int):
    """One rank: the sharded solve as the engine runs it (`ba_solve`, a
    program where it can be captured), then eagerly, each a warm call and
    REPS timed ones. Returns the rank's numbers and its solution (numpy)."""
    import torch.distributed as dist

    from viso_tpu_torch.backend import ba
    from viso_tpu_torch.parallel import dist_ba, mesh as mesh_mod
    from viso_tpu_torch.slam import programs

    params = ba.BAParams(iters=iters, num_fixed=2)
    mesh = mesh_mod.make_mesh(device=device)
    prob = dist_ba.pad_landmarks(build_problem(C, L, device), mesh.size)
    solver = dist_ba.make_sharded_solver(mesh, params)
    if dist_ba.capturable(mesh):
        program = solver.program(programs.Cache(device))
        timed = "replayed CUDA graph" if program.graphed else "eager (cpu)"
        # Two warm calls: the program's first is eager, its second captures.
        dt, (out_p, info_p) = _time(program, prob, device, warm=2)
        out_p = [x.clone() for x in (out_p.R, out_p.t, out_p.points, info_p["final_cost"])]
    else:
        timed, out_p = "eager (gloo)", None
    # Eager last: its CUDA events time the all-reduces.
    dt_eager, (out, info) = _time(solver, prob, device)
    if out_p is None:
        dt, same = dt_eager, None
    else:
        same = all(torch.equal(a, b) for a, b in zip(
            out_p, (out.R, out.t, out.points, info["final_cost"])))
    calls, nbytes, ms = solver.stats.per_iter(iters)
    return {
        "rank": mesh.rank, "world": mesh.size, "backend": dist.get_backend(),
        "lm_iters_per_s": iters / dt, "timed": timed, "eager_lm_iters_per_s": iters / dt_eager,
        "replay_equal": same,
        "allreduce_bytes_per_iter": nbytes, "allreduce_calls_per_iter": calls,
        "allreduce_ms_per_iter": ms, "landmarks_per_rank": (L + mesh.size - 1) // mesh.size,
        "final_cost": float(info["final_cost"]), "initial_cost": float(info["initial_cost"]),
        "R": out.R.cpu().numpy(), "t": out.t.cpu().numpy(),
        "points": out.points[:L].cpu().numpy(),
    }


def backend_for(world: int, device) -> str:
    device = torch.device(device)
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def run_world(world: int, device, C: int, L: int, iters: int, timeout: float = 300.0):
    """(record, per-rank results) of one world size."""
    from viso_tpu_torch.parallel import dist_ba
    from viso_tpu_torch.tools import multiprocess_ba

    device = torch.device(device)
    backend = backend_for(world, device)
    results = multiprocess_ba.launch(rank_bench, world, args=(C, L, iters),
                                     device=device, backend=backend, timeout=timeout)
    r0 = results[0]
    shared = device.type == "cuda" and backend == "gloo" and world > 1
    rec = {
        "world": world, "backend": backend,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "cams": C, "landmarks": L, "iters": iters,
        "lm_iters_per_s": r0["lm_iters_per_s"], "timed": r0["timed"],
        "eager_lm_iters_per_s": r0["eager_lm_iters_per_s"], "replay_equal": r0["replay_equal"],
        "allreduce_bytes_per_iter": r0["allreduce_bytes_per_iter"],
        "psum_bytes_per_iter": dist_ba.psum_bytes_per_iter(C),
        "allreduce_calls_per_iter": r0["allreduce_calls_per_iter"],
        "allreduce_ms_per_iter": (r0["allreduce_ms_per_iter"]
                                  if r0["allreduce_ms_per_iter"] is not None else "not measured"),
        "landmarks_per_rank": r0["landmarks_per_rank"],
        "final_cost": r0["final_cost"],
        "ranks_share_one_card": shared,
    }
    if shared:
        rec["note"] = "ranks share one card: not a scaling number"
    return rec, results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cams", type=int, default=16)
    ap.add_argument("--landmarks", type=int, default=65536)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--worlds", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device (pass --device cpu)")
    if device.type == "cuda":
        from viso_tpu_torch.tools.bench_extract import card_line

        print(card_line())
    for world in args.worlds:
        rec, _ = run_world(world, device, args.cams, args.landmarks, args.iters)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
