"""LM iterations/s of the window BA on a 50-keyframe window (port of
`tools/bench_ba.py`).

    python -m viso_tpu_torch.tools.bench_ba [--cams 50] [--landmarks 4096]
        [--iters 10] [--device cuda|cpu]

A synthetic 50-camera x 4,096-landmark problem (about 60k observations,
0.7 px observation noise, cameras 2.. perturbed), solved 10 times back to
back, ending in one synchronise, after a warm-up: through a
`slam/programs.Program` of `ba.solve_impl` (on the card a CUDA graph,
captured at its first call and replayed, as the reference times its
jitted solve: `value`), then by the eager function (`eager_value`). The
replay's result is held against an eager solve's (`replay_equal`). Prints
one JSON line.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import torch

REPS = 10   # timed solves, back to back


def time_solves(solve, prob, reps: int):
    """(seconds per solve, the last result) of `solve(prob)`: one warm-up
    call, then `reps` back to back ending in one synchronise (the read of
    the final cost)."""
    out = solve(prob)
    float(out[1]["final_cost"])
    t0 = time.perf_counter()
    for _ in range(reps):
        out = solve(prob)
    float(out[1]["final_cost"])          # one synchronise, after the last solve
    return (time.perf_counter() - t0) / reps, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cams", type=int, default=50)
    ap.add_argument("--landmarks", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from viso_tpu_torch.backend import ba
    from viso_tpu_torch.slam import programs
    from viso_tpu_torch.tools.bench_dist_ba import build_problem

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device (pass --device cpu)")
    C, L = args.cams, args.landmarks
    prob = build_problem(C, L, device, obs_noise=1.0 / 700, pose_noise=0.01)
    params = ba.BAParams(iters=args.iters, num_fixed=2)
    solve = functools.partial(ba.solve_impl, params=params)
    program = programs.Program(solve, device, name="ba_solve")
    dt, (out, info) = time_solves(program, prob, REPS)
    dt_eager, (out_e, info_e) = time_solves(solve, prob, REPS)
    rec = {
        "metric": f"ba_iters_per_s_{C}kf_{L}lm",
        "value": args.iters / dt,
        "unit": "LM iterations/s",
        "timed": "replayed CUDA graph" if program.graphed else "eager (cpu)",
        "eager_value": args.iters / dt_eager,
        "replay_equal": all(torch.equal(a, b) for a, b in zip(
            programs.flatten((out, info))[0], programs.flatten((out_e, info_e))[0])
            if isinstance(a, torch.Tensor)),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "num_obs": int(info["num_obs"]),
        "initial_cost": float(info["initial_cost"]),
        "final_cost": float(info["final_cost"]),
    }
    if device.type == "cuda":
        from viso_tpu_torch.tools.bench_extract import card_line

        rec["card"] = card_line()
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
