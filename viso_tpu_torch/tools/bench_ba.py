"""LM iterations/s of the window BA on a 50-keyframe window (port of
`tools/bench_ba.py`).

    python -m viso_tpu_torch.tools.bench_ba [--cams 50] [--landmarks 4096]
        [--iters 10] [--device cuda|cpu]

A synthetic 50-camera x 4,096-landmark problem (about 60k observations,
0.7 px observation noise, cameras 2.. perturbed), solved by
`ba.solve_impl` once to warm up and then 10 times back to back, ending in
one synchronise. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

REPS = 10   # timed solves, back to back


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cams", type=int, default=50)
    ap.add_argument("--landmarks", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from viso_tpu_torch.backend import ba
    from viso_tpu_torch.tools.bench_dist_ba import build_problem

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device (pass --device cpu)")
    C, L = args.cams, args.landmarks
    prob = build_problem(C, L, device, obs_noise=1.0 / 700, pose_noise=0.01)
    params = ba.BAParams(iters=args.iters, num_fixed=2)
    out, info = ba.solve_impl(prob, params)
    float(info["final_cost"])
    t0 = time.perf_counter()
    for _ in range(REPS):
        out, info = ba.solve_impl(prob, params)
    float(info["final_cost"])          # one synchronise, after the last solve
    dt = (time.perf_counter() - t0) / REPS
    rec = {
        "metric": f"ba_iters_per_s_{C}kf_{L}lm",
        "value": args.iters / dt,
        "unit": "LM iterations/s",
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
