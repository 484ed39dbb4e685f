"""The LM-iteration time model of the window BA (port of
`tools/calib_ba_iter.py`).

    python -m viso_tpu_torch.tools.calib_ba_iter [--cams 16] [--iters 10]
        [--landmarks 65536 8192] [--device cuda|cpu]

Times `ba.solve_impl` on one device at two landmark counts
(`bench_dist_ba.build_problem`) and fits T_iter(L) = a * L + b: a * L is
the work that splits across landmark shards, b the replicated work (the
reduced camera solve, damping, the accept logic). Each count: one warm
solve, then 10 back to back ending in one synchronise
(`bench_ba.time_solves`), through a `slam/programs.Program` (on the card
a replayed CUDA graph, as the reference times its jitted solve: the fit
and `t_iter_s`), and eagerly (`eager_t_iter_s`). Prints one JSON line.
The fit describes this device only; nothing here models another one.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys

import torch


def _time_solve(prob, params, reps: int = 10):
    """(replayed, eager) seconds per solve."""
    from viso_tpu_torch.backend import ba
    from viso_tpu_torch.slam import programs
    from viso_tpu_torch.tools.bench_ba import time_solves

    solve = functools.partial(ba.solve_impl, params=params)
    program = programs.Program(solve, prob.R.device, name="ba_solve")
    return time_solves(program, prob, reps)[0], time_solves(solve, prob, reps)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cams", type=int, default=16)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--landmarks", type=int, nargs=2, default=[65536, 8192])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from viso_tpu_torch.backend import ba
    from viso_tpu_torch.tools.bench_dist_ba import build_problem

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device (pass --device cpu)")
    params = ba.BAParams(iters=args.iters, num_fixed=2)
    L1, L2 = args.landmarks
    (t1, e1), (t2, e2) = (_time_solve(build_problem(args.cams, L, device), params)
                          for L in (L1, L2))
    it1, it2 = t1 / args.iters, t2 / args.iters
    a = max((it1 - it2) / (L1 - L2), 0.0)
    b = max(it2 - a * L2, 0.0)
    print(json.dumps({
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "cams": args.cams,
        "iters": args.iters,
        "timed": "replayed CUDA graph" if device.type == "cuda" else "eager (cpu)",
        "t_iter_s": {str(L1): it1, str(L2): it2},
        "eager_t_iter_s": {str(L1): e1 / args.iters, str(L2): e2 / args.iters},
        "a_s_per_lm_iter": a,
        "b_s_per_iter": b,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
