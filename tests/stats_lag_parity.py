"""The random-delay cadence scenario of the stats stress tests at a
pinned hard lag, over several delay draws, through the JAX package's
StereoVO or the port's, on the CPU.

    JAX_PLATFORMS=cpu python tests/stats_lag_parity.py --package jax \
        [--lags 8 4] [--seeds 0 1 2 3 4 5 6 7] [--frames 60]
    python tests/stats_lag_parity.py --package port [...]

The scenario is `tests/test_stats_stress.py::
test_keyframe_cadence_under_random_delay`'s (the corridor of
`default_rng(7)` at 192x256, `stats_max_lag=4`, `kf_min_gap=2`,
`kf_max_gap=8`, every stats sample delayed 0-10 frames), with the delay
drawn from `default_rng(seed)` for each seed (the test's own draw is
seed 3) and `stats_hard_lag` pinned to each of `--lags` (8 is the JAX
package's accelerator default, `max(8, 2 * stats_max_lag)`; 4 the CPU's;
the port's card default is 1, `engine.default_stats_hard_lag`). Each
package's run is built by its own test module (`_make_vo` /
`make_vo`). Prints one JSON line per (lag, seed): the keyframe gaps and
the ATE (m, rigid alignment), then one line per lag with the ATE's
min / median / max and how many runs reach the test's 0.08 m.

The JAX package's CPU dispatch runs frames ahead of its compute, so a
sample there lands only when the hard lag force-joins it, whatever its
drawn delay (`viso_tpu/slam/engine.py:806-813`); the port's CPU fetch is
done at once, so its samples land as drawn. `--sync` (JAX only) waits for
the JAX engine's pose and map after each frame (the track program's stats
come out of the same program as the pose), so that its samples land as
drawn too, as the port's do.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

ATE_BOUND_M = 0.08


def run_one(package: str, frames, Rs, ts, seed: int, lag: int, sync: bool = False) -> dict:
    if package == "jax":
        import test_stats_stress as t

        vo = t._make_vo(np.random.default_rng(seed), max_delay=10, stats_hard_lag=lag)
    else:
        import test_torch_stats_stress as t

        vo = t.make_vo(np.random.default_rng(seed), max_delay=10, stats_hard_lag=lag)
    from viso_tpu_torch.utils import metrics

    try:
        for il, ir in frames:
            vo.process(il, ir)
            if sync:
                import jax

                jax.block_until_ready((vo.R, vo.t, vo.map))
        R_est, t_est = vo.trajectory()
        gaps = np.diff([i for i, r in enumerate(vo.results) if r.is_keyframe])
    finally:
        vo.close()
    ate = metrics.ate_rmse(metrics.camera_centers(np.asarray(R_est), np.asarray(t_est)),
                           metrics.camera_centers(Rs, ts), align=True, with_scale=False)
    return dict(gaps=[int(g) for g in gaps], ate_m=float(ate))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--lags", type=int, nargs="+", default=[8, 4])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--sync", action="store_true")
    args = ap.parse_args(argv)
    if args.sync and args.package != "jax":
        ap.error("--sync is for the JAX package")
    from viso_tpu_torch.data import synthetic
    from viso_tpu_torch.geometry import camera
    import test_torch_stats_stress as port_test

    corridor = synthetic.corridor_scene(np.random.default_rng(7), tex_size=512)
    intr = camera.Intrinsics.create(**port_test.INTR)
    Rs, ts = synthetic.forward_trajectory(args.frames, step=0.2, yaw_rate=0.004)
    frames = [synthetic.make_stereo_pair(corridor, intr, R, t, port_test.H, port_test.W,
                                         baseline=0.3)[:2] for R, t in zip(Rs, ts)]
    for lag in args.lags:
        ates = []
        for seed in args.seeds:
            t0 = time.perf_counter()
            r = run_one(args.package, frames, Rs, ts, seed, lag, args.sync)
            ates.append(r["ate_m"])
            print(json.dumps(dict(package=args.package, sync=args.sync, lag=lag, seed=seed, **r,
                                  seconds=time.perf_counter() - t0)), flush=True)
        print(json.dumps(dict(package=args.package, sync=args.sync, lag=lag, seeds=args.seeds,
                              ate_min_m=min(ates), ate_median_m=float(np.median(ates)),
                              ate_max_m=max(ates),
                              under_bound=sum(a < ATE_BOUND_M for a in ates))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
