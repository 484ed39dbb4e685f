"""The loop funnel of the 500-frame SLAM cells through the JAX package's
engines or the port's, on the CPU.

    JAX_PLATFORMS=cpu python tests/loop_funnel_parity.py --package jax [--mono]
    JAX_PLATFORMS=cpu python tests/loop_funnel_parity.py --package port [--mono]

The cells are `viso_tpu_torch/tools/diag_loops.py`'s: StereoSLAM on the
loop orbit (`bench.py:604-692`) or, with `--mono`, MonoSLAM on its left
images (`bench.py:452-534`), with `LoopParams(min_inliers=40,
max_correction_m=4.0)`, at `--seed` (`VOConfig.seed`; each package draws
its own RANSAC hypotheses). `diag_loops.Funnel` is installed the same way
on either package's engine. Prints one JSON line: the funnel, the loops,
the ATE with and without the corrections (stereo: every frame, no scale
alignment; mono: the keyframe nodes, scale-aligned) and the seconds.
Takes 150-400 s per run on a CPU; `chip_smoke.py` phases 6 and 9 print
the port's funnels on the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def jax_run(mono: bool, frames: int, seed: int) -> dict:
    from viso_tpu.slam.engine import VOConfig, _pull_poses
    from viso_tpu.slam.full import StereoSLAM
    from viso_tpu.slam.loop_closure import LoopParams
    from viso_tpu.slam.mono_full import MonoSLAM
    from viso_tpu.utils import metrics
    from viso_tpu_torch.tools import diag_loops, mono_cell

    port_cfg = mono_cell.slam_config(seed) if mono else diag_loops.stereo_config(seed)
    cfg = VOConfig(**{f: getattr(port_cfg, f) for f in port_cfg.__dataclass_fields__
                      if f in VOConfig.__dataclass_fields__})
    params = LoopParams(min_inliers=40, max_correction_m=4.0)
    if mono:
        imgs, Rs, ts = mono_cell.render_orbit(frames)
        slam = MonoSLAM(cfg, params)
    else:
        imgs, Rs, ts = diag_loops.render_stereo(frames)
        slam = StereoSLAM(cfg, params)
    funnel = diag_loops.Funnel(slam)
    t0 = time.perf_counter()
    try:
        for img in imgs:
            slam.process(*(img if isinstance(img, tuple) else (img,)))
        slam.join()
        out = dict(funnel=funnel.counts(),
                   loops=[(lp["from"], lp["to"], int(lp["inliers"])) for lp in slam.loops],
                   hook_errors=len(slam.hook_errors))
        if mono:
            out["ate_m"], out["ate_raw_m"] = mono_cell.slam_accuracy(slam, Rs, ts)
        else:
            c_gt = metrics.camera_centers(Rs, ts)
            for key, (R, t) in (("ate_m", slam.trajectory()),
                                ("ate_raw_m", _pull_poses(slam.results))):
                out[key] = float(metrics.ate_rmse(metrics.camera_centers(R, t), c_gt,
                                                  align=True, with_scale=False))
        out["seconds"] = time.perf_counter() - t0
        return out
    finally:
        slam.close()


def port_run(mono: bool, frames: int, seed: int) -> dict:
    from viso_tpu_torch.tools import diag_loops

    r = diag_loops.run(mono, frames, seed, "cpu")
    return {k: r[k] for k in ("funnel", "loops", "hook_errors", "ate_m", "ate_raw_m",
                              "seconds") if k in r}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--mono", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=500)
    args = ap.parse_args(argv)
    run = jax_run if args.package == "jax" else port_run
    r = run(args.mono, args.frames, args.seed)
    print(json.dumps(dict(package=args.package, cell="mono_slam" if args.mono else "stereo_slam",
                          seed=args.seed, frames=args.frames, **r)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
