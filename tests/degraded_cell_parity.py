"""The degraded 500-frame loop cell (`bench.py:649-766`,
`bench_long_slam(degrade=True)`) through the JAX package and through the
port, on the CPU: the figure chip_smoke phase 16(b) takes its bound from,
and the port's own result on the same frames.

    JAX_PLATFORMS=cpu python tests/degraded_cell_parity.py --package jax
    JAX_PLATFORMS=cpu python tests/degraded_cell_parity.py --package port

`--package jax` runs `bench.bench_long_slam(degrade=True)` as it stands:
it renders the orbit into `$TMPDIR/viso_bench_seq_<uid>_184x616x500_v2`
(once), reads it through the native prefetch ring (ring 16, 3 threads),
degrades each pair with `PhotometricNuisance(default_rng(77))` and stages
it one frame ahead. `--package port` runs the port's StereoSLAM on the
same PNG files the same way (`device="cpu"`). Each prints one JSON line:
ATE over every frame of the corrected trajectory (Umeyama, no scale: the
bench's figure), the corrected keyframe ATE (port only), loops, and
seconds. About 150 s (JAX) and 600 s (port) on 8 cores. The JAX
package's result moves with XLA's CPU threading: give the machine's core
count beside a reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def run_jax():
    import bench

    ate, loops, fps = bench.bench_long_slam(degrade=True)
    return dict(ate_m=ate, loops=loops, fps_cpu=list(fps))


def run_port(n_frames=500, warmup=60):
    import numpy as np

    import bench
    from viso_tpu_torch.data import native, synthetic
    from viso_tpu_torch.slam.full import StereoSLAM
    from viso_tpu_torch.slam.loop_closure import LoopParams
    from viso_tpu_torch.tools import diag_loops
    from viso_tpu_torch.utils import metrics

    root, Rs, ts = bench._ensure_png_sequence(184, 616, n_frames)
    paths = [os.path.join(root, f"{side}{i:04d}.png") for i in range(n_frames) for side in "LR"]
    slam = StereoSLAM(diag_loops.stereo_config(), LoopParams(min_inliers=40, max_correction_m=4.0),
                      device="cpu")
    pre = native.Prefetcher(paths, ring=16, threads=3)
    nuisance = synthetic.PhotometricNuisance(np.random.default_rng(77))

    def next_pair():
        il, ir = next(pre), next(pre)
        nuisance.step()
        il, ir = nuisance.apply(il), nuisance.apply(ir)
        return slam.to_device(np.clip(il, 0, 255).astype(np.uint8),
                              np.clip(ir, 0, 255).astype(np.uint8))

    try:
        nxt = next_pair()
        for i in range(n_frames):
            cur = nxt
            nxt = next_pair() if i < n_frames - 1 else None
            slam.process(*cur)
        slam.join()
        R, t = slam.trajectory()
        kf_R, kf_t, kf_frames = slam.graph_trajectory()
        loops = len(slam.loops)
        errors = len(slam.hook_errors)
    finally:
        pre.close()
        slam.close()
    ate = metrics.ate_rmse(metrics.camera_centers(R, t), metrics.camera_centers(Rs, ts),
                           align=True, with_scale=False)
    kf_ate = metrics.ate_rmse(metrics.camera_centers(kf_R, kf_t),
                              metrics.camera_centers(Rs[kf_frames], ts[kf_frames]),
                              align=True, with_scale=False)
    return dict(ate_m=float(ate), keyframe_ate_m=float(kf_ate), loops=loops, hook_errors=errors,
                nodes=len(kf_frames))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=["jax", "port"], required=True)
    args = ap.parse_args(argv)
    t0 = time.time()
    out = run_jax() if args.package == "jax" else run_port()
    out.update(package=args.package, seconds=time.time() - t0, cores=os.cpu_count())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
