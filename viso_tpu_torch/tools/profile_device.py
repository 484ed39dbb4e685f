"""On-device time per frame of the captured track program (port of
`tools/profile_device.py` and `bench.device_metrics`).

    python -m viso_tpu_torch.tools.profile_device [--frames 64]
        [--trace-dir DIR] [--height 376 --width 1240] [--device cuda|cpu]

StereoVO at the bench headline's configuration (376x1240, KITTI
intrinsics, 512 features, 2048 landmarks, grid 6x12, FAST 20, disparity
128, stats lag 8, `kf_max_gap` 5) runs the first 12 frames of its rng-42
corridor; then the engine's own track program (`vo._program("track")`,
the CUDA graph it captured) replays over a pipelined burst of `--frames`
calls on the 12 pre-staged, distinct frames, each call's pose and
velocity written into the engine's state for the next (as the engine
does), with one synchronisation at the end. One JSON line:

  on_device_fps        burst frames over the burst's host-clock seconds;
                       the host enqueues a replay in microseconds, so
                       this is the device's sustained rate;
  device_ms_per_frame, kernels_per_frame
                       one replay's kernels under torch.profiler and the
                       sum of their device times
                       (`utils/profiling.profile_stage`).

The JAX tool's `mfu_vs_f32_peak` and `hbm_bw_utilization` divide XLA's
cost analysis of the compiled program (its flops and bytes) by the v5e's
peaks. The port has no count of the track program's flops and bytes, so
it reports neither share; the first benchmark change defines that count
(ROADMAP). `--trace-dir` writes the burst's torch.profiler Chrome trace
there (`trace.json`). The default device is the card; without one the
tool raises unless `--device cpu` is given, and on the CPU the device
numbers are None (not measured): `burst_s` is the burst's host clock on
any device. `--height` / `--width` resize the frames (a CPU smoke run).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time

import torch

from viso_tpu_torch.tools import profile_frame, target

FRAMES = 12


def config(height: int = profile_frame.H, width: int = profile_frame.W):
    """The bench headline's configuration at (height, width)."""
    return dataclasses.replace(profile_frame.config(height, width), stats_max_lag=8,
                               kf_max_gap=5)


def profile(device, n: int = 64, height: int = profile_frame.H, width: int = profile_frame.W,
            trace_dir: str | None = None) -> dict:
    from viso_tpu_torch.slam.engine import StereoVO
    from viso_tpu_torch.utils import profiling

    cfg = config(height, width)
    frames = profile_frame.render(cfg, FRAMES)
    vo = StereoVO(cfg, device=device)
    try:
        for il, ir in frames:
            vo.process(il, ir)
        staged = [vo.to_device(il, ir)[0] for il, ir in frames]
        track = vo._program("track")

        def step(img):
            out = track(vo.map, vo._templates, vo._active_idx, img, vo.R, vo.t, vo.vel_xi)
            vo.R, vo.t, vo.vel_xi = out[0], out[1], out[6]
            return out

        cuda = device.type == "cuda"
        one = profiling.profile_stage("track", lambda: step(staged[0]), reps=3,
                                      counter=profile_frame.k1_launches)
        if cuda:
            torch.cuda.synchronize(device)
        trace = profiling.device_trace(trace_dir) if trace_dir else contextlib.nullcontext()
        with trace:
            t0 = time.perf_counter()
            for i in range(n):
                step(staged[i % len(staged)])
            if cuda:
                torch.cuda.synchronize(device)
            burst_s = time.perf_counter() - t0
    finally:
        vo.close()
    return dict(size=[cfg.height, cfg.width], frames=n, burst_s=burst_s,
                on_device_fps=n / burst_s if cuda else None,
                device_ms_per_frame=one["device_ms"], kernels_per_frame=one["kernels"],
                k1_launches_per_frame=one["launches"], host_ms_per_frame=one["host_ms"],
                captured=track.graph is not None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--height", type=int, default=profile_frame.H)
    ap.add_argument("--width", type=int, default=profile_frame.W)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device, where = target("profile_device", args.device)
    r = profile(device, args.frames, args.height, args.width, args.trace_dir)
    print(json.dumps(dict(device=where, tool="profile_device", **r)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
