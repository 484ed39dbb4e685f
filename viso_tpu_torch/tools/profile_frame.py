"""Per-stage profile of the stereo VO frame path on the card (port of
`tools/profile_frame.py`).

    python -m viso_tpu_torch.tools.profile_frame [--reps 5]
        [--height 376 --width 1240] [--device cuda|cpu]

StereoVO at the reference tool's configuration (376x1240, KITTI
intrinsics, 512 features, 2048 landmarks, grid 6x12, FAST 20, disparity
128) on its rng-42 corridor (16 frames at 0.8 m, yaw 0.003 rad per
frame). After 10 frames, each stage of the frame path is called again
from the engine's state (`utils/profiling.profile_stage`, `--reps`
calls after a warm-up):

  tiny dispatch+sync   one elementwise op and its synchronisation;
  upload               one uint8 image to the device through the engine's
                       pinned buffers (`to_device`'s path);
  track                the per-frame program as the engine runs it: the
                       replay of its captured CUDA graph
                       (`vo._program("track")`; on the CPU an eager call
                       through the same static buffers);
  templates            the templates program, once per keyframe;
  stereo_kf            the keyframe insertion program;
  ba                   the window BA program;
  track_eager, templates_eager, stereo_kf_eager, ba_eager
                       the bare functions (`StereoVO._track`,
                       `_templates_program`, `_stereo_kf_program`,
                       `_ba_program`) on the same inputs, eagerly;
  stats fetch          a `HostFetch` of the track's stats and its result
                       after the device is idle (the copy alone), and
                       right after the track is enqueued (what a
                       force-join waits: the rest of the track, then the
                       copy), both on the host clock;

each with host ms (enqueue), wall ms (ending in synchronisation), stream
ms (CUDA events), device ms (the sum of its kernels' device times under
torch.profiler), its kernel count and K1's launches. Then `process()` over
the last 6 frames on the host clock ending in synchronisation, and one
JSON line with every number. `--height` / `--width` resize the images
and scale the intrinsics with them (a CPU smoke run; multiples of 8, as
the pyramid's three halvings need). The default device is the card;
without one the tool raises unless `--device cpu` is given; on the CPU
the device numbers are None (not measured).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from viso_tpu_torch.tools import target

H, W = 376, 1240
KITTI = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157)
FRAMES, WARM = 16, 10


def config(height: int = H, width: int = W):
    from viso_tpu_torch.slam.engine import VOConfig

    sx, sy = width / W, height / H
    return VOConfig(
        height=height, width=width, fx=KITTI["fx"] * sx, fy=KITTI["fy"] * sx,
        cx=KITTI["cx"] * sx, cy=KITTI["cy"] * sy,
        baseline=0.537, num_features=512, max_landmarks=2048, detect_grid=(6, 12),
        fast_threshold=20.0, max_disparity=128,
    )


def render(cfg, n: int = FRAMES):
    """The tool's first `n` stereo frames (float32) at `cfg`'s size: the
    bench's headline corridor (rng 42, 0.8 m steps)."""
    from viso_tpu_torch.data import synthetic

    scene = synthetic.corridor_scene(np.random.default_rng(42), tex_size=1024, far_z=60.0)
    Rs, ts = synthetic.forward_trajectory(n, step=0.8, yaw_rate=0.003)
    return [synthetic.make_stereo_pair(scene, cfg.intrinsics(), R, t, cfg.height, cfg.width,
                                       baseline=cfg.baseline)[:2] for R, t in zip(Rs, ts)]


def k1_launches():
    from viso_tpu_torch.geometry import extract

    return extract.launch.launches


def stats_fetch(vo, img, reps: int):
    """(copy alone, wait after enqueue) in ms per fetch of the track
    program's stats, on the host clock."""
    from viso_tpu_torch.slam.engine import HostFetch

    def track():
        return vo._track(vo.map, vo._templates, vo._active_idx, img, vo.R, vo.t, vo.vel_xi)

    def sync():
        if img.is_cuda:
            torch.cuda.synchronize(img.device)

    alone, after = [], []
    for _ in range(reps + 1):
        stats = track()[4]
        sync()
        t0 = time.perf_counter()
        HostFetch(stats).result()
        alone.append(time.perf_counter() - t0)
        stats = track()[4]
        t0 = time.perf_counter()
        HostFetch(stats).result()
        after.append(time.perf_counter() - t0)
    return 1e3 * float(np.mean(alone[1:])), 1e3 * float(np.mean(after[1:]))


def profile(device, reps: int = 5, height: int = H, width: int = W, frames=None) -> dict:
    """The tool's stages and process() timings on `device`; `frames`, the
    tool's rendered frames when the caller already has them."""
    from viso_tpu_torch.slam.engine import PROGRAMS, StereoVO
    from viso_tpu_torch.utils import profiling

    cfg = config(height, width)
    frames = render(cfg) if frames is None else frames
    vo = StereoVO(cfg, device=device)
    try:
        for il, ir in frames[:WARM]:
            vo.process(il, ir)
        il8 = np.clip(frames[0][0], 0, 255).astype(np.uint8)
        img_l, img_r = vo.to_device(*frames[WARM - 1])
        slot = vo.kf_order[-1]
        L = cfg.max_landmarks
        no_obs = (torch.zeros(L, dtype=torch.bool, device=device),
                  torch.zeros((L, 2), dtype=torch.float32, device=device))
        # The engine's own frozen-camera buffer (the BA program reads it
        # in place).
        cam_fixed = vo._cam_fixed
        cam_fixed.zero_()
        cam_fixed[vo.kf_order[0]].fill_(True)
        x = torch.zeros((), device=device)
        args = {
            "track": (vo.map, vo._templates, vo._active_idx, img_l, vo.R, vo.t, vo.vel_xi),
            "templates": (vo.map, slot),
            "stereo_kf": (vo.map, slot, False, vo.R, vo.t, 99, vo.last_pyr, img_l, img_r,
                          *no_obs, False),
            "ba": (vo.map, cam_fixed, slot, vo.R, vo.t),
        }
        stages = {"tiny dispatch+sync": lambda: x + 1, "upload": lambda: vo._upload(il8)}
        for name, a in args.items():
            stages[name] = lambda prog=vo._program(name), a=a: prog(*a)
            stages[name + "_eager"] = lambda fn=getattr(vo, PROGRAMS[name]), a=a: fn(*a)
        rows = [profiling.profile_stage(name, fn, reps, counter=k1_launches)
                for name, fn in stages.items()]
        copy_ms, wait_ms = stats_fetch(vo, img_l, reps)
        per_frame = []
        for il, ir in frames[WARM:]:
            t0 = time.perf_counter()
            vo.process(il, ir)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            per_frame.append(time.perf_counter() - t0)
        keyframes = sum(r.is_keyframe for r in vo.results)
    finally:
        vo.close()
    return dict(size=[cfg.height, cfg.width], stages=rows, stats_copy_ms=copy_ms,
                stats_wait_ms=wait_ms, process_ms=1e3 * float(np.mean(per_frame)),
                process_frames=len(per_frame), keyframes=keyframes, frames=len(frames))


def fmt(v, spec=".3f"):
    return "n/m" if v is None else format(v, spec)


def print_stages(rows, where):
    """One line per stage: host, wall, stream and device ms, kernels, K1."""
    for r in rows:
        print(f"{r['name']:20s}: host {fmt(r['host_ms'])} ms  wall {fmt(r['wall_ms'])} ms  "
              f"stream {fmt(r['stream_ms'])} ms  device {fmt(r['device_ms'])} ms  "
              f"kernels {fmt(r['kernels'], 'd')}  K1 {fmt(r['launches'], 'd')} [{where}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device, where = target("profile_frame", args.device)
    r = profile(device, args.reps, args.height, args.width)
    print(f"StereoVO {r['size'][0]}x{r['size'][1]} after {WARM} frames (n/m: not measured)")
    print_stages(r["stages"], where)
    print(f"{'stats fetch':20s}: copy alone {r['stats_copy_ms']:.3f} ms, after the track "
          f"is enqueued {r['stats_wait_ms']:.3f} ms (host clock) [{where}]")
    print(f"{'process() avg':20s}: {r['process_ms']:.3f} ms over {r['process_frames']} "
          f"frames (host clock, ending in synchronisation) [{where}]")
    print(f"keyframes: {r['keyframes']}/{r['frames']} frames")
    print(json.dumps(dict(device=where, tool="profile_frame", **r)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
