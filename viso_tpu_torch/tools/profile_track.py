"""Sub-stages of the track program on the card (port of
`tools/profile_track.py`).

    python -m viso_tpu_torch.tools.profile_track [--reps 5]
        [--height 376 --width 1240] [--device cuda|cpu]

The reference tool's inputs: two uniform-noise images at 376x1240 (rng 0),
1024 landmarks in front of the camera, KITTI intrinsics. Times, through
`utils/profiling.profile_stage`: the pyramid; direct tracking
(`direct.estimate_pose`, templates and GN) at 4 and 3 levels; the
2-level-pyramid alignment against a stack of 8 keyframe pyramids; and the
PnP refine (8 iterations). Each with host, wall, stream and device ms, its
kernel count and K1's launches; then one JSON line. The default device is
the card; without one the tool raises unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from viso_tpu_torch.tools import profile_frame, target

A, K = 1024, 8


def profile(device, reps: int = 5, height: int = profile_frame.H,
            width: int = profile_frame.W) -> list:
    from viso_tpu_torch.geometry import camera as cam_mod
    from viso_tpu_torch.ops import align, direct, pnp, pyramid
    from viso_tpu_torch.utils import profiling

    intr = profile_frame.config(height, width).intrinsics()
    rng = np.random.default_rng(0)

    def T(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    img0 = T(rng.uniform(0, 255, (height, width)))
    img1 = T(rng.uniform(0, 255, (height, width)))
    pyr0, pyr1 = pyramid.build_pyramid(img0), pyramid.build_pyramid(img1)
    pts = T(np.stack([rng.uniform(-5, 5, A), rng.uniform(-2, 2, A), rng.uniform(5, 40, A)], -1))
    mask = torch.ones(A, dtype=torch.bool, device=device)
    R, t = torch.eye(3, device=device), torch.zeros(3, device=device)
    kf_pyr = tuple(lvl[None].expand((K,) + tuple(lvl.shape)).contiguous() for lvl in pyr0)
    k_idx = torch.zeros(A, dtype=torch.int64, device=device)
    uv_ref = T(rng.uniform(20, 350, (A, 2)))
    x_ref = cam_mod.normalize(uv_ref, intr)
    stages = {"pyramid": lambda: pyramid.build_pyramid(img1)}
    for lv in (4, 3):
        p = direct.DirectParams(levels=lv)
        stages[f"direct levels={lv}"] = (
            lambda p=p: direct.estimate_pose(pyr0, pyr1, R, t, pts, mask, intr, R, t, p))
    stages["align"] = lambda: align.align(kf_pyr, k_idx, uv_ref, pyr1, uv_ref + 1.0, mask)
    stages["pnp refine"] = lambda: pnp.refine_pose(R, t, pts, x_ref, mask.to(torch.float32),
                                                   huber=0.003, iters=8)
    return [profiling.profile_stage(name, fn, reps, counter=profile_frame.k1_launches)
            for name, fn in stages.items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--height", type=int, default=profile_frame.H)
    ap.add_argument("--width", type=int, default=profile_frame.W)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device, where = target("profile_track", args.device)
    rows = profile(device, args.reps, args.height, args.width)
    print(f"track sub-stages at {args.height}x{args.width}, {A} landmarks (n/m: not measured)")
    profile_frame.print_stages(rows, where)
    print(json.dumps(dict(device=where, tool="profile_track", size=[args.height, args.width],
                          stages=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
