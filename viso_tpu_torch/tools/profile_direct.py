"""Inside direct tracking on the card: per-level cost, and K1's window
extraction against the samplers and the Gauss-Newton pass (port of
`tools/profile_direct.py`).

    python -m viso_tpu_torch.tools.profile_direct [--reps 5]
        [--height 376 --width 1240] [--device cuda|cpu]

The reference tool's inputs (two uniform-noise images at 376x1240, rng 0,
1024 landmarks, KITTI intrinsics). Per pyramid level, through
`utils/profiling.profile_stage`:

  pass     one full plain pass, `direct.level_pass_plain` (window
           extraction, 10 GN iterations of hat-weight sampling and a 6x6
           solve, the final cost) against the level's frozen template;
  pass (kernel)
           the same pass as the track runs it, `direct._level_pass_cached`:
           on the card K1's windows and the GN kernel
           (`csrc/direct_gn.cu`, iters + 1 launches with a cuBLAS gemv
           between two), on the CPU the plain pass again;
  K1       the pass's own window extraction alone
           (`extract.extract_windows_fast` at the pass's window size and
           points: K1 on the card);
  sampler  one `sampling.sample_patch_grid_scaled` over those windows
           (the per-iteration sampling).

Then, as the reference tool at level 0: K1 at 16x16 and 24x24 windows of
1024 centres, one sampler pass, one with gradients, and 10 chained
passes. Each with host, wall, stream and device ms, kernels and K1's
launches; one JSON line at the end. This is what a fusion of K1 with the
samplers would have to beat. The default device is the card; without one
the tool raises unless `--device cpu` is given.

`TrackLaunches` holds the kernel's launches on a run of the engine to
the track programs that made them (chip_smoke.py's main paths and the
ranks of `multiprocess_ba`).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from viso_tpu_torch.tools import profile_frame, target

A = 1024


def pass_window(img, half: int) -> int:
    """The window `direct._level_pass_cached` extracts at this level."""
    margin = 8 if min(img.shape) <= 200 else 4
    return min(2 * half + 2 * margin, *img.shape)


def profile(device, reps: int = 5, height: int = profile_frame.H,
            width: int = profile_frame.W) -> dict:
    from viso_tpu_torch.geometry import camera as cam_mod
    from viso_tpu_torch.geometry import extract, sampling, se3
    from viso_tpu_torch.ops import direct, pyramid
    from viso_tpu_torch.utils import profiling

    intr = profile_frame.config(height, width).intrinsics()
    rng = np.random.default_rng(0)

    def T(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

    img0 = T(rng.uniform(0, 255, (height, width)))
    img1 = T(rng.uniform(0, 255, (height, width)))
    pyr0, pyr1 = pyramid.build_pyramid(img0), pyramid.build_pyramid(img1)
    pts = T(np.stack([rng.uniform(-5, 5, A), rng.uniform(-2, 2, A), rng.uniform(5, 40, A)], -1))
    mask = torch.ones(A, dtype=torch.bool, device=device)
    R, t = torch.eye(3, device=device), torch.zeros(3, device=device)
    p = direct.DirectParams()
    half = p.half_patch

    def stage(name, fn):
        return profiling.profile_stage(name, fn, reps, counter=profile_frame.k1_launches)

    levels = []
    for level in range(len(pyr0)):
        intr_l = intr.at_level(level)
        pts_l, mask_l = direct._level_points(pts, mask, level)
        tmpl = direct.build_level_template(pyr0[level], pts_l, mask_l, R, t, intr_l, p)
        img = pyr1[level]
        win = pass_window(img, half)
        uv, _ = cam_mod.project(se3.transform(R, t, pts_l), intr_l)
        wins, base = extract.extract_windows_fast(img, uv, win)
        scale = torch.ones(uv.shape[0], device=device)
        levels.append(dict(
            level=level, shape=list(img.shape), points=int(uv.shape[0]), win=win,
            iters=p.iters,
            gn_pass=stage(f"level {level} pass", lambda img=img, tmpl=tmpl, pts_l=pts_l,
                        intr_l=intr_l: direct.level_pass_plain(img, tmpl, pts_l, R, t,
                                                               intr_l, p)),
            gn_kernel=stage(f"level {level} pass (kernel)",
                            lambda img=img, tmpl=tmpl, pts_l=pts_l.contiguous(),
                            intr_l=intr_l: direct._level_pass_cached(img, tmpl, pts_l, R, t,
                                                                     intr_l, p)),
            k1=stage(f"level {level} K1", lambda img=img, uv=uv, win=win:
                     extract.extract_windows_fast(img, uv, win)),
            sampler=stage(f"level {level} sampler", lambda wins=wins, base=base, uv=uv,
                          scale=scale: sampling.sample_patch_grid_scaled(wins, base, uv, half,
                                                                         scale)),
        ))
    centers = T(rng.uniform(30, 300, (A, 2)))
    rows = [stage(f"K1 win={win}", lambda win=win: extract.extract_windows_fast(img0, centers,
                                                                                win))
            for win in (16, 24)]
    wins, base = extract.extract_windows_fast(img0, centers, 16)
    rows.append(stage("sampler (1 pass)",
                      lambda: sampling.sample_patch_grid(wins, base, centers, 4)))
    rows.append(stage("sampler with grad",
                      lambda: sampling.sample_patch_grid_with_grad(wins, base, centers, 4)))

    def chain():
        acc = torch.zeros((), device=device)
        for _ in range(10):
            acc = acc + sampling.sample_patch_grid(wins, base, centers + acc * 1e-9, 4).sum()
        return acc

    rows.append(stage("10x sampler chained", chain))
    return dict(levels=levels, level0=rows)


def corridor_levels(device, iters: int = 6) -> dict:
    """The track's four level passes on real frames: two frames of the
    rng-5 corridor at 376x1240 (KITTI intrinsics), 0.8 m apart
    (`stereo_vo.drive`'s step), the keyframe's templates (its FAST corners
    in 4x8 cells of 32, 1,024 points unprojected at their rendered depths,
    at its ground-truth pose) and the next frame's pyramid. Each level's
    input pose is what the track feeds it: the plain pass's result at the
    level above, from the keyframe's pose. Returns dict(intr, pyr, tmpl,
    pts, params, args: {level: the level pass's arguments}, truth: the
    frame's ground-truth (R, t))."""
    from viso_tpu_torch.data import synthetic
    from viso_tpu_torch.geometry import camera as cam_mod
    from viso_tpu_torch.ops import direct, fast, pyramid

    H, W = profile_frame.H, profile_frame.W
    intr = profile_frame.config(H, W).intrinsics()
    sc = synthetic.corridor_scene(np.random.default_rng(5), tex_size=1024, far_z=90.0)
    Rs, ts = synthetic.forward_trajectory(2, step=0.8, yaw_rate=0.002)
    kf_img, kf_depth = sc.render(intr, Rs[0], ts[0], H, W)
    img, _ = sc.render(intr, Rs[1], ts[1], H, W)

    def T(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    kf_pyr = pyramid.build_pyramid(T(kf_img), 4)
    uv, _, mask = fast.detect_grid(kf_pyr[0], threshold=8.0, grid=(4, 8), per_cell=32)
    uv_np = uv.cpu().numpy()
    z = np.asarray(kf_depth)[np.clip(uv_np[:, 1].astype(int), 0, H - 1),
                             np.clip(uv_np[:, 0].astype(int), 0, W - 1)]
    z = np.where(np.isfinite(z) & (z > 0.1), z, 10.0)
    x_n = cam_mod.normalize(uv, intr).cpu().numpy()
    p_cam = np.concatenate([x_n * z[:, None], z[:, None]], axis=-1)
    pts = T((p_cam - np.asarray(ts[0])) @ np.asarray(Rs[0]))   # R^T (p - t)
    params = direct.DirectParams(iters=iters)
    tmpl = direct.build_templates(kf_pyr, T(Rs[0]), T(ts[0]), pts, mask, intr, params)
    pyr = pyramid.build_pyramid(T(img), 4)
    args = {}
    R, t = T(Rs[0]), T(ts[0])
    for level in range(3, -1, -1):
        pts_l, _ = direct._level_points(pts, None, level)
        args[level] = [pyr[level], tmpl[level], pts_l.contiguous(), R, t,
                       intr.at_level(level), params]
        R, t, _ = direct.level_pass_plain(*args[level])
    return dict(intr=intr, pyr=pyr, tmpl=tmpl, pts=pts, params=params, args=args,
                truth=(T(Rs[1]), T(ts[1])))


class TrackLaunches:
    """The direct kernel's launches held to the engines' track programs.

    While installed (a context), each call of an engine's track program
    adds the launches it makes on the card: one level pass of
    `direct_iters + 1` launches for each of min(levels, pyramid_levels)
    levels, once for a replay (the programs add a graph's launches,
    `slam/programs.COUNTERS`) and once more for each eager warm-up before
    a capture; none on the CPU. `reset` zeroes that tally, the calls and
    `direct.launch.launches`; `held` raises unless the launches since equal
    the tally, and returns them."""

    def __init__(self):
        self.calls = self.want = 0

    def __enter__(self):
        from viso_tpu_torch.ops import direct
        from viso_tpu_torch.slam import programs

        self._call = call = programs.Program.__call__

        def counted(prog, *args):
            if prog.name != "track":
                return call(prog, *args)
            fresh = prog.graph is None
            out = call(prog, *args)
            cfg = prog.fn.__self__.cfg
            n = 1 + (programs.WARMUP_CALLS if fresh and prog.graph is not None
                     and prog.cache is None else 0)
            self.calls += 1
            if prog.device.type == "cuda":
                self.want += n * min(direct.DirectParams().levels, cfg.pyramid_levels) * (
                    cfg.direct_iters + 1)
            return out

        programs.Program.__call__ = counted
        return self

    def __exit__(self, *exc):
        from viso_tpu_torch.slam import programs

        programs.Program.__call__ = self._call

    def reset(self):
        from viso_tpu_torch.ops import direct

        direct.launch.launches = 0
        self.calls = self.want = 0

    def held(self, label: str) -> int:
        from viso_tpu_torch.ops import direct

        got = direct.launch.launches
        if got != self.want:
            raise AssertionError(f"{label}: {got} direct_gn launches for {self.calls} track "
                                 f"calls, which make {self.want}")
        return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--height", type=int, default=profile_frame.H)
    ap.add_argument("--width", type=int, default=profile_frame.W)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device, where = target("profile_direct", args.device)
    r = profile(device, args.reps, args.height, args.width)
    print(f"direct tracking at {args.height}x{args.width}, {A} landmarks (n/m: not measured)")
    for lv in r["levels"]:
        print(f"level {lv['level']} {lv['shape'][0]}x{lv['shape'][1]}: {lv['points']} points, "
              f"{lv['win']}x{lv['win']} windows, {lv['iters']} GN iterations")
        profile_frame.print_stages([lv["gn_pass"], lv["gn_kernel"], lv["k1"], lv["sampler"]],
                                   where)
    profile_frame.print_stages(r["level0"], where)
    print(json.dumps(dict(device=where, tool="profile_direct", size=[args.height, args.width],
                          **r)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
