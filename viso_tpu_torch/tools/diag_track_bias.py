"""The tracking chain's per-frame step bias under ideal conditions (port of
`tools/diag_track_bias.py`).

    python -m viso_tpu_torch.tools.diag_track_bias [--scene corridor|room]
        [--frames 12] [--step 0.15] [--iters 6] [--device cuda|cpu]

A controlled experiment: a perfect map (FAST corners of the keyframe
image at their rendered depths, the ground-truth keyframe pose) and a
sequence of rendered frames at known poses (184x616, half-KITTI
intrinsics; the rng-5 corridor along a forward path or the room along an
orbit). Each frame is tracked from a ground-truth constant-velocity warm
start, and the estimated step from the previous ground-truth pose is held
against the true one after each stage:

    direct   direct photometric GN against the keyframe templates
             (`direct.build_templates` / `estimate_pose_templated`);
    refined  `align.align` of the keyframe's corners, then the PnP
             `refine_pose` on top of direct.

A bias here is the front end's own, not the map's. Prints one row per
frame (|t| of each step, its ratio to the truth, its error, the rotation
error and the aligned count) and one JSON line with the rows. The default
device is the card; without one the tool raises unless `--device cpu` is
given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from viso_tpu_torch.tools import target

H, W = 184, 616
FX = 718.856 / 2
CX, CY = 607.1928 / 2, 185.2157 / 2


def scene_and_path(scene: str, frames: int, step: float):
    """The reference tool's scene and `frames + 1` ground-truth poses."""
    from viso_tpu_torch.data import synthetic

    rng = np.random.default_rng(5)
    if scene == "corridor":
        sc = synthetic.corridor_scene(rng, tex_size=1024, far_z=90.0)
        Rs, ts = synthetic.forward_trajectory(frames + 1, step=step, yaw_rate=0.002)
    elif scene == "room":
        sc = synthetic.room_scene(rng, tex_size=768, half=5.5)
        Rs, ts = synthetic.orbit_trajectory(frames + 1, radius=2.5,
                                            total_angle=4 * np.pi * (frames + 1) / 500)
    else:
        raise ValueError(f"unknown scene {scene!r}")
    return sc, Rs, ts


def run(scene: str, frames: int, step: float, iters: int, device):
    """Rows of the experiment, one per frame k >= 1: ground-truth, direct
    and refined step lengths (m), the two step errors (m), the refined
    pose's rotation error (deg) and the count of aligned corners."""
    from viso_tpu_torch.geometry import camera as cam_mod
    from viso_tpu_torch.geometry import se3
    from viso_tpu_torch.ops import align, direct, fast, pnp, pyramid

    dev = torch.device(device)
    intr = cam_mod.Intrinsics.create(FX, FX, CX, CY)
    sc, Rs, ts = scene_and_path(scene, frames, step)

    def T(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    # The keyframe at its ground-truth pose, with its corners unprojected
    # at their rendered depths.
    kf_img, kf_depth = sc.render(intr, Rs[0], ts[0], H, W)
    kf_pyr = pyramid.build_pyramid(T(kf_img), 4)
    uv, _, mask = fast.detect_grid(kf_pyr[0], threshold=8.0, grid=(4, 8), per_cell=32)
    uv_np = uv.cpu().numpy()
    z = np.asarray(kf_depth)[np.clip(uv_np[:, 1].astype(int), 0, H - 1),
                             np.clip(uv_np[:, 0].astype(int), 0, W - 1)]
    mask = mask.cpu().numpy() & (z > 0.1) & np.isfinite(z)
    x_n = cam_mod.normalize(uv, intr).cpu().numpy()
    p_cam = np.concatenate([x_n * z[:, None], z[:, None]], axis=-1)
    R0, t0 = np.asarray(Rs[0]), np.asarray(ts[0])
    pts_w = T((p_cam - t0) @ R0)   # R^T (p - t)
    mask_t = torch.as_tensor(mask, device=dev)
    templates = direct.build_templates(kf_pyr, T(R0), T(t0), pts_w, mask_t, intr)
    kf_stack = tuple(lvl[None] for lvl in kf_pyr)
    k_idx = torch.zeros(pts_w.shape[0], dtype=torch.int64, device=dev)

    def step_of(Rx, tx, k):
        _, tr = se3.relative(T(Rx), T(tx), T(Rs[k - 1]), T(ts[k - 1]))
        return tr.cpu().numpy()

    rows = []
    for k in range(1, frames + 1):
        img, _ = sc.render(intr, Rs[k], ts[k], H, W)
        pyr = pyramid.build_pyramid(T(img), 4)
        # Ground-truth constant-velocity warm start, as the engine's.
        Rp, tp = T(Rs[k - 1]), T(ts[k - 1])
        if k >= 2:
            dR, dt = se3.relative(T(Rs[k - 1]), T(ts[k - 1]), T(Rs[k - 2]), T(ts[k - 2]))
            Rp, tp = se3.compose(dR, dt, Rp, tp)
        R_d, t_d, _ = direct.estimate_pose_templated(templates, pyr, pts_w, intr, Rp, tp,
                                                     direct.DirectParams(iters=iters))
        uv_pred, depth = cam_mod.project(se3.transform(R_d, t_d, pts_w), intr)
        visible = mask_t & (depth > 0.1) & cam_mod.is_inside(uv_pred, H, W, border=8)
        refined, _, ok = align.align(kf_stack, k_idx, uv, pyr, uv_pred, visible,
                                     align.AlignParams(iters=5))
        R_f, t_f = pnp.refine_pose(R_d, t_d, pts_w, cam_mod.normalize(refined, intr),
                                   ok.to(torch.float32), huber=2.0 / FX, iters=4)
        gt = step_of(Rs[k], ts[k], k)
        d, f = step_of(R_d.cpu(), t_d.cpu(), k), step_of(R_f.cpu(), t_f.cpu(), k)
        R_f = R_f.cpu().numpy()
        rot = np.degrees(np.arccos(np.clip((np.trace(R_f @ np.asarray(Rs[k]).T) - 1) / 2,
                                           -1, 1)))
        rows.append(dict(frame=k, gt_step_m=float(np.linalg.norm(gt)),
                         direct_step_m=float(np.linalg.norm(d)),
                         refined_step_m=float(np.linalg.norm(f)),
                         direct_err_m=float(np.linalg.norm(d - gt)),
                         refined_err_m=float(np.linalg.norm(f - gt)),
                         rot_err_deg=float(rot), aligned=int(ok.sum())))
    return rows, int(mask.sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="corridor", choices=("corridor", "room"))
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--step", type=float, default=0.15)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device, where = target("diag_track_bias", args.device)
    t0 = time.perf_counter()
    rows, n_landmarks = run(args.scene, args.frames, args.step, args.iters, device)
    print(f"# scene={args.scene} step={args.step} n_landmarks={n_landmarks} "
          f"iters={args.iters} [{where}]")
    print("frame  |t_gt|   direct:|t| ratio  err     refined:|t| ratio  err     "
          "rot_err(deg)")
    for r in rows:
        g = max(r["gt_step_m"], 1e-12)
        print(f"{r['frame']:4d}  {r['gt_step_m']:7.4f}  {r['direct_step_m']:7.4f} "
              f"{r['direct_step_m'] / g:5.2f} {r['direct_err_m']:7.4f}  "
              f"{r['refined_step_m']:7.4f} {r['refined_step_m'] / g:5.2f} "
              f"{r['refined_err_m']:7.4f}  {r['rot_err_deg']:6.3f}   ok={r['aligned']}")
    print(json.dumps(dict(device=where, scene=args.scene, step=args.step, iters=args.iters,
                          landmarks=n_landmarks, rows=rows,
                          seconds=time.perf_counter() - t0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
