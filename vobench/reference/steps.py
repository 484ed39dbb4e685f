"""The engine's per-frame programs as plain functions: a frozen copy of
`viso_tpu_torch/slam/engine.py`'s `_track`, `_templates_program`,
`_stereo_kf_program`, `_mono_kf_program` and `_ba_program` (the
reprojection and photometric window BA with its adoption gate), run
eagerly on the reference's own modules. `step` replays one frame of an
engine from the state the engine held before it, with the host decisions
the engine made for it (keyframe or not, slots, eviction).

Nothing here imports the port. `cfg` is a `Config`, built from the
configuration file's `engine` section.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from vobench.reference.backend import ba, ba_photometric
from vobench.reference.geometry import camera as cam_mod
from vobench.reference.geometry import se3, triangulation
from vobench.reference.mapping import map_state
from vobench.reference.ops import align, direct, fast, lk, pnp, pyramid, stereo, twoview


@dataclass(frozen=True)
class Config:
    """The engine settings the programs read (`VOConfig`'s defaults)."""

    height: int = 376
    width: int = 1241
    fx: float = 718.856
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    baseline: float = 0.537
    max_keyframes: int = 8
    max_landmarks: int = 2048
    num_features: int = 512
    pyramid_levels: int = 4
    fast_threshold: float = 25.0
    detect_grid: tuple = (6, 12)
    detect_levels: int = 3
    min_triangulation_parallax_deg: float = 0.5
    ransac_threshold_px: float = 2.0
    min_tracked_points: int = 30
    direct_iters: int = 6
    align_iters: int = 5
    track_landmarks: int = 1024
    min_lost_points: int = 8
    max_step_translation: float = 3.0
    max_step_rotation: float = 0.5
    max_accel_rotation: float = 0.2
    max_accel_translation: float = 1.0
    max_ba_shift_rotation: float = 0.05
    max_ba_shift_translation: float = 0.5
    ba_iters: int = 8
    ba_huber_px: float = 3.0
    ba_trunc_px: float = 10.0
    ba_backend: str = "reprojection"
    photo_ba_level: int = 1
    photo_ba_huber: float = 12.0
    max_disparity: int = 128
    min_stereo_depth: float = 0.5
    max_stereo_depth: float = 80.0

    @classmethod
    def of(cls, engine: dict, ba_backend: str):
        keys = set(cls.__dataclass_fields__)
        kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in engine.items() if k in keys}
        return cls(**kw, ba_backend=ba_backend)

    def intrinsics(self):
        return cam_mod.Intrinsics.create(self.fx, self.fy, self.cx, self.cy)


def _clamp_twist(cfg, xi):
    t_norm = torch.linalg.norm(xi[:3])
    r_norm = torch.linalg.norm(xi[3:])
    rho = xi[:3] * torch.clamp(cfg.max_step_translation / torch.clamp(t_norm, min=1e-9), max=1.0)
    phi = xi[3:] * torch.clamp(cfg.max_step_rotation / torch.clamp(r_norm, min=1e-9), max=1.0)
    return torch.cat([rho, phi])


def _detect(cfg, pyr):
    per_cell = max(1, cfg.num_features // (cfg.detect_grid[0] * cfg.detect_grid[1]))
    if cfg.detect_levels > 1:
        return fast.detect_grid_pyramid(pyr, threshold=cfg.fast_threshold, grid=cfg.detect_grid,
                                        per_cell=per_cell, levels=cfg.detect_levels)
    return fast.detect_grid(pyr[0], threshold=cfg.fast_threshold, grid=cfg.detect_grid,
                            per_cell=per_cell)


def track(cfg, m, templates, active, img, R, t, vel_xi):
    """The per-frame program: (R_new, t_new, ok_align (L,), refined (L, 2),
    pyr, vel_new)."""
    intr = cfg.intrinsics()
    pyr = pyramid.build_pyramid(img.to(torch.float32), cfg.pyramid_levels)
    xi_warm = _clamp_twist(cfg, vel_xi)
    dR, dt = se3.se3_exp(xi_warm)
    R0, t0 = se3.compose(dR, dt, R, t)
    L = m.points.shape[0]
    pts_a = m.points[active]
    mask_a = m.point_mask[active]
    R_d, t_d, _ = direct.estimate_pose_templated(
        templates, pyr, pts_a, intr, R0, t0, direct.DirectParams(iters=cfg.direct_iters))
    p_cam = se3.transform(R_d, t_d, pts_a)
    uv_pred, depth = cam_mod.project(p_cam, intr)
    visible = mask_a & (depth > 0.1) & cam_mod.is_inside(uv_pred, cfg.height, cfg.width, border=8)
    k_idx_a, _ = align.select_reference_keyframes(pts_a, m.kf_R, m.kf_t, m.kf_mask,
                                                  m.obs_mask[:, active])
    has_obs = m.obs_mask[k_idx_a, active]
    uv_ref = m.obs_uv[k_idx_a, active]
    refined_a, _, ok_a = align.align(m.kf_pyr, k_idx_a, uv_ref, pyr, uv_pred, visible & has_obs,
                                     align.AlignParams(iters=cfg.align_iters))
    x_ref = cam_mod.normalize(refined_a, intr)
    R_f, t_f = pnp.refine_pose(R_d, t_d, pts_a, x_ref, ok_a.to(torch.float32),
                               huber=cfg.ransac_threshold_px / cfg.fx, iters=4)
    n_tracked = torch.sum(ok_a)
    dRm, dtm = se3.relative(R_f, t_f, R, t)
    xi_meas = _clamp_twist(cfg, se3.se3_log(dRm, dtm))
    dev = xi_meas - vel_xi
    sane = ((torch.linalg.norm(dev[3:]) <= cfg.max_accel_rotation)
            & (torch.linalg.norm(dev[:3]) <= cfg.max_accel_translation))
    use_refined = (n_tracked >= cfg.min_tracked_points) & sane
    lost = n_tracked < cfg.min_lost_points
    R_new = torch.where(use_refined, R_f, torch.where(lost, R, R0))
    t_new = torch.where(use_refined, t_f, torch.where(lost, t, t0))
    vel_new = torch.where(use_refined, 0.7 * vel_xi + 0.3 * xi_meas, vel_xi)
    ok_align = torch.zeros(L, dtype=torch.bool, device=ok_a.device)
    ok_align[active] = ok_a
    refined = torch.zeros((L, 2), dtype=refined_a.dtype, device=ok_a.device)
    refined[active] = refined_a
    return R_new, t_new, ok_align, refined, pyr, vel_new


def templates(cfg, m, slot: int):
    """Active landmark subset and their frozen templates from keyframe `slot`."""
    row = map_state.row
    A = min(cfg.track_landmarks, cfg.max_landmarks)
    priority = (m.point_mask.to(torch.int32) * 2
                + (m.point_mask & row(m.obs_mask, slot)).to(torch.int32))
    active = torch.argsort(-priority, stable=True)[:A]
    pyr_kf = tuple(row(lvl, slot) for lvl in m.kf_pyr)
    tpl = direct.build_templates(pyr_kf, row(m.kf_R, slot), row(m.kf_t, slot), m.points[active],
                                 m.point_mask[active], cfg.intrinsics())
    return tpl, active


def _top_m_by_score(good, score, m):
    s = torch.where(good, score, float("-inf"))
    rank = torch.argsort(torch.argsort(-s, stable=True), stable=True)
    return good & (rank < m)


def _near_existing(uv, existing_uv, existing_mask, radius=8.0):
    d = torch.linalg.norm(uv[:, None, :] - existing_uv[None, :, :], dim=-1)
    d = torch.where(existing_mask[None, :], d, float("inf"))
    return torch.amin(d, dim=-1) < radius


def stereo_kf(cfg, m, slot, do_evict, R, t, frame_id, pyr, img_left, img_right, ok_align,
              refined, have_existing):
    """Keyframe insertion: evict, insert, tracked observations, detect,
    stereo match, backproject, allocate."""
    intr = cfg.intrinsics()
    m = map_state.select(do_evict, map_state.evict_keyframe(m, slot), m)
    img_left = img_left.to(torch.float32)
    img_right = img_right.to(torch.float32)
    m = map_state.insert_keyframe(m, slot, R, t, frame_id, pyr)
    L = m.points.shape[0]
    existing = ok_align & have_existing
    m = map_state.set_observations(m, slot, torch.arange(L, device=m.points.device), refined,
                                   existing)
    uv, score, det_mask = _detect(cfg, pyr)
    det_mask = det_mask & ~_near_existing(uv, refined, existing, 8.0)
    disp, _, ok_d = stereo.match(img_left, img_right, uv, det_mask,
                                 stereo.StereoParams(max_disparity=cfg.max_disparity))
    depth = stereo.disparity_to_depth(disp, cfg.fx, cfg.baseline, ok_d)
    good = ok_d & (depth > cfg.min_stereo_depth) & (depth < cfg.max_stereo_depth)
    budget = torch.clamp(cfg.num_features - torch.sum(existing), min=0)
    good = _top_m_by_score(good, score, budget)
    p_cam = cam_mod.backproject(uv, depth, intr)
    R_inv, t_inv = se3.inverse(R, t)
    p_world = se3.transform(R_inv, t_inv, p_cam)
    m, slots, ok_alloc = map_state.allocate_landmarks(m, p_world, good)
    return map_state.set_observations(m, slot, slots, uv, ok_alloc)


def mono_kf(cfg, m, slot, do_evict, prev_slot, R, t, frame_id, pyr, ok_align, refined):
    """Keyframe insertion: evict, insert with the tracked observations, FAST
    in the previous keyframe, LK to the new frame, gated two-view
    triangulation, far points, allocation."""
    intr = cfg.intrinsics()
    row = map_state.row
    m = map_state.select(do_evict, map_state.evict_keyframe(m, slot), m)
    prev_R = row(m.kf_R, prev_slot)
    prev_t = row(m.kf_t, prev_slot)
    prev_pyr = tuple(row(lvl, prev_slot) for lvl in m.kf_pyr)
    m = map_state.insert_keyframe(m, slot, R, t, frame_id, pyr)
    L = m.points.shape[0]
    m = map_state.set_observations(m, slot, torch.arange(L, device=m.points.device), refined,
                                   ok_align)
    uv_prev, _, det_mask = _detect(cfg, prev_pyr)
    det_mask = det_mask & ~_near_existing(uv_prev, row(m.obs_uv, prev_slot),
                                          row(m.obs_mask, prev_slot), 8.0)
    uv_cur, _, ok_trk = lk.track(prev_pyr, pyr, uv_prev, det_mask)
    x1 = cam_mod.normalize(uv_prev, intr)
    x2 = cam_mod.normalize(uv_cur, intr)
    pts, d1, d2 = triangulation.triangulate(x1, x2, prev_R, prev_t, R, t)
    e1 = triangulation.reprojection_error(pts, x1, prev_R, prev_t)
    e2 = triangulation.reprojection_error(pts, x2, R, t)
    cosang = triangulation.parallax_cos(pts, prev_R, prev_t, R, t)
    enough_parallax = cosang < float(
        np.cos(np.deg2rad(np.float32(cfg.min_triangulation_parallax_deg))))
    good = (ok_trk & (d1 > 0.05) & (d2 > 0.05) & enough_parallax
            & (e1 * cfg.fx < cfg.ransac_threshold_px) & (e2 * cfg.fx < cfg.ransac_threshold_px))
    nan = float("nan")
    d_far = 2.0 * torch.nanquantile(torch.where(good, d1, nan), 0.9)
    p_prev_cam = torch.einsum("ij,nj->ni", prev_R, m.points) + prev_t
    d_map = torch.nanquantile(torch.where(m.point_mask, p_prev_cam[:, 2], nan), 0.5)
    d_far = torch.where(torch.isfinite(d_far), d_far, 4.0 * d_map)
    prev_c = -prev_R.T @ prev_t
    rays_w = torch.cat([x1, torch.ones_like(x1[:, :1])], dim=-1) @ prev_R
    pts_far = prev_c[None, :] + d_far * rays_w
    e2_far = triangulation.reprojection_error(pts_far, x2, R, t)
    far_ok = (ok_trk & ~enough_parallax & torch.isfinite(d_far)
              & (e2_far * cfg.fx < cfg.ransac_threshold_px))
    pts = torch.where(enough_parallax[:, None], pts, pts_far)
    m, slots, ok_alloc = map_state.allocate_landmarks(m, pts, good | far_ok)
    m = map_state.set_observations(m, prev_slot, slots, uv_prev, ok_alloc)
    return map_state.set_observations(m, slot, slots, uv_cur, ok_alloc)


def window_ba(cfg, m, fixed_slots, pose_slot, R0, t0):
    """Window BA with the cameras `fixed_slots` frozen, gated on the shift
    of keyframe `pose_slot` from the tracking pose: (map, R, t)."""
    intr = cfg.intrinsics()
    cam_fixed = torch.zeros(cfg.max_keyframes, dtype=torch.bool, device=m.points.device)
    for s in fixed_slots:
        cam_fixed[s] = True
    if cfg.ba_backend == "photometric":
        prob, intr_l = map_state.as_photo_ba_problem(m, intr, level=cfg.photo_ba_level)
        params = ba_photometric.PhotoBAParams(iters=cfg.ba_iters, huber=cfg.photo_ba_huber,
                                              num_fixed=0)
        out, _ = ba_photometric.solve_impl(prob._replace(cam_fixed=cam_fixed), intr_l, params)
    else:
        prob = map_state.as_ba_problem(m, intr)._replace(cam_fixed=cam_fixed)
        params = ba.BAParams(iters=cfg.ba_iters, huber=cfg.ba_huber_px / cfg.fx,
                             trunc=cfg.ba_trunc_px / cfg.fx, num_fixed=0)
        out, _ = ba.solve_impl(prob, params)
    m_new = map_state.update_from_ba(m, out.R, out.t, out.points[:cfg.max_landmarks])
    R_new, t_new = out.R[pose_slot], out.t[pose_slot]
    dR, dt = se3.relative(R_new, t_new, R0, t0)
    xi = se3.se3_log(dR, dt)
    sane = ((torch.linalg.norm(xi[3:]) <= cfg.max_ba_shift_rotation)
            & (torch.linalg.norm(xi[:3]) <= cfg.max_ba_shift_translation))
    return (map_state.select(sane, m_new, m),
            torch.where(sane, R_new, R0), torch.where(sane, t_new, t0))


def twoview_init(device, gen_state, x1, x2, mask, params):
    """A monocular bootstrap's two-view initialization from its
    correspondences, with its RANSAC hypotheses drawn from a generator in
    the state the engine's was in: (R, t, points, inliers)."""
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    res = twoview.initialize(gen, x1, x2, mask, twoview.TwoViewParams(*params))
    return {"R": res.R, "t": res.t, "points": res.points, "inliers": res.inliers}


def first(cfg, stereo_rig: bool, frame, device):
    """A stereo engine's first frame, from nothing: the empty map, the
    identity pose, and the keyframe built from the first pair alone (slot
    0, frame 0)."""
    if not stereo_rig:
        raise ValueError("a monocular engine's first frames are its bootstrap")
    m = map_state.empty(cfg.max_keyframes, cfg.max_landmarks, (cfg.height, cfg.width),
                        cfg.pyramid_levels, device=device)
    R = torch.eye(3, dtype=torch.float32, device=device)
    t = torch.zeros(3, dtype=torch.float32, device=device)
    pyr = pyramid.build_pyramid(frame[0].to(torch.float32), cfg.pyramid_levels)
    L = cfg.max_landmarks
    m = stereo_kf(cfg, m, 0, False, R, t, 0, pyr, frame[0], frame[1],
                  torch.zeros(L, dtype=torch.bool, device=device),
                  torch.zeros((L, 2), dtype=torch.float32, device=device), False)
    return {"map": m, "R": R, "t": t, "vel": torch.zeros(6, dtype=torch.float32, device=device)}


def step(cfg, stereo_rig: bool, pre, frame, decision):
    """One frame of an engine from the state `pre` it held before the frame
    (a dict: `map` a MapState, `R`, `t`, `vel`), the frame's images
    (`frame`: (left, right) uint8 tensors, or (image,)) and the host
    decisions the engine made for it (`decision`: `frame_id`, `kf_before`
    and `kf_after`, the keyframe slots oldest first before and after the
    frame). Returns the state after the frame, as `pre`."""
    m = pre["map"]
    kf_before, kf_after = decision["kf_before"], decision["kf_after"]
    tpl, active = templates(cfg, m, kf_before[-1])
    R, t, ok_align, refined, pyr, vel = track(cfg, m, tpl, active, frame[0], pre["R"], pre["t"],
                                              pre["vel"])
    if kf_after == kf_before:
        return {"map": m, "R": R, "t": t, "vel": vel}
    slot = kf_after[-1]
    evict = len(kf_before) >= cfg.max_keyframes
    if stereo_rig:
        m = stereo_kf(cfg, m, slot, evict, R, t, decision["frame_id"], pyr, frame[0], frame[1],
                      ok_align, refined, True)
        fixed = kf_after[:1]
    else:
        m = mono_kf(cfg, m, slot, evict, kf_before[-1], R, t, decision["frame_id"], pyr,
                    ok_align, refined)
        fixed = kf_after[:2]
    if len(kf_after) >= 2:
        m, R, t = window_ba(cfg, m, fixed, slot, R, t)
    return {"map": m, "R": R, "t": t, "vel": vel}
