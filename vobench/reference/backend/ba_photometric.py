"""Frozen copy of `viso_tpu_torch/backend/ba_photometric.py` for the benchmark's plain
reference (imports rewritten to `vobench.reference`; window copies by
`vobench/reference/geometry/extract.py`'s plain indexing). The original
docstring follows.

Photometric (direct) bundle adjustment: LM + Schur on patch residuals
(port of `viso_tpu/backend/ba_photometric.py`).

Each landmark carries a 4x4 template sampled from its anchor keyframe;
every observing camera contributes a 16-dim residual of its image's
intensities at the landmark's projection, on one pyramid level.

  * One 16x16 window per (camera, landmark) observation is copied once
    per solve around the initial projections -- one launch of the window
    kernel over the keyframe stack, with the origins computed in the
    kernel. Every LM iteration then samples the moving patches and their
    exact bilinear-surface gradients as separable hat-weight products
    against the cached windows; a projection that drifts out of its
    window is masked for that iteration.
  * Landmark-minor layout: r (C, P2, L), Jc (C, P2, 6, L), Jp as three
    (C, P2, L) slabs.
  * The damped 6/3 Schur solve is `ba.schur_solve`.
  * The sample footprint scales with the anchor/current depth ratio,
    frozen per solve.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vobench.reference.backend import robust
from vobench.reference.backend.ba import schur_solve
from vobench.reference.geometry import camera as cam_mod
from vobench.reference.geometry import sampling, se3


class PhotoBAProblem(NamedTuple):
    R: torch.Tensor            # (C, 3, 3)
    t: torch.Tensor            # (C, 3)
    points: torch.Tensor       # (L, 3)
    images: torch.Tensor       # (C, H, W) the keyframe images (one level)
    template: torch.Tensor     # (L, P*P) patch intensities from the anchor
    anchor_idx: torch.Tensor   # (L,) keyframe that owns each template
    obs_mask: torch.Tensor     # (C, L)
    cam_mask: torch.Tensor     # (C,)
    point_mask: torch.Tensor   # (L,)
    cam_fixed: Optional[torch.Tensor] = None


class PhotoBAParams(NamedTuple):
    iters: int = 8
    half_patch: int = 2          # 4x4 patch = 16-dim residual
    huber: float = 12.0          # gray levels
    lam0: float = 1e-3
    lam_up: float = 4.0
    lam_down: float = 0.5
    num_fixed: int = 1
    min_depth: float = 1e-2
    # Each observation's samples live in a win x win window copied at the
    # initial projection.
    win: int = 16


def make_template(images, anchor_idx, points, R, t, intr, half_patch=2):
    """Each landmark's (L, P*P) template, bilinear from its anchor keyframe
    at the point's projection."""
    p_cam = torch.einsum("lij,lj->li", R[anchor_idx], points) + t[anchor_idx]
    uv, _ = cam_mod.project(p_cam, intr)
    offs = sampling.patch_offsets(half_patch, uv.dtype, uv.device).reshape(-1, 2)
    return sampling.bilinear_indexed(images, anchor_idx, uv[:, None, :] + offs[None])


class _Windows(NamedTuple):
    """Per-observation cached sampling state (N = C*L, flattened)."""

    win: torch.Tensor      # (N, w, w) image windows
    base: torch.Tensor     # (N, 2) float window origins (x0, y0)
    scale: torch.Tensor    # (N,) frozen patch-footprint scale
    cover: torch.Tensor    # (C, L) window coverage possible at all


def _project_planes(R, t, points_T, intr):
    """p_cam (C, 3, L), pixel u, v (C, L)."""
    p_cam = torch.einsum("cij,jl->cil", R, points_T) + t[:, :, None]
    z = torch.clamp(p_cam[:, 2], min=1e-6)
    u = intr.fx * p_cam[:, 0] / z + intr.cx
    v = intr.fy * p_cam[:, 1] / z + intr.cy
    return p_cam, u, v


def _precompute_windows(prob: PhotoBAProblem, intr, params: PhotoBAParams):
    """Copy one window per observation at the initial projections."""
    C, H, W = prob.images.shape
    L = prob.points.shape[0]
    _, u0, v0 = _project_planes(prob.R, prob.t, prob.points.T, intr)
    uv0 = torch.stack([u0.reshape(-1), v0.reshape(-1)], dim=-1)   # (N, 2)
    # In-image centres only (the extractor clips origins: a far-out
    # projection would otherwise sample the border window).
    cover = prob.obs_mask & (u0 >= 0) & (u0 <= W - 1) & (v0 >= 0) & (v0 <= H - 1)
    uv_safe = torch.stack(
        [torch.clamp(uv0[:, 0], 0.0, W - 1.0), torch.clamp(uv0[:, 1], 0.0, H - 1.0)], dim=-1
    )
    cam_idx = torch.arange(C, dtype=torch.int32, device=uv0.device)[:, None].expand(C, L).reshape(-1)
    tiles, base = sampling.extract_windows_indexed(prob.images, cam_idx, uv_safe, params.win)
    # Frozen scale warp: anchor depth / current depth at the initial state.
    d_anchor = (
        torch.einsum("lj,lj->l", prob.points, prob.R[prob.anchor_idx][:, 2, :])
        + prob.t[prob.anchor_idx][:, 2]
    )
    z0 = torch.einsum("cj,jl->cl", prob.R[:, 2, :], prob.points.T) + prob.t[:, 2:3]
    scale = torch.clamp(d_anchor[None, :] / torch.clamp(z0, min=1e-3), 0.5, 2.0).reshape(-1)
    return _Windows(win=tiles, base=base.to(uv0.dtype), scale=scale, cover=cover)


def _sampled_residuals(prob, wins: _Windows, R, t, points, intr,
                       params: PhotoBAParams, need_grad: bool):
    """r_T (C, P2, L), gx_T / gy_T (C, P2, L) or None, ok (C, L), p_cam."""
    C = prob.images.shape[0]
    L = points.shape[0]
    half = params.half_patch
    w0 = params.win
    p_cam, u, v = _project_planes(R, t, points.T, intr)
    uv = torch.stack([u.reshape(-1), v.reshape(-1)], dim=-1)
    vals, gx, gy = sampling.sample_patch_grid_scaled_with_grad(
        wins.win, wins.base, uv, half, wins.scale
    )
    # Validity: coverage, masks, positive depth, and the whole scaled
    # patch (with its bilinear support) inside the cached window.
    ext = half * wins.scale.reshape(C, L) + 1.0
    bx = wins.base[:, 0].reshape(C, L)
    by = wins.base[:, 1].reshape(C, L)
    ok = (
        wins.cover
        & prob.cam_mask[:, None]
        & prob.point_mask[None, :]
        & (p_cam[:, 2] > params.min_depth)
        & (u - ext >= bx) & (u + ext <= bx + w0 - 1)
        & (v - ext >= by) & (v + ext <= by + w0 - 1)
    )
    P2 = (2 * half) ** 2

    def to_T(x):  # (N, P, P) -> (C, P2, L)
        return x.reshape(C, L, P2).permute(0, 2, 1)

    r_T = torch.where(ok[:, None, :], to_T(vals) - prob.template.T[None], 0.0)
    if not need_grad:
        return r_T, None, None, ok, p_cam
    return r_T, to_T(gx), to_T(gy), ok, p_cam


def compute_cost(prob: PhotoBAProblem, intr, params: PhotoBAParams,
                 wins: _Windows = None, R=None, t=None, points=None):
    """Total Huber cost of the patch residual norms (huber * 4 per patch)."""
    R = prob.R if R is None else R
    t = prob.t if t is None else t
    points = prob.points if points is None else points
    if wins is None:
        wins = _precompute_windows(prob, intr, params)
    r_T, _, _, ok, _ = _sampled_residuals(prob, wins, R, t, points, intr, params,
                                          need_grad=False)
    r_norm = torch.linalg.norm(r_T, dim=1)
    return torch.sum(torch.where(ok, robust.huber_cost(r_norm, params.huber * 4), 0.0))


def _lm_iteration(prob, wins, R, t, points, intr, lam, params):
    C = R.shape[0]
    r_T, gx_T, gy_T, ok, p_cam = _sampled_residuals(
        prob, wins, R, t, points, intr, params, need_grad=True
    )
    r_norm = torch.linalg.norm(r_T, dim=1)
    w = torch.where(ok, robust.huber_weight(r_norm, params.huber * 4), 0.0)

    # Projection Jacobians in pixel units, L-minor (as ba._jacobians,
    # times the focal lengths).
    X, Y, Z = p_cam[:, 0], p_cam[:, 1], p_cam[:, 2]               # (C, L)
    iz = 1.0 / torch.clamp(Z, min=1e-6)
    iz2 = iz * iz
    zero = torch.zeros_like(X)
    one = torch.ones_like(X)
    fx, fy = intr.fx, intr.fy
    Ju = fx * torch.stack(
        [iz, zero, -X * iz2, -X * Y * iz2, one + X * X * iz2, -Y * iz], dim=1
    )                                                             # (C, 6, L)
    Jv = fy * torch.stack(
        [zero, iz, -Y * iz2, -(one + Y * Y * iz2), X * Y * iz2, X * iz], dim=1
    )
    R0 = R[:, 0, :, None]
    R1 = R[:, 1, :, None]
    R2 = R[:, 2, :, None]
    Jpu = fx * (R0 * iz[:, None] - R2 * (X * iz2)[:, None])      # (C, 3, L)
    Jpv = fy * (R1 * iz[:, None] - R2 * (Y * iz2)[:, None])

    # Chain rule with the exact bilinear-surface gradient planes.
    Jc = gx_T[:, :, None, :] * Ju[:, None] + gy_T[:, :, None, :] * Jv[:, None]
    Jp = [gx_T * Jpu[:, k][:, None] + gy_T * Jpv[:, k][:, None] for k in range(3)]

    Jc_w = Jc * w[:, None, None, :]
    Jp_w = [Jp[k] * w[:, None, :] for k in range(3)]
    U = torch.einsum("cpil,cpjl->cij", Jc_w, Jc)
    V = torch.stack([
        torch.stack([torch.einsum("cpl,cpl->l", Jp_w[i], Jp[j]) for j in range(3)])
        for i in range(3)
    ])                                                            # (3, 3, L)
    Wb = [torch.einsum("cpil,cpl->cil", Jc_w, Jp[k]) for k in range(3)]
    g_c = -torch.einsum("cpil,cpl->ci", Jc_w, r_T)
    g_p = -torch.stack([torch.einsum("cpl,cpl->l", Jp_w[k], r_T) for k in range(3)])

    free = prob.cam_mask & (torch.arange(C, device=R.device) >= params.num_fixed)
    if prob.cam_fixed is not None:
        free = free & ~prob.cam_fixed
    delta_c, delta_p = schur_solve(U, V, Wb, g_c, g_p, lam, prob.point_mask, free)
    R_new, t_new = se3.left_update(delta_c, R, t)
    return R_new, t_new, points + delta_p.T


def solve_impl(prob: PhotoBAProblem, intr, params: PhotoBAParams = PhotoBAParams()):
    """Photometric LM + Schur over the window, `params.iters` iterations
    with branchless accept/reject. Returns (problem, info)."""
    wins = _precompute_windows(prob, intr, params)
    cost0 = compute_cost(prob, intr, params, wins)
    R, t, points = prob.R, prob.t, prob.points
    lam = torch.full((), params.lam0, dtype=prob.R.dtype, device=prob.R.device)
    cost = cost0
    history = []
    for _ in range(params.iters):
        R_n, t_n, p_n = _lm_iteration(prob, wins, R, t, points, intr, lam, params)
        new_cost = compute_cost(prob, intr, params, wins, R_n, t_n, p_n)
        accept = new_cost < cost
        R = torch.where(accept, R_n, R)
        t = torch.where(accept, t_n, t)
        points = torch.where(accept, p_n, points)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(
            accept,
            torch.clamp(lam * params.lam_down, min=1e-9),
            torch.clamp(lam * params.lam_up, max=1e6),
        )
        history.append(cost)
    return prob._replace(R=R, t=t, points=points), {
        "initial_cost": cost0,
        "final_cost": cost,
        "cost_history": torch.stack(history) if history else cost0[None][:0],
    }
