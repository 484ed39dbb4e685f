"""Frozen copy of `viso_tpu_torch/ops/direct.py` for the benchmark's plain
reference (imports rewritten to `vobench.reference`; window copies by
`vobench/reference/geometry/extract.py`'s plain indexing). The original
docstring follows.

Sparse direct (photometric) pose estimation against frozen templates
(port of `viso_tpu/ops/direct.py`: the templated path the engine runs, and
`estimate_pose`).

Multi-level coarse-to-fine Gauss-Newton on SE(3) with 8x8-patch
photometric residuals. Templates (patches + frozen Jacobians) are built
once per keyframe; each GN iteration then needs only bilinear samples of
the current image's cached windows. Branchless: a fixed iteration count
with best-cost rollback, and a singular 6x6 solve zeroes the step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.geometry import camera as cam_mod
from vobench.reference.geometry import extract, sampling, se3


class DirectParams(NamedTuple):
    half_patch: int = 4
    iters: int = 10
    levels: int = 4
    huber_delta: float = 25.0  # gray levels
    min_depth: float = 1e-3
    lm_damping: float = 1e-4
    # Global affine illumination compensation (one closed-form gain/bias
    # pair over all valid patch pixels per iteration).
    affine: bool = True


def pixel_jacobian(p_cam, intr: cam_mod.Intrinsics):
    """d(u,v)/d(xi) for a left-perturbed world->cam pose: (..., 2, 6),
    twist [rho, phi] (translation first)."""
    X, Y, Z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    iz = 1.0 / torch.clamp(Z, min=1e-9)
    iz2 = iz * iz
    fx, fy = intr.fx, intr.fy
    zero = torch.zeros_like(X)
    row_u = torch.stack(
        [
            fx * iz,
            zero,
            -fx * X * iz2,
            -fx * X * Y * iz2,
            fx * (1.0 + X * X * iz2),
            -fx * Y * iz,
        ],
        dim=-1,
    )
    row_v = torch.stack(
        [
            zero,
            fy * iz,
            -fy * Y * iz2,
            -fy * (1.0 + Y * Y * iz2),
            fy * X * Y * iz2,
            fy * X * iz,
        ],
        dim=-1,
    )
    return torch.stack([row_u, row_v], dim=-2)


def _huber_weight(r, delta):
    a = torch.abs(r)
    return torch.where(a <= delta, 1.0, delta / torch.clamp(a, min=1e-9))


class LevelTemplate(NamedTuple):
    """Frozen per-level tracking template: T (N, P, P) patches; J6
    (6, N*P*P) frozen photometric Jacobian; ok (N,) validity; d_ref (N,)
    reference depths (for the depth-ratio scale warp)."""
    T: torch.Tensor
    J6: torch.Tensor
    ok: torch.Tensor
    d_ref: torch.Tensor


def build_level_template(img_ref, points_w, point_mask, R_ref, t_ref,
                         intr_l, params: DirectParams) -> LevelTemplate:
    """Template patches + frozen Jacobians for one pyramid level."""
    half = params.half_patch
    H_img, W_img = img_ref.shape
    p_ref = se3.transform(R_ref, t_ref, points_w)
    uv_ref, d_ref = cam_mod.project(p_ref, intr_l)
    ref_ok = (d_ref > params.min_depth) & cam_mod.is_inside(
        uv_ref, H_img, W_img, border=half + 1
    ) & point_mask
    n_points = points_w.shape[0]
    win = min(2 * half + 2, *img_ref.shape)
    ref_win, ref_base = extract.extract_windows_fast(img_ref, uv_ref, win)
    T, gx, gy = sampling.sample_patch_grid_with_grad(
        ref_win, ref_base, uv_ref, half
    )
    Jpix = pixel_jacobian(p_ref, intr_l)                        # (N, 2, 6)
    patch_px = (2 * half) ** 2
    J6 = (
        gx[None] * Jpix[:, 0].T[:, :, None, None]
        + gy[None] * Jpix[:, 1].T[:, :, None, None]
    ).reshape(6, n_points * patch_px)
    return LevelTemplate(T=T, J6=J6, ok=ref_ok, d_ref=d_ref)


def _level_pass_cached(img_cur, tmpl: LevelTemplate, points_w,
                       R0, t0, intr_l, params: DirectParams):
    """One pyramid level of direct GN against a frozen template.
    Returns (R, t, cost)."""
    half = params.half_patch
    H_img, W_img = img_cur.shape
    # Window = patch + motion margin; coarse levels get the wider margin.
    margin = 8 if min(img_cur.shape) <= 200 else 4
    win = min(2 * half + 2 * margin, *img_cur.shape)
    n_points = points_w.shape[0]
    patch_px = (2 * half) ** 2
    dtype, dev = img_cur.dtype, img_cur.device

    p0 = se3.transform(R0, t0, points_w)
    uv0, _ = cam_mod.project(p0, intr_l)
    cur_win, cur_base = extract.extract_windows_fast(img_cur, uv0, win)
    T, J6, ref_ok = tmpl.T, tmpl.J6, tmpl.ok
    # Upper scale clip from the cached window footprint: the in_win gate
    # needs half*scale + 1 <= half + margin - 1.
    scale_hi = min(2.0, (half + margin - 2) / half)
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def compute_b(R, t):
        p_cur = se3.transform(R, t, points_w)
        uv_cur, d_cur = cam_mod.project(p_cur, intr_l)
        # Depth-ratio scale warp of the current patch footprint.
        scale = torch.clamp(
            tmpl.d_ref / torch.clamp(d_cur, min=params.min_depth), 0.5, scale_hi
        )
        ext = half * scale[:, None] + 1.0
        # The port's windows are exactly win x win (the TPU kernel's
        # aligned over-copy is not reproduced), so the extent is `win`.
        in_win = torch.all(
            (uv_cur - cur_base >= ext) & (uv_cur - cur_base <= win - ext - 1.0),
            dim=-1,
        )
        cur_ok = (
            (d_cur > params.min_depth)
            & cam_mod.is_inside(uv_cur, H_img, W_img, border=half + 1)
            & in_win
        )
        ok = (ref_ok & cur_ok).to(dtype)  # (N,)
        I = sampling.sample_patch_grid_scaled(cur_win, cur_base, uv_cur, half, scale)
        if params.affine:
            okm = ok[:, None, None]
            wsum = torch.clamp(torch.sum(okm) * T.shape[1] * T.shape[2], min=1.0)
            mT = torch.sum(T * okm) / wsum
            mI = torch.sum(I * okm) / wsum
            dT = (T - mT) * okm
            cov = torch.sum(dT * (I - mI))
            varT = torch.sum(dT * dT)
            a = torch.clamp(cov / torch.clamp(varT, min=1e-3), 0.5, 2.0)
            r = I - (a * T + (mI - a * mT))
        else:
            r = I - T
        w = _huber_weight(r, params.huber_delta) * ok[:, None, None]
        rf = r.reshape(n_points * patch_px)
        wf = w.reshape(n_points * patch_px)
        J6w = J6 * wf[None]                                  # (6, M)
        H = J6w @ J6.T
        b = -(J6w @ rf)
        # A pose that pushes (almost) every point out of view reads as
        # terrible, not perfect.
        n_valid = torch.sum(ok)
        mean = torch.sum(wf * rf * rf) / torch.clamp(torch.sum(wf), min=1.0)
        cost = torch.where(n_valid >= 10, mean, float("inf"))
        return H, b, cost

    R, t = R0, t0
    best_R, best_t = R0, t0
    best_cost = torch.full((), float("inf"), dtype=dtype, device=dev)
    for _ in range(params.iters):
        H, b, cost = compute_b(R, t)
        improved = cost < best_cost
        best_R = torch.where(improved, R, best_R)
        best_t = torch.where(improved, t, best_t)
        best_cost = torch.minimum(cost, best_cost)
        Hd = H + params.lm_damping * eye6 * (torch.trace(H) / 6.0 + 1.0)
        # solve_ex does not raise on a singular system (jnp.linalg.solve
        # returns non-finite values there); either way the step is zeroed.
        xi, _ = torch.linalg.solve_ex(Hd, b)
        xi = torch.where(torch.all(torch.isfinite(xi)), xi, 0.0)
        R, t = se3.left_update(xi, R, t)
    # Let the final iterate compete too.
    _, _, cost = compute_b(R, t)
    improved = cost < best_cost
    best_R = torch.where(improved, R, best_R)
    best_t = torch.where(improved, t, best_t)
    best_cost = torch.minimum(cost, best_cost)
    return best_R, best_t, best_cost


def estimate_pose(pyr_ref, pyr_cur, R_ref, t_ref, points_w, point_mask,
                  intr: cam_mod.Intrinsics, R0, t0, params: DirectParams = DirectParams()):
    """Multi-level direct pose estimation of the current frame against a
    reference frame (viso.cpp:760-766): `build_templates` from the
    reference pyramid at its world->camera pose (R_ref, t_ref), then
    `estimate_pose_templated` from the initial guess (R0, t0).
    points_w (N, 3) world points, point_mask (N,). Returns (R, t,
    final_cost)."""
    templates = build_templates(pyr_ref, R_ref, t_ref, points_w, point_mask, intr, params)
    return estimate_pose_templated(templates, pyr_cur, points_w, intr, R0, t0, params)


def _level_points(points_w, point_mask, level: int):
    """A quarter of the points at coarse levels (>= 2) of a large set."""
    if level >= 2 and points_w.shape[0] >= 512:
        return points_w[::4], None if point_mask is None else point_mask[::4]
    return points_w, point_mask


def build_templates(pyr_ref, R_ref, t_ref, points_w, point_mask,
                    intr: cam_mod.Intrinsics, params: DirectParams = DirectParams()):
    """Frozen multi-level tracking templates (tuple indexed by level)."""
    levels = min(params.levels, len(pyr_ref))
    out = []
    for level in range(levels):
        pts_l, mask_l = _level_points(points_w, point_mask, level)
        out.append(
            build_level_template(
                pyr_ref[level], pts_l, mask_l, R_ref, t_ref,
                intr.at_level(level), params,
            )
        )
    return tuple(out)


def estimate_pose_templated(templates, pyr_cur, points_w, intr: cam_mod.Intrinsics,
                            R0, t0, params: DirectParams = DirectParams()):
    """Multi-level direct pose estimation against frozen templates.
    Returns (R, t, final_cost)."""
    R, t = R0, t0
    cost = None
    levels = min(params.levels, len(pyr_cur), len(templates))
    for level in range(levels - 1, -1, -1):
        pts_l, _ = _level_points(points_w, None, level)
        R, t, cost = _level_pass_cached(
            pyr_cur[level], templates[level], pts_l, R, t,
            intr.at_level(level), params,
        )
    return R, t, cost
