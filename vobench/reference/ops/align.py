"""Frozen copy of `viso_tpu_torch/ops/align.py` for the benchmark's plain
reference (imports rewritten to `vobench.reference`; window copies by
`vobench/reference/geometry/extract.py`'s plain indexing). The original
docstring follows.

Map-to-frame feature alignment (port of `viso_tpu/ops/align.py`).

For every visible map point, pick the keyframe with the best viewing
angle as the photometric reference, then run coarse-to-fine batched
2-DoF Gauss-Newton patch alignment of the predicted current-frame
position against it, with best-cost rollback.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.geometry import camera as cam_mod
from vobench.reference.geometry import extract, sampling


class AlignParams(NamedTuple):
    half_patch: int = 4
    iters: int = 10
    err_thresh: float = 225.0
    min_det: float = 1e-4
    max_shift: float = 4.0  # reject refinements that moved further than this
    levels: int = 2         # finest pyramid levels to run


def select_reference_keyframes(points_w, kf_R, kf_t, kf_mask, obs_mask=None):
    """Best-viewing-angle keyframe per point.

    points_w (L, 3); kf_R (K, 3, 3); kf_t (K, 3); kf_mask (K,); obs_mask
    (K, L) optional, restricting the choice to observing keyframes.
    Returns (kf_idx (L,), cos_angle (L,)), cos_angle -inf where no
    keyframe is eligible.
    """
    p_cam = torch.einsum("kij,lj->kli", kf_R, points_w) + kf_t[:, None, :]
    cosang = cam_mod.viewing_cos(p_cam)  # (K, L)
    eligible = kf_mask[:, None] & (p_cam[..., 2] > 1e-3)
    if obs_mask is not None:
        eligible = eligible & obs_mask
    cosang = torch.where(eligible, cosang, float("-inf"))
    return torch.argmax(cosang, dim=0), torch.amax(cosang, dim=0)


def _mean_pp(x):
    return torch.mean(x, dim=(-1, -2))


def _align_level(imgs_ref, k_idx, uv_ref, img_cur, flow0, params: AlignParams):
    """One level of batched 2-DoF GN alignment.

    imgs_ref (K, h, w) keyframe images at this level; k_idx (N,) reference
    keyframe per pair; uv_ref (N, 2) template positions; flow0 (N, 2)
    current displacement of the target from uv_ref.
    """
    half = params.half_patch
    win = min(2 * half + 8, imgs_ref.shape[1], imgs_ref.shape[2], *img_cur.shape)
    # Template and current-frame windows in ONE two-source extraction (the
    # keyframe stack, then the current image), with no copy of the images.
    n = uv_ref.shape[0]
    win2, base2 = extract.extract_windows_two_source(
        imgs_ref, k_idx, uv_ref, img_cur, uv_ref + flow0, win
    )
    ref_win, cur_win = win2[:n], win2[n:]
    ref_base, cur_base = base2[:n], base2[n:]
    T, gx, gy = sampling.sample_patch_grid_with_grad(ref_win, ref_base, uv_ref, half)
    # Zero-mean template (ZSSD) on both sides.
    T = T - _mean_pp(T)[..., None, None]
    H00 = torch.sum(gx * gx, dim=(-1, -2))
    H01 = torch.sum(gx * gy, dim=(-1, -2))
    H11 = torch.sum(gy * gy, dim=(-1, -2))
    det = H00 * H11 - H01 * H01
    det_ok = torch.abs(det) > params.min_det
    safe = torch.where(det_ok, det, 1.0)

    flow, best_flow = flow0, flow0
    best_cost = torch.full(uv_ref.shape[:1], float("inf"), dtype=uv_ref.dtype,
                           device=uv_ref.device)
    for _ in range(params.iters):
        I = sampling.sample_patch_grid(cur_win, cur_base, uv_ref + flow, half)
        r = I - _mean_pp(I)[..., None, None] - T
        cost = _mean_pp(r * r)
        improved = cost < best_cost
        best_flow = torch.where(improved[:, None], flow, best_flow)
        best_cost = torch.minimum(cost, best_cost)
        b0 = torch.sum(gx * r, dim=(-1, -2))
        b1 = torch.sum(gy * r, dim=(-1, -2))
        d0 = (H11 * b0 - H01 * b1) / safe
        d1 = (H00 * b1 - H01 * b0) / safe
        delta = torch.stack([d0, d1], dim=-1)
        delta = torch.where(
            (det_ok & torch.all(torch.isfinite(delta), dim=-1))[:, None], delta, 0.0
        )
        flow = flow - delta
    I = sampling.sample_patch_grid(cur_win, cur_base, uv_ref + flow, half)
    I = I - _mean_pp(I)[..., None, None]
    cost = _mean_pp((I - T) ** 2)
    improved = cost < best_cost
    best_flow = torch.where(improved[:, None], flow, best_flow)
    best_cost = torch.minimum(cost, best_cost)
    return best_flow, best_cost


def align(kf_pyramids, k_idx, uv_ref, cur_pyramid, uv_cur0, mask,
          params: AlignParams = AlignParams()):
    """Refine predicted current-frame positions against reference keyframes.

    kf_pyramids: tuple over levels of (K, h_l, w_l) keyframe images;
    k_idx (N,); uv_ref (N, 2) level-0 template positions; cur_pyramid:
    tuple over levels of (h_l, w_l); uv_cur0 (N, 2) predictions.
    Returns (uv_refined (N, 2), err (N,), ok (N,)).
    """
    levels = min(params.levels, len(cur_pyramid))
    flow = (uv_cur0 - uv_ref) * (0.5 ** (levels - 1))
    for level in range(levels - 1, -1, -1):
        s = 0.5**level
        flow, err = _align_level(
            kf_pyramids[level], k_idx, uv_ref * s, cur_pyramid[level], flow, params
        )
        if level > 0:
            flow = flow * 2.0
    uv_out = uv_ref + flow
    H0, W0 = cur_pyramid[0].shape
    shift = torch.linalg.norm(uv_out - uv_cur0, dim=-1)
    ok = (
        mask
        & (err < params.err_thresh)
        & (shift <= params.max_shift)
        & cam_mod.is_inside(uv_out, H0, W0, border=params.half_patch)
    )
    return uv_out, err, ok
