"""Frozen copy of `viso_tpu_torch/ops/lk.py` for the benchmark's plain
reference (imports rewritten to `vobench.reference`; window copies by
`vobench/reference/geometry/extract.py`'s plain indexing). The original
docstring follows.

Pyramidal Lucas-Kanade optical flow, batched over keypoints (port of
`viso_tpu/ops/lk.py`).

Per keypoint, inverse-compositional Gauss-Newton on a zero-mean 8x8 patch
(half_patch 4), 10 iterations per level with best-cost rollback,
coarse-to-fine over the pyramid with the flow doubled between levels,
and a photometric-error gate at the finest level.

Each level copies the template (reference image) and warm-start (current
image) windows in one launch of the window kernel, through its
two-source entry: the reference image is a one-image stack, so no
(2, H, W) stack and no concatenated centres are copied.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.geometry import extract, sampling


class LKParams(NamedTuple):
    half_patch: int = 4
    iters: int = 10
    levels: int = 4
    # Mean squared photometric error gate per pixel (225 = 15^2).
    err_thresh: float = 225.0
    min_det: float = 1e-4


def _solve2x2(H, b, min_det):
    """Batched closed-form solve of H (..., 2, 2) x = b (..., 2); returns
    (x, ok) with ok where |det| > min_det."""
    det = H[..., 0, 0] * H[..., 1, 1] - H[..., 0, 1] * H[..., 1, 0]
    ok = torch.abs(det) > min_det
    safe = torch.where(ok, det, 1.0)
    x0 = (H[..., 1, 1] * b[..., 0] - H[..., 0, 1] * b[..., 1]) / safe
    x1 = (H[..., 0, 0] * b[..., 1] - H[..., 1, 0] * b[..., 0]) / safe
    return torch.stack([x0, x1], dim=-1), ok


def _zero_mean_cost(cur_win, cur_base, centers, T, half):
    I = sampling.sample_patch_grid(cur_win, cur_base, centers, half)
    r = I - torch.mean(I, dim=(-1, -2), keepdim=True) - T
    return r, torch.mean(r * r, dim=(-1, -2))


def _single_level(img_ref, img_cur, kp_ref, flow0, params: LKParams):
    """One pyramid level of batched inverse-compositional LK.

    kp_ref (N, 2) keypoints at this level's scale; flow0 (N, 2) initial
    displacements. Returns (flow (N, 2), mean_sq_err (N,), ok (N,)).
    """
    half = params.half_patch
    win = min(4 * half + 8, *img_ref.shape)
    n = kp_ref.shape[0]
    k0 = torch.zeros(n, dtype=torch.int32, device=kp_ref.device)
    win2, base2 = extract.extract_windows_two_source(
        img_ref[None], k0, kp_ref, img_cur, kp_ref + flow0, win
    )
    ref_win, cur_win = win2[:n], win2[n:]
    ref_base, cur_base = base2[:n], base2[n:]
    T, gx, gy = sampling.sample_patch_grid_with_grad(ref_win, ref_base, kp_ref, half)
    T = T - torch.mean(T, dim=(-1, -2), keepdim=True)      # ZSSD template
    # Template Hessian, out of the loop (inverse-compositional).
    H00 = torch.sum(gx * gx, dim=(-1, -2))
    H01 = torch.sum(gx * gy, dim=(-1, -2))
    H11 = torch.sum(gy * gy, dim=(-1, -2))
    det = H00 * H11 - H01 * H01
    det_ok = torch.abs(det) > params.min_det
    safe = torch.where(det_ok, det, 1.0)

    flow, best_flow = flow0, flow0
    best_cost = torch.full((n,), float("inf"), dtype=kp_ref.dtype, device=kp_ref.device)
    for _ in range(params.iters):
        r, cost = _zero_mean_cost(cur_win, cur_base, kp_ref + flow, T, half)
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
        flow = flow - delta          # inverse-compositional update
    # The final iterate also competes for best.
    _, cost = _zero_mean_cost(cur_win, cur_base, kp_ref + flow, T, half)
    improved = cost < best_cost
    best_flow = torch.where(improved[:, None], flow, best_flow)
    best_cost = torch.minimum(cost, best_cost)
    return best_flow, best_cost, best_cost < params.err_thresh


def track(pyr_ref, pyr_cur, kp_ref, mask, params: LKParams = LKParams()):
    """Track keypoints kp_ref (N, 2) (level-0 (u, v)) from pyr_ref to
    pyr_cur (tuples of (H/2^l, W/2^l) images), coarse to fine.
    Returns (kp_cur (N, 2), err (N,), ok (N,)); ok also requires the
    tracked point inside the level-0 image with a patch border."""
    flow = torch.zeros_like(kp_ref)
    for level in range(len(pyr_ref) - 1, -1, -1):
        flow, err, ok = _single_level(
            pyr_ref[level], pyr_cur[level], kp_ref * 0.5**level, flow, params
        )
        if level > 0:
            flow = flow * 2.0
    kp_cur = kp_ref + flow
    H0, W0 = pyr_ref[0].shape
    hp = params.half_patch
    inside = (
        (kp_cur[:, 0] >= hp) & (kp_cur[:, 0] < W0 - hp)
        & (kp_cur[:, 1] >= hp) & (kp_cur[:, 1] < H0 - hp)
    )
    return kp_cur, err, ok & inside & mask
