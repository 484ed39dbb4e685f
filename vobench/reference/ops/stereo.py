"""Frozen copy of `viso_tpu_torch/ops/stereo.py` for the benchmark's plain
reference (imports rewritten to `vobench.reference`; window copies by
`vobench/reference/geometry/extract.py`'s plain indexing). The original
docstring follows.

Stereo matching along rectified epipolar lines (port of
`viso_tpu/ops/stereo.py`).

For N keypoints and D candidate disparities: one scanline window of
width D+P per keypoint (the window-extraction kernel), resampled once
onto the keypoint's fractional grid with separable hat weights; the SSD
of every disparity is then a static slice of the resampled strip. Argmin
over D, then a sub-pixel parabola fit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from vobench.reference.geometry import extract, sampling


class StereoParams(NamedTuple):
    max_disparity: int = 128
    half_patch: int = 4
    # Maximum acceptable mean SSD per pixel for a valid match.
    max_cost: float = 400.0
    min_disparity: float = 0.25   # sub-pixel disparities below are unusable


def match(img_left, img_right, kp_left, mask, params: StereoParams = StereoParams()):
    """Match left-image keypoints (N, 2) into the right image.

    Returns (disparity (N,), cost (N,), ok (N,)); depth = f * b / d.
    """
    half = params.half_patch
    P = 2 * half
    D = params.max_disparity
    H, W = img_left.shape
    lwin, lbase = extract.extract_windows_fast(img_left, kp_left, min(P + 4, H, W))
    tmpl = sampling.sample_patch_grid(lwin, lbase, kp_left, half)       # (N,P,P)

    # Right scanline strip covering disparities 0..D-1.
    WH = min(P + 4, H)
    WW = min(D + P + 4, W)
    u = kp_left[:, 0]
    v = kp_left[:, 1]
    bx = torch.clamp(torch.floor(u).to(torch.int32) - (D - 1) - half - 1, 0, W - WW)
    by = torch.clamp(torch.floor(v).to(torch.int32) - half - 2, 0, H - WH)
    rwin, rbase = extract.extract_rects_fast(
        img_right, torch.stack([bx, by], dim=-1), WH, WW
    )                                                                    # (N,RH,RW)
    RH, RW = rwin.shape[-2], rwin.shape[-1]
    bx, by = rbase[:, 0], rbase[:, 1]
    # Resample the strip onto the keypoint's fractional grid:
    # rows v-half..v+half-1, cols u-(D-1)-half..u+half-1.
    S = D + P - 1
    rows = v[:, None] - half + torch.arange(P, dtype=v.dtype, device=v.device)[None]
    cols = u[:, None] - (D - 1) - half + torch.arange(
        S, dtype=u.dtype, device=u.device
    )[None]
    Wy = sampling._hat_weights(rows - by[:, None].to(v.dtype), RH)       # (N,P,RH)
    Wx = sampling._hat_weights(cols - bx[:, None].to(u.dtype), RW)       # (N,S,RW)
    strip = torch.einsum("npy,nyx,nsx->nps", Wy, rwin, Wx)               # (N,P,S)
    # Sliding sums of strip^2 over the column axis via cumsum.
    csum = torch.cumsum(F.pad(torch.sum(strip * strip, dim=1), (1, 0)), dim=-1)
    win_sq = csum[:, P:] - csum[:, :-P]                                  # (N,D) by start
    # Cross-correlation without a (N, D, P, P) candidate stack:
    # cross[n, s] = sum_q B[n, q, s+q], B = einsum over p.
    B = torch.einsum("nps,npq->nqs", strip, tmpl)                        # (N,P,S)
    cross = sum(B[:, q, q: q + D] for q in range(P))                     # (N,D)
    t_sq = torch.sum(tmpl * tmpl, dim=(-1, -2))
    ssd_start = win_sq - 2.0 * cross + t_sq[:, None]
    # Start s is disparity d = D-1-s; flip to index by d.
    ssd = torch.flip(ssd_start, dims=(-1,)) / (P * P)
    # Invalidate disparities that push the patch out of the image.
    d_range = torch.arange(D, dtype=kp_left.dtype, device=kp_left.device)
    valid_d = (u[:, None] - d_range[None, :]) >= (half + 1)
    ssd = torch.where(valid_d, ssd, float("inf"))
    best = torch.argmin(ssd, dim=-1)                                     # (N,)
    best_cost = torch.gather(ssd, 1, best[:, None])[:, 0]
    # Sub-pixel parabola fit around the minimum.
    c0 = torch.gather(ssd, 1, torch.clamp(best - 1, 0, D - 1)[:, None])[:, 0]
    c2 = torch.gather(ssd, 1, torch.clamp(best + 1, 0, D - 1)[:, None])[:, 0]
    c1 = best_cost
    denom = c0 - 2 * c1 + c2
    delta = torch.where(
        (torch.abs(denom) > 1e-9) & torch.isfinite(c0) & torch.isfinite(c2),
        0.5 * (c0 - c2) / torch.clamp(denom, min=1e-9),
        0.0,
    )
    delta = torch.clamp(delta, -1.0, 1.0)
    disparity = best.to(kp_left.dtype) + delta
    ok = (
        mask
        & torch.isfinite(best_cost)
        & (best_cost < params.max_cost)
        & (disparity > params.min_disparity)
        & (best > 0)
        & (best < D - 1)
    )
    return disparity, best_cost, ok


def disparity_to_depth(disparity, focal, baseline, ok=None):
    """z = f b / d; masked entries get depth 0."""
    z = focal * baseline / torch.clamp(disparity, min=1e-6)
    if ok is not None:
        z = torch.where(ok, z, 0.0)
    return z
