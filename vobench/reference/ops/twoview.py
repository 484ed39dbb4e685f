"""Frozen copy of `viso_tpu_torch/ops/twoview.py` for the benchmark's plain
reference (imports rewritten to `vobench.reference`; window copies by
`vobench/reference/geometry/extract.py`'s plain indexing). The original
docstring follows.

Two-view initialization: motion hypotheses, selection, scale fixing
(port of `viso_tpu/ops/twoview.py`).

Disparity gate, essential and homography RANSAC, candidate
decomposition, gated motion selection over a (candidates x
correspondences) triangulation grid, and mean-depth normalization.

`initialize` is the JAX package's one jitted program as segments between
the calls that read the device on the host on CUDA: the two hypothesis
draws from the caller's generator (first, in the reference's order, so
the generator advances as it did and no graph holds it) and each `eigh`
and `svd` of `geometry/epipolar.py`. Each segment runs through
`run(name, fn, statics, *args)`: a plain call by default, a captured
program in the monocular engine (`slam/engine.py`), with the same ops
either way.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vobench.reference.geometry import epipolar, triangulation
from vobench.reference.mapping.map_state import row
from vobench.reference.ops import ransac


class TwoViewResult(NamedTuple):
    R: torch.Tensor             # (3, 3) world(frame1)->frame2
    t: torch.Tensor             # (3,)
    points: torch.Tensor        # (N, 3) triangulated points (frame1 = world)
    inliers: torch.Tensor       # (N,) bool
    num_inliers: torch.Tensor   # scalar int
    num_tracks: torch.Tensor    # scalar int (valid correspondences in)
    disparity_ok: torch.Tensor  # scalar bool: enough baseline to init
    # Median triangulation parallax (deg) over the selected motion's
    # inliers: a rotation-compensated baseline measure.
    median_parallax_deg: torch.Tensor


class TwoViewParams(NamedTuple):
    focal: float = 520.0                  # for pixel-unit gates
    projection_error_thresh: float = 0.3  # px
    parallax_thresh_deg: float = 1.0      # accepts LOW parallax, as the reference
    disparity_squared_thresh: float = 15.0**2  # px^2
    ransac_hypotheses: int = 512
    use_homography: bool = True


def select_motion(x1, x2, mask, Rs, ts, params: TwoViewParams):
    """Score candidate motions Rs (C, 3, 3), ts (C, 3) by the count of
    correspondences x1, x2 (N, 2) passing the cheirality, parallax and
    reprojection gates. Returns (R, t, points (N, 3), inliers (N,),
    num_inliers, median parallax deg), scaled to mean inlier depth 1.

    The median is `nanquantile(., 0.5)`, which averages the two middle
    values as `jnp.nanmedian` does (`torch.nanmedian` returns the lower).
    """
    C = Rs.shape[0]
    eye = torch.eye(3, dtype=x1.dtype, device=x1.device).expand(C, 3, 3)[:, None]
    zero = torch.zeros((C, 1, 3), dtype=x1.dtype, device=x1.device)
    Rc, tc = Rs[:, None], ts[:, None]
    Xw, d1, d2 = triangulation.triangulate(x1[None], x2[None], eye, zero, Rc, tc)
    good = (d1 > 0) & (d2 > 0)
    cosang = triangulation.parallax_cos(Xw, eye, zero, Rc, tc)
    good &= cosang >= float(np.cos(np.deg2rad(np.float32(params.parallax_thresh_deg))))
    e1 = triangulation.reprojection_error(Xw, x1[None], eye, zero)
    e2 = triangulation.reprojection_error(Xw, x2[None], Rc, tc)
    px = params.focal
    good &= (e1 * px <= params.projection_error_thresh) & (
        e2 * px <= params.projection_error_thresh
    )
    good &= mask[None, :]

    counts = torch.sum(good, dim=-1)
    best = torch.argmax(counts)
    R, t = row(Rs, best), row(ts, best)
    inl = row(good, best)
    pts = row(Xw, best)
    # Mean-depth normalization: the monocular scale fix.
    mean_depth = torch.sum(torch.where(inl, pts[:, 2], 0.0)) / torch.clamp(
        torch.sum(inl), min=1
    )
    scale = torch.where(mean_depth > 1e-9, 1.0 / mean_depth, 1.0)
    ang = torch.rad2deg(torch.arccos(torch.clamp(row(cosang, best), -1.0, 1.0)))
    med_par = torch.nanquantile(torch.where(inl, ang, float("nan")), 0.5)
    med_par = torch.where(torch.isfinite(med_par), med_par, 0.0)
    return R, t * scale, pts * scale, inl, row(counts, best), med_par


def _select(U_e, Vt_e, svd_h, x1, x2, mask, *, params: TwoViewParams):
    """The disparity gate, the candidate motions from the SVDs of E and
    (with `use_homography`) H, and `select_motion`."""
    n_tracks = torch.sum(mask)
    # Disparity gate: mean squared pixel disparity >= thresh.
    disp_sq = torch.sum((x1 - x2) ** 2, dim=-1) * params.focal**2
    mean_disp = torch.sum(torch.where(mask, disp_sq, 0.0)) / torch.clamp(n_tracks, min=1)
    disparity_ok = mean_disp >= params.disparity_squared_thresh
    Rs, ts = epipolar.essential_candidates(U_e, Vt_e)
    if svd_h:
        Rs_h, ts_h, _ = epipolar.homography_candidates(*svd_h)
        Rs = torch.cat([Rs, Rs_h], dim=0)
        ts = torch.cat([ts, ts_h], dim=0)
    R, t, pts, inl, n_inl, med_par = select_motion(x1, x2, mask, Rs, ts, params)
    return TwoViewResult(R, t, pts, inl, n_inl, n_tracks, disparity_ok, med_par)


def initialize_from_indices(idx_e, idx_h, x1, x2, mask,
                            params: TwoViewParams = TwoViewParams(), *, run=ransac.eager):
    """Two-view initialization on normalized correspondences x1, x2 (N, 2)
    with the RANSAC hypotheses given: idx_e (S, 8) for the essential
    matrix, idx_h (S/2, 4) for the homography (ignored without
    `use_homography`). `run(name, fn, statics, *args)` runs the segments
    between the solver calls: eagerly by default, or as captured programs
    (`slam/programs.Cache.run`)."""
    # Sampson threshold in normalized units ~ (thresh_px / f)^2.
    sampson_thresh = (params.projection_error_thresh / params.focal) ** 2 * 4.0
    e_res = ransac.essential_ransac_from_indices(idx_e, x1, x2, mask, threshold=sampson_thresh,
                                                 run=run)
    U_e, _, Vt_e = torch.linalg.svd(e_res.model)
    svd_h = ()
    if params.use_homography:
        h_res = ransac.homography_ransac_from_indices(idx_h, x1, x2, mask,
                                                      threshold=sampson_thresh, run=run)
        svd_h = torch.linalg.svd(h_res.model)
    return run("twoview_select", _select, dict(params=params), U_e, Vt_e, tuple(svd_h),
               x1, x2, mask)


def initialize(generator, x1, x2, mask, params: TwoViewParams = TwoViewParams(), *,
               run=ransac.eager):
    """`initialize_from_indices` with the hypotheses drawn from `generator`:
    the essential matrix's first, then the homography's."""
    S = params.ransac_hypotheses
    idx_e = ransac.draw_indices(generator, mask, S, 8)
    idx_h = ransac.draw_indices(generator, mask, S // 2, 4)
    return initialize_from_indices(idx_e, idx_h, x1, x2, mask, params, run=run)
