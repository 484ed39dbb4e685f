"""Vectorized RANSAC: every hypothesis fitted and scored in one batched
pass (port of `viso_tpu/ops/ransac.py`).

Split as `ops/pnp.py` is: `draw_indices` draws the minimal samples from a
`torch.Generator`, and the `*_from_indices` functions take them. torch
cannot reproduce a `jax.random` stream, so tests hand both packages the
same indices.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from viso_tpu_torch.geometry import epipolar


class RansacResult(NamedTuple):
    model: torch.Tensor        # best model parameters
    inliers: torch.Tensor      # (N,) bool (respects the input mask)
    num_inliers: torch.Tensor  # scalar int
    best_hypo: torch.Tensor    # index of the winning hypothesis


def draw_indices(generator, mask, num_hypotheses: int, sample_size: int):
    """(S, k) indices drawn with replacement, uniform over the True entries
    of mask (N,): the law of `jax.random.categorical` over logits
    where(mask, 0, -inf). Draw j of a uniform u lands on the
    floor(u * n_valid)-th valid index, found in the cumulative count of
    the mask. With no valid entry every index is 0, as the JAX draw gives.
    No host sync."""
    cum = torch.cumsum(mask.to(torch.int64), dim=0)
    n_valid = cum[-1]
    u = torch.rand((num_hypotheses, sample_size), generator=generator, device=mask.device)
    rank = torch.minimum(torch.floor(u * n_valid).to(torch.int64), n_valid - 1)
    idx = torch.searchsorted(cum, rank, right=True)
    return torch.where(n_valid > 0, idx, 0)


def ransac_from_indices(idx, x1, x2, mask, fit_fn, residual_fn, threshold: float):
    """Generic batched RANSAC over hypotheses idx (S, k): fit all, count
    inliers (residual < threshold, masked), keep the first best count."""
    models = fit_fn(x1[idx], x2[idx])                          # (S, ...)
    res = residual_fn(models, x1[None], x2[None])              # (S, N)
    inl = (res < threshold) & mask[None, :]
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts)
    return RansacResult(models[best], inl[best], counts[best], best)


def essential_ransac_from_indices(idx, x1, x2, mask, threshold: float = 1e-5,
                                  top_k: int = 8, refine_iters: int = 12):
    """8-point essential RANSAC over hypotheses idx (S, 8): MSAC scoring,
    then LM refinement on the essential manifold from the `top_k` best
    hypotheses (ties in index order, as `lax.top_k`), keeping the best
    final robust cost. `threshold` is the squared Sampson gate in
    normalized units."""
    models = epipolar.fit_essential(x1[idx], x2[idx])          # (S, 3, 3)
    res = epipolar.epipolar_residual(models, x1[None], x2[None])
    res = torch.where(mask[None, :], res, threshold)
    scores = torch.sum(torch.clamp(res, max=threshold), dim=-1)
    top_idx = torch.argsort(scores, stable=True)[:top_k]
    Rs, ts = epipolar.decompose_essential(models[top_idx])    # (K, 4, 3, 3)
    tau = float(np.sqrt(np.float32(threshold)))
    R_f, t_f, cost_f = epipolar.refine_essential(
        Rs[:, 0], ts[:, 0], x1, x2, mask, tau, iters=refine_iters
    )
    best = torch.argmin(cost_f)
    E = epipolar.essential_from_rt(R_f[best], t_f[best])
    inl = (epipolar.epipolar_residual(E, x1, x2) < threshold) & mask
    return RansacResult(E, inl, torch.sum(inl), top_idx[best])


def homography_ransac_from_indices(idx, x1, x2, mask, threshold: float = 1e-5,
                                   lo_steps: int = 4):
    """4-point DLT homography RANSAC over hypotheses idx (S, 4), then
    `lo_steps` local-optimisation refits on the inliers, each kept when it
    does not lose inliers."""
    out = ransac_from_indices(idx, x1, x2, mask, epipolar.fit_homography,
                              epipolar.homography_residual, threshold)
    H, inl, n_inl = out.model, out.inliers, out.num_inliers
    for _ in range(lo_steps):
        H_new = epipolar.fit_homography(x1, x2, weights=inl.to(x1.dtype))
        inl_new = (epipolar.homography_residual(H_new, x1, x2) < threshold) & mask
        better = torch.sum(inl_new) >= n_inl
        H = torch.where(better, H_new, H)
        inl = torch.where(better, inl_new, inl)
        n_inl = torch.sum(inl)
    return RansacResult(H, inl, n_inl, out.best_hypo)
