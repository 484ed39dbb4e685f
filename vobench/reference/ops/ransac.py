"""Frozen copy of `viso_tpu_torch/ops/ransac.py` for the benchmark's plain
reference (imports rewritten to `vobench.reference`; window copies by
`vobench/reference/geometry/extract.py`'s plain indexing). The original
docstring follows.

Vectorized RANSAC: every hypothesis fitted and scored in one batched
pass (port of `viso_tpu/ops/ransac.py`).

Split as `ops/pnp.py` is: `draw_indices` draws the minimal samples from a
`torch.Generator`, and the `*_from_indices` functions take them;
`ransac`, `essential_ransac` and `homography_ransac` do both in one call,
with a generator where the JAX package takes a key. torch cannot
reproduce a `jax.random` stream, so tests hand both packages the same
indices.

The `*_from_indices` functions are segments between the calls that read
the device on the host on CUDA (the `eigh` and `svd` of
`geometry/epipolar.py`), each run through `run(name, fn, statics, *args)`:
eagerly by default, or as a captured program (`ops/twoview.py`). A best
hypothesis is selected with `index_select` (`map_state.row`): indexing
with a 0-d tensor reads it on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_map

from vobench.reference.geometry import epipolar
from vobench.reference.mapping.map_state import row


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


def ransac(generator, x1, x2, mask, fit_fn, residual_fn, sample_size: int,
           num_hypotheses: int, threshold: float):
    """Generic batched RANSAC over correspondences x1, x2 (N, 2):
    `num_hypotheses` minimal samples of `sample_size` drawn from
    `generator`, then `ransac_from_indices`."""
    idx = draw_indices(generator, mask, num_hypotheses, sample_size)
    return ransac_from_indices(idx, x1, x2, mask, fit_fn, residual_fn, threshold)


def ransac_from_indices(idx, x1, x2, mask, fit_fn, residual_fn, threshold: float):
    """Batched RANSAC over hypotheses idx (S, k): fit_fn((k, 2), (k, 2)) ->
    model (a tensor or a tuple of tensors) and residual_fn(model, x1, x2)
    -> (N,) squared residuals, each mapped over the hypotheses
    (`torch.func.vmap`); the first hypothesis with the most inliers wins
    (`jnp.argmax`'s order)."""
    models = torch.func.vmap(fit_fn)(x1[idx], x2[idx])
    res = torch.func.vmap(lambda m: residual_fn(m, x1, x2))(models)
    inl = (res < threshold) & mask[None, :]
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts)
    model = tree_map(lambda m: row(m, best), models)
    return RansacResult(model, row(inl, best), row(counts, best), best)


def essential_ransac(generator, x1, x2, mask, threshold: float = 1e-5,
                     num_hypotheses: int = 2048, top_k: int = 8, refine_iters: int = 12):
    """8-point essential RANSAC with multi-start manifold refinement
    (`essential_ransac_from_indices`) over `num_hypotheses` samples drawn
    from `generator`."""
    return essential_ransac_from_indices(draw_indices(generator, mask, num_hypotheses, 8),
                                         x1, x2, mask, threshold, top_k, refine_iters)


def homography_ransac(generator, x1, x2, mask, threshold: float = 1e-5,
                      num_hypotheses: int = 256):
    """4-point DLT homography RANSAC with 4 local-optimisation refits
    (`homography_ransac_from_indices`) over `num_hypotheses` samples drawn
    from `generator`."""
    return homography_ransac_from_indices(draw_indices(generator, mask, num_hypotheses, 4),
                                          x1, x2, mask, threshold)


def eager(name, fn, statics, *args):
    """A segment as a plain call: the eager path's `run(name, fn, statics,
    *args)`. A caller that runs the segments as captured programs passes
    its own (`slam/programs.Cache.run`)."""
    return fn(*args, **statics)


def _essential_system(idx, x1, x2):
    return epipolar.essential_normal_matrix(x1[idx], x2[idx])


def _essential_score(U, s, Vt, x1, x2, mask, *, threshold, top_k):
    """The hypotheses projected onto the manifold, MSAC-scored; the `top_k`
    best (ties in index order, as `lax.top_k`) and their indices."""
    models = epipolar.project_essential(U, s, Vt)              # (S, 3, 3)
    res = epipolar.epipolar_residual(models, x1[None], x2[None])
    res = torch.where(mask[None, :], res, threshold)
    scores = torch.sum(torch.clamp(res, max=threshold), dim=-1)
    top_idx = torch.argsort(scores, stable=True)[:top_k]
    return models[top_idx], top_idx


def _essential_refine(U, Vt, top_idx, x1, x2, mask, *, threshold, refine_iters):
    """LM refinement from the top hypotheses' first decompositions; the
    best final robust cost wins."""
    Rs, ts = epipolar.essential_candidates(U, Vt)             # (K, 4, 3, 3)
    tau = float(np.sqrt(np.float32(threshold)))
    R_f, t_f, cost_f = epipolar.refine_essential(
        Rs[:, 0], ts[:, 0], x1, x2, mask, tau, iters=refine_iters
    )
    best = torch.argmin(cost_f)
    E = epipolar.essential_from_rt(row(R_f, best), row(t_f, best))
    inl = (epipolar.epipolar_residual(E, x1, x2) < threshold) & mask
    return RansacResult(E, inl, torch.sum(inl), row(top_idx, best))


def essential_ransac_from_indices(idx, x1, x2, mask, threshold: float = 1e-5,
                                  top_k: int = 8, refine_iters: int = 12, run=eager):
    """8-point essential RANSAC over hypotheses idx (S, 8): MSAC scoring,
    then LM refinement on the essential manifold from the `top_k` best
    hypotheses (ties in index order, as `lax.top_k`), keeping the best
    final robust cost. `threshold` is the squared Sampson gate in
    normalized units. `run` runs the segments between the solver calls
    (`eager`)."""
    e = epipolar.null_vector(run("essential_system", _essential_system, {}, idx, x1, x2))
    U, s, Vt = torch.linalg.svd(epipolar.as_matrix(e))
    top, top_idx = run("essential_score", _essential_score,
                       dict(threshold=threshold, top_k=top_k), U, s, Vt, x1, x2, mask)
    U, _, Vt = torch.linalg.svd(top)
    return run("essential_refine", _essential_refine,
               dict(threshold=threshold, refine_iters=refine_iters), U, Vt, top_idx, x1, x2, mask)


def _homography_system(idx, x1, x2):
    return epipolar.homography_normal_matrix(x1[idx], x2[idx])


def _refit_system(x1, x2, inl, refit):
    """The next local-optimisation refit's system, weighted by the
    inliers; None after the last."""
    return epipolar.homography_normal_matrix(x1, x2, weights=inl.to(x1.dtype)) if refit else None


def _homography_score(h, x1, x2, mask, *, threshold, refit):
    """The hypotheses' inlier counts; the first best (H, inliers, count,
    index) and the first refit's system."""
    models = epipolar.homography_from_null(h)                 # (S, 3, 3)
    res = epipolar.homography_residual(models, x1[None], x2[None])
    inl = (res < threshold) & mask[None, :]
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts)
    inl = row(inl, best)
    return row(models, best), inl, row(counts, best), best, _refit_system(x1, x2, inl, refit)


def _homography_refit(h, H, inl, n_inl, x1, x2, mask, *, threshold, refit):
    """One local-optimisation step, kept when it does not lose inliers;
    the next step's system."""
    H_new = epipolar.homography_from_null(h)
    inl_new = (epipolar.homography_residual(H_new, x1, x2) < threshold) & mask
    better = torch.sum(inl_new) >= n_inl
    H = torch.where(better, H_new, H)
    inl = torch.where(better, inl_new, inl)
    return H, inl, torch.sum(inl), _refit_system(x1, x2, inl, refit)


def homography_ransac_from_indices(idx, x1, x2, mask, threshold: float = 1e-5,
                                   lo_steps: int = 4, run=eager):
    """4-point DLT homography RANSAC over hypotheses idx (S, 4), then
    `lo_steps` local-optimisation refits on the inliers, each kept when it
    does not lose inliers. `run` runs the segments between the solver
    calls (`eager`)."""
    h = epipolar.null_vector(run("homography_system", _homography_system, {}, idx, x1, x2))
    H, inl, n_inl, best, AtA = run("homography_score", _homography_score,
                                   dict(threshold=threshold, refit=lo_steps > 0), h, x1, x2, mask)
    for i in range(lo_steps):
        H, inl, n_inl, AtA = run("homography_refit", _homography_refit,
                                 dict(threshold=threshold, refit=i + 1 < lo_steps),
                                 epipolar.null_vector(AtA), H, inl, n_inl, x1, x2, mask)
    return RansacResult(H, inl, n_inl, best)
