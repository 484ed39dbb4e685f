"""Frozen copy of `viso_tpu_torch/ops/pnp.py` for the benchmark's plain
reference (imports rewritten to `vobench.reference`; window copies by
`vobench/reference/geometry/extract.py`'s plain indexing). The original
docstring follows.

Perspective-n-Point: 6-point DLT, MSAC RANSAC and robust Gauss-Newton
refinement on reprojection error (port of `viso_tpu/ops/pnp.py`).

The JAX package differentiates the residual with `jax.jacfwd` at
xi = 0; here the same Jacobian is written out: d proj / d p_cam (with
the depth clamp's zero derivative below 1e-6) times d p_cam / d xi =
[I | -hat(p_cam)] for a left-perturbed pose.

RANSAC is split in two: `pnp_ransac_from_indices` takes the hypotheses'
point indices (H, 6), and `pnp_ransac` draws them from a
`torch.Generator` by the rule of the JAX package's
`jax.random.categorical` over the mask (six draws per hypothesis, with
replacement, uniform over the masked points). torch cannot reproduce a
`jax.random` stream, so tests hand both packages the same indices.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vobench.reference.backend import robust
from vobench.reference.geometry import se3
from vobench.reference.mapping.map_state import row
from vobench.reference.ops import ransac


def reprojection_residual(R, t, points_w, x):
    """Squared normalized reprojection errors (N,); behind-camera points
    get 1e6."""
    pc = se3.transform(R, t, points_w)
    z = pc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    proj = pc[..., :2] / z_safe[..., None]
    err = torch.sum((proj - x) ** 2, dim=-1)
    return torch.where(z > 1e-6, err, 1e6)


def _residual_and_jacobian(R, t, points_w, x):
    """Residual (2N,) at xi = 0 and its Jacobian (2N, 6) wrt xi."""
    pc = se3.transform(R, t, points_w)                      # (N, 3)
    z_raw = pc[..., 2]
    z = torch.clamp(z_raw, min=1e-6)
    proj = pc[..., :2] / z[..., None]
    r = (proj - x).reshape(-1)
    iz = 1.0 / z
    gate = (z_raw > 1e-6).to(pc.dtype)                      # d clamp / d z
    zero = torch.zeros_like(iz)
    # d proj / d p_cam: (N, 2, 3)
    dproj = torch.stack(
        [
            torch.stack([iz, zero, -proj[..., 0] * iz * gate], dim=-1),
            torch.stack([zero, iz, -proj[..., 1] * iz * gate], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    dpc = torch.cat([eye, -se3.hat(pc)], dim=-1)            # (N, 3, 6)
    J = (dproj @ dpc).reshape(-1, 6)
    return r, J


def _projection_residual(R, t, points_w, x):
    pc = se3.transform(R, t, points_w)
    z = torch.clamp(pc[..., 2], min=1e-6)
    return (pc[..., :2] / z[..., None] - x).reshape(-1)


def refine_pose(R0, t0, points_w, x, mask, huber, iters: int = 10):
    """Robust LM on SE(3) minimizing reprojection error over masked points."""
    dtype, dev = points_w.dtype, points_w.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def cost(rr):
        rn = torch.linalg.norm(rr.reshape(-1, 2), dim=-1)
        return torch.sum(mask * robust.huber_cost(rn, huber))

    R, t = R0, t0
    lam = torch.full((), 1e-3, dtype=dtype, device=dev)
    for _ in range(iters):
        r, J = _residual_and_jacobian(R, t, points_w, x)
        r_norm = torch.linalg.norm(r.reshape(-1, 2), dim=-1)
        w = mask * robust.huber_weight(r_norm, huber)
        Jw = J * torch.repeat_interleave(w, 2)[:, None]
        H = Jw.T @ J + lam * eye6
        g = Jw.T @ r
        # solve_ex does not raise on a singular system; the step is zeroed.
        d, _ = torch.linalg.solve_ex(H, -g)
        d = torch.where(torch.all(torch.isfinite(d)), d, 0.0)
        Rd, td = se3.left_update(d, R, t)
        accept = cost(_projection_residual(Rd, td, points_w, x)) < cost(r)
        # exp(0) * T == T exactly, so selecting the updated pose equals
        # the reference's left_update(where(accept, d, 0)).
        R = torch.where(accept, Rd, R)
        t = torch.where(accept, td, t)
        lam = torch.where(
            accept, torch.clamp(lam * 0.3, min=1e-8), torch.clamp(lam * 10, max=1e4)
        )
    return R, t


class PnPResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor


def _dlt_pnp(points_w, x):
    """6+ point DLT, batched: points_w (..., k, 3), x (..., k, 2) ->
    (R (..., 3, 3), t (..., 3)), R projected onto SO(3) by SVD and t
    rescaled by the mean singular value.

    The null vector of A^T A is taken from `eigh` (ascending eigenvalues,
    as `jnp.linalg.eigh`); its sign is fixed by a vote over the points'
    depths, so the eigenvector's arbitrary sign does not matter. On CUDA,
    `eigh` and `svd` check their solver status on the host (a sync), so
    the steps around them are functions of their own (`dlt_system`,
    `dlt_sign`, `dlt_finish`) that a captured detection runs as graphs.
    """
    AtA, Xh = dlt_system(points_w, x)
    _, vecs = torch.linalg.eigh(AtA)
    M, tvec = dlt_sign(vecs, Xh)
    U, s, Vt = torch.linalg.svd(M)
    return dlt_finish(U, s, Vt, tvec)


def dlt_system(points_w, x):
    """The DLT's normal matrix A^T A (..., 12, 12) and the homogeneous
    points (..., k, 4)."""
    ones = torch.ones(points_w.shape[:-1] + (1,), dtype=points_w.dtype,
                      device=points_w.device)
    Xh = torch.cat([points_w, ones], dim=-1)                       # (..., k, 4)
    zeros = torch.zeros_like(Xh)
    row_u = torch.cat([Xh, zeros, -x[..., 0:1] * Xh], dim=-1)
    row_v = torch.cat([zeros, Xh, -x[..., 1:2] * Xh], dim=-1)
    A = torch.cat([row_u, row_v], dim=-2)                          # (..., 2k, 12)
    return A.transpose(-1, -2) @ A, Xh


def dlt_sign(vecs, Xh):
    """The projection's 3x3 block M and translation from the eigenvectors
    of A^T A (ascending), signed so that most points lie in front."""
    p = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 4))
    M = p[..., :, :3]
    depths = torch.einsum("...kc,...c->...k", Xh, p[..., 2, :])
    sign = torch.where(torch.sum(torch.sign(depths), dim=-1) >= 0, 1.0, -1.0)
    return M * sign[..., None, None], p[..., :, 3] * sign[..., None]


def dlt_finish(U, s, Vt, tvec):
    """(R, t) from the SVD of M: R its nearest rotation, t rescaled by the
    mean singular value."""
    det = torch.linalg.det(U @ Vt)
    D = torch.ones(det.shape + (3,), dtype=U.dtype, device=U.device)
    D = torch.cat([D[..., :2], det[..., None]], dim=-1)
    R = U @ (D[..., :, None] * Vt)
    scale = torch.mean(s, dim=-1)
    t = tvec / torch.clamp(scale, min=1e-12)[..., None]
    return R, t


def draw_hypotheses(generator, mask, num_hypotheses: int = 512):
    """(H, 6) point indices: six draws per hypothesis, with replacement,
    uniform over the masked points (`ransac.draw_indices`). No host sync."""
    return ransac.draw_indices(generator, mask, num_hypotheses, 6)


def pnp_ransac_from_indices(idx, points_w, x, mask, threshold: float = 4e-6,
                            refine_iters: int = 10):
    """RANSAC PnP over given hypotheses idx (H, 6): world points (N, 3),
    normalized observations (N, 2), mask (N,). MSAC scoring, robust GN
    refinement over all masked points, kept only if it does not lose
    inliers. `threshold` gates squared normalized reprojection error."""
    Rs, ts = _dlt_pnp(points_w[idx], x[idx])
    return score_and_refine(Rs, ts, points_w, x, mask, threshold, refine_iters)


def score_and_refine(Rs, ts, points_w, x, mask, threshold: float = 4e-6,
                     refine_iters: int = 10):
    """The RANSAC step after the hypotheses' poses (H, 3, 3), (H, 3): MSAC
    scores, the best hypothesis refined, kept if it loses no inliers."""
    res = reprojection_residual(Rs[:, None], ts[:, None], points_w, x)  # (H, N)
    res = torch.where(mask[None, :], res, threshold)
    scores = torch.sum(torch.clamp(res, max=threshold), dim=-1)     # MSAC
    best = torch.argmin(scores)
    R0, t0 = row(Rs, best), row(ts, best)
    R, t = refine_pose(
        R0, t0, points_w, x, mask.to(points_w.dtype),
        huber=float(np.sqrt(np.float32(threshold))), iters=refine_iters,
    )
    final = reprojection_residual(R, t, points_w, x)
    inl = (final < threshold) & mask
    # Keep the refined pose only if it did not get worse.
    inl0 = (row(res, best) < threshold) & mask
    better = torch.sum(inl) >= torch.sum(inl0)
    R = torch.where(better, R, R0)
    t = torch.where(better, t, t0)
    inl = torch.where(better, inl, inl0)
    return PnPResult(R, t, inl, torch.sum(inl))


def pnp_ransac(generator, points_w, x, mask, threshold: float = 4e-6,
               num_hypotheses: int = 512, refine_iters: int = 10):
    """RANSAC PnP with hypotheses drawn from `generator` (a
    torch.Generator on the points' device)."""
    idx = draw_hypotheses(generator, mask, num_hypotheses)
    return pnp_ransac_from_indices(idx, points_w, x, mask, threshold, refine_iters)
