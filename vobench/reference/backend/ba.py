"""Frozen copy of `viso_tpu_torch/backend/ba.py` for the benchmark's plain
reference (imports rewritten to `vobench.reference`; window copies by
`vobench/reference/geometry/extract.py`'s plain indexing). The original
docstring follows.

Sliding-window bundle adjustment: Levenberg-Marquardt + Schur
complement (port of `viso_tpu/backend/ba.py`).

Dense (camera x landmark) observation grid, closed-form batched 3x3
landmark inverses for the marginalization, a (6C x 6C) reduced camera
solve by Cholesky, and branchless LM (fixed iteration count, masked
accept/reject). Per-observation tensors keep landmarks in the last
("L-minor") dimension, as the reference lays them out.

Landmark-sharded mode (`parallel/dist_ba.py`): `compute_cost`,
`_lm_iteration`, `schur_solve` and `solve_impl` take `reduce`, a callable
that sums a list of tensors in place over the landmark group (the
reference's `axis_name` and `psum`). Each LM iteration hands it two
lists: the camera blocks, Schur cross terms and the folded cost inside
`schur_solve`, then (cost, n_obs) of the accept test. Everything
landmark-indexed stays local; the 6C x 6C solve is replicated.

Known reference fault, reproduced on purpose: when the reduced system
is numerically indefinite in float32, the Cholesky factorization fails
and the whole camera step is zeroed without any signal
(`torch.linalg.cholesky_ex` reports the failure instead of raising; the
reference's `jnp.linalg.cholesky` returns NaN, which its `isfinite`
check zeroes).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vobench.reference.backend import robust
from vobench.reference.geometry import se3


class BAProblem(NamedTuple):
    """Window state, structure-of-arrays. C cameras, L landmarks."""

    R: torch.Tensor          # (C, 3, 3) world->camera rotations
    t: torch.Tensor          # (C, 3)
    points: torch.Tensor     # (L, 3) world landmarks
    obs_uv: torch.Tensor     # (C, L, 2) observed normalized image coords
    obs_mask: torch.Tensor   # (C, L) bool
    cam_mask: torch.Tensor   # (C,) bool
    point_mask: torch.Tensor  # (L,) bool
    # Cameras frozen in addition to the first `params.num_fixed` slots.
    cam_fixed: Optional[torch.Tensor] = None


class BAParams(NamedTuple):
    iters: int = 10
    huber: float = 5.0 / 520.0
    trunc: float = 20.0 / 520.0
    anneal: float = 4.0
    lam0: float = 1e-4
    lam_up: float = 4.0
    lam_down: float = 0.5
    num_fixed: int = 2
    min_depth: float = 1e-3


def _project_residuals(R, t, points_T, obs_T, valid, min_depth):
    """Residuals r (C, 2, L), validity (C, L), cam points (C, 3, L)."""
    p_cam = torch.einsum("cij,jl->cil", R, points_T) + t[:, :, None]
    z = p_cam[:, 2]
    ok = valid & (z > min_depth)
    z_safe = torch.where(ok, z, 1.0)
    proj = p_cam[:, :2] / z_safe[:, None]
    r = torch.where(ok[:, None], proj - obs_T, 0.0)
    return r, ok, p_cam


def _jacobians(p_cam, R):
    """Jc (C, 2, 6, L) wrt the left-perturbed camera twist [rho, phi];
    Jp (C, 2, 3, L) wrt the world point. Normalized coords."""
    X, Y, Z = p_cam[:, 0], p_cam[:, 1], p_cam[:, 2]     # (C, L)
    iz = 1.0 / torch.clamp(Z, min=1e-9)
    iz2 = iz * iz
    zero = torch.zeros_like(X)
    one = torch.ones_like(X)
    Ju = torch.stack(
        [iz, zero, -X * iz2, -X * Y * iz2, one + X * X * iz2, -Y * iz], dim=1
    )                                                    # (C, 6, L)
    Jv = torch.stack(
        [zero, iz, -Y * iz2, -(one + Y * Y * iz2), X * Y * iz2, X * iz], dim=1
    )
    Jc = torch.stack([Ju, Jv], dim=1)                    # (C, 2, 6, L)
    R0 = R[:, 0, :, None]                                # (C, 3, 1)
    R1 = R[:, 1, :, None]
    R2 = R[:, 2, :, None]
    Jpu = R0 * iz[:, None] - R2 * (X * iz2)[:, None]     # (C, 3, L)
    Jpv = R1 * iz[:, None] - R2 * (Y * iz2)[:, None]
    Jp = torch.stack([Jpu, Jpv], dim=1)                  # (C, 2, 3, L)
    return Jc, Jp


def _inv3x3_planes(M):
    """Closed-form 3x3 inverse on (3, 3, L) scalar planes."""
    a, b, c = M[0, 0], M[0, 1], M[0, 2]
    d, e, f = M[1, 0], M[1, 1], M[1, 2]
    g, h, i = M[2, 0], M[2, 1], M[2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(torch.abs(det) < 1e-18, 1e-18, det)
    rows = [
        torch.stack([A, B, C], dim=0),
        torch.stack([D, E, F], dim=0),
        torch.stack([G, H, I], dim=0),
    ]
    return torch.stack(rows, dim=0) / det[None, None]


def _valid(prob: BAProblem):
    return prob.obs_mask & prob.cam_mask[:, None] & prob.point_mask[None, :]


def compute_cost(prob: BAProblem, params: BAParams = BAParams(), trunc=None, reduce=None):
    """Total robust (Tukey) reprojection cost and the valid-observation count.

    With `reduce`, both are summed over the landmark group in one call;
    the count travels as a float32 (exact up to 2^24 observations)."""
    r, ok, _ = _project_residuals(
        prob.R, prob.t, prob.points.T, prob.obs_uv.permute(0, 2, 1),
        _valid(prob), params.min_depth,
    )
    r_norm = torch.linalg.norm(r, dim=1)
    trunc = params.trunc if trunc is None else trunc
    rho = robust.tukey_cost(r_norm, trunc)
    cost, n_obs = torch.sum(torch.where(ok, rho, 0.0)), torch.sum(ok)
    if reduce is not None:
        n_obs_f = n_obs.to(cost.dtype)
        reduce([cost, n_obs_f])
        n_obs = torch.round(n_obs_f).to(n_obs.dtype)
    return cost, n_obs


def _lm_iteration(R, t, points, prob: BAProblem, lam, trunc, params: BAParams, C,
                  reduce=None):
    """One LM step: normal equations, Schur reduction, solve, update.
    Also returns the robust cost at the input state (summed over the
    landmark group with the camera blocks, when `reduce` is given)."""
    r, ok, p_cam = _project_residuals(
        R, t, points.T, prob.obs_uv.permute(0, 2, 1), _valid(prob),
        params.min_depth,
    )
    r_norm = torch.linalg.norm(r, dim=1)
    cost = torch.sum(torch.where(ok, robust.tukey_cost(r_norm, trunc), 0.0))
    w = torch.where(ok, robust.tukey_weight(r_norm, trunc), 0.0)  # (C, L)
    Jc, Jp = _jacobians(p_cam, R)
    okf = ok.to(r.dtype)
    Jc = Jc * okf[:, None, None]
    Jp = Jp * okf[:, None, None]

    Jc_w = Jc * w[:, None, None]
    U = torch.einsum("cail,cajl->cij", Jc_w, Jc)
    Jp_w = Jp * w[:, None, None]
    V = torch.einsum("cail,cajl->ijl", Jp_w, Jp)         # (3, 3, L)
    W = [
        Jc_w[:, 0] * Jp[:, 0, k][:, None] + Jc_w[:, 1] * Jp[:, 1, k][:, None]
        for k in range(3)
    ]                                                    # 3 x (C, 6, L)
    g_c = -torch.einsum("cail,cal->ci", Jc_w, r)
    g_p = -torch.einsum("cail,cal->il", Jp_w, r)         # (3, L)

    free = prob.cam_mask & (
        torch.arange(C, device=prob.cam_mask.device) >= params.num_fixed
    )
    if prob.cam_fixed is not None:
        free = free & ~prob.cam_fixed

    delta_c, delta_p, cost = schur_solve(
        U, V, W, g_c, g_p, lam, prob.point_mask, free, reduce=reduce, fold_scalar=cost
    )
    R_new, t_new = se3.left_update(delta_c, R, t)
    return R_new, t_new, points + delta_p.T, cost


def schur_solve(U, V, W, g_c, g_p, lam, point_mask, free, reduce=None, fold_scalar=None):
    """Damped Schur-complement solve of a 6/3 block system, slab form.

    U (C, 6, 6); V (3, 3, L) planes; W three (C, 6, L) slabs; g_c (C, 6);
    g_p (3, L); free (C,) bool. Returns (delta_c (C, 6), delta_p (3, L)),
    zero for masked slots, and `fold_scalar` after them when one is given.

    With `reduce`, ONE call sums U, g_c, the Schur cross terms and
    `fold_scalar` (the caller's local cost: folding it here spares a
    collective per LM iteration) over the landmark group; the damping
    comes after it, so it sees the global camera blocks.
    """
    C = U.shape[0]
    dtype, dev = U.dtype, U.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    trV = (V[0, 0] + V[1, 1] + V[2, 2]) / 3.0 + 1e-6    # (L,)
    V_d = V + (lam * trV) * eye3[:, :, None]
    V_inv = _inv3x3_planes(V_d) * point_mask[None, None, :]
    Y = [
        sum(W[k] * V_inv[k, j][None, None] for k in range(3))
        for j in range(3)
    ]                                                    # 3 x (C, 6, L)
    S_cross = -sum(torch.einsum("cil,djl->cdij", Y[j], W[j]) for j in range(3))
    b_cross = torch.stack(
        [torch.einsum("cil,l->ci", Y[j], g_p[j]) for j in range(3)]
    ).sum(0)
    if reduce is not None:
        reduce([U, g_c, S_cross, b_cross] + ([] if fold_scalar is None else [fold_scalar]))

    diag = torch.arange(C, device=dev)
    U_d = U + lam * (torch.einsum("cii->c", U) / 6.0 + 1e-6)[:, None, None] * eye6
    S = S_cross.clone()
    S[diag, diag] += U_d
    b_red = g_c - b_cross

    free_f = free.to(dtype)
    S = S * free_f[:, None, None, None] * free_f[None, :, None, None]
    S[diag, diag] += (1.0 - free_f)[:, None, None] * eye6
    b_red = b_red * free_f[:, None]

    # Dense reduced camera solve (6C x 6C) by Cholesky. cholesky_ex does
    # not raise on an indefinite matrix: a failed factorization zeroes
    # the camera step, as the reference's NaN does.
    S_flat = S.permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
    chol, info = torch.linalg.cholesky_ex(S_flat)
    delta_c = torch.cholesky_solve(b_red.reshape(6 * C, 1), chol).reshape(C, 6)
    delta_c = torch.where(
        (info == 0) & torch.isfinite(delta_c), delta_c, 0.0
    ) * free_f[:, None]

    rhs = g_p - torch.stack(
        [torch.einsum("cil,ci->l", W[j], delta_c) for j in range(3)]
    )                                                    # (3, L)
    delta_p = torch.einsum("ijl,jl->il", V_inv, rhs)
    delta_p = torch.where(torch.isfinite(delta_p), delta_p, 0.0)
    if fold_scalar is None:
        return delta_c, delta_p * point_mask[None, :]
    return delta_c, delta_p * point_mask[None, :], fold_scalar


def solve_impl(prob: BAProblem, params: BAParams = BAParams(), reduce=None):
    """Run LM for `params.iters` iterations. Returns (BAProblem, info).

    `reduce` runs the landmark-sharded mode (see the module docstring):
    `prob` holds this rank's landmark block and the replicated cameras,
    and the result is this rank's block. Two reductions per LM
    iteration, plus one each for the initial and the final cost."""
    C = prob.R.shape[0]
    dtype, dev = prob.R.dtype, prob.R.device
    # Graduated non-convexity schedule for the truncation radius.
    truncs = params.trunc * params.anneal ** torch.linspace(
        1.0, 0.0, params.iters, dtype=dtype, device=dev
    )
    cost0, n_obs = compute_cost(prob, params, reduce=reduce)
    R, t, points = prob.R, prob.t, prob.points
    lam = torch.full((), params.lam0, dtype=dtype, device=dev)
    history = []
    for i in range(params.iters):
        trunc = truncs[i]
        R_n, t_n, p_n, cost = _lm_iteration(R, t, points, prob, lam, trunc, params, C,
                                             reduce)
        new_cost, _ = compute_cost(
            prob._replace(R=R_n, t=t_n, points=p_n), params, trunc, reduce
        )
        accept = new_cost < cost
        R = torch.where(accept, R_n, R)
        t = torch.where(accept, t_n, t)
        points = torch.where(accept, p_n, points)
        lam = torch.where(
            accept,
            torch.clamp(lam * params.lam_down, min=1e-9),
            torch.clamp(lam * params.lam_up, max=1e6),
        )
        history.append(torch.minimum(new_cost, cost))
    cost, _ = compute_cost(prob._replace(R=R, t=t, points=points), params, reduce=reduce)
    info = {
        "initial_cost": cost0,
        "final_cost": cost,
        "cost_history": torch.stack(history) if history else cost0[None][:0],
        "num_obs": n_obs,
        "final_lambda": lam,
    }
    return prob._replace(R=R, t=t, points=points), info
