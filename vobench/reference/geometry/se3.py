"""Frozen copy of `viso_tpu_torch/geometry/se3.py` for the benchmark's plain
reference (imports rewritten to `vobench.reference`; window copies by
`vobench/reference/geometry/extract.py`'s plain indexing). The original
docstring follows.

SO(3)/SE(3) Lie-group operations on batched tensors.

Port of `viso_tpu/geometry/se3.py`. Rotations are 3x3 matrices; a
transform is the pair ``(R, t)`` mapping world->camera:
``x_cam = R @ x_world + t``. All functions broadcast over leading batch
dimensions. Small-angle paths use Taylor expansions selected with
`torch.where`: in float32, 1 - cos(theta) and theta - sin(theta) are pure
cancellation noise below theta ~ 1e-2, so the switch sits at
theta^2 < 1e-4, not near machine epsilon.

Angles and their coefficients keep a trailing axis of 1 (`keepdim`): on an
unbatched input they would be 0-dim, and forward-mode AD
(`torch.func.jacfwd`) promotes the tangent of a 0-dim tensor met by a
Python float to float64.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def hat(w):
    """Skew-symmetric matrix of w (..., 3) -> (..., 3, 3)."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def vee(W):
    """Inverse of `hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye_like(M):
    return torch.eye(3, dtype=M.dtype, device=M.device).expand(M.shape)


def _taylor_coeffs(theta_sq):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3), Taylor-safe,
    of theta_sq (..., 1)."""
    theta = torch.sqrt(theta_sq + _EPS)
    small = theta_sq < 1e-4
    A = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    B = torch.where(
        small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / (theta_sq + _EPS)
    )
    C = torch.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0,
        (theta - torch.sin(theta)) / (theta_sq * theta + _EPS),
    )
    return A, B, C


def so3_exp(w):
    """Rodrigues: axis-angle (..., 3) -> rotation matrix (..., 3, 3)."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    A, B, _ = _taylor_coeffs(theta_sq)
    W = hat(w)
    W2 = W @ W
    return _eye_like(W) + A[..., None] * W + B[..., None] * W2


def so3_log(R):
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3).

    Robust near theta = 0 (Taylor) and theta = pi (diagonal extraction).
    """
    trace = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2])[..., None]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    skew = vee(R - R.transpose(-1, -2))               # = 2 sin(theta) axis
    near_zero = cos_theta > 1.0 - 5e-5                 # theta < ~1e-2
    theta = torch.where(near_zero, 0.0, torch.arccos(cos_theta))
    theta_sq_t = torch.sum(skew * skew, dim=-1, keepdim=True) * 0.25
    sin_theta = torch.sin(theta)
    generic_scale = torch.where(
        near_zero,
        0.5 + theta_sq_t / 12.0,  # Taylor of theta/(2 sin theta)
        theta / (2.0 * sin_theta + _EPS),
    )
    w_generic = generic_scale * skew
    # Near-pi branch: w = theta * axis, axis from largest diagonal of (R + I)/2.
    S = R + _eye_like(R)
    diag = torch.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    idx = k[..., None, None].expand(S.shape[:-1] + (1,))
    col = torch.gather(S, -1, idx)[..., 0]
    axis = col / (torch.linalg.norm(col, dim=-1, keepdim=True) + _EPS)
    sign = torch.where(
        torch.sum(skew * axis, dim=-1, keepdim=True) < 0, -1.0, 1.0
    )
    w_pi = theta * axis * sign
    near_pi = (math.pi - theta) < 1e-3
    return torch.where(near_pi, w_pi, w_generic)


def se3_exp(xi):
    """Twist (..., 6) [rho, phi] (translation first) -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    A, B, C = _taylor_coeffs(theta_sq)
    W = hat(phi)
    W2 = W @ W
    eye = _eye_like(W)
    R = eye + A[..., None] * W + B[..., None] * W2
    V = eye + B[..., None] * W + C[..., None] * W2
    t = torch.einsum("...ij,...j->...i", V, rho)
    return R, t


def se3_log(R, t):
    """(R, t) -> twist (..., 6) [rho, phi]; inverse of `se3_exp`."""
    phi = so3_log(R)
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    A, B, _ = _taylor_coeffs(theta_sq)
    W = hat(phi)
    W2 = W @ W
    # V^{-1} = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2, Taylor below 1e-4.
    coef = torch.where(
        theta_sq < 1e-4,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - A / (2.0 * B + _EPS)) / (theta_sq + _EPS),
    )
    V_inv = _eye_like(W) - 0.5 * W + coef[..., None] * W2
    rho = torch.einsum("...ij,...j->...i", V_inv, t)
    return torch.cat([rho, phi], dim=-1)


def compose(R1, t1, R2, t2):
    """(R1,t1) o (R2,t2): apply T2 first, then T1."""
    R = R1 @ R2
    t = torch.einsum("...ij,...j->...i", R1, t2) + t1
    return R, t


def inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def transform(R, t, points):
    """Apply (R, t) to points (..., 3)."""
    return torch.einsum("...ij,...j->...i", R, points) + t


def left_update(xi, R, t):
    """T <- exp(xi) * T — the GN update rule."""
    dR, dt = se3_exp(xi)
    return compose(dR, dt, R, t)


def make_matrix(R, t):
    """A 4x4 homogeneous transform (..., 4, 4) from R (..., 3, 3), t (..., 3)."""
    R = torch.as_tensor(R)
    t = torch.as_tensor(t, dtype=R.dtype, device=R.device)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    top = torch.cat([R, t[..., None]], dim=-1)
    return torch.cat([top, bottom.expand(R.shape[:-2] + (1, 4))], dim=-2)


def from_matrix(T):
    """Split a 4x4 homogeneous transform into (R, t)."""
    return T[..., :3, :3], T[..., :3, 3]


def relative(Ra, ta, Rb, tb):
    """T_ab = T_a * T_b^{-1}: transform taking frame-b camera coords to frame-a."""
    Rbi, tbi = inverse(Rb, tb)
    return compose(Ra, ta, Rbi, tbi)
