"""Sim(3) similarity transforms for monocular loop closure (port of
`viso_tpu/geometry/sim3.py`).

Convention: S = (s, R, t) maps x -> s * R @ x + t. Pose-graph nodes are
world->cam similarities (odometry enters with s = 1); a loop edge carries
the relative scale measured by a masked Umeyama fit.

Every function broadcasts over leading batch axes (the pose graph runs
them over its edge axis, where the JAX package vmaps). `compose` and
`inverse` are plain operator code, so they take numpy arrays and Python
floats as well as tensors: the SLAM worker's host bookkeeping calls them
on numpy. The tangent update is first order, delta7 = [rho, phi, sigma]
-> (e^sigma, exp_so3(phi), rho), as in the JAX package.
"""

from __future__ import annotations

import torch

from viso_tpu_torch.geometry import se3


def _col(s):
    """s with a trailing unit axis, so a batch of scales broadcasts over
    the last axis of a batch of vectors (a scalar stays a scalar)."""
    return s[..., None] if getattr(s, "ndim", 0) else s


def _mv(R, t):
    """R @ t over leading batch axes (torch or numpy)."""
    return (R @ t[..., None])[..., 0]


def compose(sa, Ra, ta, sb, Rb, tb):
    """S_a o S_b: x -> s_a R_a (s_b R_b x + t_b) + t_a."""
    return sa * sb, Ra @ Rb, _col(sa) * _mv(Ra, tb) + ta


def inverse(s, R, t):
    """S^-1 = (1/s, R^T, -(1/s) R^T t)."""
    s_inv = 1.0 / s
    Rt = R.swapaxes(-1, -2)
    return s_inv, Rt, -_col(s_inv) * _mv(Rt, t)


def left_update(delta7, s, R, t):
    """First-order left update S <- exp(delta) o S, with
    delta7 = [rho (3), phi (3), sigma (1)] (..., 7)."""
    return compose(
        torch.exp(delta7[..., 6]), se3.so3_exp(delta7[..., 3:6]), delta7[..., :3], s, R, t
    )


def log_decomposed(s, R, t):
    """[t, so3_log(R), log(s)] (..., 7): zero exactly at the identity,
    not the exact Sim(3) log (no W matrix); used as an edge residual."""
    return torch.cat([t, se3.so3_log(R), torch.log(s)[..., None]], dim=-1)


def umeyama_masked(src, dst, mask):
    """Masked similarity fit dst ~= s R src + t (Umeyama 1991).

    src, dst: (..., N, 3); mask: (..., N) weights in {0, 1}. Returns
    (s (...), R (..., 3, 3), t (..., 3)). Degenerate masks (fewer than
    three points, zero variance) and non-finite fits give the identity
    similarity. Selected with `torch.where`: no host read of its own; on
    CUDA the SVD checks its status on the host, so the steps around it
    are functions of their own (`umeyama_moments`, `umeyama_finish`)."""
    cov, moments = umeyama_moments(src, dst, mask)
    U, D, Vt = torch.linalg.svd(cov)
    return umeyama_finish(U, D, Vt, *moments)


def umeyama_moments(src, dst, mask):
    """The fit's cross-covariance (..., 3, 3), the identity where it is
    not finite (as in the JAX package, whose SVD returns NaN there, the
    SVD sees a finite matrix), and the moments `umeyama_finish` takes."""
    w = mask.to(src.dtype)
    w_sum = torch.sum(w, dim=-1)
    n = torch.clamp(w_sum, min=1e-6)
    mu_s = torch.sum(src * w[..., None], dim=-2) / n[..., None]
    mu_d = torch.sum(dst * w[..., None], dim=-2) / n[..., None]
    src_c = src - mu_s[..., None, :]
    dc = (dst - mu_d[..., None, :]) * w[..., None]
    cov = dc.swapaxes(-1, -2) @ src_c / n[..., None, None]          # (..., 3, 3)
    var_s = torch.sum(src_c * w[..., None] * src_c, dim=(-2, -1)) / n
    finite = torch.isfinite(cov).all(dim=-1).all(dim=-1)
    eye = torch.eye(3, dtype=src.dtype, device=src.device)
    return torch.where(finite[..., None, None], cov, eye), (mu_s, mu_d, var_s, w_sum, finite)


def umeyama_finish(U, D, Vt, mu_s, mu_d, var_s, w_sum, finite):
    """(s, R, t) from the SVD of the cross-covariance and the moments."""
    eye = torch.eye(3, dtype=U.dtype, device=U.device)
    det = torch.linalg.det(U @ Vt)
    d = torch.cat([torch.ones_like(D[..., :2]), det[..., None]], dim=-1)
    R = (U * d[..., None, :]) @ Vt
    s = torch.sum(D * d, dim=-1) / torch.clamp(var_s, min=1e-9)
    t = mu_d - s[..., None] * _mv(R, mu_s)
    ok = (finite & (w_sum >= 3.0) & (var_s > 1e-9)
          & torch.isfinite(s) & (s > 1e-6))
    s = torch.where(ok, s, 1.0)
    R = torch.where(ok[..., None, None], R, eye)
    t = torch.where(ok[..., None], t, 0.0)
    return s, R, t
