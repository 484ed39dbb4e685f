"""Frozen copy of `viso_tpu_torch/geometry/epipolar.py` for the benchmark's plain
reference (imports rewritten to `vobench.reference`; window copies by
`vobench/reference/geometry/extract.py`'s plain indexing). The original
docstring follows.

Two-view epipolar geometry: essential matrix, homography and their
decompositions (port of `viso_tpu/geometry/epipolar.py`).

All solvers take normalized image coordinates (K^-1 applied) and batch
over leading dimensions. Null vectors come from `eigh` of the normal
matrix (ascending eigenvalues, as `jnp.linalg.eigh`; `null_vector`), the
essential manifold projection and the decompositions from `svd`. Each
fit and decomposition is also split at its solver call (`*_normal_matrix`
before `eigh`; `project_essential` and `*_candidates` after `svd`), for
callers that run the rest as captured programs (`ops/twoview.py`). The
sign of a null vector and of singular vectors depends on the solver, so
a fitted E or H equals the JAX package's only up to scale and sign, and
the candidate motions of a decomposition only as a set. On CUDA, batched
`eigh` and `svd` check their solver status on the host (a sync).
"""

from __future__ import annotations

import torch

from vobench.reference.geometry import se3


def normal_matrix(A, w=None):
    """A^T diag(w) A of constraint rows A (..., m, 9)."""
    if w is not None:
        A = A * w[..., None]
    return torch.einsum("...ki,...kj->...ij", A, A)


def null_vector(AtA):
    """Eigenvector of the smallest eigenvalue of AtA (..., 9, 9): the
    solver call (`eigh`, a host sync on CUDA)."""
    _, vecs = torch.linalg.eigh(AtA)
    return vecs[..., :, 0]


def _weighted_nullvec(A, w=None):
    """Eigenvector of the smallest eigenvalue of A^T diag(w) A, A (..., m, 9)."""
    return null_vector(normal_matrix(A, w))


def _epipolar_rows(x1, x2):
    """Constraint rows a with a . vec(E) = 0 for x2^T E x1 = 0:
    (..., N, 2) -> (..., N, 9)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = torch.ones_like(u1)
    return torch.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], dim=-1
    )


def essential_normal_matrix(x1, x2, weights=None):
    """The 8-point system's normal matrix (..., 9, 9) of (..., N, 2)
    correspondences."""
    return normal_matrix(_epipolar_rows(x1, x2), weights)


def as_matrix(v):
    """A null vector (..., 9) as the (..., 3, 3) matrix it holds row-major."""
    return v.reshape(v.shape[:-1] + (3, 3))


def project_essential(U, s, Vt):
    """The essential matrix from the SVD of its unprojected fit: singular
    values set to (1, 1, 0)."""
    s_proj = torch.zeros_like(s)
    s_proj[..., :2].fill_(1.0)   # fill_: no scalar copied from the host
    return U @ (s_proj[..., :, None] * Vt)


def fit_essential(x1, x2, weights=None):
    """8-point essential matrix of (..., N, 2) correspondences, N >= 8,
    projected onto the essential manifold (singular values 1, 1, 0)."""
    E = as_matrix(null_vector(essential_normal_matrix(x1, x2, weights)))
    return project_essential(*torch.linalg.svd(E))


def _homogeneous(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def epipolar_residual(E, x1, x2):
    """Sampson distance of correspondences to E: (..., N)."""
    p1 = _homogeneous(x1)
    p2 = _homogeneous(x2)
    Ex1 = torch.einsum("...ij,...nj->...ni", E, p1)
    Etx2 = torch.einsum("...ji,...nj->...ni", E, p2)
    x2Ex1 = torch.sum(p2 * Ex1, dim=-1)
    denom = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return (x2Ex1**2) / (denom + 1e-12)


def signed_sampson(E, x1, x2):
    """First-order geometric (signed) epipolar distance of correspondences
    x1, x2 (..., N, 2) to E: (..., N)."""
    p1 = _homogeneous(x1)
    p2 = _homogeneous(x2)
    Ex1 = torch.einsum("...ij,...nj->...ni", E, p1)
    Etx2 = torch.einsum("...ji,...nj->...ni", E, p2)
    num = torch.sum(p2 * Ex1, dim=-1)
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.sqrt(den + 1e-18)


def essential_from_rt(R, t):
    """E = [t]x R (up to scale)."""
    return se3.hat(t) @ R


def _signed_sampson_with_jacobian(R, t, p1, p2):
    """Signed Sampson distances r (K, N) of E = [t]x R and their Jacobian
    (K, N, 6) wrt theta = (dphi, dt) of E(theta) = [t + dt]x exp(dphi) R at
    theta = 0, for K starts. The derivative of exp at 0 is hat(e_k)
    exactly (the Taylor branch), so this is what `jax.jacfwd` gives."""
    E = essential_from_rt(R, t)                                # (K, 3, 3)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    gens = se3.hat(eye)                                        # (3, 3, 3)
    dE = torch.cat(
        [se3.hat(t)[:, None] @ gens[None] @ R[:, None],        # d/dphi
         gens[None] @ R[:, None]],                             # d/dt
        dim=1,
    )                                                          # (K, 6, 3, 3)
    Ex1 = torch.einsum("kij,nj->kni", E, p1)
    Etx2 = torch.einsum("kji,nj->kni", E, p2)
    dEx1 = torch.einsum("kdij,nj->kndi", dE, p1)               # (K, N, 6, 3)
    dEtx2 = torch.einsum("kdji,nj->kndi", dE, p2)
    num = torch.sum(p2 * Ex1, dim=-1)                          # (K, N)
    dnum = torch.einsum("nj,kndj->knd", p2, dEx1)
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    dden = 2.0 * (
        Ex1[..., 0:1] * dEx1[..., 0] + Ex1[..., 1:2] * dEx1[..., 1]
        + Etx2[..., 0:1] * dEtx2[..., 0] + Etx2[..., 1:2] * dEtx2[..., 1]
    )
    s = torch.sqrt(den + 1e-18)
    r = num / s
    J = dnum / s[..., None] - (num / (2.0 * s**3))[..., None] * dden
    return r, J


def _signed_sampson(R, t, p1, p2):
    E = essential_from_rt(R, t)
    Ex1 = torch.einsum("kij,nj->kni", E, p1)
    Etx2 = torch.einsum("kji,nj->kni", E, p2)
    num = torch.sum(p2 * Ex1, dim=-1)
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.sqrt(den + 1e-18)


def refine_essential(R0, t0, x1, x2, mask, tau, iters: int = 12, anneal: float = 8.0):
    """LM refinement of E on the essential manifold from K starts at once.

    R0 (K, 3, 3), t0 (K, 3); x1, x2 (N, 2); mask (N,). Minimizes a
    Cauchy-robust sum of squared signed Sampson distances with the robust
    width annealed from `anneal * tau` down to `tau` (graduated
    non-convexity), branchless step acceptance per start.
    Returns (R (K, 3, 3), t (K, 3), robust_cost (K,)).
    """
    dtype, dev = x1.dtype, x1.device
    p1 = _homogeneous(x1)
    p2 = _homogeneous(x2)
    m = mask.to(dtype)
    tau = torch.full((), tau, dtype=dtype, device=dev)   # no host copy
    taus = tau * anneal ** torch.linspace(1.0, 0.0, iters, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def robust_cost(r, tau_i):
        w = tau_i**2 / (tau_i**2 + r * r)
        return torch.sum(m * w * r * r, dim=-1)

    R = R0
    t = t0 / (torch.linalg.norm(t0, dim=-1, keepdim=True) + 1e-12)
    lam = torch.full(R0.shape[:1], 1e-3, dtype=dtype, device=dev)
    for i in range(iters):
        tau_i = taus[i]
        r, J = _signed_sampson_with_jacobian(R, t, p1, p2)
        w = m * tau_i**2 / (tau_i**2 + r * r)
        Jw = J * w[..., None]
        H = Jw.transpose(-1, -2) @ J + lam[:, None, None] * eye6
        g = torch.einsum("knd,kn->kd", Jw, r)
        d, _ = torch.linalg.solve_ex(H, -g)
        d = torch.where(torch.all(torch.isfinite(d), dim=-1, keepdim=True), d, 0.0)
        R_try = se3.so3_exp(d[:, :3]) @ R
        t_try = t + d[:, 3:]
        c0 = robust_cost(r, tau_i)
        c1 = robust_cost(_signed_sampson(R_try, t_try, p1, p2), tau_i)
        accept = c1 < c0
        R = torch.where(accept[:, None, None], R_try, R)
        t = torch.where(accept[:, None], t_try, t)
        t = t / (torch.linalg.norm(t, dim=-1, keepdim=True) + 1e-12)
        lam = torch.where(
            accept, torch.clamp(lam * 0.3, min=1e-6), torch.clamp(lam * 10.0, max=1e3)
        )
    final_cost = robust_cost(_signed_sampson(R, t, p1, p2), tau)
    return R, t, final_cost


def _proper(M):
    """M with its sign flipped where det(M) < 0 (batched)."""
    return M * torch.where(torch.linalg.det(M) < 0, -1.0, 1.0)[..., None, None]


def decompose_essential(E):
    """E (..., 3, 3) -> 4 candidate motions (R (..., 4, 3, 3), t (..., 4, 3)),
    |t| = 1, in the order (R1, t), (R1, -t), (R2, t), (R2, -t)."""
    U, _, Vt = torch.linalg.svd(E)
    return essential_candidates(U, Vt)


def essential_candidates(U, Vt):
    """`decompose_essential` from the SVD of E."""
    U = _proper(U)
    Vt = _proper(Vt)
    # W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]], written on the device: a
    # tensor of a host list is a copy that waits for it.
    Wm = torch.zeros((3, 3), dtype=U.dtype, device=U.device)
    Wm[0, 1].fill_(-1.0)
    Wm[1, 0].fill_(1.0)
    Wm[2, 2].fill_(1.0)
    R1 = U @ Wm @ Vt
    R2 = U @ Wm.T @ Vt
    t = U[..., :, 2]
    return torch.stack([R1, R1, R2, R2], dim=-3), torch.stack([t, -t, t, -t], dim=-2)


def _homography_rows(x1, x2):
    """DLT rows for x2 ~ H x1: (..., N, 2) -> (..., 2N, 9), the two rows of
    a correspondence adjacent."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    zero = torch.zeros_like(u1)
    one = torch.ones_like(u1)
    r1 = torch.stack([-u1, -v1, -one, zero, zero, zero, u2 * u1, u2 * v1, u2], dim=-1)
    r2 = torch.stack([zero, zero, zero, -u1, -v1, -one, v2 * u1, v2 * v1, v2], dim=-1)
    rows = torch.stack([r1, r2], dim=-2)                       # (..., N, 2, 9)
    return rows.reshape(rows.shape[:-3] + (rows.shape[-3] * 2, 9))


def homography_normal_matrix(x1, x2, weights=None):
    """The DLT system's normal matrix (..., 9, 9) of (..., N, 2)
    correspondences, `weights` (..., N) per correspondence."""
    if weights is not None:
        weights = torch.repeat_interleave(weights, 2, dim=-1)
    return normal_matrix(_homography_rows(x1, x2), weights)


def homography_from_null(h):
    """The homography of a DLT null vector, scaled so that H[2, 2] ~ 1."""
    H = as_matrix(h)
    return H / (H[..., 2:3, 2:3] + 1e-12)


def fit_homography(x1, x2, weights=None):
    """DLT homography of (..., N, 2) correspondences, N >= 4, scaled so
    that H[2, 2] ~ 1."""
    return homography_from_null(null_vector(homography_normal_matrix(x1, x2, weights)))


def homography_residual(H, x1, x2):
    """Squared transfer error |x2 - H x1|^2: (..., N)."""
    Hx1 = torch.einsum("...ij,...nj->...ni", H, _homogeneous(x1))
    proj = Hx1[..., :2] / (Hx1[..., 2:3] + 1e-12)
    return torch.sum((proj - x2) ** 2, dim=-1)


def decompose_homography(H):
    """Homography on normalized coords -> 8 candidate motions
    (R (..., 8, 3, 3), t (..., 8, 3) unit, n (..., 8, 3)), Faugeras-style
    SVD decomposition with every sign combination and each (t, n) twin
    (-t, -n); degenerate candidates score poorly in the motion selector."""
    return homography_candidates(*torch.linalg.svd(H))


def homography_candidates(U, s, Vt):
    """`decompose_homography` from the SVD of H."""
    d1, d2, d3 = s[..., 0], s[..., 1], s[..., 2]
    sgn = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1 = d1 / d2
    d3 = d3 / d2
    eps = 1e-9
    x1 = torch.sqrt(torch.clamp((d1**2 - 1.0) / (d1**2 - d3**2 + eps), min=0.0))
    x3 = torch.sqrt(torch.clamp((1.0 - d3**2) / (d1**2 - d3**2 + eps), min=0.0))
    sin_t = torch.sqrt(
        torch.clamp((d1**2 - 1.0) * (1.0 - d3**2), min=0.0)
    ) / ((d1 + d3) * 1.0 + eps)
    cos_t = (1.0 + d1 * d3) / (d1 + d3 + eps)
    V = Vt.transpose(-1, -2)
    zero = torch.zeros_like(x1)
    one = torch.ones_like(x1)
    Rs, ts, ns = [], [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            n_p = torch.stack([e1 * x1, zero, e3 * x3], dim=-1)
            st = e1 * e3 * sin_t
            Rp = torch.stack([
                torch.stack([cos_t, zero, -st], dim=-1),
                torch.stack([zero, one, zero], dim=-1),
                torch.stack([st, zero, cos_t], dim=-1),
            ], dim=-2)
            tp = (d1 - d3)[..., None] * torch.stack([e1 * x1, zero, -e3 * x3], dim=-1)
            R = sgn[..., None, None] * (U @ Rp @ Vt)
            t = torch.einsum("...ij,...j->...i", U, tp)
            n = torch.einsum("...ij,...j->...i", V, n_p)
            Rs += [R, R]
            ts += [t, -t]
            ns += [n, -n]
    Rs = torch.stack(Rs, dim=-3)
    ts = torch.stack(ts, dim=-2)
    ts = ts / (torch.linalg.norm(ts, dim=-1, keepdim=True) + 1e-12)
    return Rs, ts, torch.stack(ns, dim=-2)
