"""Frozen copy of `viso_tpu_torch/geometry/triangulation.py` for the benchmark's plain
reference (imports rewritten to `vobench.reference`; window copies by
`vobench/reference/geometry/extract.py`'s plain indexing). The original
docstring follows.

Batched two-view triangulation (port of
`viso_tpu/geometry/triangulation.py`).

The two-ray depth system d2 * f2 = R21 (d1 * f1) + t21 is solved in
closed form as a 2x2 least-squares problem per correspondence; the point
returned is the midpoint of the rays' closest approach.
"""

from __future__ import annotations

import torch


def _mv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def triangulate(x1, x2, R1, t1, R2, t2):
    """Triangulate normalized correspondences x1, x2 (..., 2) seen from the
    world->camera poses (R1, t1), (R2, t2), which broadcast against the
    correspondence batch. Returns (points_world (..., 3), depth1 (...,),
    depth2 (...,)); a negative depth is a cheirality failure."""
    f1 = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    f2 = torch.cat([x2, torch.ones_like(x2[..., :1])], dim=-1)
    R21 = R2 @ R1.transpose(-1, -2)
    t21 = t2 - _mv(R21, t1)
    a = _mv(R21, f1)          # direction of ray 1 in cam2
    # Least squares for [d1, d2] in d1 * a - d2 * f2 = -t21. The 2x2
    # normal equations' determinant aa*bb - ab^2 and numerators are
    # written through cross products (Lagrange's identity), which are
    # exact rewrites: for nearly parallel rays (points near the focus of
    # expansion) the dot-product form cancels to f32 rounding noise, and
    # its sign and size then depend on the order of operations.
    shape = torch.broadcast_shapes(a.shape, f2.shape, t21.shape)
    a, f2, t21 = a.expand(shape), f2.expand(shape), t21.expand(shape)
    n = torch.linalg.cross(a, f2)
    det = torch.sum(n * n, dim=-1)
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    d1 = torch.sum(n * torch.linalg.cross(f2, t21), dim=-1) / det
    d2 = torch.sum(n * torch.linalg.cross(a, t21), dim=-1) / det
    mid_c2 = 0.5 * ((d1[..., None] * a + t21) + d2[..., None] * f2)
    Xw = torch.einsum("...ji,...j->...i", R2, mid_c2 - t2)
    return Xw, d1, d2


def reprojection_error(Xw, x, R, t):
    """Normalized-coordinate reprojection error (...,) of points (..., 3)."""
    pc = _mv(R, Xw) + t
    z = pc[..., 2:3]
    proj = pc[..., :2] / (z + torch.where(z >= 0, 1e-12, -1e-12))
    return torch.linalg.norm(proj - x, dim=-1)


def parallax_cos(Xw, R1, t1, R2, t2):
    """cos of the angle between the two viewing rays (close to 1 = low
    parallax)."""
    c1 = -torch.einsum("...ji,...j->...i", R1, t1)
    c2 = -torch.einsum("...ji,...j->...i", R2, t2)
    r1 = Xw - c1
    r2 = Xw - c2
    num = torch.sum(r1 * r2, dim=-1)
    den = torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1) + 1e-12
    return num / den
