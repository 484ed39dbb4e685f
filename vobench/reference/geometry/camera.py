"""Frozen copy of `viso_tpu_torch/geometry/camera.py` for the benchmark's plain
reference (imports rewritten to `vobench.reference`; window copies by
`vobench/reference/geometry/extract.py`'s plain indexing). The original
docstring follows.

Pinhole camera model with pyramid-level scaling.

Port of `viso_tpu/geometry/camera.py`. Intrinsics are four Python
floats, each rounded to float32 as the JAX package stores them, so a
scalar broadcasts onto a tensor of any device without a transfer.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Intrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float

    @classmethod
    def create(cls, fx, fy, cx, cy):
        return cls(*(float(np.float32(v)) for v in (fx, fy, cx, cy)))

    def at_level(self, level: int):
        """Intrinsics at pyramid `level` (scale 0.5**level).

        The pyramid halving maps pixel centers as u' = (u + 0.5)/2 - 0.5,
        i.e. cx' = (cx + 0.5) * s - 0.5. Computed in float32, as the JAX
        package does.
        """
        f32 = np.float32
        s = f32(0.5) ** f32(level)
        return Intrinsics(
            float(f32(self.fx) * s),
            float(f32(self.fy) * s),
            float((f32(self.cx) + f32(0.5)) * s - f32(0.5)),
            float((f32(self.cy) + f32(0.5)) * s - f32(0.5)),
        )


def project(points_cam, intr: Intrinsics, eps: float = 1e-6):
    """Camera-frame points (..., 3) -> pixel coords (..., 2) + depth (...,)."""
    z = points_cam[..., 2]
    inv_z = 1.0 / torch.where(
        torch.abs(z) < eps, torch.where(z < 0, -eps, eps), z
    )
    u = intr.fx * points_cam[..., 0] * inv_z + intr.cx
    v = intr.fy * points_cam[..., 1] * inv_z + intr.cy
    return torch.stack([u, v], dim=-1), z


def backproject(uv, depth, intr: Intrinsics):
    """Pixel coords (..., 2) + depth (...,) -> camera-frame points (..., 3)."""
    x = (uv[..., 0] - intr.cx) / intr.fx
    y = (uv[..., 1] - intr.cy) / intr.fy
    return torch.stack([x * depth, y * depth, depth], dim=-1)


def normalize(uv, intr: Intrinsics):
    """Pixels -> normalized image coords p = K^-1 [u v 1]."""
    x = (uv[..., 0] - intr.cx) / intr.fx
    y = (uv[..., 1] - intr.cy) / intr.fy
    return torch.stack([x, y], dim=-1)


def denormalize(xy, intr: Intrinsics):
    """Normalized image coords -> pixels: the inverse of `normalize`."""
    u = xy[..., 0] * intr.fx + intr.cx
    v = xy[..., 1] * intr.fy + intr.cy
    return torch.stack([u, v], dim=-1)


def is_inside(uv, height, width, border: float = 0.0):
    """Bounds mask with a patch border."""
    u, v = uv[..., 0], uv[..., 1]
    return (
        (u >= border)
        & (u < width - 1 - border)
        & (v >= border)
        & (v < height - 1 - border)
    )


def viewing_cos(points_cam):
    """cos(angle between optical axis and the ray), camera-frame (..., 3)."""
    norm = torch.linalg.norm(points_cam, dim=-1)
    return points_cam[..., 2] / (norm + 1e-9)
