"""Frozen copy of `viso_tpu_torch/backend/robust.py` for the benchmark's plain
reference (imports rewritten to `vobench.reference`; window copies by
`vobench/reference/geometry/extract.py`'s plain indexing). The original
docstring follows.

Robust kernels for the optimization backends (port of
`viso_tpu/backend/robust.py`)."""

from __future__ import annotations

import torch


def huber_weight(r_norm, delta):
    """IRLS weight for the Huber kernel: 1 inside, delta/|r| outside."""
    return torch.where(
        r_norm <= delta, 1.0, delta / torch.clamp(r_norm, min=1e-12)
    )


def cauchy_weight(r_norm, delta):
    return delta**2 / (delta**2 + r_norm**2)


def tukey_weight(r_norm, c):
    """Tukey biweight IRLS weight: (1 - (r/c)^2)^2 inside, 0 outside."""
    u = r_norm / c
    return torch.where(u < 1.0, (1.0 - u * u) ** 2, 0.0)


def tukey_cost(r_norm, c):
    """Tukey biweight rho; constant c^2/6 beyond the cutoff."""
    u = torch.clamp(r_norm / c, max=1.0)
    return (c * c / 6.0) * (1.0 - (1.0 - u * u) ** 3)


def huber_cost(r_norm, delta):
    """Huber rho(|r|): quadratic inside, linear outside."""
    quad = 0.5 * r_norm**2
    lin = delta * (r_norm - 0.5 * delta)
    return torch.where(r_norm <= delta, quad, lin)
