"""Frozen copy of `viso_tpu_torch/ops/pyramid.py` for the benchmark's plain
reference (imports rewritten to `vobench.reference`; window copies by
`vobench/reference/geometry/extract.py`'s plain indexing). The original
docstring follows.

Image pyramid (port of `viso_tpu/ops/pyramid.py`).

The [1 4 6 4 1]/16 separable blur plus 2x subsampling, written as the
same shift-and-sum of five scaled slices per axis with edge replication
(not `F.conv2d`, whose float32 path may run in TF32 and sums in another
order). Pyramids are tuples of (H/2^l, W/2^l) float32 tensors.
"""

from __future__ import annotations

import torch

# [1, 4, 6, 4, 1] / 16: every tap is exact in float32.
KERNEL_1D = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)

NUM_LEVELS = 4


def edge_pad_rows(img, p: int):
    """Replicate the first/last row p times (jnp.pad mode='edge', axis 0)."""
    idx = torch.clamp(
        torch.arange(-p, img.shape[0] + p, device=img.device), 0, img.shape[0] - 1
    )
    return img.index_select(0, idx)


def edge_pad_cols(img, p: int):
    """Replicate the first/last column p times (mode='edge', axis 1)."""
    idx = torch.clamp(
        torch.arange(-p, img.shape[1] + p, device=img.device), 0, img.shape[1] - 1
    )
    return img.index_select(1, idx)


def _blur_down(img):
    """5-tap Gaussian blur + 2x subsample of an (H, W) image."""
    h, w = img.shape
    k = KERNEL_1D
    xp = edge_pad_rows(img, 2)
    v = sum(k[i] * xp[i: i + h, :] for i in range(5))
    v = v[::2]
    vp = edge_pad_cols(v, 2)
    o = sum(k[i] * vp[:, i: i + w] for i in range(5))
    return o[:, ::2].contiguous()


def build_pyramid(img, num_levels: int = NUM_LEVELS):
    """img (H, W) -> tuple of `num_levels` float32 images, level 0 = full res."""
    levels = [img.to(torch.float32).contiguous()]
    for _ in range(num_levels - 1):
        levels.append(_blur_down(levels[-1]))
    return tuple(levels)
