"""Window copies for the benchmark's plain reference: the plain version of
the port's window-extraction kernel K1 (`viso_tpu_torch/geometry/
extract.py`'s `extract_plain` and its centred and two-source entries),
on any device, with no kernel. A window copy is exact, so these give the
kernel's bytes.
"""

from __future__ import annotations

import torch


def _slice_start(i, dim: int, size: int):
    """lax.dynamic_slice's start index: a negative start counts from the
    end once (i + dim), then the start is clamped to [0, dim - size]."""
    return torch.clamp(torch.where(i < 0, i + dim, i), 0, dim - size)


def extract_plain(img, base, h: int, w: int, k=None):
    """(N, h, w) windows of img (H, W), or of image k[n] of a stack (K, H,
    W), at origins base (N, 2) (x0, y0), by advanced indexing."""
    H, W = img.shape[-2], img.shape[-1]
    dev = img.device
    x0 = _slice_start(base[:, 0].long(), W, w)
    y0 = _slice_start(base[:, 1].long(), H, h)
    rows = (y0[:, None] + torch.arange(h, device=dev))[:, :, None]
    cols = (x0[:, None] + torch.arange(w, device=dev))[:, None, :]
    if k is None:
        return img[rows, cols]
    kk = _slice_start(k.long(), img.shape[0], 1)[:, None, None]
    return img[kk, rows, cols]


def centered_base(img_hw, centers, win: int):
    """Origins of `win` x `win` windows centred at `centers` (N, 2): floor,
    subtract win//2, clip to [0, W-win] x [0, H-win]. int32."""
    H, W = img_hw
    b = torch.floor(centers).to(torch.int32) - win // 2
    return torch.stack(
        [torch.clamp(b[:, 0], 0, W - win), torch.clamp(b[:, 1], 0, H - win)],
        dim=-1,
    )


def centered_plain(img, centers, win: int, k=None):
    base = centered_base(img.shape[-2:], centers, win)
    return extract_plain(img, base, win, win, k=k), base


def extract_windows_fast(img, centers, win: int):
    return centered_plain(img, centers, win)


def extract_windows_indexed_fast(imgs, k, centers, win: int):
    return centered_plain(imgs, centers, win, k=k)


def extract_windows_two_source(stack, k, centers, img, centers2, win: int):
    w1, b1 = centered_plain(stack, centers, win, k=k)
    w2, b2 = centered_plain(img, centers2, win)
    return torch.cat([w1, w2]), torch.cat([b1, b2])


def extract_rects_fast(img, base, h: int, w: int):
    return extract_plain(img, base, h, w), base
