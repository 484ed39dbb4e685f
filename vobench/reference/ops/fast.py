"""Frozen copy of `viso_tpu_torch/ops/fast.py` for the benchmark's plain
reference (imports rewritten to `vobench.reference`; window copies by
`vobench/reference/geometry/extract.py`'s plain indexing). The original
docstring follows.

FAST-9 corner detection on dense tensors (port of `viso_tpu/ops/fast.py`).

The segment test runs on the whole image with 16 shifted copies, scores
every pixel, 3x3 non-max suppresses, and picks a fixed-size keypoint set
per grid cell -- static shapes for everything downstream.

Tie order: `lax.top_k` returns equal values lowest index first, and FAST
scores on uint8-derived images tie often. `torch.topk` promises no tie
order (and CPU and CUDA differ), so `_top_k` is a stable descending sort
sliced to k.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vobench.reference.ops.pyramid import KERNEL_1D, edge_pad_cols, edge_pad_rows


def _top_k(x, k: int):
    """(values, indices) of the k largest along the last dim, ties broken
    by the lower index (lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def smooth_binomial(img):
    """One separable 5-tap binomial pass (sigma ~1.03), edge-replicated."""
    H, W = img.shape
    xp = edge_pad_rows(img, 2)
    img = sum(KERNEL_1D[k] * xp[k: k + H] for k in range(5))
    xp = edge_pad_cols(img, 2)
    return sum(KERNEL_1D[k] * xp[:, k: k + W] for k in range(5))


# Bresenham circle of radius 3 as (drow, dcol), clockwise (FAST-9/16).
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _shifted_stack(img):
    """(16, H, W) copies of img shifted so index i holds circle-pixel i
    (zero padding outside the image)."""
    H, W = img.shape
    padded = F.pad(img, (3, 3, 3, 3))
    return torch.stack(
        [padded[3 + dr: 3 + dr + H, 3 + dc: 3 + dc + W] for dr, dc in _CIRCLE],
        dim=0,
    )


def _arc9_any(x):
    """Any contiguous arc of length >= 9 on the 16-cycle, (16, H, W) -> (H, W)."""
    x2 = torch.cat([x, x[:8]], dim=0)          # cyclic pad
    a2 = x2[:-1] & x2[1:]                      # (23,H,W) len-2
    a4 = a2[:-2] & a2[2:]                      # (21,H,W) len-4
    a8 = a4[:-4] & a4[4:]                      # (17,H,W) len-8
    a9 = a8[:16] & x2[8:]                      # (16,H,W) len-9
    return a9.any(dim=0)


def score_map(img, threshold: float):
    """Dense FAST-9 corner score (H, W); 0 where the segment test fails.

    Score = max(sum of brighter-arc excesses, sum of darker-arc excesses).
    """
    img = smooth_binomial(img.to(torch.float32))
    circ = _shifted_stack(img)
    diff = circ - img[None]
    brighter = diff > threshold
    darker = diff < -threshold
    is_corner_b = _arc9_any(brighter)
    is_corner_d = _arc9_any(darker)
    v_b = torch.sum(torch.where(brighter, diff - threshold, 0.0), dim=0)
    v_d = torch.sum(torch.where(darker, -diff - threshold, 0.0), dim=0)
    score = torch.maximum(
        torch.where(is_corner_b, v_b, 0.0), torch.where(is_corner_d, v_d, 0.0)
    )
    # Kill the 3-pixel border (ring samples are padding-contaminated there).
    H, W = img.shape
    rows = torch.arange(H, device=img.device)[:, None]
    cols = torch.arange(W, device=img.device)[None, :]
    valid = (rows >= 3) & (rows < H - 3) & (cols >= 3) & (cols < W - 3)
    return torch.where(valid, score, 0.0)


def _nms(score):
    """3x3 non-max suppression; the window pads with -inf, as
    lax.reduce_window(-inf, max, SAME) does."""
    pooled = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= pooled, score, 0.0)


def detect(img, threshold: float = 50.0, max_num: int = 1024, nms: bool = True):
    """Single-scale FAST with a global top-k: (uv (max_num, 2) float32,
    score (max_num,), mask (max_num,)). uv is (u=col, v=row); slots past
    the detections have mask False."""
    s = score_map(img, threshold)
    if nms:
        s = _nms(s)
    W = s.shape[1]
    vals, idx = _top_k(s.reshape(-1), max_num)
    uv = torch.stack([idx % W, idx // W], dim=-1).to(torch.float32)
    return uv, vals, vals > 0.0


def _cells(s, gh: int, gw: int):
    """(G, ch*cw) per-cell score rows of a (H, W) map, plus (ch, cw)."""
    Hl, Wl = s.shape
    ch, cw = max(1, Hl // gh), max(1, Wl // gw)
    s_c = s[: gh * ch, : gw * cw].reshape(gh, ch, gw, cw)
    return s_c.permute(0, 2, 1, 3).reshape(gh * gw, ch * cw), ch, cw


def _cell_rc(idx, gw: int, ch: int, cw: int):
    """Cell-local flat indices (G, k) -> image (row, col)."""
    cell_ids = torch.arange(idx.shape[0], device=idx.device)
    r = ((cell_ids // gw) * ch)[:, None] + idx // cw
    c = ((cell_ids % gw) * cw)[:, None] + idx % cw
    return r, c


def detect_grid_pyramid(
    pyr,
    threshold: float = 25.0,
    grid: tuple = (8, 8),
    per_cell: int = 16,
    levels: int = 3,
    threshold_decay: float = 2.0,
):
    """Multi-scale grid-bucketed FAST over an image pyramid.

    Detection runs on `levels` pyramid levels with threshold
    `threshold / threshold_decay**level`, coordinates mapped to level 0;
    each grid cell keeps its finest-level corners first and fills the rest
    of its budget from coarser levels. Returns (uv (G*per_cell, 2) at
    level-0 coords, score, mask).
    """
    levels = min(levels, len(pyr))
    gh, gw = grid
    all_uv, all_key, all_score = [], [], []
    for lvl in range(levels):
        thr = threshold / (threshold_decay**lvl)
        s = _nms(score_map(pyr[lvl], thr))
        Hl, Wl = s.shape
        if Hl < gh or Wl < gw:
            break
        s_c, ch, cw = _cells(s, gh, gw)
        k = min(per_cell, ch * cw)
        vals, idx = _top_k(s_c, k)                           # (G, k)
        r, c = _cell_rc(idx, gw, ch, cw)
        scale = float(2**lvl)
        # Pixel-center-aligned mapping of level-l coords to level 0.
        u0 = (c.to(torch.float32) + 0.5) * scale - 0.5
        v0 = (r.to(torch.float32) + 0.5) * scale - 0.5
        if k < per_cell:
            pad = per_cell - k
            u0 = F.pad(u0, (0, pad))
            v0 = F.pad(v0, (0, pad))
            vals = F.pad(vals, (0, pad))
        # Finer level always beats coarser; score breaks ties in a level.
        key = torch.where(
            vals > 0.0, (levels - lvl) * 1.0e6 + vals, float("-inf")
        )
        all_uv.append(torch.stack([u0, v0], dim=-1))         # (G, per_cell, 2)
        all_key.append(key)
        all_score.append(vals)
    if not all_uv:
        raise ValueError(
            f"image {tuple(pyr[0].shape)} smaller than detection grid {grid}"
        )
    uv = torch.cat(all_uv, dim=1)                            # (G, levels*pc, 2)
    key = torch.cat(all_key, dim=1)
    score = torch.cat(all_score, dim=1)
    topk, sel = _top_k(key, per_cell)                        # (G, per_cell)
    uv = torch.gather(uv, 1, sel[:, :, None].expand(-1, -1, 2)).reshape(-1, 2)
    score = torch.gather(score, 1, sel).reshape(-1)
    mask = torch.isfinite(topk).reshape(-1)
    uv = torch.where(mask[:, None], uv, 0.0)
    return uv, torch.where(mask, score, 0.0), mask


def detect_grid(img, threshold: float = 25.0, grid: tuple = (8, 8),
                per_cell: int = 16):
    """Grid-bucketed FAST: top `per_cell` corners in each grid cell.

    Returns (uv (G*per_cell, 2), score, mask) with G = grid[0]*grid[1].
    """
    s = _nms(score_map(img, threshold))
    gh, gw = grid
    s_c, ch, cw = _cells(s, gh, gw)
    vals, idx = _top_k(s_c, per_cell)
    r, c = _cell_rc(idx, gw, ch, cw)
    uv = torch.stack([c.to(torch.float32), r.to(torch.float32)], dim=-1)
    vals = vals.reshape(-1)
    return uv.reshape(-1, 2), vals, vals > 0.0
