"""Steered BRIEF binary descriptors and matmul Hamming matching (port of
`viso_tpu/ops/descriptors.py`).

  * BRIEF-256: a fixed random pixel-pair pattern in a smoothed patch,
    from the same numpy seed as the JAX package. Keypoints are rounded to
    integer pixels, so every pattern sample sits at a fixed fractional
    offset from the window centre and its bilinear taps are constants:
    all 2 x 256 samples of N keypoints are one (N, 34^2) x (34^2, 512)
    matmul against the 34x34 windows that kernel K1 copies.
  * Orientation steering (ORB-style): the pattern is pre-rotated into 16
    bins; each keypoint blends the two bins adjacent to its intensity-
    centroid angle.
  * Descriptors are {-1, +1} bfloat16 vectors, so Hamming distance is
    (256 - a.b) / 2 and brute-force matching is one matmul. The product
    is taken in float32: integers of at most 256 are exact there.
  * Mutual-nearest + ratio-test matching, all masked and static-shape.

The pattern matrices are numpy constants built once, then kept per
device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from viso_tpu_torch.geometry import extract, sampling

DESC_BITS = 256
_PATCH_RADIUS = 15.0

# Descriptor grid: pattern radius 15 + 1 bilinear tap, centred; grid
# index i maps to pixel offset i - _HALF from the (rounded) keypoint.
_WIN = 34
_HALF = _WIN // 2

N_ORIENT_BINS = 16

# 5-tap binomial [1,4,6,4,1]/16, applied twice separably (sigma ~1.4).
_BINOMIAL = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _brief_pattern(seed: int = 17):
    """(256, 2, 2) sample-pair offsets, Gaussian like the BRIEF paper."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, _PATCH_RADIUS / 2.0, size=(DESC_BITS, 2, 2))
    return np.clip(pts, -_PATCH_RADIUS, _PATCH_RADIUS).astype(np.float32)


def _pattern_matrix(offsets=None):
    """(WIN*WIN, 2*DESC_BITS) constant bilinear-tap matrix of the pattern
    samples at `offsets` (512, 2) (du, dv) from the window centre."""
    pat = _brief_pattern().reshape(-1, 2) if offsets is None else offsets
    W = np.zeros((_WIN * _WIN, pat.shape[0]), np.float32)
    for s, (du, dv) in enumerate(pat):
        u = _HALF + du
        v = _HALF + dv
        x0, y0 = int(np.floor(u)), int(np.floor(v))
        fx, fy = u - x0, v - y0
        for (yy, xx, w) in (
            (y0, x0, (1 - fx) * (1 - fy)),
            (y0, x0 + 1, fx * (1 - fy)),
            (y0 + 1, x0, (1 - fx) * fy),
            (y0 + 1, x0 + 1, fx * fy),
        ):
            if 0 <= yy < _WIN and 0 <= xx < _WIN:
                W[yy * _WIN + xx, s] += w
    return W


def _oriented_pattern_mats():
    """(B, WIN^2, 512): the pattern rotated into N_ORIENT_BINS bins."""
    pat = _brief_pattern().reshape(-1, 2)
    mats = []
    for b in range(N_ORIENT_BINS):
        th = 2.0 * np.pi * b / N_ORIENT_BINS
        c, s = np.cos(th), np.sin(th)
        rot = np.stack(
            [pat[:, 0] * c - pat[:, 1] * s, pat[:, 0] * s + pat[:, 1] * c], axis=-1
        )
        mats.append(_pattern_matrix(rot))
    return np.stack(mats)


def _moment_matrix():
    """(WIN*WIN, 2) weights mapping a window to its intensity-centroid
    moments (m10, m01) over a centred disc of the pattern radius."""
    ys, xs = np.mgrid[0:_WIN, 0:_WIN].astype(np.float32)
    xs -= _HALF
    ys -= _HALF
    disc = (xs**2 + ys**2) <= _PATCH_RADIUS**2
    M = np.stack([xs * disc, ys * disc], axis=-1)
    return M.reshape(_WIN * _WIN, 2).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _host_constants():
    return {
        "pattern": _pattern_matrix(),
        "oriented": _oriented_pattern_mats(),
        "moment": _moment_matrix(),
    }


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device):
    return {k: torch.from_numpy(v).to(device) for k, v in _host_constants().items()}


def _pad_edge(x, dim: int):
    """Replicate two rows (dim 0) or columns (dim 1) at each end."""
    n = x.shape[dim]
    lo = x.narrow(dim, 0, 1)
    hi = x.narrow(dim, n - 1, 1)
    return torch.cat([lo, lo, x, hi, hi], dim=dim)


def _smooth(img):
    """BRIEF pre-smoothing: two separable binomial passes (without it,
    sensor noise flips every comparison whose pair difference is below
    the noise floor). The taps are summed in the JAX package's order."""
    def sep(x):
        H, W = x.shape
        xp = _pad_edge(x, 0)
        acc = 0
        for k in range(5):
            acc = acc + _BINOMIAL[k] * xp[k: k + H]
        xp = _pad_edge(acc, 1)
        out = 0
        for k in range(5):
            out = out + _BINOMIAL[k] * xp[:, k: k + W]
        return out

    return sep(sep(img))


def compute(img_smooth, kps, mask, oriented: bool = True):
    """BRIEF descriptors for keypoints (rotation-steered by default).

    img_smooth: (H, W) float32 image (smoothed here); kps (N, 2); mask
    (N,). Returns desc (N, 256) bfloat16 in {-1, +1}, 0 rows where masked
    or where the 34x34 grid would clamp at the image border. The windows
    come from K1 (`extract.extract_windows_fast`): a launch on CUDA.
    """
    H, W_img = img_smooth.shape
    consts = _constants(img_smooth.device)
    img_smooth = _smooth(img_smooth.to(torch.float32))
    kpi = torch.round(kps)
    win, base = extract.extract_windows_fast(img_smooth, kpi, _WIN)
    grid = sampling.sample_patch_grid(win, base, kpi, _HALF)      # (N, 34, 34)
    ok = (
        mask
        & (kpi[:, 0] >= _HALF) & (kpi[:, 0] < W_img - _HALF)
        & (kpi[:, 1] >= _HALF) & (kpi[:, 1] < H - _HALF)
    )
    n = kps.shape[0]
    g = grid.reshape(n, -1)
    if oriented:
        m = g @ consts["moment"]                                  # (N, 2)
        theta = torch.atan2(m[:, 1], m[:, 0])
        step = 2.0 * math.pi / N_ORIENT_BINS
        # Continuous steering: blend the two adjacent pre-rotated bins.
        tb = theta / step
        fl = torch.floor(tb)
        b_lo = fl.to(torch.int64) % N_ORIENT_BINS
        w_hi = tb - fl
        b_hi = (b_lo + 1) % N_ORIENT_BINS
        # One-hot rows by comparison: `F.one_hot` reads its input's range
        # on the host.
        bins = torch.arange(N_ORIENT_BINS, device=b_lo.device)
        weights = (
            (b_lo[:, None] == bins).to(g.dtype) * (1.0 - w_hi)[:, None]
            + (b_hi[:, None] == bins).to(g.dtype) * w_hi[:, None]
        )
        allv = torch.einsum("nw,bws->nbs", g, consts["oriented"])  # (N, B, 512)
        vals = torch.einsum("nbs,nb->ns", allv, weights)
    else:
        vals = g @ consts["pattern"]                               # (N, 512)
    vals = vals.reshape(n, DESC_BITS, 2)
    bits = vals[..., 0] < vals[..., 1]
    desc = torch.where(bits, 1.0, -1.0).to(torch.bfloat16)
    return desc * ok[:, None].to(torch.bfloat16)


def hamming(desc1, desc2):
    """Pairwise Hamming distances (..., N1, N2) via one float32 matmul of the
    {-1, 0, +1} values (exact: every partial sum is an integer <= 256)."""
    dot = desc1.to(torch.float32) @ desc2.to(torch.float32).transpose(-1, -2)
    return (DESC_BITS - dot) * 0.5


def match(desc1, mask1, desc2, mask2, max_distance: float = 64.0, ratio: float = 0.8):
    """Mutual-nearest matching with Lowe's ratio test.

    desc2 / mask2 may carry leading batch dimensions (..., N2, 256) /
    (..., N2): set 1 is then matched against each set 2 of the batch.
    Returns (idx2 (..., N1), dist (..., N1), ok (..., N1)): for each
    descriptor in set 1, its match index in set 2.
    """
    d = hamming(desc1, desc2)                                 # (..., N1, N2)
    big = 1e9
    d = torch.where(mask1[:, None] & mask2[..., None, :], d, big)
    # Best and second best along set 2 (argmin keeps the first minimum,
    # as jnp.argmin does).
    best2 = torch.argmin(d, dim=-1)
    dbest = torch.amin(d, dim=-1)
    d_wo = d.scatter(-1, best2[..., None], big)
    dsecond = torch.amin(d_wo, dim=-1)
    # Mutual check.
    best1_of_2 = torch.argmin(d, dim=-2)                      # (..., N2)
    mutual = torch.gather(best1_of_2, -1, best2) == torch.arange(
        d.shape[-2], device=d.device
    )
    ok = mask1 & mutual & (dbest < max_distance) & (dbest < ratio * dsecond)
    return best2, dbest, ok
