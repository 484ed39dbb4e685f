"""Frozen copy of `viso_tpu_torch/geometry/sampling.py` for the benchmark's plain
reference (imports rewritten to `vobench.reference`; window copies by
`vobench/reference/geometry/extract.py`'s plain indexing). The original
docstring follows.

Bilinear image sampling (port of `viso_tpu/geometry/sampling.py`).

Two families:
  * windowed: each feature's window is copied once (`extract_windows*`,
    which take the kernel in `extract` on CUDA tensors), and bilinear
    samples inside the GN loops are separable hat-weight products against
    the cached windows -- batched matmuls, no per-sample gathers;
  * gather: the four neighbours of every sample read by flat index
    (`bilinear`, `gradient`, `sample_patches` and their `_with_grad`
    forms, each corner index clamped to the image; `bilinear_indexed*`
    and `gradient_indexed` from a stack with a per-item index, the
    top-left corner clamped to [0, W-2] x [0, H-2]). The photometric BA
    templates use `bilinear_indexed`; the others serve callers of the
    package's API (no engine path runs them). `sample_windows*` are the
    flattened (unseparated) form of the windowed samplers.

Sample positions are pixel coordinates (..., 2) in (u=x=col, v=y=row)
order.
"""

from __future__ import annotations

import torch

from vobench.reference.geometry import extract


def extract_windows(img, centers, win: int):
    """Per-feature square windows: img (H, W); centers (N, 2) float.
    Returns (windows (N, win, win), base (N, 2) int32 window origins as
    (x0, y0)). Same dispatch as `extract.extract_windows_fast`."""
    return extract.extract_windows_fast(img, centers, win)


def extract_windows_indexed(imgs, k, centers, win: int):
    """`extract_windows` over a stack (K, H, W) with per-item index k (N,)."""
    return extract.extract_windows_indexed_fast(imgs, k, centers, win)


def _hat_weights(coords, win: int):
    """Linear-interpolation weights (..., win) for coords (...): the hat
    function max(0, 1 - |c - r|) of each grid row r."""
    grid = torch.arange(win, dtype=coords.dtype, device=coords.device)
    return torch.clamp(1.0 - torch.abs(coords[..., None] - grid), min=0.0)


def _hat_weights_grad(coords, win: int):
    """d/dc of `_hat_weights`: -sign(c - r) on the hat support."""
    grid = torch.arange(win, dtype=coords.dtype, device=coords.device)
    d = coords[..., None] - grid
    return torch.where(torch.abs(d) < 1.0, -torch.sign(d), 0.0)


def _axis_coords(windows, base, centers, half):
    """Per-axis window-relative sample coordinates (N, P), P = 2*half, of
    an axis-aligned patch grid centered at `centers`, clamped to the
    window."""
    rows, win = windows.shape[-2], windows.shape[-1]
    r = torch.arange(-half, half, dtype=centers.dtype, device=centers.device)
    us = torch.clamp(centers[:, 0:1] - base[:, 0:1] + r[None], 0.0, win - 1.0)
    vs = torch.clamp(centers[:, 1:2] - base[:, 1:2] + r[None], 0.0, rows - 1.0)
    return us, vs


def _separable(windows, us, vs, need_grad: bool):
    """Samples of windows (N, rows, win) on the grid of per-axis
    coordinates us, vs (N, P): values (N, P, P), rows indexed by v, columns
    by u, and with `need_grad` the exact bilinear-surface gradients gx, gy
    (N, P, P)."""
    rows, win = windows.shape[-2], windows.shape[-1]
    Wu = _hat_weights(us, win)                         # (N, P, win)
    Wv = _hat_weights(vs, rows)
    Ty = torch.einsum("npy,nyx->npx", Wv, windows)     # rows pass
    vals = torch.einsum("npx,nqx->npq", Ty, Wu)        # cols pass
    if not need_grad:
        return vals
    gx = torch.einsum("npx,nqx->npq", Ty, _hat_weights_grad(us, win))
    Tdy = torch.einsum("npy,nyx->npx", _hat_weights_grad(vs, rows), windows)
    gy = torch.einsum("npx,nqx->npq", Tdy, Wu)
    return vals, gx, gy


def sample_patch_grid(windows, base, centers, half: int):
    """Bilinear (N, P, P) patch samples from cached windows, separable:
    rows indexed by v, columns by u."""
    return _separable(windows, *_axis_coords(windows, base, centers, half), need_grad=False)


def sample_patch_grid_with_grad(windows, base, centers, half: int):
    """Separable patch samples plus exact bilinear-surface gradients:
    (vals, gx, gy), each (N, P, P)."""
    return _separable(windows, *_axis_coords(windows, base, centers, half), need_grad=True)


def _scaled_axis_coords(windows, base, centers, half, scale):
    """`_axis_coords` with per-item grid spacing scale (N,)."""
    rows, win = windows.shape[-2], windows.shape[-1]
    r = torch.arange(-half, half, dtype=centers.dtype, device=centers.device)
    us = torch.clamp(
        centers[:, 0:1] - base[:, 0:1] + r[None] * scale[:, None],
        0.0, win - 1.0,
    )
    vs = torch.clamp(
        centers[:, 1:2] - base[:, 1:2] + r[None] * scale[:, None],
        0.0, rows - 1.0,
    )
    return us, vs


def sample_patch_grid_scaled(windows, base, centers, half: int, scale):
    """`sample_patch_grid` with per-item grid spacing scale (N,): sample
    coords = centers + r * scale, r in [-half, half)."""
    us, vs = _scaled_axis_coords(windows, base, centers, half, scale)
    return _separable(windows, us, vs, need_grad=False)


def sample_patch_grid_scaled_with_grad(windows, base, centers, half: int, scale):
    """`sample_patch_grid_with_grad` with per-item grid spacing scale (N,).
    Gradients are wrt the image coordinate at each sample. Returns
    (vals, gx, gy), each (N, P, P)."""
    us, vs = _scaled_axis_coords(windows, base, centers, half, scale)
    return _separable(windows, us, vs, need_grad=True)


def sample_windows(windows, base, uv):
    """Bilinear samples from cached windows (N, win, win) with origins base
    (N, 2) at absolute coordinates uv (N, P, Q, 2) -> (N, P, Q); the
    coordinates clamped to each window's border."""
    return _sample_windows(windows, base, uv, False)


def sample_windows_with_grad(windows, base, uv):
    """`sample_windows` plus the exact bilinear-surface gradients
    (N, P, Q, 2)."""
    return _sample_windows(windows, base, uv, True)


def _sample_windows(windows, base, uv, need_grad: bool):
    rows, win = windows.shape[-2], windows.shape[-1]
    n, P, Q = uv.shape[0], uv.shape[1], uv.shape[2]
    us = torch.clamp(uv[..., 0] - base[:, None, None, 0], 0.0, win - 1.0).reshape(n, P * Q)
    vs = torch.clamp(uv[..., 1] - base[:, None, None, 1], 0.0, rows - 1.0).reshape(n, P * Q)
    Wx = _hat_weights(us, win)
    Wy = _hat_weights(vs, rows)
    if not need_grad:
        return torch.einsum("nsy,nyx,nsx->ns", Wy, windows, Wx).reshape(n, P, Q)
    Ty = torch.einsum("nsy,nyx->nsx", Wy, windows)     # shared row pass
    vals = torch.einsum("nsx,nsx->ns", Ty, Wx)
    gx = torch.einsum("nsx,nsx->ns", Ty, _hat_weights_grad(us, win))
    Tdy = torch.einsum("nsy,nyx->nsx", _hat_weights_grad(vs, rows), windows)
    gy = torch.einsum("nsx,nsx->ns", Tdy, Wx)
    return vals.reshape(n, P, Q), torch.stack([gx, gy], dim=-1).reshape(n, P, Q, 2)


# -- gather samplers ------------------------------------------------------

def _corners(uv):
    """Bilinear fractions fx, fy and top-left corner (x0, y0) of uv."""
    u, v = uv[..., 0], uv[..., 1]
    x0, y0 = torch.floor(u), torch.floor(v)
    return u - x0, v - y0, x0.to(torch.int64), y0.to(torch.int64)


def _blend(fx, fy, v00, v01, v10, v11):
    return (
        (1 - fx) * (1 - fy) * v00
        + fx * (1 - fy) * v01
        + (1 - fx) * fy * v10
        + fx * fy * v11
    )


def _surface_grad(fx, fy, v00, v01, v10, v11):
    """The exact gradient (..., 2) of the bilinear interpolant."""
    gx = (1 - fy) * (v01 - v00) + fy * (v11 - v10)
    gy = (1 - fx) * (v10 - v00) + fx * (v11 - v01)
    return torch.stack([gx, gy], dim=-1)


def _neighbours(img, uv):
    """fx, fy and the four neighbours of uv in img (..., H, W), each
    corner's row and column clamped to the image."""
    H, W = img.shape[-2], img.shape[-1]
    flat = img.reshape(img.shape[:-2] + (H * W,))
    fx, fy, x0, y0 = _corners(uv)

    def at(y, x):
        return flat[..., torch.clamp(y, 0, H - 1) * W + torch.clamp(x, 0, W - 1)]

    return fx, fy, (at(y0, x0), at(y0, x0 + 1), at(y0 + 1, x0), at(y0 + 1, x0 + 1))


def _neighbours_indexed(imgs, k, uv):
    """fx, fy and the four neighbours of uv (N, ..., 2) in imgs[k[n]]
    (K, H, W), the top-left corner clamped to [0, W-2] x [0, H-2]."""
    K, H, W = imgs.shape
    flat = imgs.reshape(-1)
    fx, fy, x0, y0 = _corners(uv)
    x0i = torch.clamp(x0, 0, W - 2)
    y0i = torch.clamp(y0, 0, H - 2)
    k_b = k.to(torch.int64).reshape((k.shape[0],) + (1,) * (uv.dim() - 2))
    i00 = k_b * (H * W) + y0i * W + x0i
    return fx, fy, (flat[i00], flat[i00 + 1], flat[i00 + W], flat[i00 + W + 1])


def bilinear(img, uv):
    """Bilinear sample img (H, W) at uv (..., 2) -> (...)."""
    fx, fy, v = _neighbours(img, uv)
    return _blend(fx, fy, *v)


def bilinear_with_grad(img, uv):
    """Bilinear value (...) and exact surface gradient (..., 2) from the
    same four reads."""
    fx, fy, v = _neighbours(img, uv)
    return _blend(fx, fy, *v), _surface_grad(fx, fy, *v)


def bilinear_indexed(imgs, k, uv):
    """Bilinear sample from a stack imgs (K, H, W), item n from image k[n]:
    k (N,), uv (N, ..., 2) -> (N, ...). One flat gather, corners clamped
    to [0, W-2] x [0, H-2]."""
    fx, fy, v = _neighbours_indexed(imgs, k, uv)
    return _blend(fx, fy, *v)


def bilinear_indexed_with_grad(imgs, k, uv):
    """`bilinear_with_grad` over a stack with a per-item index (as
    `bilinear_indexed`): (values (N, ...), gradients (N, ..., 2))."""
    fx, fy, v = _neighbours_indexed(imgs, k, uv)
    return _blend(fx, fy, *v), _surface_grad(fx, fy, *v)


def _central(sample, uv, delta: float):
    """Central differences (..., 2) [gx, gy] of `sample` at uv, +-delta."""
    du, dv = torch.zeros_like(uv), torch.zeros_like(uv)
    du[..., 0].fill_(delta)
    dv[..., 1].fill_(delta)
    gx = (sample(uv + du) - sample(uv - du)) / (2.0 * delta)
    gy = (sample(uv + dv) - sample(uv - dv)) / (2.0 * delta)
    return torch.stack([gx, gy], dim=-1)


def gradient(img, uv, delta: float = 1.0):
    """Central-difference gradient (..., 2) [gx, gy] of the bilinear
    interpolant at uv (..., 2), +-delta pixels."""
    return _central(lambda x: bilinear(img, x), uv, delta)


def gradient_indexed(imgs, k, uv, delta: float = 1.0):
    """Central-difference gradient (..., 2) of `bilinear_indexed` samples."""
    return _central(lambda x: bilinear_indexed(imgs, k, x), uv, delta)


def _patch_uv(centers, half: int):
    """(N, P, P, 2) sample coordinates of square patches around centers."""
    return centers[:, None, None, :] + patch_offsets(half, centers.dtype, centers.device)[None]


def sample_patches(img, centers, half: int):
    """Bilinear (N, 2*half, 2*half) patches of img (H, W) around centers
    (N, 2)."""
    return bilinear(img, _patch_uv(centers, half))


def sample_patches_with_grad(img, centers, half: int):
    """Patches (N, P, P) plus central-difference gradients (N, P, P, 2)."""
    uv = _patch_uv(centers, half)
    return bilinear(img, uv), gradient(img, uv)


def patch_offsets(half: int, dtype=torch.float32, device=None):
    """Dense (2*half, 2*half, 2) grid of integer offsets in [-half, half),
    in (du, dv) order: rows vary v, columns vary u."""
    r = torch.arange(-half, half, dtype=dtype, device=device)
    oy, ox = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([ox, oy], dim=-1)
