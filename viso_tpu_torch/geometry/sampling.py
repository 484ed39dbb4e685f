"""Bilinear image sampling (port of `viso_tpu/geometry/sampling.py`).

Two families:
  * windowed: each feature's window is copied once (`extract_windows*`,
    which take the kernel in `extract` on CUDA tensors), and bilinear
    samples inside the GN loops are separable hat-weight products against
    the cached windows -- batched matmuls, no per-sample gathers;
  * gather: `bilinear_indexed` reads the four neighbours of every sample
    from a stack with a per-item index by flat index, clamped to the
    image. The photometric BA templates use it. (The JAX package's other
    gather samplers have no caller outside its tests and are not ported.)

Sample positions are pixel coordinates (..., 2) in (u=x=col, v=y=row)
order.
"""

from __future__ import annotations

import torch

from viso_tpu_torch.geometry import extract


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


# -- gather sampler ------------------------------------------------------

def bilinear_indexed(imgs, k, uv):
    """Bilinear sample from a stack imgs (K, H, W), item n from image k[n]:
    k (N,), uv (N, ..., 2) -> (N, ...). One flat gather, corners clamped
    to [0, W-2] x [0, H-2]."""
    K, H, W = imgs.shape
    flat = imgs.reshape(-1)
    u, v = uv[..., 0], uv[..., 1]
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx, fy = u - x0, v - y0
    x0i = torch.clamp(x0.to(torch.int64), 0, W - 2)
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 2)
    k_b = k.to(torch.int64).reshape((k.shape[0],) + (1,) * (uv.dim() - 2))
    i00 = k_b * (H * W) + y0i * W + x0i
    return (
        (1 - fx) * (1 - fy) * flat[i00]
        + fx * (1 - fy) * flat[i00 + 1]
        + (1 - fx) * fy * flat[i00 + W]
        + fx * fy * flat[i00 + W + 1]
    )


def patch_offsets(half: int, dtype=torch.float32, device=None):
    """Dense (2*half, 2*half, 2) grid of integer offsets in [-half, half),
    in (du, dv) order: rows vary v, columns vary u."""
    r = torch.arange(-half, half, dtype=dtype, device=device)
    oy, ox = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([ox, oy], dim=-1)
