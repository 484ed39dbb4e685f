"""Per-feature window extraction: the CUDA kernel and its plain version.

Port of `viso_tpu/geometry/extract_pallas.py`. For each of N features,
copy the exact (h, w) image window at origin `base[n] = (x0, y0)` out of
one image (H, W), or out of image `k[n]` of a stack (K, H, W). Reads
follow `lax.dynamic_slice` semantics: a negative origin or `k` counts
from the end once, then the origin is clamped so the window fits and `k`
to [0, K-1]. (The origins on the VO path are never negative.)

Dispatch is by the device of the image:
  * CPU tensors take the plain PyTorch version (`extract_plain`),
    bit-identical to `sampling.extract_windows*` and to a vmap of
    `dynamic_slice` in the JAX package;
  * CUDA tensors launch the hand-written kernel in
    `viso_tpu_torch/csrc/extract_windows.cu` -- or raise. There is no
    fallback, no size threshold and no switch.

The kernel is built with nvcc at first use by `viso_tpu_torch._cuda`
(into `build/viso_tpu_torch/`, keyed by a hash of its source and flags)
and loaded through ctypes. `launch.launches` counts kernel launches so
that a run can show its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from viso_tpu_torch import _cuda

SOURCE = _cuda.CSRC / "extract_windows.cu"


def _bind(lib):
    lib.viso_extract_windows.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.viso_extract_windows.restype = ctypes.c_int


def load_library():
    """Build (if needed) and load the kernel library; cached per process."""
    return _cuda.load_library(SOURCE, _bind)


def launch(img, base, h: int, w: int, k=None):
    """Launch the CUDA kernel: (N, h, w) windows of a CUDA image.

    img f32 (H, W) or (K, H, W); base int32 (N, 2) as (x0, y0); k int32
    (N,) for a stack. All contiguous on one CUDA device. Raises on any
    other input or when the launch is refused.
    """
    indexed = img.dim() == 3
    if img.device.type != "cuda":
        raise ValueError(f"launch needs a CUDA image, got {img.device}")
    if img.dtype != torch.float32 or not img.is_contiguous():
        raise ValueError("image must be contiguous float32")
    if img.dim() not in (2, 3) or indexed != (k is not None):
        raise ValueError("pass k exactly when the image is a (K, H, W) stack")
    K = img.shape[0] if indexed else 1
    H, W = img.shape[-2], img.shape[-1]
    if not (0 < h <= H and 0 < w <= W):
        raise ValueError(f"window {(h, w)} does not fit image {(H, W)}")
    if (
        base.dtype != torch.int32 or base.dim() != 2 or base.shape[1] != 2
        or not base.is_contiguous() or base.device != img.device
    ):
        raise ValueError("base must be contiguous int32 (N, 2) on the image's device")
    N = base.shape[0]
    if k is not None and (
        k.dtype != torch.int32 or k.shape != (N,) or not k.is_contiguous()
        or k.device != img.device
    ):
        raise ValueError("k must be contiguous int32 (N,) on the image's device")
    out = torch.empty((N, h, w), dtype=torch.float32, device=img.device)
    lib = load_library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.viso_extract_windows(
            img.data_ptr(), K, H, W, base.data_ptr(),
            None if k is None else k.data_ptr(), N, h, w,
            out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"extract_windows kernel launch failed: CUDA error {err}")
    launch.launches += 1
    return out


launch.launches = 0


def extract_plain(img, base, h: int, w: int, k=None):
    """Plain PyTorch version of the kernel, dynamic_slice semantics.

    Advanced indexing with an arange grid; bit-identical to the kernel
    and to the JAX package's gather path (a pure copy).
    """
    H, W = img.shape[-2], img.shape[-1]
    dev = img.device
    x0 = _slice_start(base[:, 0].long(), W, w)
    y0 = _slice_start(base[:, 1].long(), H, h)
    rows = (y0[:, None] + torch.arange(h, device=dev))[:, :, None]   # (N,h,1)
    cols = (x0[:, None] + torch.arange(w, device=dev))[:, None, :]   # (N,1,w)
    if k is None:
        return img[rows, cols]
    kk = _slice_start(k.long(), img.shape[0], 1)[:, None, None]
    return img[kk, rows, cols]


def _slice_start(i, dim: int, size: int):
    """lax.dynamic_slice's start index: a negative start counts from the
    end once (i + dim), then the start is clamped to [0, dim - size]."""
    return torch.clamp(torch.where(i < 0, i + dim, i), 0, dim - size)


def _extract(img, base, h: int, w: int, k=None):
    if img.device.type == "cpu":
        return extract_plain(img, base, h, w, k)
    if img.device.type == "cuda":
        return launch(
            img.contiguous(), base.to(torch.int32).contiguous(), h, w,
            None if k is None else k.to(torch.int32).contiguous(),
        )
    raise ValueError(f"no window extractor for device {img.device}")


def centered_base(img_hw, centers, win: int):
    """Origins of `win` x `win` windows centered at `centers` (N, 2):
    floor, subtract win//2, clip to [0, W-win] x [0, H-win]. int32."""
    H, W = img_hw
    b = torch.floor(centers).to(torch.int32) - win // 2
    return torch.stack(
        [torch.clamp(b[:, 0], 0, W - win), torch.clamp(b[:, 1], 0, H - win)],
        dim=-1,
    )


def extract_windows_fast(img, centers, win: int):
    """Square windows centered at `centers` (N, 2) of img (H, W).

    Returns (windows (N, win, win), base (N, 2) int32 (x0, y0))."""
    base = centered_base(img.shape[-2:], centers, win)
    return _extract(img, base, win, win), base


def extract_windows_indexed_fast(imgs, k, centers, win: int):
    """Square windows over a stack (K, H, W), window n from image k[n]."""
    base = centered_base(imgs.shape[-2:], centers, win)
    return _extract(imgs, base, win, win, k=k), base


def extract_rects_fast(img, base, h: int, w: int):
    """Rectangular (h, w) windows at explicit origins base (N, 2) int32.

    Returns (windows (N, h, w), base) -- the base it was given, as the
    JAX package does."""
    return _extract(img, base, h, w), base
