"""Per-feature window extraction: the CUDA kernel K1 and its plain version.

Port of `viso_tpu/geometry/extract_pallas.py`. For each of N features,
copy the exact (h, w) image window out of one image (H, W), or out of
image `k[n]` of a stack (K, H, W). Three entries, one kernel:

  * explicit origins `base[n] = (x0, y0)` (`extract_rects_fast`, `launch`),
    with `lax.dynamic_slice` semantics: a negative origin or `k` counts
    from the end once, then the origin is clamped so the window fits and
    `k` to [0, K-1]. (The origins on the VO path are never negative.);
  * centred square windows (`extract_windows_fast`,
    `extract_windows_indexed_fast`, `launch_centered`): the origin is
    `centered_base`, computed by the kernel and returned beside the
    windows;
  * two sources (`extract_windows_two_source`): centred windows of a
    keyframe stack and of the current image in one launch and one output
    block, with no concatenated copy of the images.

Dispatch is by the device of the image:
  * CPU tensors take the plain PyTorch version (`extract_plain` over
    `centered_base`), bit-identical to `sampling.extract_windows*` and to
    a vmap of `dynamic_slice` in the JAX package;
  * CUDA tensors launch the hand-written kernel in
    `viso_tpu_torch/csrc/extract_windows.cu` -- or raise. There is no
    fallback, no size threshold and no switch.

The kernel is built with nvcc at first use by `viso_tpu_torch._cuda`
(into `build/viso_tpu_torch/`, keyed by a hash of its source and flags)
and loaded through ctypes. `launch.launches` counts K1's launches, from
every entry, so that a run can show its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from viso_tpu_torch import _cuda

SOURCE = _cuda.CSRC / "extract_windows.cu"


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.viso_extract_windows.argtypes = [p, i, i, i, p, p, i, i, i, p, p]
    lib.viso_extract_windows.restype = i
    lib.viso_extract_centered.argtypes = [p, i, i, i, p, p, i, p, p, i, i, p, p, p]
    lib.viso_extract_centered.restype = i


def load_library():
    """Build (if needed) and load the kernel library; cached per process."""
    return _cuda.load_library(SOURCE, _bind)


def _check_image(img, stack: bool):
    if img.device.type != "cuda":
        raise ValueError(f"launch needs a CUDA image, got {img.device}")
    if img.dtype != torch.float32 or not img.is_contiguous():
        raise ValueError("image must be contiguous float32")
    if img.dim() != (3 if stack else 2):
        raise ValueError("pass k exactly when the image is a (K, H, W) stack")


def _check_index(t, dtype, shape, img, what):
    if (
        t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
        or t.device != img.device
    ):
        raise ValueError(f"{what} must be contiguous {dtype} {shape} on the image's device")


def _run(fn, dev, *args):
    """Call a C entry on `dev`'s current stream, tensors by data pointer
    (None as a null pointer); raise on a non-zero return, else count."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), stream)
    if err != 0:
        raise RuntimeError(f"extract_windows kernel launch failed: CUDA error {err}")
    launch.launches += 1


def launch(img, base, h: int, w: int, k=None):
    """Launch the kernel at explicit origins: (N, h, w) windows of a CUDA
    image.

    img f32 (H, W) or (K, H, W); base int32 (N, 2) as (x0, y0); k int32
    (N,) for a stack. All contiguous on one CUDA device. Raises on any
    other input or when the launch is refused.
    """
    _check_image(img, k is not None)
    K = img.shape[0] if k is not None else 1
    H, W = img.shape[-2], img.shape[-1]
    if not (0 < h <= H and 0 < w <= W):
        raise ValueError(f"window {(h, w)} does not fit image {(H, W)}")
    if base.dim() != 2:
        raise ValueError("base must be contiguous int32 (N, 2) on the image's device")
    N = base.shape[0]
    _check_index(base, torch.int32, (N, 2), img, "base")
    if k is not None:
        _check_index(k, torch.int32, (N,), img, "k")
    out = torch.empty((N, h, w), dtype=torch.float32, device=img.device)
    _run(load_library().viso_extract_windows, img.device, img, K, H, W, base, k, N, h, w, out)
    return out


launch.launches = 0


def launch_centered(img, centers, win: int, k=None, img2=None, centers2=None):
    """Launch the kernel for centred `win` x `win` windows.

    img f32 (H, W), or (K, H, W) with k int32 (N,); centers f32 (N, 2);
    optionally a second image img2 f32 (H, W) with centers2 f32 (N2, 2),
    whose windows follow. Returns (windows (N + N2, win, win), base
    (N + N2, 2) int32 = `centered_base`). Raises on any other input or
    when the launch is refused.
    """
    _check_image(img, k is not None)
    K = img.shape[0] if k is not None else 1
    H, W = img.shape[-2], img.shape[-1]
    if not (0 < win <= min(H, W)):
        raise ValueError(f"window {win} does not fit image {(H, W)}")
    if centers.dim() != 2:
        raise ValueError("centers must be contiguous float32 (N, 2) on the image's device")
    N = centers.shape[0]
    _check_index(centers, torch.float32, (N, 2), img, "centers")
    if k is not None:
        _check_index(k, torch.int32, (N,), img, "k")
    N2 = 0
    if img2 is not None:
        _check_image(img2, False)
        if tuple(img2.shape) != (H, W) or img2.device != img.device:
            raise ValueError(f"second image must be ({H}, {W}) on the image's device")
        if centers2.dim() != 2:
            raise ValueError("centers2 must be contiguous float32 (N2, 2)")
        N2 = centers2.shape[0]
        _check_index(centers2, torch.float32, (N2, 2), img, "centers2")
    out = torch.empty((N + N2, win, win), dtype=torch.float32, device=img.device)
    base = torch.empty((N + N2, 2), dtype=torch.int32, device=img.device)
    _run(load_library().viso_extract_centered, img.device, img, K, H, W, k, centers, N,
         img2, centers2, N2, win, out, base)
    return out, base


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


def centered_base(img_hw, centers, win: int):
    """Origins of `win` x `win` windows centered at `centers` (N, 2):
    floor, subtract win//2, clip to [0, W-win] x [0, H-win]. int32."""
    H, W = img_hw
    b = torch.floor(centers).to(torch.int32) - win // 2
    return torch.stack(
        [torch.clamp(b[:, 0], 0, W - win), torch.clamp(b[:, 1], 0, H - win)],
        dim=-1,
    )


def centered_plain(img, centers, win: int, k=None):
    """Plain version of the centred entries: (windows, `centered_base`)."""
    base = centered_base(img.shape[-2:], centers, win)
    return extract_plain(img, base, win, win, k=k), base


def two_source_plain(stack, k, centers, img, centers2, win: int):
    """Plain version of `extract_windows_two_source`."""
    w1, b1 = centered_plain(stack, centers, win, k=k)
    w2, b2 = centered_plain(img, centers2, win)
    return torch.cat([w1, w2]), torch.cat([b1, b2])


def _device_of(img):
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no window extractor for device {img.device}")
    return img.device.type


def extract_windows_fast(img, centers, win: int):
    """Square windows centered at `centers` (N, 2) of img (H, W).

    Returns (windows (N, win, win), base (N, 2) int32 (x0, y0))."""
    if _device_of(img) == "cpu":
        return centered_plain(img, centers, win)
    return launch_centered(img.contiguous(), centers.contiguous(), win)


def extract_windows_indexed_fast(imgs, k, centers, win: int):
    """Square windows over a stack (K, H, W), window n from image k[n]."""
    if _device_of(imgs) == "cpu":
        return centered_plain(imgs, centers, win, k=k)
    return launch_centered(imgs.contiguous(), centers.contiguous(), win,
                           k=k.to(torch.int32).contiguous())


def extract_windows_two_source(stack, k, centers, img, centers2, win: int):
    """Square windows of two sources in one block: n windows of the stack
    (K, H, W) (window i from image k[i], centred at centers[i]), then
    n2 of img (H, W) centred at centers2. Returns (windows (n + n2, win,
    win), base (n + n2, 2) int32) -- what `extract_windows_indexed_fast`
    gives over the stack with img appended as image K, without the copy."""
    if _device_of(stack) == "cpu":
        return two_source_plain(stack, k, centers, img, centers2, win)
    return launch_centered(stack.contiguous(), centers.contiguous(), win,
                           k=k.to(torch.int32).contiguous(), img2=img.contiguous(),
                           centers2=centers2.contiguous())


def extract_rects_fast(img, base, h: int, w: int):
    """Rectangular (h, w) windows at explicit origins base (N, 2) int32.

    Returns (windows (N, h, w), base) -- the base it was given, as the
    JAX package does."""
    if _device_of(img) == "cpu":
        return extract_plain(img, base, h, w), base
    return launch(img.contiguous(), base.to(torch.int32).contiguous(), h, w), base
