"""Row-aligned window extraction (K2): the CUDA kernel and its plain version.

Port of `tools/bench_extract.py::extract_windows_pallas`, the micro-
benchmark's TPU kernel. For N feature centres (N, 2) in (x, y) order it
returns `(win + 8, win)` float32 tiles of an (H, W) float32 image and
their origins, with exactly the tool's origin rule:

    base = clip(floor(c) - win // 2, 0, (W - win, H - (win + 8)))
    base.y &= ~7        (row offsets aligned down to a multiple of 8)

The 8 extra rows keep the window covered at any alignment; samplers that
take the origin explicitly (`sampling.sample_patch_grid`) are agnostic to
the over-copy. K is the number of windows one thread block copies (one
grid step of the TPU kernel), so N must be a multiple of K: the TPU
kernel never writes the windows past (N // K) * K, and the tool skips
such K.

Dispatch is by the device of the image: CPU tensors take the plain
version (`extract_plain`, advanced indexing); CUDA tensors launch the
kernel in `viso_tpu_torch/csrc/extract_aligned.cu` or raise. The copy is
exact, so kernel and plain version are bit-equal. `launch.launches`
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from viso_tpu_torch import _cuda
from viso_tpu_torch.geometry import extract

SOURCE = _cuda.CSRC / "extract_aligned.cu"
ROW_PAD = 8


def _bind(lib):
    lib.viso_extract_aligned.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.viso_extract_aligned.restype = ctypes.c_int


def load_library():
    """Build (if needed) and load the kernel library; cached per process."""
    return _cuda.load_library(SOURCE, _bind)


def _check(img, centers, win: int, K: int):
    if img.dim() != 2:
        raise ValueError(f"image must be (H, W), got {tuple(img.shape)}")
    H, W = img.shape
    if win <= 0 or H < win + ROW_PAD or W < win:
        raise ValueError(
            f"image {(H, W)} is smaller than a ({win + ROW_PAD}, {win}) tile"
        )
    if centers.dim() != 2 or centers.shape[1] != 2:
        raise ValueError("centers must be (N, 2)")
    N = centers.shape[0]
    if K <= 0 or N % K:
        raise ValueError(
            f"N = {N} is not a multiple of K = {K}: the windows past "
            f"(N // K) * K would never be written"
        )


def aligned_base(img_hw, centers, win: int):
    """The tool's tile origins (N, 2) int32 (x0, y0)."""
    H, W = img_hw
    b = torch.floor(centers).to(torch.int32) - win // 2
    x0 = torch.clamp(b[:, 0], 0, W - win)
    y0 = torch.bitwise_and(torch.clamp(b[:, 1], 0, H - (win + ROW_PAD)), ~7)
    return torch.stack([x0, y0], dim=-1)


def extract_plain(img, centers, win: int, K: int):
    """Plain PyTorch version: the origins, then an exact copy of each
    (win + 8, win) tile by advanced indexing."""
    _check(img, centers, win, K)
    base = aligned_base(img.shape, centers, win)
    return extract.extract_plain(img, base, win + ROW_PAD, win), base


def launch(img, centers, win: int, K: int):
    """Launch the CUDA kernel on a contiguous float32 CUDA image and
    contiguous float32 (N, 2) centres on the same device."""
    if img.device.type != "cuda":
        raise ValueError(f"launch needs a CUDA image, got {img.device}")
    if img.dtype != torch.float32 or not img.is_contiguous():
        raise ValueError("image must be contiguous float32")
    if (
        centers.dtype != torch.float32 or not centers.is_contiguous()
        or centers.device != img.device
    ):
        raise ValueError("centers must be contiguous float32 on the image's device")
    _check(img, centers, win, K)
    H, W = img.shape
    N = centers.shape[0]
    if 2 * K * 4 > 48 * 1024:
        raise ValueError(f"K = {K} windows do not fit one block's origin table")
    out = torch.empty((N, win + ROW_PAD, win), dtype=torch.float32, device=img.device)
    base = torch.empty((N, 2), dtype=torch.int32, device=img.device)
    lib = load_library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.viso_extract_aligned(
            img.data_ptr(), H, W, centers.data_ptr(), N, win, K,
            out.data_ptr(), base.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"extract_aligned kernel launch failed: CUDA error {err}")
    launch.launches += 1
    return out, base


launch.launches = 0


def extract_windows_aligned(img, centers, win: int, K: int = 128):
    """(tiles (N, win + 8, win) f32, base (N, 2) int32), K windows per
    thread block. CPU tensors take the plain version; CUDA tensors the
    kernel."""
    if img.device.type == "cpu":
        return extract_plain(img, centers, win, K)
    if img.device.type == "cuda":
        return launch(
            img.to(torch.float32).contiguous(),
            centers.to(torch.float32).contiguous(), win, K,
        )
    raise ValueError(f"no aligned window extractor for device {img.device}")
