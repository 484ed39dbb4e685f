"""Minimal 8-bit PNG writer, stdlib zlib only (port of
`viso_tpu/data/png_io.py`).

The counterpart of the native decoder (`native/viso_native.cpp`): writes
grayscale frames as the PNG datasets the benchmarks read, and RGB debug
overlays, without cv2 or PIL.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_gray_png(path: str, img, level: int = 6) -> None:
    """Write (H, W) array as an 8-bit grayscale PNG (color type 0)."""
    a = np.asarray(img)
    if a.ndim != 2:
        raise ValueError(f"expected (H, W) grayscale, got {a.shape}")
    _write_png(path, a, color_type=0, level=level)


def write_rgb_png(path: str, img, level: int = 6) -> None:
    """Write (H, W, 3) array as an 8-bit RGB PNG (color type 2) — used
    by the runner's per-frame debug overlays (the headless analogue of
    the reference's cv::imshow rectangles, viso.cpp:123-135)."""
    a = np.asarray(img)
    if a.ndim != 3 or a.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) RGB, got {a.shape}")
    _write_png(path, a, color_type=2, level=level)


def _write_png(path: str, a: np.ndarray, color_type: int, level: int) -> None:
    if a.dtype != np.uint8:
        a = np.clip(a, 0, 255).astype(np.uint8)
    h, w = a.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # Filter byte 0 (None) per scanline.
    raw = b"".join(b"\x00" + a[r].tobytes() for r in range(h))
    idat = zlib.compress(raw, level)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", idat))
        f.write(_chunk(b"IEND", b""))
