"""The benchmark's own 8-bit grayscale PNG encoder (stdlib zlib): one
IHDR, one IDAT of filter-0 scanlines at zlib level 1 (fast, since every
run of the PNG cell writes its frames in set-up), IEND."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(tag + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + tag + payload + struct.pack(">I", crc)


def encode_gray(img: np.ndarray) -> bytes:
    """PNG bytes of a (H, W) uint8 image."""
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"expected (H, W) uint8, got {img.dtype} {img.shape}")
    h, w = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))


def write_gray(path, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_gray(img))
