"""ctypes bindings to the repository's native ingestion runtime
(`native/viso_native.cpp`; port of `viso_tpu/data/native.py`).

C++ PNG/PGM decoding plus a multi-threaded in-order prefetch ring, so
that host decoding overlaps the device's frame. The library is resolved
from this file (`<repo>/native/libviso_native.so`) and built with
`make -C native` at first use; `available()` reports whether it could be
built and loaded (callers fall back to cv2 otherwise).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libviso_native.so"))

_lib = None
_load_error: str | None = None


def _load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        if not os.path.exists(_LIB_PATH):
            subprocess.run(
                ["make", "-C", os.path.abspath(_NATIVE_DIR)],
                check=True,
                capture_output=True,
            )
        lib = ctypes.CDLL(_LIB_PATH)
        lib.viso_decode_gray.restype = ctypes.c_int
        lib.viso_decode_gray.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.viso_prefetcher_create.restype = ctypes.c_void_p
        lib.viso_prefetcher_create.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.viso_prefetcher_next.restype = ctypes.c_int
        lib.viso_prefetcher_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.viso_prefetcher_destroy.restype = None
        lib.viso_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception as e:  # noqa: BLE001 — record and fall back
        _load_error = str(e)
    return _lib


def available() -> bool:
    return _load() is not None


MAX_PIXELS = 4096 * 3072


def decode_gray(path: str) -> np.ndarray | None:
    """Decode a PNG/PGM file to (H, W) float32, or None on failure."""
    lib = _load()
    if lib is None:
        return None
    buf = np.empty(MAX_PIXELS, np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.viso_decode_gray(
        path.encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(w),
        ctypes.byref(h),
        MAX_PIXELS,
    )
    if rc != 0:
        return None
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


class Prefetcher:
    """In-order multi-threaded decode-ahead over a list of image paths."""

    def __init__(self, paths, ring: int = 8, threads: int = 2):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_load_error}")
        self._lib = lib
        blob = b"".join(p.encode() + b"\0" for p in paths) + b"\0"
        self._handle = lib.viso_prefetcher_create(
            blob, len(paths), ring, threads
        )
        self._n = len(paths)
        self._buf = np.empty(MAX_PIXELS, np.float32)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        w = ctypes.c_int()
        h = ctypes.c_int()
        rc = self._lib.viso_prefetcher_next(
            self._handle,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(w),
            ctypes.byref(h),
            MAX_PIXELS,
        )
        if rc == 1:
            raise StopIteration
        if rc != 0:
            raise IOError("native decode failed")
        return self._buf[: w.value * h.value].reshape(h.value, w.value).copy()

    def close(self):
        if self._handle:
            self._lib.viso_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
