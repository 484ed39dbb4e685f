"""Build and load the port's CUDA kernels (`viso_tpu_torch/csrc/*.cu`).

Each source is compiled by nvcc for `sm_90a` into its own plain-C shared
library under `build/viso_tpu_torch/` at the root of the checkout, keyed
by a hash of the source and the flags, and loaded through ctypes. Nothing
here runs when a module is imported: a kernel is built at its first
launch (or up front by `build_all`, which runs one nvcc per source at
once).

Raises RuntimeError, with the compiler's output, when nvcc is missing or
a build fails; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent
CSRC = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "viso_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# Toolkit roots searched after $CUDA_HOME / $CUDA_PATH and $PATH.
CUDA_ROOTS = ("/usr/local/cuda",)

_LIBS: dict = {}            # source path -> loaded, bound ctypes library
_LOCK = threading.Lock()


def find_nvcc():
    """Path of nvcc, or None when no CUDA toolkit is installed."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    for root in CUDA_ROOTS:
        if Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    return None


def sources():
    """Every kernel source of the package, sorted."""
    return sorted(CSRC.glob("*.cu"))


def library_path(source) -> Path:
    source = Path(source)
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def _nvcc_or_raise(source) -> str:
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build {Path(source).name}: nvcc not found "
            "(set CUDA_HOME or put nvcc on PATH)"
        )
    return nvcc


def build_library(source) -> Path:
    """Compile one source if it is not built yet; return the library path."""
    path = library_path(source)
    if path.is_file():
        return path
    nvcc = _nvcc_or_raise(source)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source}:\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, path)
    return path


def build_all() -> list:
    """`build_library` for every source, all at once (one nvcc each);
    returns the library paths in the order of `sources()` and raises with
    every failing source's output."""
    srcs = sources()
    with ThreadPoolExecutor(max(1, len(srcs))) as pool:
        futures = [pool.submit(build_library, s) for s in srcs]
    errors = [str(f.exception()) for f in futures if f.exception() is not None]
    if errors:
        raise RuntimeError("\n".join(errors))
    return [f.result() for f in futures]


def load_library(source, bind):
    """Build (if needed) and load one kernel library, cached per process.

    `bind(lib)` sets the argtypes and restype of the library's C entry
    points once, when it is first loaded. Every library also exports
    `int viso_empty(void* stream)`, an empty kernel (the launch floor),
    bound here. A loaded library is returned without taking the lock."""
    source = Path(source)
    lib = _LIBS.get(source)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(source)))
            bind(lib)
            lib.viso_empty.argtypes = [ctypes.c_void_p]
            lib.viso_empty.restype = ctypes.c_int
            _LIBS[source] = lib
    return lib


def launch_empty(lib):
    """Launch the library's empty kernel on the current CUDA stream; raises
    if the launch is refused."""
    import torch

    err = lib.viso_empty(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")
