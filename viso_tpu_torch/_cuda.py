"""Build and load the port's CUDA kernels (`viso_tpu_torch/csrc/*.cu`).

Each source is compiled by nvcc for `sm_90a` into its own plain-C shared
library under `build/viso_tpu_torch/` at the root of the checkout, keyed
by a hash of the source and the flags, and loaded through ctypes. Nothing
here runs when a module is imported: a kernel is built at its first
launch (or up front by `build_all`, which runs one nvcc per source at
once).

Raises RuntimeError, with the compiler's output, when nvcc is missing or
a build fails; there is no fallback.

`graph_nodes` counts a captured CUDA graph's nodes by type through the
CUDA driver (ctypes too): the programs' kernel counts
(`slam/programs.kernel_nodes`). `Events` are the driver's CUDA events,
for the frame recorder (`utils/profiling`). `cublas_version` reads the
loaded cuBLAS's version (the direct kernel's check of its library
orders, `ops/direct.check_versions`).
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


def cublas_version():
    """The version of the cuBLAS that torch loaded, "major.minor.patch", or
    None where it cannot be read. Opened by its soname, which names the
    library already loaded in the process."""
    import torch

    try:
        torch.cuda.current_blas_handle()   # loads cuBLAS
        lib = ctypes.CDLL(f"libcublas.so.{torch.version.cuda.split('.')[0]}")
        get = lib.cublasGetProperty
    except (AttributeError, OSError, RuntimeError):
        return None
    value, parts = ctypes.c_int(), []
    for prop in range(3):   # MAJOR_VERSION, MINOR_VERSION, PATCH_LEVEL
        if get(prop, ctypes.byref(value)) != 0:
            return None
        parts.append(str(value.value))
    return ".".join(parts)


# The CUDA driver's CUgraphNodeType values that `graph_nodes` names.
GRAPH_NODE_KERNEL = 0
GRAPH_NODE_MEMCPY = 1
GRAPH_NODE_MEMSET = 2
GRAPH_NODE_CHILD = 4
_DRIVER: list = []          # the loaded driver library, once bound


def _driver():
    """The CUDA driver library (`libcuda.so.1`, loaded by PyTorch already),
    with the graph and event calls of `graph_nodes` and `Events` bound."""
    with _LOCK:
        if not _DRIVER:
            drv = ctypes.CDLL("libcuda.so.1")
            p, size_p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
            drv.cuGraphGetNodes.argtypes = [p, p, size_p]
            drv.cuGraphNodeGetType.argtypes = [p, ctypes.POINTER(ctypes.c_int)]
            drv.cuGraphChildGraphNodeGetGraph.argtypes = [p, ctypes.POINTER(p)]
            drv.cuEventCreate.argtypes = [ctypes.POINTER(p), ctypes.c_uint]
            drv.cuEventRecord.argtypes = [p, p]
            drv.cuEventQuery.argtypes = [p]
            drv.cuEventElapsedTime.argtypes = [ctypes.POINTER(ctypes.c_float), p, p]
            drv.cuEventDestroy_v2.argtypes = [p]
            for fn in (drv.cuGraphGetNodes, drv.cuGraphNodeGetType,
                       drv.cuGraphChildGraphNodeGetGraph, drv.cuEventCreate, drv.cuEventRecord,
                       drv.cuEventQuery, drv.cuEventElapsedTime, drv.cuEventDestroy_v2):
                fn.restype = ctypes.c_int
            _DRIVER.append(drv)
    return _DRIVER[0]


class Events:
    """The CUDA driver's events (`CUevent` handles as ints, with timing),
    recorded on a raw stream handle (`torch.cuda.Stream.cuda_stream`) of
    the calling thread's current context, and read without waiting: a
    few microseconds a call cheaper than `torch.cuda.Event`, whose calls
    each set the device. Raises OSError without a driver."""

    def __init__(self):
        drv = _driver()
        self.record = drv.cuEventRecord            # (event, stream) -> error code
        self._query = drv.cuEventQuery
        self._elapsed = drv.cuEventElapsedTime
        self._destroy = drv.cuEventDestroy_v2
        self._create = drv.cuEventCreate
        self._ms = ctypes.c_float()
        self._ms_ref = ctypes.byref(self._ms)

    def create(self) -> int:
        ev = ctypes.c_void_p()
        _check(self._create(ctypes.byref(ev), 0), "cuEventCreate")
        return ev.value

    def done(self, event) -> bool:
        """Whether the work before the event's record has completed."""
        return self._query(event) == 0

    def elapsed_ms(self, start, end):
        """Stream ms between two completed events; None if the driver
        refuses (an event not recorded, or not completed)."""
        return self._ms.value if self._elapsed(self._ms_ref, start, end) == 0 else None

    def destroy(self, event):
        self._destroy(event)


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA driver error {err}")


def graph_nodes(graph: int) -> dict:
    """The nodes of a CUDA graph (a `cudaGraph_t`, as `torch.cuda.CUDAGraph.
    raw_cuda_graph()` gives it) by the driver's node type, the nodes of
    its child graphs counted in place of the child nodes: {type: count}
    (`GRAPH_NODE_KERNEL`: kernels). Raises OSError without a driver and
    RuntimeError when the driver refuses a query."""
    drv = _driver()
    n = ctypes.c_size_t(0)
    _check(drv.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(drv.cuGraphGetNodes(graph, ctypes.cast(nodes, ctypes.c_void_p), ctypes.byref(n)),
           "cuGraphGetNodes")
    counts: dict = {}
    kind = ctypes.c_int(0)
    for node in nodes[:n.value]:
        _check(drv.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value == GRAPH_NODE_CHILD:
            child = ctypes.c_void_p()
            _check(drv.cuGraphChildGraphNodeGetGraph(node, ctypes.byref(child)),
                   "cuGraphChildGraphNodeGetGraph")
            for k, v in graph_nodes(child.value).items():
                counts[k] = counts.get(k, 0) + v
        else:
            counts[kind.value] = counts.get(kind.value, 0) + 1
    return counts
