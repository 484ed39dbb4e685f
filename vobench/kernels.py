"""The yardstick's table of peaks and the least work of the port's
kernels, counted from the shapes of their calls (never from the program).

K1 (`viso_tpu_torch/csrc/extract_windows.cu`) copies N (h, w) float32
windows: each window is read once and written once, 2 * N * h * w * 4
bytes (`viso_tpu_torch/tools/bench_extract.bound_ms`'s count), so its
least time is those bytes at the card's memory rate. A configuration
file lists the shapes of the track program's K1 calls
(`k1_track_calls`, as `viso_tpu_torch/tools/bench_k1.MAIN_PATH_CASES`
lists them), so the count reads the same work whatever implements it.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB, NVIDIA's data sheet, at its 700 W limit.
H100_HBM_BYTES_PER_S = 3.35e12
K1_KERNEL = "extract_windows_kernel"


def k1_bytes(n: int, h: int, w: int) -> int:
    """Bytes a K1 call of n (h, w) float32 windows must move."""
    return 2 * n * h * w * 4


def k1_bound_s(calls) -> float:
    """Least seconds for K1 calls [(n, h, w), ...] at the HBM rate."""
    return sum(k1_bytes(n, h, w) for n, h, w in calls) / H100_HBM_BYTES_PER_S
