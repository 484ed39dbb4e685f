"""`graph_kernels_per_frame` (programs layer, `slam/programs.py`'s CUDA
graphs): the mean over the window's frames of the kernel nodes of the
graphs replayed for the frame (each program's counted once at its
capture, `Program.kernels`), from the port's frame recorder
(`viso_tpu_torch.utils.profiling.RECORDER`). Nothing without it, or
where a frame's count is not known (on the CPU nothing is a graph)."""

import numpy as np


def read(run):
    try:
        from viso_tpu_torch.utils.profiling import RECORDER
    except ImportError:   # a port without the recorder
        return None
    frames = RECORDER.frames(run.cell.config["warmup_frames"], len(run.host_ms))
    counts = [f.counters.get("graph_kernels") for f in frames]
    if not counts or any(c is None for c in counts):
        return None
    return float(np.mean(counts))
