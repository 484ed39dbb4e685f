"""`launch_ms` (programs layer, `slam/programs.py`'s replay enqueue): the
median over the window's frames of the host ms of the frame's
`launch.<program>` spans, summed (each program's arguments staged and
its CUDA graph's replay enqueued), from the port's frame recorder
(`viso_tpu_torch.utils.profiling.RECORDER`). Nothing without it."""

import numpy as np


def read(run):
    try:
        from viso_tpu_torch.utils.profiling import RECORDER
    except ImportError:   # a port without the recorder
        return None
    frames = RECORDER.frames(run.cell.config["warmup_frames"], len(run.host_ms))
    return float(np.median([f.span_ms("launch.") for f in frames])) if frames else None
