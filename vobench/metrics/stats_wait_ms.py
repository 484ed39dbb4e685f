"""`stats_wait_ms` (engine layer, `slam/engine.py`'s stats pipeline): the
median over the window's frames of the host ms in each frame's
`stats_wait` spans, where a stats sample is read on the host (and waited
for when it has not landed), from the port's frame recorder
(`viso_tpu_torch.utils.profiling.RECORDER`). Nothing without it."""

import numpy as np


def read(run):
    try:
        from viso_tpu_torch.utils.profiling import RECORDER
    except ImportError:   # a port without the recorder
        return None
    frames = RECORDER.frames(run.cell.config["warmup_frames"], len(run.host_ms))
    return float(np.median([f.span_ms("stats_wait") for f in frames])) if frames else None
