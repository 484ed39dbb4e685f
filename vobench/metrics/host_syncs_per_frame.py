"""`host_syncs_per_frame` (engine layer, `slam/engine.py` `process()`): the
mean over the window's frames of the frame's `host_syncs` counter (a
stats sample not landed when read, or another read of a device tensor on
the host), from the port's frame recorder
(`viso_tpu_torch.utils.profiling.RECORDER`). Nothing without it."""

import numpy as np


def read(run):
    try:
        from viso_tpu_torch.utils.profiling import RECORDER
    except ImportError:   # a port without the recorder
        return None
    frames = RECORDER.frames(run.cell.config["warmup_frames"], len(run.host_ms))
    return float(np.mean([f.counters.get("host_syncs", 0) for f in frames])) if frames else None
