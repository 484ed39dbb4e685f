"""`host_self_ms` (engine layer, `slam/engine.py` `process()`): the median
over the window's frames of the host ms of the frame's `process` span
less the union of its child spans (upload, program launches, stats
wait): the engine's own host policy and bookkeeping, from the port's
frame recorder (`viso_tpu_torch.utils.profiling.RECORDER`). Nothing
without it."""

import numpy as np


def read(run):
    try:
        from viso_tpu_torch.utils.profiling import RECORDER
    except ImportError:   # a port without the recorder
        return None
    frames = RECORDER.frames(run.cell.config["warmup_frames"], len(run.host_ms))
    return float(np.median([f.self_ms() for f in frames])) if frames else None
