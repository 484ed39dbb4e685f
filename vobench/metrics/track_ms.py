"""`track_ms` (programs layer, `slam/programs.py`, the track program's
CUDA graph replay): the median over the window's frames of the stream
time between CUDA events recorded around each call."""

import numpy as np


def read(run):
    ms = [v for _, v in run.program_ms.get("track", []) if np.isfinite(v)]
    return float(np.median(ms)) if ms else None
