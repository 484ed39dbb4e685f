"""`keyframe_ms` (programs layer: the keyframe insertion, the window BA
and the templates): per keyframe frame of the window, the stream time
between CUDA events around each of the configuration's
`keyframe_programs`, summed; the median over the keyframe frames."""

from collections import defaultdict

import numpy as np


def read(run):
    names = set(run.cell.config["keyframe_programs"])
    per_frame = defaultdict(float)
    for name in names:
        for frame, ms in run.program_ms.get(name, []):
            per_frame[frame] += ms
    ms = [v for v in per_frame.values() if np.isfinite(v)]
    return float(np.median(ms)) if ms else None
