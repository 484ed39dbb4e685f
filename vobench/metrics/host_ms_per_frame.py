"""`host_ms_per_frame` (engine layer, `slam/engine.py` `process()`): the
median over the window's frames of the host clock around each call."""

import numpy as np


def read(run):
    return float(np.median(run.host_ms)) if run.host_ms else None
