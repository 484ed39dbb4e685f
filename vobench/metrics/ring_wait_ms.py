"""`ring_wait_ms` (ingestion layer, `data/native.py`'s prefetch ring):
the median over the window's frames of the host time blocked reading a
frame's images from the ring. Nothing for a feed without a ring."""

import numpy as np


def read(run):
    return float(np.median(run.ring_waits)) * 1e3 if run.ring_waits else None
