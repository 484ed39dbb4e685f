"""`keyframe_share` (engine layer, the keyframe decision): the share of
the window's frames that became keyframes, in percent."""

import numpy as np


def read(run):
    return 100.0 * float(np.mean(run.keyframes)) if run.keyframes else None
