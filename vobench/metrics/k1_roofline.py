"""`k1_roofline` (kernel K1, `geometry/extract.py` + `csrc/
extract_windows.cu`): the least time of the track program's K1 calls
over their device time, in percent. The least time is the bytes each
window is read and written once, at the card's HBM rate, from the call
shapes the configuration lists (`k1_track_calls`; `vobench/kernels.py`);
the device time is that of the `extract_windows_kernel` kernels inside
the track replays of the profiled slice (between their marker kernels).
Nothing when the slice holds no such kernel."""

import sys


def read(run):
    s = run.slice
    if s is None or not s.complete or s.k1_track_s <= 0:
        return None
    print(f"k1_roofline on {run.power_limit} over {len(s.track_intervals)} track replays",
          file=sys.stderr)
    return 100.0 * s.k1_track_bound_s / s.k1_track_s
