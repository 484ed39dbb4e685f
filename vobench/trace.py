"""The traced run's device timeline: a fixed slice of the window's frames
under `torch.profiler`, fenced as `viso_tpu_torch.utils.profiling.
profile_stage` fences a stage (the device synchronised, then FENCE_KERNELS
launches of K1's library's empty kernel on each side), with a marker
kernel (`torch.cuda._sleep`, "spin_kernel") enqueued just before and just
after each call of the track program, so that the kernels of a track
replay can be told apart on the device's clock.

`Slice` reduces the profiler's events to what the per-layer readers and
the result's `device` and `breakdown` read: the device's busy and total
seconds, the kernels by name, the idle gaps by what the host was doing,
and each track replay's K1 time.
"""

from __future__ import annotations

from collections import defaultdict

import torch

from vobench import kernels

FENCE_KERNELS = 256
FENCE_NAME = "empty_kernel"
MARKER_NAME = "spin_kernel"
ANNOTATION = "vobench."   # prefix of the harness's host ranges (record_function)
TOP = 10


def fence(device):
    """Synchronise, launch the fence kernels, synchronise."""
    from viso_tpu_torch import _cuda
    from viso_tpu_torch.geometry import extract

    lib = extract.load_library()
    torch.cuda.synchronize(device)
    for _ in range(FENCE_KERNELS):
        _cuda.launch_empty(lib)
    torch.cuda.synchronize(device)


def marker():
    torch.cuda._sleep(1)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Slice:
    """The device timeline of one profiled slice (times in seconds)."""

    def __init__(self, events, frames: int, track_calls: int, k1_track_calls):
        cuda = torch.autograd.DeviceType.CUDA
        # The device's operations; the host ranges that the profiler mirrors
        # onto the device's timeline (user annotations) are not among them.
        dev = [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6) for e in events
               if e.device_type == cuda and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith((ANNOTATION, "ProfilerStep"))]
        host = [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6) for e in events
                if e.device_type != cuda and e.name.startswith(ANNOTATION)]
        self.fences = [d for d in dev if FENCE_NAME in d[0]]
        markers = sorted(d for d in dev if MARKER_NAME in d[0])
        self.work = [d for d in dev if FENCE_NAME not in d[0] and MARKER_NAME not in d[0]]
        self.host = host
        self.frames = frames
        self.complete = bool(self.work) and bool(self.fences) and (
            min(f[1] for f in self.fences) < min(w[1] for w in self.work)
            and max(f[2] for f in self.fences) > max(w[2] for w in self.work))
        if self.work:
            self.start = min(w[1] for w in self.work)
            self.end = max(w[2] for w in self.work)
        else:
            self.start = self.end = 0.0
        self.merged = _merge([(s, e) for _, s, e in self.work])
        self.busy_s = sum(e - s for s, e in self.merged)
        self.window_s = self.end - self.start
        # Track replays between their markers; their K1 kernels.
        self.track_intervals = []
        if len(markers) == 2 * track_calls:
            self.track_intervals = [(markers[2 * i][2], markers[2 * i + 1][1])
                                    for i in range(track_calls)]
        self.markers = len(markers)
        self.k1_track_s = sum(
            e - s for name, s, e in self.work if kernels.K1_KERNEL in name
            and any(a <= s and e <= b for a, b in self.track_intervals))
        self.k1_track_bound_s = len(self.track_intervals) * kernels.k1_bound_s(k1_track_calls)

    def device_ops(self):
        """[[name, seconds]]: the device operations that took the most time."""
        by = defaultdict(float)
        for name, s, e in self.work:
            by[name[:120]] += e - s
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self):
        """[[name, seconds]]: the device's idle time inside the slice, summed
        by the innermost harness range the host was in when each gap began."""
        by = defaultdict(float)
        for (_, e0), (s1, _) in zip(self.merged, self.merged[1:]):
            inner = [h for h in self.host if h[1] <= e0 < h[2]]
            name = max(inner, key=lambda h: h[1])[0] if inner else "host outside the harness"
            by[name] += s1 - e0
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]
