"""Profiling hooks: wall-clock stage timers and torch.profiler traces
(port of `viso_tpu/utils/profiling.py`)."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def _cuda_devices(out):
    """The CUDA devices of the tensors in `out` (nested tuples, lists and
    dicts)."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return set().union(*(_cuda_devices(x) for x in out)) if out else set()
    return set()


class StageTimer:
    """Accumulating per-stage wall-clock timer.

    `timed(..., block=True)` (the default) synchronises the device of every
    CUDA tensor in the result before it stops the clock, so that
    asynchronous launches do not hide device time.
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        yield
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def timed(self, name: str, fn, *args, block: bool = True, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if block:
            for dev in _cuda_devices(out):
                torch.cuda.synchronize(dev)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

    def report(self):
        rows = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            total = self.totals[name]
            n = self.counts[name]
            rows.append(
                f"{name:32s} {total * 1e3:9.1f} ms total  "
                f"{total / n * 1e3:8.2f} ms/call  x{n}"
            )
        return "\n".join(rows)


@contextlib.contextmanager
def device_trace(logdir: str | None):
    """torch.profiler over the block (CPU, and CUDA where there is a card);
    writes `logdir/trace.json` (Chrome trace format: chrome://tracing or
    Perfetto) unless `logdir` is None, and yields the profiler, whose
    `key_averages()` sums time by kernel once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    if logdir is not None:
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# A torch.profiler window can miss kernels at its ends: on the H100 one
# lost a few dozen, and a window of a fresh process one fence kernel, at
# its start; another recorded none of a 21-kernel stage. profile_stage
# fences the stage with this many `torch.cuda._sleep` kernels
# (`spin_kernel`) on both sides, each side synchronised, and takes the
# window again (at most PROFILER_TRIES windows) until the stage's kernels
# lie between fence kernels on both sides.
PROFILER_PAD_KERNELS = 256
PAD_KERNEL = "spin_kernel"
PROFILER_TRIES = 4


def window_kernels(events):
    """The stage's CUDA kernels in one profiler window's `events`, and the
    fence kernels recorded before the first of them and after the last
    (both None when the window holds none of the stage's kernels). The
    window holds the whole stage when both counts are above 0."""
    cuda = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in cuda if PAD_KERNEL not in e.name]
    if not kernels:
        return kernels, None, None
    pads = [e for e in cuda if PAD_KERNEL in e.name]
    first = min(e.time_range.start for e in kernels)
    last = max(e.time_range.end for e in kernels)
    return (kernels, sum(e.time_range.end <= first for e in pads),
            sum(e.time_range.start >= last for e in pads))


def profile_stage(name: str, fn, reps: int = 5, counter=None) -> dict:
    """Time one stage `fn()` on the device of its result, after a warm-up
    call:

      host_ms    per call on the host clock, no synchronisation: the
                 enqueue (the stage's critical path on a launch-bound host);
      wall_ms    per call on the host clock ending in synchronisation
                 (`StageTimer.timed`);
      stream_ms  per call between CUDA events on the current stream around
                 `reps` back-to-back calls: device time plus the gaps the
                 host leaves (None on the CPU);
      kernels, device_ms
                 the CUDA kernels of one call under `device_trace` and the
                 sum of their device times: the device's busy time (None
                 on the CPU);
      tries, fence
                 the profiler windows taken for them, and the last one's
                 fence kernels before and after the stage
                 (`window_kernels`; None on the CPU);
      launches   how far `counter()` moved over that one call (None
                 without a counter).
    """
    timer = StageTimer()
    devs = _cuda_devices(fn())

    def sync():
        for dev in devs:
            torch.cuda.synchronize(dev)

    sync()
    with timer.time("enqueue"):
        for _ in range(reps):
            fn()
    sync()
    for _ in range(reps):
        timer.timed("wall", fn)
    out = dict(name=name, reps=reps, host_ms=timer.totals["enqueue"] * 1e3 / reps,
               wall_ms=timer.totals["wall"] * 1e3 / reps,
               stream_ms=None, device_ms=None, kernels=None, tries=None, fence=None,
               launches=None)
    if devs:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out["stream_ms"] = start.elapsed_time(end) / reps

    def pad():
        for dev in devs:
            with torch.cuda.device(dev):
                for _ in range(PROFILER_PAD_KERNELS):
                    torch.cuda._sleep(1)
        sync()

    for tries in range(1, (PROFILER_TRIES if devs else 1) + 1):
        with device_trace(None) as prof:
            pad()
            before = counter() if counter is not None else None
            fn()
            sync()
            out["launches"] = counter() - before if counter is not None else None
            pad()
        if not devs:
            break
        kernels, pre, post = window_kernels(prof.events())
        out.update(kernels=len(kernels), device_ms=sum(e.device_time for e in kernels) / 1e3,
                   tries=tries, fence=[pre, post])
        if pre and post:
            break
    return out
