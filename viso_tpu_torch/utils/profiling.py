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
def device_trace(logdir: str):
    """torch.profiler over the block (CPU, and CUDA where there is a card);
    writes `logdir/trace.json` (Chrome trace format: chrome://tracing or
    Perfetto) and yields the profiler, whose `key_averages()` sums time by
    kernel once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
