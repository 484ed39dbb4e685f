"""Profiling hooks: wall-clock stage timers and torch.profiler traces
(port of `viso_tpu/utils/profiling.py`), and the engines' frame recorder.

`RECORDER` is the process-wide `FrameRecorder`, a `StageTimer` that also
keeps, for each engine frame, the spans and counters that the engines and
their programs record on the frame's thread (`slam/engine.py`,
`slam/programs.py`), in a preallocated ring of `RING_FRAMES` frames:

  spans     `process` (the root: `StereoVO.process`, `MonocularVO.process`),
            `upload` (`BaseVO._upload_frame`, also when a caller stages a
            frame ahead with `to_device`), `launch.<program>` (a program's call:
            its arguments staged and its graph replayed), `capture.<program>`
            (a capture, inside its launch or a drain), `drain`
            (`programs.Cache.drain` with captures to make), `stats_wait`
            (a stats sample waited for on the host), `bootstrap` and `reinit`
            (`MonocularVO._try_initialize`, `_reinitialize`);
  counters  `host_syncs` (a stats sample not landed when read, or any
            other read of a device tensor on the host in
            `slam/engine.py`), `keyframe`, `reinits`, `captures`, and
            `graph_kernels` (the kernel nodes of the graphs the frame
            replayed; only on a CUDA engine);
  events    on a CUDA engine, on one frame in `EVENT_EVERY`: CUDA events at
            the frame's first and last enqueue, around each program's
            graph replay, and at the next frame's first enqueue, from a
            pool of `EVENT_FRAMES` such frames an engine. A frame's events
            are read when its slot comes round again, if they have
            completed, or by `collect`: the recorder never waits on one.
            Events cost the host ~100 us a frame on an H100's host (each
            call 2-5 us, more beside a graph launch), hence the sampling.

It reads no device value and adds no host synchronisation. While a
`torch.profiler` runs, each span also opens a
`record_function("viso.<span>")` range. `RECORD = False` turns it off.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

import torch

# Whether `RECORDER` records (set False to measure what recording costs).
RECORD = True
# Frames the recorder's ring holds; the oldest record is reused first.
RING_FRAMES = 16384
# One frame in this many takes CUDA events (1: every frame).
EVENT_EVERY = 16
# An engine's CUDA event slots: a frame's events are read when its slot
# comes round again, EVENT_FRAMES * EVENT_EVERY frames later.
EVENT_FRAMES = 128
# Program replays of one frame timed with events; later ones are not.
EVENT_REPLAYS = 8
# Prefix of the spans' `record_function` ranges under a profiler.
RANGE_PREFIX = "viso."


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


class Frame:
    """One engine frame in the recorder's ring.

    engine, index: the engine's id (`BaseVO.engine_id`) and the frame's
      `frame_idx`, which its spans share;
    spans: (name, start ns, end ns, parent) each, on `time.perf_counter_ns()`'s
      clock; parent is the index of the span it ran in, -1 for none (a
      frame staged ahead of its `process()`). Kept flat in one list that
      the ring reuses (`log`), so that recording allocates no container;
    counters: name -> count;
    state: the engine's state when `process()` returned;
    programs, device_ms, gap_ms: on a CUDA engine, once its events are
      read: (name, stream ms) of each timed replay, the stream ms from the
      frame's first enqueue to its last, and from its last to the next
      frame's first (None until read, or when they had not completed)."""

    __slots__ = ("engine", "index", "log", "counters", "state", "programs", "device_ms",
                 "gap_ms")

    def __init__(self):
        self.log: list = []       # name, start, end, parent of each span in turn
        self.counters: dict = {}
        self.reset(None, None)

    def reset(self, engine, index):
        self.engine, self.index = engine, index
        self.log.clear()
        self.counters.clear()
        self.state = self.programs = self.device_ms = self.gap_ms = None

    @property
    def spans(self) -> list:
        log = self.log
        return list(zip(log[0::4], log[1::4], log[2::4], log[3::4]))

    def span_ms(self, name: str) -> float:
        """The summed ms of the spans called `name`, or, for a name ending
        in ".", of every span whose name starts with it."""
        if name.endswith("."):
            return 1e-6 * sum(e - s for n, s, e, _ in self.spans if n.startswith(name))
        return 1e-6 * sum(e - s for n, s, e, _ in self.spans if n == name)

    def self_ms(self, index: int = 0) -> float:
        """The ms of span `index` (0: the root, `process`) less the union of
        its child spans' intervals."""
        start, end = self.log[4 * index + 1:4 * index + 3]
        covered, reach = 0, start
        for s, e in sorted((s, e) for _, s, e, p in self.spans if p == index):
            s, e = max(s, reach), min(e, end)
            if e > s:
                covered += e - s
                reach = e
        return 1e-6 * (end - start - covered)

    def summary(self) -> dict:
        """The frame's host ms by span name and its counters, as an
        operator's log takes them (`run.py`'s `frames.jsonl`)."""
        spans: dict = {}
        for n, s, e, _ in self.spans:
            spans[n] = spans.get(n, 0.0) + 1e-6 * (e - s)
        return {"spans_ms": {n: round(v, 3) for n, v in spans.items()},
                "counters": dict(self.counters)}


class _Span:
    """A span of the recorder's newest frame (`FrameRecorder.time`)."""

    __slots__ = ("rec", "name", "log", "index", "t0", "range")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        log = rec.current.log
        self.log = log
        stack = rec.stack
        self.index = len(log)   # of the span's name in the frame's log
        log.extend((self.name, 0, 0, stack[-1] if stack else -1))
        stack.append(self.index // 4)
        self.range = None
        if _profiler_enabled():
            self.range = torch.autograd.profiler.record_function(RANGE_PREFIX + self.name)
            self.range.__enter__()
        self.t0 = _now()
        return self

    def __exit__(self, *exc):
        t1 = _now()
        if self.range is not None:
            self.range.__exit__(*exc)
        i = self.index
        self.log[i + 1] = self.t0
        self.log[i + 2] = t1
        stack = self.rec.stack
        if stack and stack[-1] == i // 4:
            stack.pop()
        return False


class _EventSlot:
    """One frame's CUDA events (`_cuda.Events` handles): its first and last
    enqueue, a pair around each of up to EVENT_REPLAYS replays, and the
    next frame's first enqueue."""

    __slots__ = ("frame", "engine", "index", "stream", "closed", "followed", "start", "end",
                 "next_start", "pairs", "names", "used")

    def __init__(self, events):
        self.frame = self.engine = self.index = self.stream = None
        self.closed = False     # its frame's last event recorded
        self.followed = False   # the next frame's first event recorded
        self.start, self.end, self.next_start = events.create(), events.create(), events.create()
        self.pairs = [(events.create(), events.create()) for _ in range(EVENT_REPLAYS)]
        self.names = [None] * EVENT_REPLAYS
        self.used = 0


class _EventPool:
    """An engine's event slots, timed frame `i` (`i % EVENT_EVERY == 0`) in
    slot `i // EVENT_EVERY % EVENT_FRAMES`, on the device `index` (the
    current device when the engine first ran)."""

    def __init__(self, events, index: int):
        self.events, self.index = events, index
        self.slots = [_EventSlot(events) for _ in range(EVENT_FRAMES)]

    def _slot(self, index: int) -> _EventSlot:
        return self.slots[index // EVENT_EVERY % EVENT_FRAMES]

    def open(self, frame, stream) -> _EventSlot:
        """The slot of `frame` (the frame it held read first, if its events
        have completed), its start recorded on `stream`."""
        slot = self._slot(frame.index)
        if slot.frame is not None:
            self.read(slot)
        slot.frame, slot.engine, slot.index, slot.stream = frame, frame.engine, frame.index, stream
        slot.closed = slot.followed = False
        slot.used = 0
        self.events.record(slot.start, stream)
        return slot

    def follow(self, index: int, stream):
        """Record the first enqueue of the frame after frame `index` in its
        slot, if frame `index` was timed."""
        if index % EVENT_EVERY:
            return
        slot = self._slot(index)
        if slot.frame is not None and slot.index == index and slot.closed and not slot.followed:
            self.events.record(slot.next_start, stream)
            slot.followed = True

    def read(self, slot) -> bool:
        """Read a slot's events into its frame if they have completed
        (False, and nothing read, if not: the recorder never waits), and
        free the slot. A frame left open (its last event never recorded)
        reads nothing."""
        ev = self.events
        if slot.closed and not ev.done(slot.end):
            return False
        frame, slot.frame = slot.frame, None
        if not slot.closed or frame.engine != slot.engine or frame.index != slot.index:
            return True   # left open, or the ring has reused the frame's record
        frame.device_ms = ev.elapsed_ms(slot.start, slot.end)
        frame.programs = [(slot.names[i], ev.elapsed_ms(s, e))
                          for i, (s, e) in enumerate(slot.pairs[:slot.used])]
        if slot.followed and ev.done(slot.next_start):
            frame.gap_ms = ev.elapsed_ms(slot.end, slot.next_start)
        return True

    def close(self):
        """Read what has completed, then destroy the events."""
        for slot in sorted((s for s in self.slots if s.frame is not None and s.closed),
                           key=lambda s: s.index):
            self.read(slot)
        for slot in self.slots:
            for e in (slot.start, slot.end, slot.next_start,
                      *(x for pair in slot.pairs for x in pair)):
                self.events.destroy(e)


def _event_pool(device):
    """A new event pool for an engine on `device`, or None where the
    recorder takes no events there: a device other than the current one
    (the driver's events belong to the calling thread's context), or no
    driver."""
    from viso_tpu_torch import _cuda

    current = torch.cuda.current_device()
    if device.index not in (None, current):
        return None
    try:
        return _EventPool(_cuda.Events(), current)
    except (OSError, RuntimeError):
        return None


class FrameRecorder(StageTimer):
    """The engines' frame recorder (module docstring): a `StageTimer`
    whose `time(name)` is a span of the newest frame, recorded only on the
    thread that opened it (the engine's dispatch thread). It keeps each
    frame's spans in the ring and sums none into `totals` (the tools'
    timers do): every microsecond here is a frame's."""

    def __init__(self, frames: int = RING_FRAMES):
        super().__init__()
        self.size = frames
        self.ring: list = []     # made at the first frame
        self.opened = 0          # frames opened so far
        self.current = None      # the newest frame
        self.thread = None       # the thread that opened it
        self.stack: list = []    # indices of its open spans
        self._slot = None        # its event slot while process() runs
        self._root_range = None
        self._pools: dict = {}   # engine id -> _EventPool, or None: no events

    def _here(self) -> bool:
        return RECORD and self.current is not None and threading.get_ident() == self.thread

    def time(self, name: str):
        """A span called `name` of the newest frame (a context manager);
        nothing when the recorder is off or on another thread."""
        if RECORD and self.current is not None and threading.get_ident() == self.thread:
            return _Span(self, name)
        return _NULL

    def count(self, name: str, n: int = 1):
        """Add `n` to the newest frame's counter `name`."""
        if RECORD and self.current is not None and threading.get_ident() == self.thread:
            c = self.current.counters
            c[name] = c.get(name, 0) + n

    def open_frame(self, engine: int, index: int, device):
        """Start frame `index` of engine `engine` with its root span
        `process`, on this thread; on a CUDA device also its first event."""
        if not RECORD:
            return
        if not self.ring:
            self.ring = [Frame() for _ in range(self.size)]
        frame = self.ring[self.opened % self.size]
        self.opened += 1
        frame.reset(engine, index)
        self.current, self.thread = frame, threading.get_ident()
        self._slot = None
        if device.type == "cuda":
            frame.counters["graph_kernels"] = 0
            if engine not in self._pools:
                self._pools[engine] = _event_pool(device)
            pool = self._pools[engine]
            # Only a timed frame and the one after it record events.
            if pool is not None and (EVENT_EVERY == 1 or index % EVENT_EVERY < 2):
                stream = torch._C._cuda_getCurrentRawStream(pool.index)
                pool.follow(index - 1, stream)
                if index % EVENT_EVERY == 0:
                    self._slot = pool.open(frame, stream)
        self._root_range = None
        if _profiler_enabled():
            self._root_range = torch.autograd.profiler.record_function(RANGE_PREFIX + "process")
            self._root_range.__enter__()
        self.stack = [0]
        frame.log.extend(("process", _now(), 0, -1))

    def close_frame(self, state):
        """End the newest frame's root span, with the engine's `state`."""
        if not self._here() or not self.stack or self.stack[0] != 0:
            return
        frame = self.current
        frame.log[2] = _now()
        frame.state = state
        self.stack = []
        slot = self._slot
        if slot is not None:
            self._pools[frame.engine].events.record(slot.end, slot.stream)
            slot.closed = True
            self._slot = None
        if self._root_range is not None:
            self._root_range.__exit__(None, None, None)
            self._root_range = None

    def replay(self, name: str, graph, kernels):
        """`graph.replay()` of program `name`, between a pair of the open
        frame's CUDA events (its first EVENT_REPLAYS replays), its `kernels`
        (None: not counted) added to the frame's `graph_kernels`."""
        here = RECORD and self.current is not None and threading.get_ident() == self.thread
        slot = self._slot if here else None
        if slot is None or slot.used == EVENT_REPLAYS:
            graph.replay()
        else:
            record = self._pools[self.current.engine].events.record
            start, end = slot.pairs[slot.used]
            slot.names[slot.used] = name
            slot.used += 1
            record(start, slot.stream)
            graph.replay()
            record(end, slot.stream)
        if here:
            c = self.current.counters
            if kernels is None or c.get("graph_kernels") is None:
                c["graph_kernels"] = None
            else:
                c["graph_kernels"] += kernels

    def collect(self):
        """Read every closed frame's events that have completed."""
        for pool in self._pools.values():
            if pool is not None:
                for slot in sorted((s for s in pool.slots if s.frame is not None and s.closed),
                                   key=lambda s: s.index):
                    pool.read(slot)

    def release(self, engine: int):
        """Read what has completed of `engine`'s events, then destroy them
        (the engine is closing)."""
        pool = self._pools.pop(engine, None)
        if pool is not None:
            if self._slot is not None and self._slot in pool.slots:
                self._slot = None
            pool.close()

    def frames(self, first: int, n: int, engine: int | None = None) -> list:
        """The ring's frames `first` to `first + n - 1` of `engine` (the
        newest frame's engine by default), in order, after `collect`."""
        if self.current is None:
            return []
        self.collect()
        engine = self.current.engine if engine is None else engine
        got = [f for f in self.ring if f.engine == engine and first <= f.index < first + n]
        return sorted(got, key=lambda f: f.index)

    def frame(self, engine: int, index: int):
        """The ring's record of frame `index` of `engine`, or None."""
        if self.current is not None and (self.current.engine, self.current.index) == (
                engine, index):
            return self.current
        return next((f for f in self.ring if (f.engine, f.index) == (engine, index)), None)


_NULL = contextlib.nullcontext()
_now = time.perf_counter_ns
_profiler_enabled = torch.autograd._profiler_enabled
# The process-wide recorder of the engines' frames.
RECORDER = FrameRecorder()


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
