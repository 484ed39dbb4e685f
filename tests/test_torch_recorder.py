"""The frame recorder (`viso_tpu_torch/utils/profiling.FrameRecorder`, the
process-wide `RECORDER`) on the CPU: its spans' nesting and parents, a
frame's self time, the ring's wrap-around, the off switch, the thread it
records on, `record_function` ranges only under a profiler, and what the
engines record: one `process` span a frame with its children, `keyframe`
counts equal to the results' flags, and no kernel count on the CPU."""

import threading

import numpy as np
import pytest
import torch

from viso_tpu_torch.data import synthetic
from viso_tpu_torch.geometry import camera
from viso_tpu_torch.slam.engine import MonocularVO, StereoVO, VOConfig
from viso_tpu_torch.utils import profiling
from viso_tpu_torch.utils.profiling import RECORDER

torch.set_num_threads(2)

CPU = torch.device("cpu")
# tests/test_torch_programs.py's configuration and corridor, its mono gates.
H, W = 192, 256
INTR = dict(fx=200.0, fy=200.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5)
CFG = dict(
    height=H, width=W, max_keyframes=6, max_landmarks=384, num_features=192,
    detect_grid=(4, 6), fast_threshold=15.0, baseline=0.3, max_disparity=48,
    kf_min_gap=2, stats_deterministic=True, **INTR,
)
MONO_CFG = dict(CFG, fast_threshold=10.0, kf_max_gap=6, kf_min_visible_frac=0.45,
                min_init_tracks=25, disparity_squared_thresh=25.0)


def names(frame):
    return [s[0] for s in frame.spans]


def test_spans_nest_under_the_frame_root():
    rec = profiling.FrameRecorder(frames=8)
    rec.open_frame(7, 0, CPU)
    with rec.time("a"):
        with rec.time("b"):
            rec.count("n")
        with rec.time("c"):
            rec.count("n", 2)
    with rec.time("d"):
        pass
    rec.close_frame("tracking")
    (frame,) = rec.frames(0, 1)
    assert (frame.engine, frame.index, frame.state) == (7, 0, "tracking")
    assert names(frame) == ["process", "a", "b", "c", "d"]
    assert [s[3] for s in frame.spans] == [-1, 0, 1, 1, 0]
    assert frame.counters == {"n": 3}
    for name, start, end, parent in frame.spans[1:]:
        _, p0, p1, _ = frame.spans[parent]
        assert p0 <= start <= end <= p1, name
    a, b = frame.spans[1], frame.spans[2]
    assert a[2] - a[1] >= b[2] - b[1] > 0
    assert frame.span_ms("a") >= frame.span_ms("b") + frame.span_ms("c")


def test_self_time_is_the_root_less_the_union_of_its_children():
    frame = profiling.Frame()
    frame.reset(0, 3)
    ms = 1_000_000
    for span in [
        ("process", 0, 10 * ms, -1),
        ("upload", 1 * ms, 2 * ms, 0),
        ("launch.track", 3 * ms, 6 * ms, 0),
        ("capture.track", 4 * ms, 5 * ms, 2),    # a grandchild: inside its parent
        ("stats_wait", 5 * ms, 7 * ms, 0),       # overlaps launch.track's end
        ("upload", 12 * ms, 13 * ms, -1),        # staged ahead, outside the frame
    ]:
        frame.log.extend(span)
    assert frame.self_ms() == pytest.approx(10 - 1 - 4)
    assert frame.self_ms(2) == pytest.approx(3 - 1)
    assert frame.span_ms("upload") == pytest.approx(2)
    assert frame.span_ms("launch.") == pytest.approx(3)
    assert frame.span_ms("capture.track") == pytest.approx(1)
    summary = frame.summary()
    assert summary["spans_ms"] == {"process": 10, "upload": 2, "launch.track": 3,
                                   "capture.track": 1, "stats_wait": 2}


def test_ring_wraps_around_oldest_first():
    rec = profiling.FrameRecorder(frames=4)
    for i in range(6):
        rec.open_frame(1, i, CPU)
        rec.count("i", i)
        rec.close_frame("tracking")
    assert len(rec.ring) == 4
    assert [f.index for f in rec.frames(0, 6)] == [2, 3, 4, 5]
    assert [f.counters.get("i", 0) for f in rec.frames(0, 6)] == [2, 3, 4, 5]
    assert rec.frame(1, 1) is None and rec.frame(1, 5).index == 5
    # Spans after a frame has closed (a frame staged ahead) go to the
    # newest frame, outside its root.
    with rec.time("upload"):
        pass
    assert rec.frame(1, 5).spans[-1][0] == "upload" and rec.frame(1, 5).spans[-1][3] == -1
    # Another engine's frames do not mix in; the newest engine is the default.
    rec.open_frame(2, 0, CPU)
    rec.close_frame("init")
    assert [f.index for f in rec.frames(0, 6)] == [0]
    assert [f.index for f in rec.frames(0, 6, engine=1)] == [3, 4, 5]


def test_the_off_switch_records_nothing(monkeypatch):
    rec = profiling.FrameRecorder(frames=4)
    monkeypatch.setattr(profiling, "RECORD", False)
    rec.open_frame(0, 0, CPU)
    with rec.time("a"):
        rec.count("n")
    rec.close_frame("tracking")
    assert rec.ring == [] and rec.current is None and rec.frames(0, 1) == []
    monkeypatch.setattr(profiling, "RECORD", True)
    rec.open_frame(0, 1, CPU)
    rec.close_frame("tracking")
    assert [f.index for f in rec.frames(0, 2)] == [1]


def test_other_threads_record_nothing():
    rec = profiling.FrameRecorder(frames=4)
    rec.open_frame(0, 0, CPU)

    def worker():
        with rec.time("detect"):
            rec.count("n")

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    with rec.time("here"):
        pass
    rec.close_frame("tracking")
    (frame,) = rec.frames(0, 1)
    assert names(frame) == ["process", "here"] and frame.counters == {}


def test_record_function_ranges_only_under_a_profiler(monkeypatch):
    opened = []
    real = torch.autograd.profiler.record_function

    def record_function(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", record_function)
    rec = profiling.FrameRecorder(frames=4)
    rec.open_frame(0, 0, CPU)
    with rec.time("launch.track"):
        torch.ones(4).sum()
    rec.close_frame("tracking")
    assert opened == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec.open_frame(0, 1, CPU)
        with rec.time("launch.track"):
            torch.ones(4).sum()
        rec.close_frame("tracking")
    assert opened == ["viso.process", "viso.launch.track"]
    got = {e.name for e in prof.events()}
    assert {"viso.process", "viso.launch.track"} <= got


def _stereo_frames(n):
    intr = camera.Intrinsics.create(**INTR)
    scene = synthetic.corridor_scene(np.random.default_rng(7), tex_size=512)
    Rs, ts = synthetic.forward_trajectory(n, step=0.25, yaw_rate=0.004)
    return [synthetic.make_stereo_pair(scene, intr, R, t, H, W, baseline=0.3)[:2]
            for R, t in zip(Rs, ts)]


def _mono_frames(n):
    intr = camera.Intrinsics.create(**INTR)
    scene = synthetic.corridor_scene(np.random.default_rng(7), tex_size=512)
    Rs, ts = synthetic.forward_trajectory(n, step=0.15, yaw_rate=0.004)
    return [np.clip(scene.render(intr, R, t, H, W)[0], 0, 255).astype(np.uint8)
            for R, t in zip(Rs, ts)]


def _check_engine_frames(vo, results, states):
    """The engine's recorded frames against its results and its state
    after each call."""
    frames = RECORDER.frames(0, len(results), engine=vo.engine_id)
    assert [f.index for f in frames] == list(range(len(results)))
    assert [f.state for f in frames] == states
    for f, r in zip(frames, results):
        assert f.spans[0][0] == "process" and f.spans[0][3] == -1
        kids = [s[0] for s in f.spans if s[3] == 0]
        assert kids.count("upload") == 1, kids
        assert f.counters.get("keyframe", 0) == int(r.is_keyframe)
        assert f.counters.get("host_syncs", 0) == 0          # nothing waits on the CPU
        assert f.counters.get("graph_kernels") is None       # not measured on the CPU
        assert f.programs is f.device_ms is f.gap_ms is None  # no events on the CPU
        assert 0 < f.self_ms() <= f.span_ms("process")
    return frames


def test_stereo_engine_records_a_frame_per_process_call():
    vo = StereoVO(VOConfig(**CFG), device="cpu")
    try:
        results, states = [], []
        for il, ir in _stereo_frames(8):
            results.append(vo.process(il, ir))
            states.append(vo.state)
        frames = _check_engine_frames(vo, results, states)
        assert all(p.kernels is None for p in vo._kernels.values())
    finally:
        vo.close()
    kids = [[s[0] for s in f.spans if s[3] == 0] for f in frames]
    assert kids[0][1:] == ["launch.stereo_kf", "launch.templates"]   # the first keyframe
    for k, r in zip(kids[1:], results[1:]):
        assert k[1] == "launch.track", k
        assert ("launch.ba" in k) == r.is_keyframe
    # A stats sample lands within its frame on the CPU: none is waited for.
    assert not any("stats_wait" in k for k in kids)
    assert sum(r.is_keyframe for r in results) >= 2


def test_mono_engine_records_its_bootstrap():
    vo = MonocularVO(VOConfig(**MONO_CFG), device="cpu")
    try:
        results, states = [], []
        for img in _mono_frames(14):
            results.append(vo.process(img))
            states.append(vo.state)
        frames = _check_engine_frames(vo, results, states)
    finally:
        vo.close()
    assert states[-1] == "tracking", states
    boot = [f for f in frames if "bootstrap" in names(f)]
    tracked = [f for f in frames if "launch.track" in names(f)]
    assert boot and tracked and boot[-1].index < tracked[0].index
    # The frame that initialized: its keyframe, and the templates built.
    init = boot[-1]
    assert init.counters.get("keyframe") == 1 and "launch.templates" in names(init)
    assert [s[0] for s in init.spans if s[3] == 0] == ["upload", "bootstrap"]


class FakeEvents:
    """`_cuda.Events` on a fake stream clock: `record` stamps an event with
    the next tick; it has completed once the device has reached its tick
    (`DONE`)."""

    CLOCK = [0]
    DONE = [float("inf")]

    def __init__(self):
        self.ticks, self.made, self.destroyed = {}, 0, 0

    def create(self):
        self.made += 1
        return self.made

    def record(self, event, stream):
        FakeEvents.CLOCK[0] += 1
        self.ticks[event] = FakeEvents.CLOCK[0]
        return 0

    def done(self, event):
        return self.ticks.get(event, 0) <= FakeEvents.DONE[0]

    def elapsed_ms(self, start, end):
        assert self.done(start) and self.done(end), "read before it completed"
        return float(self.ticks[end] - self.ticks[start])

    def destroy(self, event):
        self.destroyed += 1


class FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1
        FakeEvents.CLOCK[0] += 10     # the replay's device time


@pytest.fixture
def fake_card(monkeypatch):
    """The driver's events on a fake clock, 4 event slots an engine, 2
    timed replays a frame."""
    from viso_tpu_torch import _cuda

    FakeEvents.CLOCK[0], FakeEvents.DONE[0] = 0, float("inf")
    made = []
    monkeypatch.setattr(_cuda, "Events", lambda: made.append(FakeEvents()) or made[-1])
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 0, raising=False)
    monkeypatch.setattr(profiling, "EVENT_FRAMES", 4)
    monkeypatch.setattr(profiling, "EVENT_REPLAYS", 2)
    monkeypatch.setattr(profiling, "EVENT_EVERY", 1)
    return torch.device("cuda"), made


def test_events_are_read_when_their_slot_comes_round(fake_card):
    """Each frame's events (its first and last enqueue, a pair around each
    of its first EVENT_REPLAYS replays) are read when its slot is reused
    EVENT_FRAMES frames later, or by `collect`; a frame whose events have
    not completed then is left unread, never waited for; the replays'
    kernel counts add up in `graph_kernels`."""
    card, made = fake_card
    rec = profiling.FrameRecorder(frames=64)
    graph = FakeGraph()
    for i in range(6):
        rec.open_frame(3, i, card)
        for name in ("track", "ba", "templates")[:1 + i % 3]:
            rec.replay(name, graph, 100)
        rec.close_frame("tracking")
    assert graph.replays == 1 + 2 + 3 + 1 + 2 + 3
    first = rec.frame(3, 0)
    # Frames 0 and 1 were read when frames 4 and 5 took their slots.
    assert first.programs == [("track", 11.0)] and first.device_ms == 13.0
    assert first.gap_ms == 1.0                      # its end to frame 1's start
    assert rec.frame(3, 1).programs == [("track", 11.0), ("ba", 11.0)]
    assert rec.frame(3, 2).programs is None         # not read yet
    assert [f.counters["graph_kernels"] for f in rec.frames(0, 6)] == [100, 200, 300] * 2
    # Frame 2 replayed 3 programs: 2 timed (EVENT_REPLAYS), the third untimed.
    FakeEvents.DONE[0] = FakeEvents.CLOCK[0]
    frames = rec.frames(0, 6)
    assert [len(f.programs) for f in frames] == [1, 2, 2, 1, 2, 2]
    assert frames[2].device_ms == 1 + 12 + 12 + 10
    assert [f.gap_ms for f in frames] == [1.0] * 5 + [None]
    # A frame whose events have not completed when its slot comes round.
    FakeEvents.DONE[0] = 0
    for i in range(6, 11):
        rec.open_frame(3, i, card)
        rec.replay("track", graph, None)
        rec.close_frame("tracking")
    assert rec.frame(3, 6).device_ms is None and rec.frame(3, 6).programs is None
    assert rec.frame(3, 6).counters["graph_kernels"] is None   # a count not known
    FakeEvents.DONE[0] = float("inf")
    rec.release(3)
    assert rec.frame(3, 6).device_ms is None                  # its slot was reused
    assert [f.device_ms for f in rec.frames(7, 4)] == [13.0] * 4
    (events,) = made                                          # one pool, all destroyed
    assert events.made == events.destroyed == 4 * (3 + 2 * 2)
    # An engine on another device than the current one takes no events.
    rec.open_frame(4, 0, torch.device("cuda", 1))
    rec.close_frame("tracking")
    assert rec._pools[4] is None and len(made) == 1
    assert rec.frame(4, 0).counters == {"graph_kernels": 0}


def test_one_frame_in_event_every_takes_events(fake_card, monkeypatch):
    """With EVENT_EVERY 3, frames 0, 3, 6, ... take events (their slot
    every 3 frames), each with its gap to the next frame's first enqueue;
    the others none. Counters and spans are every frame's."""
    card, made = fake_card
    monkeypatch.setattr(profiling, "EVENT_EVERY", 3)
    rec = profiling.FrameRecorder(frames=64)
    graph = FakeGraph()
    for i in range(14):
        rec.open_frame(5, i, card)
        rec.replay("track", graph, 7)
        rec.close_frame("tracking")
    frames = rec.frames(0, 14)
    assert [f.index for f in frames if f.device_ms is not None] == [0, 3, 6, 9, 12]
    assert all(f.programs is None for f in frames if f.index % 3)
    timed = [f for f in frames if f.index % 3 == 0]
    assert [f.device_ms for f in timed] == [13.0] * 5
    assert [f.gap_ms for f in timed] == [1.0] * 5      # each to the next frame's first event
    assert [f.counters["graph_kernels"] for f in frames] == [7] * 14
