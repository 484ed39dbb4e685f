"""The per-layer metrics read from the port's own frame recorder
(`viso_tpu_torch.utils.profiling.RECORDER`): each reads a value on a small
traced run where one exists (on the CPU nothing is a CUDA graph and
there are no CUDA events), and nothing from a port without the recorder.
On the card, a traced run reads all of them, and the recorder's ranges
stay out of the profiled slice's device operations."""

import importlib

import pytest

from vobench import run
from vobench import trace as trace_mod
from vobench.tests import small

RECORDED = ("stats_wait_ms", "host_self_ms", "host_syncs_per_frame", "upload_ms", "launch_ms",
            "graph_kernels_per_frame", "frame_gap_share")
# The readers that find nothing on the CPU: no graph, no CUDA event.
DEVICE_ONLY = ("graph_kernels_per_frame", "frame_gap_share")


def test_recorded_metrics_are_in_every_cell():
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        names = {m["name"] for m in run.cell_of(w["name"], bench).per_layer}
        assert set(RECORDED) <= names, w["name"]


@pytest.fixture(scope="module")
def traced():
    return run.run_cell(small.stereo_cell(), 2**31 + 29, small.SECONDS, True, device="cpu")


def test_traced_cpu_run_reads_the_recorded_metrics(traced):
    assert traced["correct"] is True
    got = traced["metrics"]
    for name in RECORDED:
        assert (name in got) == (name not in DEVICE_ONLY), name
    assert got["host_syncs_per_frame"]["value"] == 0.0   # nothing waits on the CPU
    assert got["host_syncs_per_frame"]["unit"] == "count"
    for name in ("stats_wait_ms", "host_self_ms", "upload_ms", "launch_ms"):
        assert got[name]["value"] >= 0 and got[name]["unit"] == "ms", name
    # The launches hold the programs, which run eagerly on the CPU: most
    # of a frame's host time.
    assert got["launch_ms"]["value"] > got["host_self_ms"]["value"]
    assert got["launch_ms"]["value"] < got["host_ms_per_frame"]["value"]


@pytest.mark.parametrize("name", RECORDED)
def test_reader_reads_nothing_without_the_recorder(monkeypatch, name):
    from viso_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "RECORDER")
    trace = run.Trace(small.stereo_cell(), host_ms=[1.0] * 5, keyframes=[False] * 5)
    assert importlib.import_module(f"vobench.metrics.{name}").read(trace) is None


@pytest.mark.cuda
def test_traced_run_on_the_card_reads_every_recorded_metric(card, monkeypatch):
    """The profiled slice's device operations hold none of the recorder's
    `viso.` ranges (they are user annotations), and all seven metrics read."""
    slices = []

    class Kept(trace_mod.Slice):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            slices.append(self)

    monkeypatch.setattr(trace_mod, "Slice", Kept)
    res = run.run_cell(small.stereo_cell(), 2**31 + 31, 4.0, True, device=str(card))
    assert res["correct"] is True
    (s,) = slices
    assert s.complete and s.work
    assert not [w for w in s.work if w[0].startswith("viso.")]
    assert not [n for n, _ in res["breakdown"]["device_ops"] if n.startswith("viso.")]
    got = res["metrics"]
    assert set(RECORDED) <= set(got), sorted(got)
    assert got["graph_kernels_per_frame"]["value"] > 0
    assert 0 <= got["frame_gap_share"]["value"] < 100


def test_frame_gap_share_reads_the_timed_frames_inside_the_window(monkeypatch):
    """The gaps of the window's timed frames over their stream time; the
    last window frame's gap (into whatever follows the window, a traced
    run's profiler start) is left out, and frames without events are."""
    from types import SimpleNamespace

    from viso_tpu_torch.utils import profiling
    from vobench.metrics import frame_gap_share

    def frame(device_ms, gap_ms):
        return SimpleNamespace(device_ms=device_ms, gap_ms=gap_ms)

    frames = [frame(9.0, 1.0), frame(None, None), frame(19.0, 1.0), frame(10.0, 5000.0)]
    fake = SimpleNamespace(frames=lambda first, n: frames)
    monkeypatch.setattr(profiling, "RECORDER", fake)
    trace = run.Trace(small.stereo_cell(), host_ms=[1.0] * 4)
    assert frame_gap_share.read(trace) == pytest.approx(100.0 * 2.0 / 30.0)
    frames[:] = [frame(None, None)] * 3
    assert frame_gap_share.read(trace) is None
