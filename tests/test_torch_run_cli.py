"""The port's CLI runner (`python -m viso_tpu_torch.run`) on the synthetic
dataset with `--device cpu`, under tests/test_run_cli.py's bounds and
artifacts; its refusals (no CUDA device, modes not ported yet); plots
skipped where matplotlib is absent. Every K1 call the four modes make is
at a shape of `tools/bench_k1.MAIN_PATH_CASES`, where chip_smoke.py holds
the kernel against its plain version."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from viso_tpu_torch import run
from viso_tpu_torch.geometry import extract
from viso_tpu_torch.tools import bench_k1

torch.set_num_threads(2)


@pytest.fixture
def k1_calls(monkeypatch):
    """The K1 calls of a run as bench_k1 case keys (image shape, window,
    N, source); two-source calls as the (K + 1, H, W) stack of the table."""
    calls = set()

    def record(name, key):
        real = getattr(extract, name)

        def entry(*a):
            calls.add(key(*a))
            return real(*a)

        monkeypatch.setattr(extract, name, entry)

    record("extract_windows_fast",
           lambda img, c, win: (tuple(img.shape), (win, win), c.shape[0], False))
    record("extract_rects_fast", lambda img, b, h, w: (tuple(img.shape), (h, w), b.shape[0], False))
    record("extract_windows_indexed_fast",
           lambda imgs, k, c, win: (tuple(imgs.shape), (win, win), c.shape[0], "stack"))
    record("extract_windows_two_source",
           lambda st, k, c, img, c2, win: (
               (st.shape[0] + 1,) + tuple(img.shape), (win, win), c.shape[0] + c2.shape[0],
               "two" if c.shape[0] == c2.shape[0] else "uneven"))
    return calls


def _in_case_table(calls):
    table = {(shape, hw, n, source) for _, shape, hw, n, source in bench_k1.MAIN_PATH_CASES}
    assert calls and calls <= table, sorted(calls - table, key=str)


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_run_cli_stereo_with_overlays(tmp_path, k1_calls):
    out = str(tmp_path / "out")
    summary = run.main(["--dataset", "synthetic", "--mode", "stereo", "--max-frames", "12",
                        "--viz-every", "4", "--out-dir", out, "--device", "cpu"])
    assert summary["ate_rmse_m"] < 0.2
    for name in ("trajectory.txt", "trajectory.png", "map_topdown.png", "map.html",
                 "summary.json"):
        assert os.path.exists(os.path.join(out, name)), name
    lines = _lines(os.path.join(out, "frames.jsonl"))
    assert len(lines) == 12
    # Each frame's host ms by span and its counters, from the frame recorder.
    for r in lines:
        assert r["spans_ms"]["process"] >= r["spans_ms"]["upload"] > 0, r
        assert r["counters"].get("keyframe", 0) == int(r["kf"]), r
    assert all("launch.track" in r["spans_ms"] for r in lines[1:])
    # Frame 0 initializes (no overlay); frames 4 and 8 draw one each.
    overlays = sorted(os.listdir(os.path.join(out, "overlays")))
    assert overlays == ["frame_000004.png", "frame_000008.png"], overlays
    with open(os.path.join(out, "overlays", overlays[0]), "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f) == json.loads(json.dumps(summary))
    assert summary["device"] == "cpu"
    _in_case_table(k1_calls)


def test_run_cli_slam_mode_with_checkpoint(tmp_path, k1_calls):
    out = str(tmp_path / "out_slam")
    summary = run.main(["--dataset", "synthetic", "--mode", "slam", "--max-frames", "14",
                        "--checkpoint-every", "8", "--out-dir", out, "--device", "cpu"])
    assert summary["ate_rmse_m"] < 0.3
    for name in ("slam.npz", "trajectory.txt", "map.html"):
        assert os.path.exists(os.path.join(out, name)), name
    # Resume from the checkpoint: the restored engine runs on.
    resumed = run.main(["--dataset", "synthetic", "--mode", "slam", "--max-frames", "3",
                        "--resume", os.path.join(out, "slam.npz"),
                        "--out-dir", str(tmp_path / "resumed"), "--device", "cpu"])
    assert resumed["frames"] == 3
    _in_case_table(k1_calls)


def test_run_cli_mono_mode(tmp_path, k1_calls):
    """Mono on the synthetic forward corridor (init disparity gate lowered
    to 5 px by the runner), scale-aligned ATE finite and below 2 m; its
    window BA is photometric (K1 over the (8, 120, 160) stack)."""
    out = str(tmp_path / "out_mono")
    summary = run.main(["--dataset", "synthetic", "--mode", "mono", "--max-frames", "14",
                        "--out-dir", out, "--device", "cpu"])
    assert np.isfinite(summary["ate_rmse_m"]) and summary["ate_rmse_m"] < 2.0
    assert summary["keyframes"] >= 2
    assert os.path.exists(os.path.join(out, "trajectory.png"))
    lines = _lines(os.path.join(out, "frames.jsonl"))
    states = [r["state"] for r in lines]
    assert len(states) == 14 and states[-1] == "tracking", states
    assert "bootstrap" in lines[1]["spans_ms"]     # the frame recorder's spans
    _in_case_table(k1_calls)
    assert ((8, 120, 160), (16, 16), 16384, "stack") in k1_calls
    assert sum(src == "two" and shape[0] == 2 for shape, _, _, src in k1_calls) == 4   # LK


def test_run_cli_mono_slam_mode(tmp_path, k1_calls):
    """tests/test_run_cli.py::test_run_cli_mono_slam_mode on the port: the
    Sim(3) SLAM layer end to end on the synthetic sequence (init disparity
    gate lowered to 5 px by the runner, one image per frame), a
    scale-aligned ATE below 2 m, with a checkpoint every 8 frames that
    resumes as a MonoSLAM; K1 (the loop digest's descriptor windows
    included) only at shapes of the case table."""
    out = str(tmp_path / "out_mono_slam")
    summary = run.main(["--dataset", "synthetic", "--mode", "mono-slam", "--max-frames", "14",
                        "--checkpoint-every", "8", "--out-dir", out, "--device", "cpu"])
    assert np.isfinite(summary["ate_rmse_m"]) and summary["ate_rmse_m"] < 2.0
    for name in ("trajectory.txt", "trajectory.png", "summary.json", "slam.npz"):
        assert os.path.exists(os.path.join(out, name)), name
    states = [r["state"] for r in _lines(os.path.join(out, "frames.jsonl"))]
    assert len(states) == 14 and states[-1] == "tracking", states
    _in_case_table(k1_calls)
    assert ((240, 320), (34, 34), 256, False) in k1_calls      # the loop digest
    resumed = run.main(["--dataset", "synthetic", "--mode", "mono-slam", "--max-frames", "3",
                        "--resume", os.path.join(out, "slam.npz"),
                        "--out-dir", str(tmp_path / "resumed"), "--device", "cpu"])
    assert resumed["frames"] == 3


def test_run_cli_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib is not installed the two PNG plots are skipped and
    the summary says so; everything else is written."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = str(tmp_path / "out")
    summary = run.main(["--dataset", "synthetic", "--mode", "stereo", "--max-frames", "3",
                        "--out-dir", out, "--device", "cpu"])
    assert summary["plots_skipped"] == "matplotlib not installed"
    assert not os.path.exists(os.path.join(out, "trajectory.png"))
    assert not os.path.exists(os.path.join(out, "map_topdown.png"))
    for name in ("trajectory.txt", "frames.jsonl", "summary.json", "map.html"):
        assert os.path.exists(os.path.join(out, name)), name


@pytest.mark.parametrize("argv, err, match", [
    # Without torchrun the world is this one process: a group of 3 is refused.
    (["--mode", "stereo", "--distribute", "--mesh-devices", "3", "--max-frames", "3"],
     ValueError, "world size 1"),
])
def test_run_cli_unported_modes_raise(tmp_path, argv, err, match):
    with pytest.raises(err, match=match):
        run.main(argv + ["--out-dir", str(tmp_path), "--device", "cpu"])


def test_run_cli_distribute_stereo(tmp_path, k1_calls):
    """`--distribute` in stereo mode: the window BA solved landmark-sharded
    over a world of one (no torchrun), the summary as the plain run's."""
    out = str(tmp_path / "dist")
    summary = run.main(["--dataset", "synthetic", "--mode", "stereo", "--max-frames", "8",
                        "--distribute", "--out-dir", out, "--device", "cpu"])
    plain = run.main(["--dataset", "synthetic", "--mode", "stereo", "--max-frames", "8",
                      "--out-dir", str(tmp_path / "plain"), "--device", "cpu"])
    assert summary["ate_rmse_m"] == plain["ate_rmse_m"] < 0.2
    assert summary["keyframes"] >= 2 and len(_lines(os.path.join(out, "frames.jsonl"))) == 8
    _in_case_table(k1_calls)


def test_run_cli_needs_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    """The default device is the card: with no CUDA device the runner
    raises instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        run.main(["--dataset", "synthetic", "--max-frames", "2", "--out-dir", str(tmp_path)])
    assert not os.path.exists(os.path.join(tmp_path, "frames.jsonl"))
