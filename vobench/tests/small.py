"""Small cells for tests on the CPU: the configurations and drives of the
benchmark's cells at a size a test run can hold."""

from __future__ import annotations

import copy

from vobench import run

# A CPU test run's window: long enough for the check's blocks (the first 6
# window frames) on a loaded CPU.
SECONDS = 6.0
# The check's blocks and the traced slice's frames in a test run
# (`run.CHECK_BLOCKS`, `run.TRACE_FRAMES`; set by `conftest.small_run`).
CHECK_BLOCKS = 2
TRACE_FRAMES = 3

STEREO_RIG = {"image_rows": 120, "image_cols": 320, "fx": 185.5, "fy": 185.5, "cx": 159.5,
              "cy": 59.5, "baseline_m": 0.537}
STEREO_ENGINE = {
    "num_features": 128, "max_landmarks": 512, "max_keyframes": 4,
    "detect_grid": [3, 6], "fast_threshold": 20.0, "max_disparity": 48, "stats_max_lag": 8,
    "kf_max_gap": 5, "track_landmarks": 256,
}
# The monocular engine at half KITTI's size, at which its bootstrap
# initializes on the corridor within a CPU test run's warm-up.
MONO_RIG = {"image_rows": 184, "image_cols": 616, "fx": 359.428, "fy": 359.428,
            "cx": 303.5964, "cy": 92.60785}
MONO_K1_TRACK_CALLS = [[1024, 24, 24], [1024, 24, 24], [256, 24, 24], [256, 23, 23],
                       [2048, 16, 16], [2048, 16, 16]]


def _cell(name: str) -> run.Cell:
    cell = run.cell_of(name, run.load_json(run.ROOT / "BENCHMARK.json"))
    cell.config = copy.deepcopy(cell.config)
    return cell


def stereo_cell(check=(3, 6), workload="stereo_vo.drive") -> run.Cell:
    """A cell of `kitti_stereo_vo`'s kind at 120x320 on `workload`'s drive."""
    cell = _cell(workload)
    cfg = cell.config
    cfg.update(STEREO_RIG)
    cfg["engine"] = dict(STEREO_ENGINE)
    cfg["warmup_frames"] = 6
    frames, within = check
    cfg["check"] = dict(cfg["check"], block_frames=frames, within_frames=within)
    return cell


def mono_cell() -> run.Cell:
    """`mono_vo.drive`'s engine settings at 184x616, with a short check
    sample."""
    cell = _cell("mono_vo.drive")
    cell.config.update(MONO_RIG, k1_track_calls=MONO_K1_TRACK_CALLS)
    cell.config["check"] = dict(cell.config["check"], block_frames=3, within_frames=6)
    return cell
