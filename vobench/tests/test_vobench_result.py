"""A whole run at a small size on the CPU: the result line's keys, the
check's verdict on a sound run, and the refusal without a card."""

import json
import subprocess
import sys

import pytest

from vobench import run
from vobench.tests import small

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def result():
    return run.run_cell(small.stereo_cell(), 2**31 + 11, small.SECONDS, False, device="cpu")


def test_result_line_keys(result):
    keys = list(result)
    assert keys[:5] == KEYS and keys[-1] == "check"
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert result["attempted"] > 0 and result["failed"] == 0
    for name in ("fps", "setup_s"):
        m = result["metrics"][name]
        assert m["value"] > 0 and m["unit"]
    for name, v in result["check"].items():
        assert set(v) == {"value", "limit"}, name
    json.dumps(result)


def test_sound_run_is_correct(result):
    """The engine on the CPU runs the same operations as the reference."""
    assert result["correct"] is True
    assert all(v["value"] == 0 for v in result["check"].values())


@pytest.mark.parametrize("make", [lambda: small.stereo_cell(workload="stereo_vo.drive_png"),
                                  small.mono_cell], ids=["png_ring", "mono"])
def test_sound_runs_of_the_other_cells_are_correct(make):
    """The PNG feed (its frames through the native decoder and ring) and the
    monocular engine (its keyframe path, photometric BA and bootstrap) held
    to the reference, gap 0 on the CPU."""
    from viso_tpu_torch.data import native

    cell = make()
    if cell.traffic["feed"] == "png_ring" and not native.available():
        pytest.skip(f"the native decoder is unavailable: {native._load_error}")
    res = run.run_cell(cell, 77, small.SECONDS, False, device="cpu")
    assert res["correct"] is True, res["check"]
    assert all(v["value"] == 0 for v in res["check"].values())


def test_traced_run_reports_per_layer_metrics():
    res = run.run_cell(small.stereo_cell(), 5, small.SECONDS, True, device="cpu")
    assert res["correct"] is True
    assert {"host_ms_per_frame", "keyframe_share"} <= set(res["metrics"])
    assert "fps" not in res["metrics"]


def test_no_card_no_result():
    """Without a card the run exits non-zero and prints nothing."""
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            "from vobench import run; sys.exit(run.main(['--workload', 'stereo_vo.drive', "
            "'--seed', '1', '--seconds', '1']))")
    p = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""
