"""K1's byte count against the port's own bound for the same shapes."""

import json

import pytest

from vobench import kernels, run


@pytest.mark.parametrize("config", ["kitti_stereo_vo", "kitti_mono_vo"])
def test_k1_bytes_match_bench_extract(config):
    from viso_tpu_torch.tools import bench_extract

    calls = json.loads((run.HERE / "configs" / f"{config}.json").read_text())["k1_track_calls"]
    assert len(calls) == 6   # direct at four levels, align at two
    for n, h, w in calls:
        assert abs(kernels.k1_bytes(n, h, w) / kernels.H100_HBM_BYTES_PER_S * 1e3
                   - bench_extract.bound_ms(n, h, w)) < 1e-15


def test_stereo_track_calls_are_bench_k1_s():
    """The headline's six track calls, as `bench_k1.MAIN_PATH_CASES` lists
    them, and their bound per tracked frame (0.005243 ms)."""
    from viso_tpu_torch.tools import bench_k1

    cases = [(n, h, w) for name, _, (h, w), n, _ in bench_k1.MAIN_PATH_CASES
             if name in bench_k1.TRACK_CASES]
    calls = json.loads((run.HERE / "configs" / "kitti_stereo_vo.json").read_text())[
        "k1_track_calls"]
    assert sorted(map(tuple, calls)) == sorted(cases)
    assert abs(kernels.k1_bound_s(calls) * 1e3 - 0.005243) < 5e-7
