"""The port's utilities and BA tools on the CPU: `direct.estimate_pose`
against the JAX package's, `utils/debug.py` (finite-state audit, the
snapshot-version form of the no-donation invariant), `utils/profiling.py`
and each new tool's `main` at a tiny size with `--device cpu`."""

import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viso_tpu.geometry import camera as j_cam
from viso_tpu.geometry import se3 as j_se3
from viso_tpu.ops import direct as j_direct
from viso_tpu.ops import pyramid as j_pyr
from viso_tpu_torch.geometry import camera as t_cam
from viso_tpu_torch.geometry import se3 as t_se3
from viso_tpu_torch.ops import direct as t_direct
from viso_tpu_torch.ops import pyramid as t_pyr
from viso_tpu_torch.slam.engine import StereoVO, VOConfig
from viso_tpu_torch.slam.full import StereoSLAM
from viso_tpu_torch.tools import (bench_backends, bench_ba, bench_dist_ba, calib_ba_iter,
                                  multiprocess_ba)
from viso_tpu_torch.utils import debug, profiling

from tests.test_frontend import _render_plane, smooth_texture

torch.set_num_threads(2)

SMALL = dict(height=64, width=96, max_keyframes=2, max_landmarks=32, num_features=16,
             detect_grid=(2, 2), fx=100.0, fy=100.0, cx=47.5, cy=31.5)


def test_estimate_pose_matches_jax(rng):
    """tests/test_frontend.py::test_direct_pose_estimation_recovers_motion's
    case through both packages. The templates agree to f32 rounding (1e-4
    on Jacobian entries up to ~300, 1e-5 relative elsewhere); the
    pose is `estimate_pose_templated` on them, bit for bit. Both packages
    recover the true second pose within the reference test's 0.01 twist
    and cost < 30, and their final costs agree to 1e-2 relative, but not
    their poses to 1e-4 as tests/test_torch_frontend.py's GN parity does:
    this plane's level-0 normal matrix has a condition number of about
    4e5, so float32 sums in another order move the weak lateral-
    translation/yaw direction by up to ~1e-2 (measured: 0.0097 twist
    between the packages, each 0.004-0.006 from the truth)."""
    intr = j_cam.Intrinsics.create(120.0, 120.0, 80.0, 60.0)
    tex = smooth_texture(rng, 256, 256)
    R1 = np.eye(3, dtype=np.float32)
    t1 = np.zeros(3, np.float32)
    xi_true = np.array([0.08, -0.05, 0.03, 0.01, -0.015, 0.01], np.float32)
    R2, t2 = (np.asarray(x) for x in j_se3.se3_exp(jnp.array(xi_true)))
    img1, pts_w = _render_plane(intr, R1, t1, tex)
    img2, _ = _render_plane(intr, R2, t2, tex)
    points = pts_w[rng.integers(10, 110, 80), rng.integers(10, 150, 80)].astype(np.float32)
    pyr_j = [j_pyr.build_pyramid(jnp.array(img)) for img in (img1, img2)]
    Rj, tj, cj = j_direct.estimate_pose(
        *pyr_j, jnp.array(R1), jnp.array(t1), jnp.array(points), jnp.ones(80, bool), intr,
        jnp.array(R1), jnp.array(t1),
    )
    T = torch.from_numpy
    pyr_t = [t_pyr.build_pyramid(T(np.asarray(img, np.float32))) for img in (img1, img2)]
    intr_t = t_cam.Intrinsics.create(120.0, 120.0, 80.0, 60.0)
    mask = torch.ones(80, dtype=torch.bool)
    Rt, tt, ct = t_direct.estimate_pose(*pyr_t, T(R1), T(t1), T(points), mask, intr_t,
                                        T(R1), T(t1))
    tmpl_t = t_direct.build_templates(pyr_t[0], T(R1), T(t1), T(points), mask, intr_t)
    tmpl_j = j_direct.build_templates(pyr_j[0], jnp.array(R1), jnp.array(t1),
                                      jnp.array(points), jnp.ones(80, bool), intr)
    for lt, lj in zip(tmpl_t, tmpl_j, strict=True):
        for a, b in zip(lt, lj, strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)
    R_c, t_c, c_c = t_direct.estimate_pose_templated(tmpl_t, pyr_t[1], T(points), intr_t,
                                                     T(R1), T(t1))
    assert torch.equal(R_c, Rt) and torch.equal(t_c, tt) and torch.equal(c_c, ct)
    jax_pose = (torch.tensor(np.asarray(Rj)), torch.tensor(np.asarray(tj)), cj)
    for R, t, c in ((Rt, tt, ct), jax_pose):
        xi_err = t_se3.se3_log(*t_se3.compose(*t_se3.inverse(R, t), T(R2), T(t2))).numpy()
        assert np.linalg.norm(xi_err) < 0.01, xi_err
        assert float(c) < 30.0
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-2)


def test_debug_finite_state_audit():
    """tests/test_utils.py::test_debug_finite_state_audit on the port:
    check_finite_state flags exactly the poisoned field, on a VO engine
    and a SLAM engine's pose graph and loop database."""
    vo = StereoVO(VOConfig(**SMALL), device="cpu")
    assert debug.check_finite_state(vo) == []
    vo.map = vo.map._replace(points=vo.map.points.clone().index_put_(
        (torch.tensor(3), torch.tensor(1)), torch.tensor(float("nan"))))
    assert debug.check_finite_state(vo) == ["map.points"]
    vo.close()
    slam = StereoSLAM(VOConfig(**SMALL), device="cpu")
    slam.pg_raw_R = [np.eye(3, dtype=np.float32)]
    slam.pg_t = [np.array([0.0, np.inf, 0.0], np.float32)]
    slam.loop_db.points_w_dev[0, 0, 2] = float("nan")
    assert debug.check_finite_state(slam) == ["pg_t", "loop_db.points_w_dev"]
    slam.close()


def test_assert_no_donation_catches_in_place_writes():
    """The engine's state is written in place (the captured programs read
    fixed addresses); what it keeps of earlier frames is not."""
    vo = StereoVO(VOConfig(**SMALL), device="cpu")
    vo._record(num_tracked=0)
    vo._record(num_tracked=0)
    snap = debug.snapshot_versions(vo)
    assert {"results[0].R", "results[0].t", "results[1].R"} <= {name for name, _, _ in snap}
    # Writes into the state, map and pose, leave the snapshot intact.
    vo.map = vo.map._replace(points=vo.map.points + 1.0)
    vo.R, vo.t = 2.0 * vo.R, vo.t + 1.0
    debug.assert_no_donation(snap)
    assert float(vo.results[1].t.sum()) == 0.0 and float(vo.t.sum()) == 3.0
    # An in-place write into a tensor the snapshot holds is caught.
    [x for name, x, _ in snap if name == "results[1].t"][0][0] = 5.0
    with pytest.raises(AssertionError, match=r"results\[1\]\.t"):
        debug.assert_no_donation(snap)
    vo.close()


def test_enable_nan_checks_toggles_anomaly_mode():
    try:
        debug.enable_nan_checks(True)
        assert torch.is_anomaly_enabled()
    finally:
        debug.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()


def test_stage_timer_and_device_trace(tmp_path):
    timer = profiling.StageTimer()
    with timer.time("outer"):
        out = timer.timed("matmul", torch.matmul, torch.ones(8, 8), torch.ones(8, 8))
    timer.timed("tuple", lambda: (torch.zeros(2), {"a": [torch.ones(1)]}), block=True)
    assert out.shape == (8, 8) and float(out[0, 0]) == 8.0
    assert dict(timer.counts) == {"outer": 1, "matmul": 1, "tuple": 1}
    assert timer.totals["outer"] >= timer.totals["matmul"] > 0
    lines = timer.report().splitlines()
    assert len(lines) == 3 and lines[0].startswith("outer")
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        torch.matmul(torch.ones(16, 16), torch.ones(16, 16))
    path = tmp_path / "trace" / "trace.json"
    assert path.exists() and "traceEvents" in json.loads(path.read_text())
    assert any("matmul" in e.key for e in prof.key_averages())


def test_profiler_window_counts_the_fence_on_each_side_of_the_stage():
    class Ev:
        def __init__(self, name, start, device_type=torch.autograd.DeviceType.CUDA):
            self.name, self.device_type = name, device_type
            self.time_range = types.SimpleNamespace(start=start, end=start + 1)

    def fence(t0, n):
        return [Ev(profiling.PAD_KERNEL, t0 + 2 * i) for i in range(n)]

    stage = [Ev("gather", 1000), Ev("sum", 1002),
             Ev("aten::sum", 999, torch.autograd.DeviceType.CPU)]
    kernels, pre, post = profiling.window_kernels(fence(0, 5) + stage + fence(2000, 7))
    assert [e.name for e in kernels] == ["gather", "sum"] and (pre, post) == (5, 7)
    assert profiling.window_kernels(stage + fence(2000, 7))[1:] == (0, 7)
    assert profiling.window_kernels(fence(0, 5) + stage)[1:] == (5, 0)
    assert profiling.window_kernels(fence(0, 5) + stage[2:] + fence(2000, 7)) == ([], None, None)


def test_profile_stage_on_the_cpu_takes_one_window():
    calls = []

    def stage():
        calls.append(1)
        return torch.ones(4, 4) @ torch.ones(4, 4)

    row = profiling.profile_stage("matmul", stage, reps=2, counter=lambda: len(calls))
    assert row["launches"] == 1 and len(calls) == 1 + 2 + 2 + 1
    assert row["tries"] is row["fence"] is row["kernels"] is None
    assert row["device_ms"] is row["stream_ms"] is None
    assert row["host_ms"] > 0 and row["wall_ms"] > 0


def _json_lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_bench_dist_ba_main(capsys):
    assert bench_dist_ba.main(["--device", "cpu", "--cams", "4", "--landmarks", "64",
                               "--iters", "2", "--worlds", "1", "2"]) == 0
    recs = _json_lines(capsys)
    assert [r["world"] for r in recs] == [1, 2]
    for r in recs:
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        assert r["allreduce_bytes_per_iter"] == r["psum_bytes_per_iter"] == 3084
        assert r["allreduce_calls_per_iter"] == 2
        assert r["allreduce_ms_per_iter"] == "not measured"
        assert r["ranks_share_one_card"] is False and r["lm_iters_per_s"] > 0
    assert [r["landmarks_per_rank"] for r in recs] == [64, 32]
    np.testing.assert_allclose(recs[1]["final_cost"], recs[0]["final_cost"], rtol=1e-3, atol=1e-9)


def test_bench_ba_and_calib_main(capsys):
    assert bench_ba.main(["--device", "cpu", "--cams", "6", "--landmarks", "64",
                          "--iters", "2"]) == 0
    assert calib_ba_iter.main(["--device", "cpu", "--cams", "4", "--iters", "2",
                               "--landmarks", "128", "64"]) == 0
    ba_rec, calib = _json_lines(capsys)
    assert ba_rec["metric"] == "ba_iters_per_s_6kf_64lm" and ba_rec["device"] == "cpu"
    assert ba_rec["value"] > 0 and ba_rec["final_cost"] < ba_rec["initial_cost"]
    assert set(calib["t_iter_s"]) == {"128", "64"} and calib["device"] == "cpu"
    assert calib["a_s_per_lm_iter"] >= 0 and calib["b_s_per_iter"] >= 0


def test_bench_backends_main(capsys):
    assert bench_backends.main(["--device", "cpu", "--frames", "5", "--reps", "1"]) == 0
    recs = _json_lines(capsys)
    assert [r["backend"] for r in recs] == ["reprojection", "photometric"]
    for r in recs:
        assert r["ate_rmse_m"] < 0.05 and r["ba_ms_per_keyframe"] > 0 and r["device"] == "cpu"


def test_multiprocess_ba_main(capsys):
    assert multiprocess_ba.main(["--device", "cpu", "--procs", "2"]) == 0
    assert "MULTIPROCESS BA OK (2 processes, cpu)" in capsys.readouterr().out


@pytest.mark.parametrize("tool", [bench_dist_ba, bench_ba, calib_ba_iter, bench_backends,
                                  multiprocess_ba])
def test_tools_need_cuda_unless_cpu_is_asked(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tool.main([])
