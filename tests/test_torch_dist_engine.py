"""Distributed window BA as a live engine mode of the port
(`VOConfig(distribute_ba=True)`), against the port's single-device run
and the JAX package's distributed engine, on the CPU.

tests/test_dist_engine.py's configuration and 14-frame stereo corridor
(rendered once by the JAX package), with `stats_deterministic=True` in
both packages, so that keyframe decisions follow the computed values and
not the moment a stats copy lands (the JAX package's asynchronous
dispatch otherwise moves its keyframe schedule from run to run). At world
size 1 the sharded solve is bit-equal to the single-device one, so the
whole run is too; the JAX package's run rides its 8 virtual devices,
whose reduction order differs: centres within tests/test_torch_engine.py's
band between the two packages' engines, 0.01 m (measured: 3.4 mm).
Multi-rank runs are spawned gloo ranks (`tools/multiprocess_ba`), killed
past 120 s.
"""

import os

import numpy as np
import pytest
import torch

from viso_tpu.slam.engine import StereoVO as JStereoVO
from viso_tpu.utils import metrics as j_metrics
from viso_tpu_torch.parallel import mesh as mesh_mod
from viso_tpu_torch.slam.engine import MonocularVO, StereoVO, VOConfig
from viso_tpu_torch.slam.full import StereoSLAM
from viso_tpu_torch.slam.loop_closure import LoopParams
from viso_tpu_torch.slam.mono_full import MonoSLAM
from viso_tpu_torch.tools import bench_k1, multiprocess_ba
from viso_tpu_torch.utils import debug, metrics

from tests.test_engine import corridor, render_forward, small_config  # noqa: F401
from tests.test_torch_run_cli import _in_case_table, _lines, k1_calls  # noqa: F401

torch.set_num_threads(2)

ATE_M = 0.05
CENTER_BAND_M = 0.01


def _config(**kw) -> VOConfig:
    """tests/test_engine.py's small_config, in the port."""
    cfg = small_config(**kw)
    return VOConfig(**{f: getattr(cfg, f) for f in VOConfig.__dataclass_fields__})


def _centres(vo, frames):
    for il, ir in frames:
        vo.process(il, ir)
    R, t = vo.trajectory()
    vo.close()
    return metrics.camera_centers(R, t)


@pytest.fixture(scope="module")
def frames14(corridor):  # noqa: F811
    return render_forward(corridor, 14, stereo=True)


@pytest.fixture(scope="module")
def port_runs(frames14):
    frames, _ = frames14
    return (_centres(StereoVO(_config(stats_deterministic=True), device="cpu"), frames),
            _centres(StereoVO(_config(distribute_ba=True, stats_deterministic=True),
                              device="cpu"), frames))


def test_world_one_distributed_stereo_vo_equals_single_device(frames14, port_runs):
    _, (Rs, ts) = frames14
    c_single, c_dist = port_runs
    np.testing.assert_array_equal(c_dist, c_single)
    c_gt = metrics.camera_centers(Rs, ts)
    assert metrics.ate_rmse(c_dist, c_gt, align=True, with_scale=False) < ATE_M


def test_distributed_stereo_vo_matches_jax_package(frames14, port_runs):
    """tests/test_dist_engine.py's run on the JAX package's 8-device mesh
    against the port's distributed run."""
    frames, (Rs, ts) = frames14
    jvo = JStereoVO(small_config(distribute_ba=True, stats_deterministic=True))
    for il, ir in frames:
        jvo.process(il, ir)
    R_j, t_j = jvo.trajectory()
    jvo.close()
    c_jax = j_metrics.camera_centers(R_j, t_j)
    c_gt = j_metrics.camera_centers(Rs, ts)
    _, c_dist = port_runs
    assert j_metrics.ate_rmse(c_jax, c_gt, align=True, with_scale=False) < ATE_M
    assert metrics.ate_rmse(c_dist, c_gt, align=True, with_scale=False) < ATE_M
    assert np.abs(c_dist - c_jax).max() < CENTER_BAND_M


def test_world_one_distributed_slam(corridor):  # noqa: F811
    """tests/test_dist_engine.py's StereoSLAM (loop database and pose-graph
    hooks on) with its window BA on the group; no engine program writes
    into what the engine keeps of an earlier frame
    (`debug.snapshot_versions`)."""
    frames, (Rs, ts) = render_forward(corridor, 10, stereo=True)
    vo = StereoSLAM(_config(distribute_ba=True),
                    LoopParams(capacity=16, num_features=64, guard=4), device="cpu")
    snaps = []
    for k, (il, ir) in enumerate(frames):
        r = vo.process(il, ir)
        if r.is_keyframe:
            snaps.append(debug.snapshot_versions(vo))
    R_est, t_est = vo.trajectory()
    vo.close()
    assert vo.hook_errors == [] and len(vo.pg_raw_R) >= 3 and len(snaps) >= 3
    for snap in snaps:
        debug.assert_no_donation(snap)
    c_est = metrics.camera_centers(R_est, t_est)
    ate = metrics.ate_rmse(c_est, metrics.camera_centers(Rs, ts), align=True, with_scale=False)
    assert ate < ATE_M, ate


def test_two_gloo_ranks_engine_with_pinned_cadence():
    """`multiprocess_ba --engine` over 2 spawned gloo ranks: each rank's
    distributed StereoVO within 0.05 m of its single-rank run, both ATEs
    below 0.08 m, and the two ranks' trajectories equal."""
    ranks = multiprocess_ba.launch(multiprocess_ba.engine_rank, 2, device="cpu")
    for r in ranks:
        assert multiprocess_ba.engine_ok(r), r
        np.testing.assert_array_equal(r["c_dist"], ranks[0]["c_dist"])
        np.testing.assert_array_equal(r["c_single"], ranks[0]["c_single"])
    assert [r["rank"] for r in ranks] == [0, 1] and ranks[0]["world"] == 2


def test_two_gloo_ranks_of_stereo_slam(corridor):  # noqa: F811
    """tests/test_dist_engine.py's StereoSLAM (10 corridor frames, loop
    database and pose-graph hooks on) with stats_deterministic over 2
    spawned gloo ranks (`multiprocess_ba.slam_rank`, frames passed as
    numpy): the ranks' raw and corrected trajectories equal, each rank
    within CENTER_BAND_M of the port's world-1 run and of the JAX
    package's `StereoSLAM(distribute_ba=True)` on its 8 virtual devices,
    ATE below ATE_M, no hook error."""
    from viso_tpu.slam.full import StereoSLAM as JStereoSLAM
    from viso_tpu.slam.loop_closure import LoopParams as JLoopParams

    frames, (Rs, ts) = render_forward(corridor, 10, stereo=True)
    lp = dict(capacity=16, num_features=64, guard=4)
    cfg = _config(distribute_ba=True, stats_deterministic=True)
    ranks = multiprocess_ba.launch(multiprocess_ba.slam_rank, 2,
                                   args=(frames, cfg, LoopParams(**lp)), device="cpu")
    world1 = multiprocess_ba.slam_rank("cpu", frames, cfg, LoopParams(**lp))
    jvo = JStereoSLAM(small_config(distribute_ba=True, stats_deterministic=True),
                      loop_params=JLoopParams(**lp))
    for il, ir in frames:
        jvo.process(il, ir)
    R_j, t_j = jvo.trajectory()
    jvo.close()
    c_jax = j_metrics.camera_centers(R_j, t_j)
    c_gt = metrics.camera_centers(Rs, ts)
    assert [r["rank"] for r in ranks] == [0, 1] and ranks[0]["world"] == 2
    assert world1["world"] == 1 and not world1["hook_errors"]
    for r in ranks:
        assert not r["hook_errors"] and r["window_bas"] > 0 and r["nodes"] >= 2, r
        np.testing.assert_array_equal(r["c_raw"], ranks[0]["c_raw"])
        np.testing.assert_array_equal(r["c"], ranks[0]["c"])
        assert np.abs(r["c"] - world1["c"]).max() < CENTER_BAND_M
        assert np.abs(r["c"] - c_jax).max() < CENTER_BAND_M
        assert metrics.ate_rmse(r["c"], c_gt, align=True, with_scale=False) < ATE_M


def test_two_gloo_ranks_of_the_cli_in_mono_slam_mode(tmp_path):
    """`run.main(["--distribute", "--mode", "mono-slam", ...])` on the
    CLI's synthetic run over 2 spawned gloo ranks (`multiprocess_ba.
    cli_rank`): mono reaches tracking on both, their trajectories and
    summaries are equal (rank 1's in --out-dir/rank1), no keyframe hook
    failed, and the run is within tests/test_run_cli.py's mono-slam
    bounds (a finite scale-aligned ATE below 2 m)."""
    out = str(tmp_path / "out")
    argv = ["--distribute", "--dataset", "synthetic", "--mode", "mono-slam",
            "--max-frames", "14", "--out-dir", out]
    summaries = [r["summary"] for r in multiprocess_ba.launch(multiprocess_ba.cli_rank, 2,
                                                               args=(argv,), device="cpu")]
    dirs = [out, os.path.join(out, "rank1")]
    trajs = [np.loadtxt(os.path.join(d, "trajectory.txt")) for d in dirs]
    states = [[r["state"] for r in _lines(os.path.join(d, "frames.jsonl"))] for d in dirs]
    np.testing.assert_array_equal(trajs[1], trajs[0])
    assert states[0] == states[1] and states[0][-1] == "tracking", states
    for s in summaries:
        assert s["ate_rmse_m"] == summaries[0]["ate_rmse_m"] and s["hook_errors"] == 0
        assert np.isfinite(s["ate_rmse_m"]) and s["ate_rmse_m"] < 2.0


def test_distributed_backend_resolution():
    """As viso_tpu/slam/engine.py:519-530: an explicit photometric backend
    with distribute_ba raises; "auto" resolves to reprojection, the mono
    engine's default included."""
    vo = StereoVO(_config(distribute_ba=True, ba_backend="photometric"), device="cpu")
    vo.kf_order = [0, 1]
    with pytest.raises(ValueError, match="reprojection"):
        vo._run_window_ba([0])
    assert MonocularVO(_config(), device="cpu")._ba_backend() == "photometric"
    assert MonocularVO(_config(distribute_ba=True), device="cpu")._ba_backend() == "reprojection"
    assert StereoVO(_config(ba_backend="photometric"), device="cpu")._ba_backend() == "photometric"


def test_multi_rank_guards(monkeypatch):
    """Over more than one rank both SLAM engines run under
    `stats_deterministic` and are refused without it, as StereoVO is: a
    keyframe policy that reads stats whenever they land would part the
    ranks."""
    monkeypatch.setattr(mesh_mod, "make_mesh",
                        lambda n=None, device="cuda": mesh_mod.Mesh(None, 0, 2, torch.device(device)))
    for slam_cls in (StereoSLAM, MonoSLAM):
        slam = slam_cls(_config(distribute_ba=True, stats_deterministic=True), device="cpu")
        try:
            assert slam._mesh().size == 2
        finally:
            slam.close()
        with pytest.raises(ValueError, match="kf_min_gap == kf_max_gap"):
            slam_cls(_config(distribute_ba=True), device="cpu")
    with pytest.raises(ValueError, match="kf_min_gap == kf_max_gap"):
        StereoVO(_config(distribute_ba=True), device="cpu")
    assert StereoVO(_config(distribute_ba=True, kf_max_gap=2), device="cpu")._mesh().size == 2
    assert StereoVO(_config(distribute_ba=True, stats_deterministic=True),
                    device="cpu")._mesh().size == 2


def test_phase10_engine_runs_call_k1_at_table_shapes(k1_calls):  # noqa: F811
    """The distributed engine runs of chip_smoke.py phase 10 (the mesh
    dryrun's StereoSLAM and the multi-process engine's StereoVO, here at
    world size 1) make every K1 call at a shape of bench_k1's table, where
    phase 3 holds K1 against its plain version."""
    assert len(bench_k1.MAIN_PATH_CASES) > 0
    frames, Rs, ts = multiprocess_ba.dryrun_frames()
    vo = multiprocess_ba.dryrun_slam("cpu", distribute_ba=True, stats_deterministic=True)
    for il, ir in frames:
        vo.process(il, ir)
    vo.join()
    t_fin = vo.t.numpy()
    assert len(vo.pg_raw_R) >= 3 and len(vo.kf_order) >= 3 and abs(float(t_fin[2])) > 0.2
    vo.close()
    frames, _, _, intr_kw = multiprocess_ba.engine_frames()
    vo = StereoVO(multiprocess_ba.engine_config(intr_kw, distribute_ba=True), device="cpu")
    for il, ir in frames[:6]:
        vo.process(il, ir)
    vo.close()
    _in_case_table(k1_calls)


def test_close_frees_the_engine_programs():
    """`close()` drops the engine's programs, so that their graphs go at
    once and not when the engine's reference cycles are collected: a graph
    that captured NCCL collectives (`ba_solve`) keeps the process group
    from being destroyed."""
    import weakref

    frames, _, _, intr_kw = multiprocess_ba.engine_frames()
    vo = StereoVO(multiprocess_ba.engine_config(intr_kw, distribute_ba=True), device="cpu")
    for il, ir in frames[:6]:
        vo.process(il, ir)
    assert {"track", "ba_prep", "ba_solve", "ba_finish"} <= set(vo._kernels)
    refs = [weakref.ref(p) for p in vo._kernels.values()]
    vo.close()
    assert vo._kernels == {} and all(r() is None for r in refs)
