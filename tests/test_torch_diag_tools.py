"""The port's diagnostic and profiling tools on the CPU, at small sizes.

Each tool's `main` runs with `--device cpu` and ends on one JSON line of
its results (device "cpu", the device numbers None: not measured), and
refuses to run without a CUDA device unless `--device cpu` is given.
`diag_drift.drift_report` is held to the reference tool's arithmetic and
`diag_track_bias` to the JAX ops on the same frames. The loop funnel is
held across packages in tests/test_torch_slam.py, on the orbit both
packages run there.
"""

import json

import numpy as np
import pytest
import torch

from viso_tpu.data import synthetic as j_syn
from viso_tpu.geometry import camera as j_cam
from viso_tpu.geometry import se3 as j_se3
from viso_tpu.ops import align as j_align
from viso_tpu.ops import direct as j_direct
from viso_tpu.ops import fast as j_fast
from viso_tpu.ops import pnp as j_pnp
from viso_tpu.ops import pyramid as j_pyramid
from viso_tpu.utils import metrics as j_metrics
from viso_tpu_torch.data.synthetic import so3_exp
from viso_tpu_torch.tools import (bench_pose_graph, diag_drift, diag_loops, diag_mono_seam,
                                  diag_track_bias, multiprocess_ba, profile_device,
                                  profile_direct, profile_frame, profile_track)

torch.set_num_threads(2)

SMALL = ["--height", "96", "--width", "320", "--reps", "1"]
TOOLS = {
    "diag_loops": (diag_loops, ["--frames", "6"]),
    "diag_loops --mono": (diag_loops, ["--frames", "6", "--mono"]),
    "diag_drift": (diag_drift, ["--frames", "8"]),
    "diag_track_bias": (diag_track_bias, ["--frames", "2"]),
    "diag_mono_seam": (diag_mono_seam, ["--frames", "10"]),
    "profile_frame": (profile_frame, SMALL),
    "profile_track": (profile_track, SMALL),
    "profile_direct": (profile_direct, SMALL),
    "profile_device": (profile_device, ["--frames", "2", "--height", "96", "--width", "320"]),
    "bench_pose_graph": (bench_pose_graph, ["--nodes", "20", "--reps", "2"]),
}


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_runs_on_the_cpu_when_asked(capsys, name):
    tool, argv = TOOLS[name]
    assert tool.main(argv + ["--device", "cpu"]) == 0
    out = last_json(capsys)
    assert out["device"] == "cpu"
    stages = out.get("stages", []) + out.get("level0", [])
    for lv in out.get("levels", []):
        stages += [lv["gn_pass"], lv["gn_kernel"], lv["k1"], lv["sampler"]]
    for st in stages:
        # No device number from a CPU run; host times only.
        assert st["device_ms"] is None and st["stream_ms"] is None and st["kernels"] is None
        assert st["host_ms"] >= 0 and st["wall_ms"] >= 0 and st["launches"] == 0
    if name.startswith("diag_loops"):
        f = out["funnel"]
        assert list(f) == [s for s in diag_loops.STAGES
                           if s != "scale_gate" or name.endswith("--mono")]
        assert f["keyframes"] >= 1 and f["loops"] == len(out["loops"])
    if name == "diag_drift":
        assert out["frames"] == 8 and np.isfinite(out["ate_rmse_m"])
    if name == "diag_track_bias":
        assert len(out["rows"]) == 2 and all(r["aligned"] > 50 for r in out["rows"])
    if name == "profile_frame":
        names = [st["name"] for st in stages]
        for prog in ("track", "templates", "stereo_kf", "ba"):
            assert prog in names and prog + "_eager" in names
    if name == "bench_pose_graph":
        # Eager solves and the program's calls (eager on the CPU) bit-equal.
        assert [g["key"] for g in out["graphs"]] == [["pose_graph", 32, 64],
                                                     ["pose_graph_sim3", 32, 64]]
        for g in out["graphs"]:
            assert g["bit_equal"] and g["max_gap"] == 0.0 and g["eager"] == 2
            assert g["device_ms"] is None and g["pool_bytes"] is None
            assert g["final_cost"] < 1e-3
    if name == "profile_device":
        assert out["frames"] == 2 and out["burst_s"] > 0 and out["k1_launches_per_frame"] == 0
        for key in ("on_device_fps", "device_ms_per_frame", "kernels_per_frame"):
            assert out[key] is None      # not measured on the CPU


@pytest.mark.parametrize("name", sorted({n.split()[0] for n in TOOLS}))
def test_tool_refuses_without_a_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        TOOLS[name][0].main([])


def test_multiprocess_launch_defaults_to_the_card(monkeypatch):
    """`multiprocess_ba.launch` runs its ranks on the card unless the CPU
    is asked for: without one it raises before it spawns a rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multiprocess_ba.launch(multiprocess_ba.ba_rank, 2)


def reference_report(R_est, t_est, kf_flags, n_tracked, Rs_gt, ts_gt):
    """tools/diag_drift.py:99-136 as the reference tool computes it (with
    the JAX package's metrics)."""
    def rot_angle(R):
        return float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))

    def rel(Ra, ta, Rb, tb):
        R = Ra @ Rb.T
        return R, ta - R @ tb

    n = len(R_est)
    yaw_err, rot_err, trans_err = np.zeros(n), np.zeros(n), np.zeros(n)
    for i in range(1, n):
        Re, te = rel(R_est[i], t_est[i], R_est[i - 1], t_est[i - 1])
        Rg, tg = rel(Rs_gt[i], ts_gt[i], Rs_gt[i - 1], ts_gt[i - 1])
        E = Re @ Rg.T
        rot_err[i] = rot_angle(E)
        w = np.array([E[2, 1] - E[1, 2], E[0, 2] - E[2, 0], E[1, 0] - E[0, 1]])
        yaw_err[i] = 0.5 * w[1]
        trans_err[i] = np.linalg.norm(te - tg)
    E_end = R_est[n - 1] @ Rs_gt[n - 1].T @ (R_est[0] @ Rs_gt[0].T).T
    kf = kf_flags.astype(bool)
    tr = ~kf
    out = {
        "frames": n,
        "keyframes": int(kf.sum()),
        "total_rot_drift_rad": rot_angle(E_end),
        "sum_signed_yaw_err_rad": float(yaw_err.sum()),
        "per_frame_rot_err_mean_rad": float(rot_err[1:].mean()),
        "tracked_yaw_bias_rad_per_frame": float(yaw_err[tr][1:].mean())
        if tr.sum() > 1 else 0.0,
        "keyframe_yaw_bias_rad_per_frame": float(yaw_err[kf].mean()) if kf.sum() else 0.0,
        "tracked_trans_err_mean_m": float(trans_err[tr][1:].mean()),
        "keyframe_trans_err_mean_m": float(trans_err[kf].mean()) if kf.sum() else 0.0,
        "mean_n_tracked": float(n_tracked[5:].mean()),
        "min_n_tracked": int(n_tracked[5:].min()),
    }
    c_est = j_metrics.camera_centers(R_est, t_est)
    c_gt = j_metrics.camera_centers(Rs_gt[:n], ts_gt[:n])
    out["ate_rmse_m"] = float(j_metrics.ate_rmse(c_est, c_gt, align=True, with_scale=False))
    return out


def test_drift_report_is_the_reference_arithmetic():
    """A ground-truth path yawing 0.01 rad per frame, and an estimate that
    adds a yaw bias b = 0.003 rad on each tracked frame (none on the
    keyframes, every fourth frame) and 2 mm of translation noise: the
    report equals the reference tool's to 1e-6, and its yaw split is the
    known one (sin b per tracked frame, 0 per keyframe; the end drift the
    accumulated bias)."""
    rng = np.random.default_rng(0)
    n, b = 40, 0.003
    kf = np.arange(n) % 4 == 0
    yaw_gt = 0.01 * np.arange(n)
    yaw_est = yaw_gt + b * np.cumsum(~kf & (np.arange(n) > 0))
    Rs = np.stack([so3_exp(np.array([0.0, y, 0.0])) for y in yaw_gt]).astype(np.float64)
    Re = np.stack([so3_exp(np.array([0.0, y, 0.0])) for y in yaw_est]).astype(np.float64)
    c = np.stack([np.sin(yaw_gt), np.zeros(n), 0.3 * np.arange(n)], -1)
    ts = -np.einsum("nij,nj->ni", Rs, c)
    te = -np.einsum("nij,nj->ni", Re, c + rng.normal(0, 0.002, (n, 3)))
    n_tracked = rng.integers(40, 200, n)
    got = diag_drift.drift_report(Re, te, kf, n_tracked, Rs, ts)
    arrays = got.pop("_arrays")
    want = reference_report(Re, te, kf, n_tracked, Rs, ts)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(got["tracked_yaw_bias_rad_per_frame"], np.sin(b), atol=1e-6)
    assert abs(got["keyframe_yaw_bias_rad_per_frame"]) < 1e-6
    np.testing.assert_allclose(got["total_rot_drift_rad"], b * (~kf[1:]).sum(), atol=1e-6)
    np.testing.assert_allclose(arrays["yaw_err"][1:][~kf[1:]], np.sin(b), atol=1e-6)


def jax_track_bias(frames, step, iters):
    """tools/diag_track_bias.py's loop through the JAX ops (corridor)."""
    import jax.numpy as jnp

    H, W, fx = diag_track_bias.H, diag_track_bias.W, diag_track_bias.FX
    intr = j_cam.Intrinsics.create(fx, fx, diag_track_bias.CX, diag_track_bias.CY)
    sc = j_syn.corridor_scene(np.random.default_rng(5), tex_size=1024, far_z=90.0)
    Rs, ts = j_syn.forward_trajectory(frames + 1, step=step, yaw_rate=0.002)
    kf_img, kf_depth = sc.render(intr, Rs[0], ts[0], H, W)
    kf_pyr = j_pyramid.build_pyramid(jnp.asarray(kf_img, jnp.float32), 4)
    uv, _, mask = j_fast.detect_grid(kf_pyr[0], threshold=8.0, grid=(4, 8), per_cell=32)
    uv_np = np.asarray(uv)
    z = np.asarray(kf_depth)[np.clip(uv_np[:, 1].astype(int), 0, H - 1),
                             np.clip(uv_np[:, 0].astype(int), 0, W - 1)]
    mask = np.asarray(mask) & (z > 0.1) & np.isfinite(z)
    x_n = np.asarray(j_cam.normalize(uv, intr))
    p_cam = np.concatenate([x_n * z[:, None], z[:, None]], axis=-1)
    R0, t0 = np.asarray(Rs[0]), np.asarray(ts[0])
    pts_w = jnp.asarray((p_cam - t0) @ R0, jnp.float32)
    mask_j = jnp.asarray(mask)
    templates = j_direct.build_templates(kf_pyr, jnp.asarray(R0), jnp.asarray(t0), pts_w,
                                         mask_j, intr)
    rows = []
    for k in range(1, frames + 1):
        img, _ = sc.render(intr, Rs[k], ts[k], H, W)
        pyr = j_pyramid.build_pyramid(jnp.asarray(img, jnp.float32), 4)
        Rp, tp = jnp.asarray(Rs[k - 1]), jnp.asarray(ts[k - 1])
        if k >= 2:
            dR, dt = j_se3.relative(jnp.asarray(Rs[k - 1]), jnp.asarray(ts[k - 1]),
                                    jnp.asarray(Rs[k - 2]), jnp.asarray(ts[k - 2]))
            Rp, tp = j_se3.compose(dR, dt, Rp, tp)
        R_d, t_d, _ = j_direct.estimate_pose_templated(templates, pyr, pts_w, intr, Rp, tp,
                                                       j_direct.DirectParams(iters=iters))
        uv_pred, depth = j_cam.project(j_se3.transform(R_d, t_d, pts_w), intr)
        visible = mask_j & (depth > 0.1) & j_cam.is_inside(uv_pred, H, W, border=8)
        refined, _, ok = j_align.align(tuple(lvl[None] for lvl in kf_pyr),
                                       jnp.zeros(pts_w.shape[0], jnp.int32), uv, pyr,
                                       uv_pred, visible, j_align.AlignParams(iters=5))
        R_f, t_f = j_pnp.refine_pose(R_d, t_d, pts_w, j_cam.normalize(refined, intr),
                                     ok.astype(jnp.float32), huber=2.0 / fx, iters=4)

        def step_of(Rx, tx):
            _, tr = j_se3.relative(jnp.asarray(Rx), jnp.asarray(tx),
                                   jnp.asarray(Rs[k - 1]), jnp.asarray(ts[k - 1]))
            return np.asarray(tr)

        gt, d, f = step_of(Rs[k], ts[k]), step_of(R_d, t_d), step_of(R_f, t_f)
        rows.append(dict(gt_step_m=np.linalg.norm(gt), direct_step_m=np.linalg.norm(d),
                         refined_step_m=np.linalg.norm(f), direct_err_m=np.linalg.norm(d - gt),
                         refined_err_m=np.linalg.norm(f - gt), aligned=int(ok.sum())))
    return rows, int(mask.sum())


# Per-stage step lengths and errors of the port against the JAX ops on the
# same 4 corridor frames: within 5e-5 m (measured on the CPU: 6e-6 m at
# most, on the refined step of frame 3). Both compute in f32 and sum in
# other orders through GN, the alignment and the PnP refine; the aligned
# counts are equal.
TRACK_BIAS_TOL_M = 5e-5


def test_track_bias_matches_the_jax_ops():
    rows, n = diag_track_bias.run("corridor", 4, 0.15, 6, "cpu")
    want, n_j = jax_track_bias(4, 0.15, 6)
    assert n == n_j
    for got, ref in zip(rows, want, strict=True):
        for key in ("gt_step_m", "direct_step_m", "refined_step_m", "direct_err_m",
                    "refined_err_m"):
            assert abs(got[key] - ref[key]) < TRACK_BIAS_TOL_M, (key, got, ref)
        assert got["aligned"] == ref["aligned"]
