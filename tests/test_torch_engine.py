"""The whole slice: the port's StereoVO against viso_tpu's on the same
frames, on the CPU, plus each device program fed the same JAX map state.

Both engines run with `stats_deterministic=True`, so keyframe and lost
decisions follow a fixed schedule and depend on the computed values only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viso_tpu.data import synthetic as j_syn
from viso_tpu.geometry import camera as j_cam
from viso_tpu.geometry import se3 as j_se3
from viso_tpu.slam.engine import StereoVO as JStereoVO
from viso_tpu.slam.engine import VOConfig as JVOConfig
from viso_tpu.utils import metrics as j_metrics
from viso_tpu_torch.data import synthetic as t_syn
from viso_tpu_torch.geometry import camera as t_cam
from viso_tpu_torch.mapping import map_state as t_ms
from viso_tpu_torch.slam.engine import StereoVO, VOConfig
from viso_tpu_torch.utils import metrics

torch.set_num_threads(2)

# tests/test_engine.py's small configuration and 12-frame stereo corridor.
H, W = 192, 256
INTR = dict(fx=200.0, fy=200.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5)
CFG = dict(
    height=H, width=W, max_keyframes=6, max_landmarks=384, num_features=192,
    detect_grid=(4, 6), fast_threshold=15.0, baseline=0.3, max_disparity=48,
    kf_min_gap=2, stats_deterministic=True, **INTR,
)
N_FRAMES = 12
# Per-frame agreement band between the two engines. Both compute in f32
# but sum in different orders (einsum contraction order, cumsum, LU vs
# XLA's solve); through GN, LM and BA that reaches a few millimetres over
# the 2.75 m run (measured max 5.5 mm centre, ~0 deg rotation on CPU).
CENTER_BAND_M = 0.01
ROT_BAND_DEG = 0.1


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(7)
    corridor = j_syn.corridor_scene(rng, tex_size=512)
    intr = j_cam.Intrinsics.create(**INTR)
    Rs, ts = j_syn.forward_trajectory(N_FRAMES, step=0.25, yaw_rate=0.004)
    out = []
    for R, t in zip(Rs, ts):
        il, ir, _ = j_syn.make_stereo_pair(corridor, intr, R, t, H, W, baseline=0.3)
        out.append((np.clip(il, 0, 255).astype(np.uint8), np.clip(ir, 0, 255).astype(np.uint8)))
    return out, (Rs, ts)


@pytest.fixture(scope="module")
def runs(frames):
    imgs, _ = frames
    jvo = JStereoVO(JVOConfig(**CFG))
    tvo = StereoVO(VOConfig(**CFG), device="cpu")
    for il, ir in imgs:
        jvo.process(il, ir)
        tvo.process(il, ir)
    yield jvo, tvo
    jvo.close()
    tvo.close()


def _rot_deg(Ra, Rb):
    """Angle of Ra Rb^T, from its skew part (accurate near zero)."""
    D = Ra @ np.swapaxes(Rb, -1, -2)
    s = np.stack([D[..., 2, 1] - D[..., 1, 2], D[..., 0, 2] - D[..., 2, 0],
                  D[..., 1, 0] - D[..., 0, 1]], -1)
    return np.degrees(np.arcsin(np.clip(np.linalg.norm(s, axis=-1) / 2, 0, 1)))


def test_port_matches_reference_engine(runs):
    jvo, tvo = runs
    assert [r.is_keyframe for r in tvo.results] == [r.is_keyframe for r in jvo.results]
    assert tvo.kf_order == jvo.kf_order
    Rj, tj = jvo.trajectory()
    Rt, tt = tvo.trajectory()
    d = np.linalg.norm(metrics.camera_centers(Rt, tt) - metrics.camera_centers(Rj, tj), axis=-1)
    assert d.max() < CENTER_BAND_M, d
    assert _rot_deg(Rt, Rj).max() < ROT_BAND_DEG
    # Tracked counts agree to within a few landmarks per frame.
    nj = np.array([r.num_tracked for r in jvo.results])
    nt = np.array([r.num_tracked for r in tvo.results])
    assert np.abs(nj - nt).max() <= 0.05 * nj.max(), (nj, nt)


def test_port_tracks_trajectory(runs, frames):
    """tests/test_engine.py::test_stereo_vo_tracks_trajectory's bounds."""
    _, tvo = runs
    _, (Rs, ts) = frames
    R_est, t_est = tvo.trajectory()
    assert len(R_est) == N_FRAMES
    c_est = metrics.camera_centers(R_est, t_est)
    c_gt = metrics.camera_centers(Rs, ts)
    ate = metrics.ate_rmse(c_est, c_gt, align=True, with_scale=False)
    assert ate < 0.05, ate
    d_est = np.linalg.norm(c_est[-1] - c_est[0])
    d_gt = np.linalg.norm(c_gt[-1] - c_gt[0])
    assert abs(d_est / d_gt - 1.0) < 0.05
    assert min(r.num_tracked for r in tvo.results[1:]) > 30
    assert int(tvo.map.num_points) > 50 and tvo.results[0].is_keyframe


def _jax_map_to_port(m):
    return t_ms.from_numpy(
        {name: (tuple(np.asarray(a) for a in v) if name == "kf_pyr" else np.asarray(v))
         for name, v in zip(m._fields, m)},
        "cpu",
    )


def _close(a, b, tol):
    np.testing.assert_allclose(
        a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a), np.asarray(b),
        rtol=tol, atol=tol,
    )


def test_programs_match_on_the_reference_map(runs, frames):
    """Feed viso_tpu's map state (its 'weights') into the port's template,
    track, keyframe and BA programs and compare with viso_tpu's programs."""
    jvo, _ = runs
    imgs, _ = frames
    il, ir = imgs[-1]
    tvo = StereoVO(VOConfig(**CFG), device="cpu")
    m_t = _jax_map_to_port(jvo.map)
    slot = jvo.kf_order[-1]

    tmpl_j, active_j = jvo._kernels["templates"](jvo.map, slot)
    tmpl_t, active_t = tvo._templates_program(m_t, slot)
    assert np.array_equal(active_t.numpy(), np.asarray(active_j))
    for a, b in zip(tmpl_t, tmpl_j):
        assert np.array_equal(a.ok.numpy(), np.asarray(b.ok))
        _close(a.T, b.T, 1e-3)

    R, t, vel = (torch.tensor(np.asarray(x)) for x in (jvo.R, jvo.t, jvo.vel_xi))
    out_j = jvo._kernels["track"](jvo.map, tmpl_j, active_j, jnp.asarray(il), jvo.R, jvo.t,
                                  jvo.vel_xi)
    out_t = tvo._track(m_t, tmpl_t, active_t, torch.from_numpy(il), R, t, vel)
    R_j, t_j, ok_j, ref_j, stats_j = (np.asarray(x) for x in out_j[:5])
    # 4 levels x 6 direct GN steps, 2 x 5 LK steps and 4 LM steps in f32,
    # summed in other orders: from identical inputs the poses agree to
    # 1e-3 in rotation entries (0.06 deg) and 5 mm (measured 2.2e-4 and
    # 1.5 mm on CPU).
    _close(out_t[0], R_j, 1e-3)
    _close(out_t[1], t_j, 5e-3)
    assert np.abs(out_t[4].numpy() - stats_j).max() <= 2      # tracked counts
    both = ok_j & out_t[2].numpy()
    assert both.sum() >= 0.95 * ok_j.sum()
    # Refined positions start from predictions of poses that differ by
    # the above, and best-cost rollback may keep a different iterate:
    # median within 0.02 px, none beyond 0.5 px (measured 0.16 px max).
    dpx = np.abs(out_t[3].numpy()[both] - ref_j[both]).max(axis=-1)
    assert np.median(dpx) < 0.02 and dpx.max() < 0.5, np.sort(dpx)[-5:]

    new_slot = jvo.kf_order[0]
    pyr_j = out_j[5]
    m_kf_j = jvo._kernels["stereo_kf"](
        jvo.map, new_slot, jnp.asarray(True), jvo.R, jvo.t, 99, pyr_j,
        jnp.asarray(il), jnp.asarray(ir), out_j[2], out_j[3], jnp.asarray(True),
    )
    m_kf_t = tvo._stereo_kf_program(
        m_t, new_slot, True, R, t, 99, tuple(torch.tensor(np.asarray(p)) for p in pyr_j),
        torch.from_numpy(il), torch.from_numpy(ir),
        torch.tensor(np.asarray(out_j[2])), torch.tensor(np.asarray(out_j[3])), True,
    )
    jm = {k: np.asarray(v) for k, v in zip(m_kf_j._fields, m_kf_j) if k != "kf_pyr"}
    tm = t_ms.to_numpy(m_kf_t)
    for k in ("kf_mask", "kf_frame_id", "point_mask", "obs_mask"):
        agree = (tm[k] == jm[k]).mean()
        assert agree >= 0.99, (k, agree)       # borderline stereo matches may flip
    keep = tm["point_mask"] & jm["point_mask"]
    _close(tm["points"][keep], jm["points"][keep], 1e-2)      # metres, depth ~1-30 m

    # Window BA on the reference map with its landmarks perturbed by 2 cm,
    # so that LM has work to do.
    cam_fixed = np.zeros(CFG["max_keyframes"], bool)
    cam_fixed[jvo.kf_order[0]] = True
    noise = np.random.default_rng(11).normal(0, 0.02, (CFG["max_landmarks"], 3))
    pts = (np.asarray(jvo.map.points) + noise).astype(np.float32)
    # The engine runs BA right after inserting keyframe `slot`, with the
    # tracking pose equal to that keyframe's pose.
    R0, t0 = jvo.map.kf_R[slot], jvo.map.kf_t[slot]
    m_ba_j, cost_j, Rb_j, tb_j = jvo._kernels["ba"](
        jvo.map._replace(points=jnp.asarray(pts)), jnp.asarray(cam_fixed), slot, R0, t0)
    m_ba_t, cost_t, Rb_t, tb_t = tvo._ba_program(
        m_t._replace(points=torch.from_numpy(pts)), torch.from_numpy(cam_fixed), slot,
        torch.tensor(np.asarray(R0)), torch.tensor(np.asarray(t0)))
    moved = np.abs(np.asarray(m_ba_j.points) - pts).max()
    assert moved > 1e-3, moved
    # 8 LM iterations of f32 Schur solves: 1e-3 relative on the cost,
    # 1e-4 on the adopted pose, 1 mm on landmarks.
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-3)
    _close(Rb_t, Rb_j, 1e-4)
    _close(tb_t, tb_j, 1e-4)
    _close(m_ba_t.points, m_ba_j.points, 1e-3)
    tvo.close()


def test_unported_backends_raise():
    """The backends the engine refuses, as the JAX engine does: the
    photometric window BA cannot be distributed, and a name outside the
    three raises."""
    vo = StereoVO(VOConfig(**{**CFG, "distribute_ba": True, "ba_backend": "photometric"}),
                  device="cpu")
    vo.kf_order = [0, 1]
    with pytest.raises(ValueError, match="reprojection backend"):
        vo._run_window_ba([0])
    with pytest.raises(ValueError, match="unknown ba_backend"):
        StereoVO(VOConfig(**{**CFG, "ba_backend": "dense"}), device="cpu")._run_window_ba([0])
    with pytest.raises(TypeError):
        StereoVO(VOConfig(**CFG))      # the device is explicit


def test_photometric_window_ba_matches_reference(runs):
    """StereoVO(ba_backend="photometric") runs `_run_window_ba` on the
    reference's map (landmarks perturbed by 2 cm, so LM has work to do)
    and matches the JAX engine's photometric window BA: the bench's
    `bench_backends` configuration, photometric residuals on pyramid
    level 1 with the first keyframe frozen."""
    jvo, _ = runs
    noise = np.random.default_rng(12).normal(0, 0.02, (CFG["max_landmarks"], 3))
    pts = (np.asarray(jvo.map.points) + noise).astype(np.float32)
    slot = jvo.kf_order[-1]
    jp = JStereoVO(JVOConfig(**CFG, ba_backend="photometric"))
    tp = StereoVO(VOConfig(**CFG, ba_backend="photometric"), device="cpu")
    assert tp._ba_backend() == "photometric"
    jp.map = jvo.map._replace(points=jnp.asarray(pts))
    tp.map = _jax_map_to_port(jp.map)
    jp.kf_order, tp.kf_order = list(jvo.kf_order), list(jvo.kf_order)
    # The engine runs BA right after inserting keyframe `slot`, with the
    # tracking pose equal to that keyframe's pose.
    jp.R, jp.t = jvo.map.kf_R[slot], jvo.map.kf_t[slot]
    tp.R, tp.t = (torch.tensor(np.asarray(x)) for x in (jp.R, jp.t))
    tp.prev_R, tp.prev_t = tp.R, tp.t
    cost_j = jp._run_window_ba(jvo.kf_order[:1])
    cost_t = tp._run_window_ba(jvo.kf_order[:1])
    moved = np.abs(np.asarray(jp.map.points) - pts).max()
    assert moved > 1e-3, moved
    # 8 f32 LM iterations of photometric Schur solves: 1e-3 relative on
    # the cost, 1e-4 on the adopted pose, 2 mm on landmarks at 1-30 m.
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-3)
    _close(tp.R, jp.R, 1e-4)
    _close(tp.t, jp.t, 1e-4)
    keep = np.asarray(jp.map.point_mask)
    _close(tp.map.points.numpy()[keep], np.asarray(jp.map.points)[keep], 2e-3)
    jp.close()
    tp.close()


def test_synthetic_port_matches_reference():
    Rj, tj = j_syn.forward_trajectory(20, step=0.8, yaw_rate=0.003)
    Rt, tt = t_syn.forward_trajectory(20, step=0.8, yaw_rate=0.003)
    np.testing.assert_allclose(Rt, Rj, atol=1e-6)
    np.testing.assert_allclose(tt, tj, atol=1e-5)
    for w in ([0.0, 0.003, 0.0], [0.1, -0.4, 0.2]):
        np.testing.assert_allclose(t_syn.so3_exp(w), np.asarray(j_se3.so3_exp(jnp.asarray(w, jnp.float32))),
                                   atol=1e-6)
    scene_j = j_syn.corridor_scene(np.random.default_rng(1), tex_size=64)
    scene_t = t_syn.corridor_scene(np.random.default_rng(1), tex_size=64)
    ij = j_cam.Intrinsics.create(60.0, 60.0, 31.5, 23.5)
    it = t_cam.Intrinsics.create(60.0, 60.0, 31.5, 23.5)
    a = j_syn.make_stereo_pair(scene_j, ij, Rj[5], tj[5], 48, 64, baseline=0.3)
    b = t_syn.make_stereo_pair(scene_t, it, Rt[5], tt[5], 48, 64, baseline=0.3)
    for x, y in zip(a, b):
        # Bilinear texture lookups of f32-rounded poses: 1e-2 gray levels.
        np.testing.assert_allclose(y, x, atol=1e-2)


def test_metrics_copy_matches(rng):
    est = rng.normal(0, 1, (30, 3))
    gt = est * 1.3 + rng.normal(0, 0.01, (30, 3))
    for kw in (dict(with_scale=True), dict(with_scale=False), dict(align=False)):
        assert metrics.ate_rmse(est, gt, **kw) == j_metrics.ate_rmse(est, gt, **kw)
    R = np.tile(np.eye(3), (5, 1, 1))
    t = rng.normal(0, 1, (5, 3))
    assert metrics.rpe(R, t, R, t[::-1]) == j_metrics.rpe(R, t, R, t[::-1])
