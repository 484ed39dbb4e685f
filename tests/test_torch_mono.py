"""The port's MonocularVO against viso_tpu's on the same frames, on the
CPU, plus the mono engine's own cases of tests/test_engine.py
(recovery-scale blend, far points, the degraded-regime motion model).

torch cannot reproduce a jax.random stream, so the parity test replays
the JAX engine's RANSAC draws in the port: `ransac.draw_indices` is
replaced, inside the test, by a function that splits the engine's key as
`BaseVO._next_key` does and draws with `jax.random.categorical` over the
port's mask, as `twoview.initialize` does. Both engines run with
`stats_deterministic=True`, so keyframe and lost decisions follow a
fixed schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viso_tpu.data import synthetic as j_syn
from viso_tpu.geometry import camera as j_cam
from viso_tpu.ops import ransac as j_ransac
from viso_tpu.slam.engine import MonocularVO as JMonocularVO
from viso_tpu.slam.engine import VOConfig as JVOConfig
from viso_tpu.slam.engine import blend_recovery_scale as j_blend
from viso_tpu_torch.geometry import se3
from viso_tpu_torch.ops import ransac as t_ransac
from viso_tpu_torch.slam.engine import MonocularVO, VOConfig, blend_recovery_scale
from viso_tpu_torch.utils import metrics

torch.set_num_threads(2)

# tests/test_engine.py's small configuration, mono gates as its mono tests.
H, W = 192, 256
INTR = dict(fx=200.0, fy=200.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5)
CFG = dict(
    height=H, width=W, max_keyframes=6, max_landmarks=384, num_features=192,
    detect_grid=(4, 6), fast_threshold=10.0, kf_min_gap=2, kf_max_gap=6,
    kf_min_visible_frac=0.45, min_init_tracks=25, disparity_squared_thresh=25.0,
    stats_deterministic=True, **INTR,
)
N_FRAMES = 20
# Per-frame agreement of the two engines' camera centres, as a share of
# the distance travelled in the map's units (monocular scale is the
# bootstrap's mean inlier depth): 1 % (measured on CPU: 0.1 mm of 0.24).
# Both compute in f32 but sum in other orders, through eigh, SVD, GN, LM
# and BA.
CENTER_BAND = 0.01


@pytest.fixture(scope="module")
def corridor():
    return j_syn.corridor_scene(np.random.default_rng(7), tex_size=512)


def render_forward(corridor, n, step=0.15):
    intr = j_cam.Intrinsics.create(**INTR)
    Rs, ts = j_syn.forward_trajectory(n, step=step, yaw_rate=0.004)
    frames = [np.clip(corridor.render(intr, R, t, H, W)[0], 0, 255).astype(np.uint8)
              for R, t in zip(Rs, ts)]
    return frames, (Rs, ts)


class ReplayJaxDraws:
    """Stands in for `ransac.draw_indices` in the port: the essential
    draw (k = 8) splits the engine's key and draws both hypothesis sets
    from the JAX stream, the homography draw (k = 4) returns the second."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)
        self.homography = None

    def __call__(self, generator, mask, num_hypotheses, sample_size):
        if sample_size == 4:
            return self.homography
        self.key, sub = jax.random.split(self.key)
        k_e, k_h = jax.random.split(sub)
        m = jnp.asarray(mask.cpu().numpy())
        e = j_ransac._sample_indices(k_e, m, num_hypotheses, 8)
        self.homography = torch.tensor(
            np.asarray(j_ransac._sample_indices(k_h, m, num_hypotheses // 2, 4)))
        return torch.tensor(np.asarray(e))


@pytest.fixture(scope="module")
def runs(corridor):
    frames, gt = render_forward(corridor, N_FRAMES)
    mp = pytest.MonkeyPatch()
    mp.setattr(t_ransac, "draw_indices", ReplayJaxDraws(0))
    jvo = JMonocularVO(JVOConfig(**CFG))
    tvo = MonocularVO(VOConfig(**CFG), device="cpu")
    try:
        for img in frames:
            jvo.process(img)
            tvo.process(img)
    finally:
        mp.undo()
    yield jvo, tvo, gt
    jvo.close()
    tvo.close()


def test_port_matches_reference_mono_engine(runs):
    jvo, tvo, (Rs, ts) = runs
    states_j = [r.state for r in jvo.results]
    assert [r.state for r in tvo.results] == states_j
    assert "tracking" in states_j
    assert [r.is_keyframe for r in tvo.results] == [r.is_keyframe for r in jvo.results]
    assert tvo.kf_order == jvo.kf_order
    assert tvo.num_reinits == jvo.num_reinits
    assert tvo._ba_backend() == "photometric"
    Rj, tj = jvo.trajectory()
    Rt, tt = tvo.trajectory()
    cj = metrics.camera_centers(Rj, tj)
    ct = metrics.camera_centers(Rt, tt)
    travel = np.linalg.norm(cj[-1] - cj[0])
    assert np.linalg.norm(ct - cj, axis=-1).max() < CENTER_BAND * travel
    nj = np.array([r.num_tracked for r in jvo.results])
    nt = np.array([r.num_tracked for r in tvo.results])
    assert np.abs(nj - nt).max() <= 0.1 * nj.max(), (nj, nt)


def test_port_mono_tracks_trajectory(runs):
    """tests/test_engine.py::test_monocular_vo_initializes_and_tracks's
    bounds on the port: tracking within 6 frames, scale-aligned ATE below
    8 % of the distance travelled."""
    _, tvo, (Rs, ts) = runs
    states = [r.state for r in tvo.results]
    first = states.index("tracking")
    assert first <= 6
    R_est, t_est = tvo.trajectory()
    c_est = metrics.camera_centers(R_est[first:], t_est[first:])
    c_gt = metrics.camera_centers(Rs[first:], ts[first:])
    ate = metrics.ate_rmse(c_est, c_gt, align=True, with_scale=True)
    assert ate < 0.08 * np.linalg.norm(c_gt[-1] - c_gt[0]), ate


def test_far_points_allocated_at_assigned_depth(runs):
    """test_mono_far_points_allocated_at_assigned_depth on the port: the
    live map keeps enough landmarks and none at a junk depth."""
    _, tvo, _ = runs
    z = se3.transform(tvo.R, tvo.t, tvo.map.points)[:, 2].numpy()
    valid = tvo.map.point_mask.numpy()
    assert valid.sum() >= 50, valid.sum()
    assert (z[valid] > 0.0).all() and np.isfinite(z[valid]).all()


def test_degraded_regime_holds_motion_model(corridor):
    """test_degraded_regime_holds_motion_model on the port: a
    structureless frame gives the constant-velocity prediction or the held
    pose, never a solved pose away from both."""
    frames, _ = render_forward(corridor, 20, step=0.25)
    vo = MonocularVO(VOConfig(**{**CFG, "stats_deterministic": False, "min_lost_points": 2}),
                     device="cpu")
    for img in frames:
        vo.process(img)
    assert vo.state == "tracking"
    t_prev = vo.t.clone()
    dR, dt = se3.se3_exp(vo.vel_xi)
    _, t_pred = se3.compose(dR, dt, vo.R, vo.t)
    vo.process(np.full((H, W), 128, np.uint8))
    d_pred = float(torch.linalg.norm(vo.t - t_pred))
    d_hold = float(torch.linalg.norm(vo.t - t_prev))
    assert min(d_pred, d_hold) < 1e-4, (d_pred, d_hold)
    vo.close()


@pytest.mark.parametrize("s_d, s_s, want", [
    (1.5, 1.0, 1.5), (0.5, 1.0, 0.5),          # agreement within 2.5x: depth
    (0.125, 1.0, 1.0), (8.0, 1.0, 1.0),        # occlusion-scale disagreement: speed
    (None, 2.0, 2.0), (3.0, None, 3.0), (None, None, None),
    (100.0, None, 20.0), (0.001, None, 0.05),  # clipped
])
def test_blend_recovery_scale(s_d, s_s, want):
    assert blend_recovery_scale(s_d, s_s) == j_blend(s_d, s_s) == want


def test_map_median_depth_averages_middle_values():
    """_map_median_depth is jnp.nanmedian's median (the mean of the two
    middle depths), not torch.nanmedian's lower one."""
    vo = MonocularVO(VOConfig(**CFG), device="cpu")
    pts = torch.zeros_like(vo.map.points)
    pts[:4, 2] = torch.tensor([2.0, 4.0, 6.0, 9.0])
    vo.map = vo.map._replace(points=pts, point_mask=torch.arange(pts.shape[0]) < 4)
    assert vo._map_median_depth() == 5.0
    vo.map = vo.map._replace(point_mask=torch.zeros(pts.shape[0], dtype=torch.bool))
    assert vo._map_median_depth() is None


def test_forced_reinit_recovers(corridor):
    """tests/test_mono_robust.py::test_mono_forced_reinit_recovers on the
    port, shortened: 12 frames of noise kill every template, the lost
    counter trips, the engine re-initializes at the held pose with its
    scale priors and dead reckoning, and the new segment tracks again."""
    intr = j_cam.Intrinsics.create(**INTR)
    Rs, ts = j_syn.forward_trajectory(70, step=0.12, yaw_rate=0.004)
    noise = np.random.default_rng(3)
    vo = MonocularVO(VOConfig(**{**CFG, "stats_deterministic": False, "fast_threshold": 15.0,
                                 "kf_max_gap": 20}), device="cpu")
    for i, (R, t) in enumerate(zip(Rs, ts)):
        img = corridor.render(intr, R, t, H, W)[0]
        if 25 <= i < 37:
            img = noise.uniform(0, 255, img.shape)
        vo.process(img)
    states = [r.state for r in vo.results]
    assert vo.num_reinits >= 1
    assert states[-1] == "tracking", states[-10:]
    R_est, t_est = vo.trajectory()
    assert np.isfinite(t_est).all()
    idx = [i for i, s in enumerate(states) if s == "tracking" and i >= 50]
    assert len(idx) >= 10, states[37:]
    c_est = metrics.camera_centers(R_est[idx], t_est[idx])
    c_gt = metrics.camera_centers(Rs[idx], ts[idx])
    ate = metrics.ate_rmse(c_est, c_gt, align=True, with_scale=True)
    assert ate < 0.08 * np.linalg.norm(c_gt[-1] - c_gt[0]), ate
    vo.close()


def test_mono_cell_tool(capsys, monkeypatch):
    """tools/mono_cell.py (chip_smoke's phase 7 cell over seeds): its
    configuration is bench.py's mono configuration field by field, it runs
    on the CPU when asked (8 frames here) and prints one JSON line per
    invocation, and it refuses to fall back to the CPU without a card."""
    import json

    from viso_tpu_torch.tools import mono_cell

    cfg = mono_cell.config(seed=3)
    half = dict(fx=718.856 / 2, fy=718.856 / 2, cx=607.1928 / 2, cy=185.2157 / 2)
    ref = JVOConfig(
        height=184, width=616, **half, num_features=256, max_landmarks=1024,
        detect_grid=(4, 8), fast_threshold=8.0, kf_max_gap=8, kf_min_gap=2,
        stats_max_lag=2, stats_hard_lag=4, stats_deterministic=True,
        kf_min_visible_frac=0.45, disparity_squared_thresh=25.0, seed=3,
    )
    for field in VOConfig.__dataclass_fields__:
        assert getattr(cfg, field) == getattr(ref, field), field
    assert mono_cell.main(["--frames", "8", "--seeds", "0", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["frames"] == 8 and len(out["runs"]) == 1
    assert out["runs"][0]["seed"] == 0 and np.isfinite(out["runs"][0]["ate_m"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        mono_cell.main(["--frames", "2"])


def test_mono_cell_tool_slam(capsys):
    """`tools/mono_cell.py --slam` (chip_smoke's phase 9 cell over seeds):
    its configuration is bench.py's mono SLAM configuration field by field
    (phase 7's with FAST 6; LoopParams(min_inliers=40,
    max_correction_m=4.0)), its frames the first frames of the 500-frame
    orbit, and it runs MonoSLAM on the CPU when asked (6 frames here),
    printing one JSON line."""
    import json

    from viso_tpu.slam.loop_closure import LoopParams as JLoopParams
    from viso_tpu_torch.tools import mono_cell

    half = dict(fx=718.856 / 2, fy=718.856 / 2, cx=607.1928 / 2, cy=185.2157 / 2)
    ref = JVOConfig(
        height=184, width=616, **half, num_features=256, max_landmarks=1024,
        detect_grid=(4, 8), fast_threshold=6.0, kf_max_gap=8, kf_min_gap=2,
        stats_max_lag=2, stats_hard_lag=4, stats_deterministic=True,
        kf_min_visible_frac=0.45, disparity_squared_thresh=25.0,
    )
    cfg = mono_cell.slam_config()
    for field in VOConfig.__dataclass_fields__:
        assert getattr(cfg, field) == getattr(ref, field), field
    lp, ref_lp = mono_cell.slam_loop_params(), JLoopParams(min_inliers=40, max_correction_m=4.0)
    for field in ref_lp.__dataclass_fields__:
        assert getattr(lp, field) == getattr(ref_lp, field), field
    imgs, Rs, ts = mono_cell.render_orbit(3)
    full_Rs, full_ts = j_syn.orbit_trajectory(500, radius=2.5, total_angle=4 * np.pi)
    np.testing.assert_array_equal(Rs, full_Rs[:3])
    assert imgs[0].dtype == np.uint8 and imgs[0].shape == (184, 616)
    # The left images of chip_smoke's stereo render of the orbit (phase 6),
    # which phase 9 runs on, are these frames bit for bit.
    from viso_tpu_torch.data import synthetic

    scene, intr, _, _ = mono_cell.orbit()
    for k in range(3):
        il = synthetic.make_stereo_pair(scene, intr, Rs[k], ts[k], 184, 616, baseline=0.537)[0]
        np.testing.assert_array_equal(np.clip(il, 0, 255).astype(np.uint8), imgs[k])
    assert mono_cell.main(["--slam", "--frames", "6", "--seeds", "1", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["cell"] == "mono_slam" and out["device"] == "cpu" and out["frames"] == 6
    run = out["runs"][0]
    assert run["seed"] == 1 and run["hook_errors"] == 0 and run["loops"] == []
    assert run["nodes"] >= 1 and np.isfinite(run["ate_m"]) and run["s_min"] == 1.0
