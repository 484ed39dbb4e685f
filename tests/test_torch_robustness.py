"""The reference's robustness tests on the port, on the CPU:
tests/test_robustness.py's three (a sensor blackout, a static camera,
exposure drift; StereoVO) and the three of tests/test_mono_robust.py
that had no port (a blackout, scale continuity across a re-init, bounded
long-run drift; MonocularVO; the fourth is
tests/test_torch_mono.py::test_forced_reinit_recovers).

Same scenes, seeds, configurations and bounds as the reference tests;
the port's behaviour is held to those bounds, not to the JAX package's
run (the JAX tests run that).
"""

import numpy as np
import pytest
import torch

from viso_tpu_torch.data import synthetic
from viso_tpu_torch.geometry import camera
from viso_tpu_torch.slam.engine import MonocularVO, StereoVO, VOConfig
from viso_tpu_torch.utils import metrics

torch.set_num_threads(2)

# tests/test_engine.py's small configuration and tests/test_mono_robust.py's
# mono configuration.
H, W = 192, 256
INTR = dict(fx=200.0, fy=200.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5)


def small_config(**kw):
    base = dict(
        height=H, width=W, max_keyframes=6, max_landmarks=384, num_features=192,
        detect_grid=(4, 6), fast_threshold=15.0, baseline=0.3, max_disparity=48,
        kf_min_gap=2, **INTR,
    )
    base.update(kw)
    return VOConfig(**base)


def mono_config(**kw):
    base = dict(
        height=H, width=W, max_keyframes=6, max_landmarks=384, num_features=192,
        detect_grid=(4, 6), fast_threshold=15.0, kf_min_gap=2, min_init_tracks=25,
        disparity_squared_thresh=25.0, **INTR,
    )
    base.update(kw)
    return VOConfig(**base)


def centers(R, t):
    return metrics.camera_centers(R, t)


# -- tests/test_robustness.py -------------------------------------------------

def test_blackout_frames_recovering(rng):
    scene = synthetic.corridor_scene(rng, tex_size=512)
    intr = camera.Intrinsics.create(**INTR)
    Rs, ts = synthetic.forward_trajectory(16, step=0.25)
    vo = StereoVO(small_config(), device="cpu")
    for i, (R, t) in enumerate(zip(Rs, ts)):
        il, ir, _ = synthetic.make_stereo_pair(scene, intr, R, t, H, W, 0.3)
        if 6 <= i <= 8:  # three blacked-out frames (sensor dropout)
            il, ir = np.zeros_like(il), np.zeros_like(ir)
        vo.process(il, ir)
    R_est, t_est = vo.trajectory()
    assert np.all(np.isfinite(R_est)) and np.all(np.isfinite(t_est))
    # Poses stay bounded (the motion-model clamp holds the line).
    assert np.abs(centers(R_est, t_est)).max() < 50.0
    # Tracking resumes after the dropout.
    tracked_after = [r.num_tracked for r in vo.results[11:]]
    assert max(tracked_after) > 20, tracked_after
    vo.close()


def test_static_camera_is_stable(rng):
    # Zero motion: the pose stays ~identity.
    scene = synthetic.corridor_scene(rng, tex_size=512)
    intr = camera.Intrinsics.create(**INTR)
    R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    il, ir, _ = synthetic.make_stereo_pair(scene, intr, R0, t0, H, W, 0.3)
    vo = StereoVO(small_config(), device="cpu")
    for _ in range(8):
        vo.process(il, ir)
    R_est, t_est = vo.trajectory()
    assert np.abs(centers(R_est, t_est)).max() < 0.02
    vo.close()


def test_exposure_drift_tracking(rng):
    """Gain/bias drift, noise and blur must not wreck accuracy: the ATE
    under the nuisance stays below max(2.5 x the clean ATE, 0.15 m)."""
    scene = synthetic.corridor_scene(rng, tex_size=512)
    intr = camera.Intrinsics.create(**INTR)
    Rs, ts = synthetic.forward_trajectory(30, step=0.25)
    nuis = synthetic.PhotometricNuisance(np.random.default_rng(77), noise_std=2.0,
                                         blur_sigma=0.4)
    clean, degraded = [], []
    for R, t in zip(Rs, ts):
        il, ir, _ = synthetic.make_stereo_pair(scene, intr, R, t, H, W, 0.3)
        clean.append((il, ir))
        nuis.step()
        degraded.append((nuis.apply(il), nuis.apply(ir)))

    def run(frames):
        vo = StereoVO(small_config(), device="cpu")
        for il, ir in frames:
            vo.process(il, ir)
        R_est, t_est = vo.trajectory()
        vo.close()
        return metrics.ate_rmse(centers(R_est, t_est), centers(Rs, ts), align=True,
                                with_scale=False)

    ate_clean = run(clean)
    ate_deg = run(degraded)
    assert ate_deg < max(2.5 * ate_clean, 0.15), (ate_clean, ate_deg)


# -- tests/test_mono_robust.py ------------------------------------------------

@pytest.fixture(scope="module")
def corridor():
    return synthetic.corridor_scene(np.random.default_rng(7), tex_size=512)


def render_mono(corridor, n, step=0.12):
    intr = camera.Intrinsics.create(**INTR)
    Rs, ts = synthetic.forward_trajectory(n, step=step, yaw_rate=0.004)
    return [corridor.render(intr, R, t, H, W)[0] for R, t in zip(Rs, ts)], (Rs, ts)


def scale_aligned_ate(R_est, t_est, Rs, ts, idx):
    c_est, c_gt = centers(R_est[idx], t_est[idx]), centers(Rs[idx], ts[idx])
    return (metrics.ate_rmse(c_est, c_gt, align=True, with_scale=True),
            float(np.linalg.norm(c_gt[-1] - c_gt[0])))


def test_mono_survives_blackout(corridor):
    # A 3-frame blackout: the tracker holds pose and re-acquires.
    frames, (Rs, ts) = render_mono(corridor, 60)
    vo = MonocularVO(mono_config(), device="cpu")
    for i, img in enumerate(frames):
        if 30 <= i < 33:
            img = np.zeros_like(img)
        vo.process(img)
    states = [r.state for r in vo.results]
    assert states[-1] == "tracking", states[-10:]
    R_est, t_est = vo.trajectory()
    assert np.isfinite(t_est).all()
    idx = [i for i, s in enumerate(states) if s == "tracking" and i >= 40]
    ate, travel = scale_aligned_ate(R_est, t_est, Rs, ts, idx)
    assert ate < 0.08 * travel, (ate, travel)
    vo.close()


def test_mono_scale_continuity_across_reinit(corridor):
    """The re-init's new segment keeps the pre-loss scale within 2x (the
    bootstrap baseline is anchored to the median pre-loss speed)."""
    frames, (Rs, ts) = render_mono(corridor, 110)
    vo = MonocularVO(mono_config(), device="cpu")
    noise_rng = np.random.default_rng(3)
    for i, img in enumerate(frames):
        if 45 <= i < 60:
            img = noise_rng.uniform(0, 255, img.shape).astype(np.float32)
        vo.process(img)
    states = [r.state for r in vo.results]
    assert vo.num_reinits >= 1
    assert states[-1] == "tracking", states[-10:]
    R_est, t_est = vo.trajectory()
    c_est, c_gt = centers(R_est, t_est), centers(Rs, ts)
    pre = [i for i, s in enumerate(states) if s == "tracking" and 15 <= i < 45]
    post = [i for i, s in enumerate(states) if s == "tracking" and i >= 75]
    assert len(pre) >= 8 and len(post) >= 8, (len(pre), len(post))

    def seg_scale(idx):
        sp_e = np.linalg.norm(np.diff(c_est[idx], axis=0), axis=-1)
        sp_g = np.linalg.norm(np.diff(c_gt[idx], axis=0), axis=-1)
        return np.median(sp_e) / np.median(sp_g)

    s_pre, s_post = seg_scale(pre), seg_scale(post)
    assert 0.5 < s_post / s_pre < 2.0, (s_pre, s_post)
    vo.close()


def test_mono_long_run_bounded_drift(corridor):
    # 100 frames with keyframe eviction: scale holds through the frozen
    # gauge cameras of the window BA.
    frames, (Rs, ts) = render_mono(corridor, 100)
    vo = MonocularVO(mono_config(), device="cpu")
    for img in frames:
        vo.process(img)
    states = [r.state for r in vo.results]
    first = states.index("tracking")
    assert first <= 8
    assert states[-1] == "tracking"
    assert vo.num_reinits == 0
    R_est, t_est = vo.trajectory()
    ate, travel = scale_aligned_ate(R_est, t_est, Rs, ts, list(range(first, len(frames))))
    assert ate < 0.05 * travel, (ate, travel)
    vo.close()
