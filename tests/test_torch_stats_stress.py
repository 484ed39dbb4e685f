"""tests/test_stats_stress.py on the port: the asynchronous stats control
loop under randomized stats delays, on the CPU.

The port's engine sends each frame's stats to the host through
`BaseVO._host_fetch` (a `HostFetch` of pinned copies and an event on the
card, an immediate copy here). These tests replace it
(`utils/debug.delay_stats`) with a fetch whose `done()` stays false until
the engine has advanced `delay` frames past submission, the reference
test's `_DelayedFuture`; `result()` is the real fetch's. The same
corridor, configuration, delay draws and bounds as the reference test:
keyframe gaps within [kf_min_gap, kf_max_gap], ATE below 0.08 m,
post-recovery ATE below 0.12 m over frames 48-69, finite poses, and no
forced recovery under a fixed 10-frame delay.
"""

import numpy as np
import pytest
import torch

from viso_tpu_torch.data import synthetic
from viso_tpu_torch.geometry import camera
from viso_tpu_torch.slam.engine import StereoVO, VOConfig, default_stats_hard_lag
from viso_tpu_torch.utils import metrics
from viso_tpu_torch.utils.debug import delay_stats

torch.set_num_threads(2)

H, W = 192, 256
INTR = dict(fx=200.0, fy=200.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5)


def make_vo(rng, max_delay, device="cpu", **kw):
    cfg = VOConfig(
        height=H, width=W, max_keyframes=6, max_landmarks=384,
        num_features=192, detect_grid=(4, 6), fast_threshold=15.0,
        baseline=0.3, max_disparity=48, kf_min_gap=2, kf_max_gap=8,
        stats_max_lag=4, **INTR, **kw,
    )
    return delay_stats(StereoVO(cfg, device=device), rng, max_delay)


@pytest.fixture(scope="module")
def corridor():
    return synthetic.corridor_scene(np.random.default_rng(7), tex_size=512)


def render(corridor, n, step=0.2):
    intr = camera.Intrinsics.create(**INTR)
    Rs, ts = synthetic.forward_trajectory(n, step=step, yaw_rate=0.004)
    frames = [synthetic.make_stereo_pair(corridor, intr, R, t, H, W, baseline=0.3)[:2]
              for R, t in zip(Rs, ts)]
    return frames, (Rs, ts)


def keyframe_gaps(vo):
    return np.diff([i for i, r in enumerate(vo.results) if r.is_keyframe])


def ate(R_est, t_est, Rs, ts):
    return metrics.ate_rmse(metrics.camera_centers(R_est, t_est),
                            metrics.camera_centers(Rs, ts), align=True, with_scale=False)


def test_delayed_fetch_is_consumed_only_when_released(corridor):
    """The seam itself: with every sample 3 frames late and a hard lag of
    10, each sample is consumed exactly when released, never earlier."""
    class Fixed:
        def integers(self, lo, hi):
            return 3

    frames, _ = render(corridor, 12)
    vo = make_vo(Fixed(), max_delay=3, stats_hard_lag=10)
    seen = []
    for il, ir in frames:
        vo.process(il, ir)
        seen.append(getattr(vo, "_stats_frame", None))
    vo.close()
    # Frame 0 initializes; the sample of frame f lands at frame f + 3
    # (the queue holds stats_max_lag = 4, so none is dropped).
    assert seen[:4] == [None] * 4, seen
    assert seen[4:] == [f - 3 for f in range(4, 12)], seen


def test_keyframe_cadence_under_random_delay(corridor):
    n = 60
    frames, (Rs, ts) = render(corridor, n)
    vo = make_vo(np.random.default_rng(3), max_delay=10)
    for il, ir in frames:
        vo.process(il, ir)
    gaps = keyframe_gaps(vo)
    # The gap-based schedule must hold regardless of stats lag.
    assert gaps.max() <= vo.cfg.kf_max_gap, gaps
    assert gaps.min() >= vo.cfg.kf_min_gap, gaps
    R_est, t_est = vo.trajectory()
    err = ate(R_est, t_est, Rs, ts)
    assert err < 0.08, err
    vo.close()


def test_lost_recovery_under_random_delay(corridor):
    # A mid-run blackout with delayed stats: recovery may arrive late, but
    # the run must re-acquire and stay finite and accurate after it.
    n = 70
    frames, (Rs, ts) = render(corridor, n)
    vo = make_vo(np.random.default_rng(5), max_delay=6)
    for i, (il, ir) in enumerate(frames):
        if 30 <= i < 34:
            il, ir = np.zeros_like(il), np.zeros_like(ir)
        vo.process(il, ir)
    R_est, t_est = vo.trajectory()
    assert np.isfinite(t_est).all()
    idx = list(range(48, n))
    err = ate(R_est[idx], t_est[idx], Rs[idx], ts[idx])
    assert err < 0.12, err
    vo.close()


def test_staleness_never_rolls_back_decisions(corridor):
    # Every sample 10 frames late: keyframes come from the gap schedule,
    # lost counts only move on fresh samples.
    class Fixed:
        def integers(self, lo, hi):
            return 10

    frames, _ = render(corridor, 40)
    vo = make_vo(Fixed(), max_delay=10)
    for il, ir in frames:
        vo.process(il, ir)
    assert keyframe_gaps(vo).max() <= vo.cfg.kf_max_gap
    # No forced recovery should ever have fired on this clean sequence.
    assert getattr(vo, "_lost_count", 0) == 0
    vo.close()


@pytest.mark.parametrize("max_lag", [2, 4, 8])
def test_default_hard_lag_on_each_device(max_lag):
    """The CPU keeps the reference's `max(2, stats_max_lag)`; on the card a
    decision waits for the previous frame's sample."""
    assert default_stats_hard_lag("cpu", max_lag) == max(2, max_lag)
    assert default_stats_hard_lag("cuda", max_lag) == 1


def test_lost_tracking_recovers_when_samples_land_late_on_the_card():
    """The card's host runs ahead of the device, so every stats sample
    reaches it late. Here on the CPU every sample lands 8 frames late (a
    host 8 frames ahead) and the engine's hard lag is the card's default.
    The scenario is tools/diag_mono_seam.py's: MonocularVO with a keyframe
    at least every 3 frames, then 12 frames of noise. Each decision must
    read a sample at most one frame old, and the noise must force a
    re-init. At the reference's accelerator lag (`max(8, 2 *
    stats_max_lag)`, what the card used before) no sample ever postdates
    the last keyframe: the lost count never moves and no re-init comes."""
    from viso_tpu_torch.slam.engine import MonocularVO
    from viso_tpu_torch.tools import diag_mono_seam

    class Fixed:
        def integers(self, lo, hi):
            return 8

    imgs, _, _ = diag_mono_seam.scenario(36)
    noise = np.random.default_rng(3)
    for i in range(24, 36):
        imgs[i] = noise.uniform(0, 255, imgs[i].shape).astype(np.float32)
    cfg = VOConfig(
        height=diag_mono_seam.H, width=diag_mono_seam.W, max_keyframes=6, max_landmarks=768,
        num_features=192, detect_grid=(4, 6), fast_threshold=10.0, kf_min_gap=1,
        kf_max_gap=3, kf_min_visible_frac=0.6, min_init_tracks=25,
        disparity_squared_thresh=25.0, **diag_mono_seam.INTR,
    )
    vo = delay_stats(MonocularVO(cfg, device="cpu"), Fixed(), 8)
    vo._stats_hard_lag = lambda: default_stats_hard_lag("cuda", cfg.stats_max_lag)
    ages = []
    try:
        for img in imgs:
            vo.process(img)
            if vo.results[-1].state == "tracking" and hasattr(vo, "_stats_frame"):
                ages.append(vo.frame_idx - vo._stats_frame)
        assert ages and max(ages) <= 1, ages
        assert vo.num_reinits >= 1
    finally:
        vo.close()
