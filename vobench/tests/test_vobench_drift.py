"""KITTI's translational error on trajectories worked out by hand."""

import numpy as np

from vobench import drift, scenes


def straight(n, step):
    R = np.tile(np.eye(3), (n, 1, 1))
    c = np.stack([np.zeros(n), np.zeros(n), step * np.arange(n)], -1)
    return R, -c


def test_exact_trajectory_has_no_error():
    R, t = straight(700, 0.8)
    assert drift.trans_err_pct(R, t, R, t) == 0.0


def test_uniform_scale_error_reads_its_percent():
    """An estimate 1 % too long on a straight drive at 1 m a frame: each
    sub-sequence of length L ends at the first frame more than L metres
    on, L + 1 frames later, and its end point is off by 1 % of the L + 1
    metres it spans."""
    n = 700
    R, t = straight(n, 1.0)
    errs = [0.01 * (L + 1) / L
            for f in range(0, n, 10) for L in (100, 200, 300, 400) if f + L + 1 < n]
    assert abs(drift.trans_err_pct(R, 1.01 * t, R, t) - 100 * sum(errs) / len(errs)) < 1e-9


def test_one_lateral_offset_counts_over_its_lengths():
    """A 1 m sideways jump of the estimate between frames 300 and 301, at
    1 m a frame. A sub-sequence from frame f (every 10th) of length L
    ends at the first frame more than L metres on, f + L + 1; it reads an
    end-point error of exactly 1 m (over L) when it spans the jump, else
    0."""
    n = 700
    R, t = straight(n, 1.0)
    t_est = t.copy()
    t_est[301:, 0] -= 1.0     # centre x + 1 m from frame 301 on
    errs = [(1.0 if f <= 300 < f + L + 1 else 0.0) / L
            for f in range(0, n, 10) for L in (100, 200, 300, 400) if f + L + 1 < n]
    assert abs(drift.trans_err_pct(R, t_est, R, t) - 100 * sum(errs) / len(errs)) < 1e-9


def test_too_short_a_window_reads_nothing():
    R, t = straight(100, 0.8)
    assert drift.trans_err_pct(R, t, R, t) is None


def test_invariant_to_the_estimate_s_world_frame():
    """The engine's world is its first camera; ground truth's is not."""
    drive = scenes.Drive(0.8, 160, 1.0, 1024, 40.0)
    R, t = drive.poses(range(37, 737))
    G = scenes.yaw_matrix(0.3)
    g = np.array([2.0, -1.0, 5.0])
    R_e = np.einsum("nij,jk->nik", R, G.T)
    t_e = t + np.einsum("nij,j->ni", R_e, g)
    assert drift.trans_err_pct(R_e, t_e, R, t) < 1e-9
