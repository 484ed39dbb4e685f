"""KITTI odometry's translational error (the devkit's
`evaluate_odometry.cpp`): over every sub-sequence that starts at every
`step`-th frame and spans `length` metres of the ground-truth path, the
end point's translation error over the length; the mean over all of them,
in percent. Normalised by length, so a window that holds more frames is
not charged for its longer trajectory.

Poses are world->cam (R, t), as the engines give them."""

from __future__ import annotations

import numpy as np

LENGTHS_M = (100.0, 200.0, 300.0, 400.0)
STEP_FRAMES = 10


def cam_to_world(R, t):
    """(N, 4, 4) cam->world transforms of world->cam (R (N, 3, 3), t (N, 3))."""
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    T = np.tile(np.eye(4), (len(R), 1, 1))
    Rt = np.transpose(R, (0, 2, 1))
    T[:, :3, :3] = Rt
    T[:, :3, 3] = -np.einsum("nij,nj->ni", Rt, t)
    return T


def trans_err_pct(R_est, t_est, R_gt, t_gt, lengths=LENGTHS_M, step=STEP_FRAMES):
    """Mean translational error in percent, or None when no sub-sequence
    of any length fits."""
    est = cam_to_world(R_est, t_est)
    gt = cam_to_world(R_gt, t_gt)
    dist = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0),
                                                           axis=-1))])
    errs = []
    for first in range(0, len(gt), step):
        for length in lengths:
            last = np.searchsorted(dist, dist[first] + length, side="right")
            if last >= len(gt):
                continue
            d_gt = np.linalg.inv(gt[first]) @ gt[last]
            d_est = np.linalg.inv(est[first]) @ est[last]
            err = np.linalg.inv(d_est) @ d_gt
            errs.append(np.linalg.norm(err[:3, 3]) / length)
    return 100.0 * float(np.mean(errs)) if errs else None
