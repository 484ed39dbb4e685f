"""How `correct` is decided: the engine's steps against the plain
reference (`vobench/reference/steps.py`), step by step from the engine's
own state.

An engine frame is a function of the state the engine held before it
(map, pose, velocity twist) and of the frame's images. The harness copies
that state on the device before each frame of a few blocks of
consecutive window frames (drawn from the seed) and after the last, and
records the host decisions of each frame (the keyframe slots before and
after it). Once the window has closed, the reference works each step out
again from the state before it and the benchmark's own images (not the
frames the engine was handed: for a fed cell that checks the decode too),
building the tracking templates itself, and the state after it is
compared with the engine's. A stereo run's first frame, which builds the
map from the first pair alone, is checked from nothing the engine made;
a monocular run's start, the two-view initialization of its bootstrap,
from the correspondences and the RANSAC generator's state it was given.

The numbers compared, each the largest over the checked steps:

  pose_gap_m      camera centre gap (m) of the frame's pose and of every
                  keyframe pose in the window (BA moves them), and the
                  gap of the velocity twist's translation (m a frame);
  rot_gap_rad     rotation angle between the frame's rotations, the
                  keyframes', and the gap of the twist's rotation;
  landmark_gap    landmark position gap over the landmark's distance
                  from the camera (at least 1 m), over landmarks both
                  states hold;
  obs_gap_px      gap of the keyframes' observation pixels, over
                  observations both states hold;
  mask_diff       landmark and observation slots whose validity differs.
"""

from __future__ import annotations

import numpy as np
import torch

NUMBERS = ("pose_gap_m", "rot_gap_rad", "landmark_gap", "obs_gap_px", "mask_diff")


def _centre(R, t):
    return -torch.einsum("...ji,...j->...i", R, t)


def _angle(Ra, Rb):
    """Rotation angle between Ra and Rb from their chordal distance
    (|Ra - Rb|_F = 2 sqrt(2) sin(angle / 2)): exactly 0 for equal
    matrices, which a trace of Ra^T Rb in float32 is not."""
    chord = torch.linalg.norm((Ra.double() - Rb.double()).flatten(-2), dim=-1)
    return 2 * torch.arcsin(torch.clamp(chord / (2 * 2**0.5), max=1.0))


def twoview_gaps(got: dict, ref: dict) -> dict:
    """The numbers of a two-view initialization (dicts of `R`, `t`,
    `points`, `inliers`; the first camera is the world, the baseline of
    unit mean inlier depth)."""
    f64 = lambda x: x.double()   # noqa: E731
    both = got["inliers"] & ref["inliers"]
    lm = torch.zeros((), dtype=torch.float64, device=got["t"].device)
    if both.any():
        p_ref = f64(ref["points"][both])
        rng = torch.clamp(torch.linalg.norm(p_ref, dim=-1), min=1.0)
        lm = (torch.linalg.norm(f64(got["points"][both]) - p_ref, dim=-1) / rng).max()
    out = dict(pose_gap_m=float(torch.linalg.norm(f64(got["t"]) - f64(ref["t"]))),
               rot_gap_rad=float(_angle(got["R"], ref["R"])), landmark_gap=float(lm),
               obs_gap_px=0.0, mask_diff=float((got["inliers"] != ref["inliers"]).sum()))
    return {k: (v if np.isfinite(v) else float("inf")) for k, v in out.items()}


def gaps(got: dict, ref: dict) -> dict:
    """The numbers of one step: `got` the engine's state after it, `ref`
    the reference's (dicts of `map`, `R`, `t`, `vel`); a two-view
    initialization's by `twoview_gaps`."""
    if "inliers" in got:
        return twoview_gaps(got, ref)
    gm, rm = got["map"], ref["map"]
    f64 = lambda x: x.double()   # noqa: E731
    kf = (gm.kf_mask & rm.kf_mask)
    c_got = _centre(f64(got["R"]), f64(got["t"]))
    c_ref = _centre(f64(ref["R"]), f64(ref["t"]))
    pose = [torch.linalg.norm(c_got - c_ref),
            torch.linalg.norm(f64(got["vel"][:3]) - f64(ref["vel"][:3]))]
    rot = [_angle(got["R"], ref["R"]),
           torch.linalg.norm(f64(got["vel"][3:]) - f64(ref["vel"][3:]))]
    if kf.any():
        ck_got = _centre(f64(gm.kf_R[kf]), f64(gm.kf_t[kf]))
        ck_ref = _centre(f64(rm.kf_R[kf]), f64(rm.kf_t[kf]))
        pose.append(torch.linalg.norm(ck_got - ck_ref, dim=-1).max())
        rot.append(_angle(gm.kf_R[kf], rm.kf_R[kf]).max())
    both = gm.point_mask & rm.point_mask
    lm = torch.zeros((), dtype=torch.float64, device=c_ref.device)
    if both.any():
        p_ref = f64(rm.points[both])
        rng = torch.clamp(torch.linalg.norm(p_ref - c_ref, dim=-1), min=1.0)
        lm = (torch.linalg.norm(f64(gm.points[both]) - p_ref, dim=-1) / rng).max()
    ob = gm.obs_mask & rm.obs_mask
    obs = torch.zeros((), dtype=torch.float64, device=c_ref.device)
    if ob.any():
        obs = torch.linalg.norm(f64(gm.obs_uv[ob]) - f64(rm.obs_uv[ob]), dim=-1).max()
    diff = (gm.point_mask != rm.point_mask).sum() + (gm.obs_mask != rm.obs_mask).sum() + (
        gm.kf_mask != rm.kf_mask).sum()
    out = dict(pose_gap_m=float(torch.stack(pose).max()), rot_gap_rad=float(torch.stack(rot).max()),
               landmark_gap=float(lm), obs_gap_px=float(obs), mask_diff=float(diff))
    # A non-finite gap is as far off as a gap can be.
    return {k: (v if np.isfinite(v) else float("inf")) for k, v in out.items()}


def worst(steps) -> dict:
    """The largest of each number over the steps' gaps."""
    return {k: max((s[k] for s in steps), default=0.0) for k in NUMBERS}


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): each number at or under its
    limit."""
    table = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    return all(numbers[k] <= limits[k] for k in NUMBERS), table
