"""The headline's first tracked frames (chip_smoke phase 4, `bench.py:116-166`,
376x1240) on both packages, on the CPU.

Under `stats_deterministic` the two packages' own runs part by 3.1e-4 to
7.1e-3 m in frames 1-4 (`tests/headline_parity.py --compare`), where each
package moves by 3e-5 m or less with its threading. The first stage that
parts is frame 0's stereo keyframe: `stereo.match` scores each disparity
as win_sq - 2 cross + t_sq, sums of ~4e6 whose float32 rounding puts the
mean SSD on a grid of 1/128, so the sub-pixel parabola over three
neighbouring costs moves by up to 0.069 px between the packages (each
0.063 px from a float64 evaluation), and where two neighbours tie on that
grid the argmin takes the lower disparity (2 of frame 0's 385 matches).
Fed the JAX package's map, templates and pose, the port's track program
follows the JAX package's frames 1-4 to 1.5e-5 m.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from headline_parity import config, jax_track_inputs, render, seeded_gaps, to_port

from viso_tpu.ops import fast as j_fast
from viso_tpu.ops import pyramid as j_pyr
from viso_tpu.ops import stereo as j_stereo
from viso_tpu_torch.ops import stereo as t_stereo

torch.set_num_threads(2)

TRACKED = 4
# Frames 1-4 of the port's engine seeded with the JAX engine's state after
# frame 0 (map, templates, active slots), against the JAX engine's: 4 x 10
# direct GN steps, LK and 4 LM steps in float32, summed in other orders
# (measured on 8 cores: 1.5e-5, 2.8e-7, 7.2e-8, 2.9e-7 m).
SEEDED_BAND_M = 1e-4
# Sub-pixel disparities of both packages on frame 0's keypoints against a
# float64 evaluation of the same formula: the SSD grid of 1/128 moves the
# parabola by up to 0.063 px in each package (measured: JAX 0.0634, port
# 0.0634 px; their mean errors 1.84e-3 and 1.75e-3 px).
DISPARITY_F64_PX = 0.1
DISPARITY_MEAN_F64_PX = 3e-3


@pytest.fixture(scope="module")
def headline():
    frames, _, _ = render(TRACKED + 1)
    return frames, config("jax", True), config("port", True)


def test_track_program_follows_reference_from_its_keyframe(headline):
    """The port's StereoVO fed the JAX engine's state after frame 0 tracks
    frames 1-4 to within SEEDED_BAND_M of the JAX engine."""
    frames, jcfg, tcfg = headline
    calls, centres = jax_track_inputs(frames, jcfg, TRACKED)
    gaps = seeded_gaps(frames, tcfg, calls, centres)
    assert len(gaps) == TRACKED + 1 and max(gaps) < SEEDED_BAND_M, gaps


def test_stereo_match_parts_only_on_the_ssd_grid(headline):
    """Frame 0's stereo match in both packages on the same keypoints: the
    same valid matches, each package's sub-pixel disparity within
    DISPARITY_F64_PX of a float64 evaluation of the port's formula, and
    the port no further from it on average than the JAX package allows."""
    frames, jcfg, _ = headline
    il, ir = (np.clip(x, 0, 255).astype(np.uint8).astype(np.float32) for x in frames[0])
    pyr = j_pyr.build_pyramid(jnp.asarray(il), jcfg.pyramid_levels)
    per_cell = max(1, jcfg.num_features // (jcfg.detect_grid[0] * jcfg.detect_grid[1]))
    uv, _, mask = j_fast.detect_grid_pyramid(
        pyr, threshold=jcfg.fast_threshold, grid=jcfg.detect_grid, per_cell=per_cell,
        levels=jcfg.detect_levels)
    d_j, _, ok_j = (np.asarray(x) for x in j_stereo.match(
        jnp.asarray(il), jnp.asarray(ir), uv, mask,
        j_stereo.StereoParams(max_disparity=jcfg.max_disparity)))
    params = t_stereo.StereoParams(max_disparity=jcfg.max_disparity)
    args = [torch.from_numpy(il), torch.from_numpy(ir), to_port(uv)]
    d_t, _, ok_t = (x.numpy() for x in t_stereo.match(*args, to_port(mask), params))
    d_64, _, _ = (x.numpy() for x in t_stereo.match(*(a.double() for a in args),
                                                        to_port(mask), params))
    assert np.array_equal(ok_t, ok_j) and ok_t.sum() > 300
    err_j, err_t = (np.abs(d - d_64)[ok_t] for d in (d_j, d_t))
    assert err_j.max() < DISPARITY_F64_PX and err_t.max() < DISPARITY_F64_PX, (
        err_j.max(), err_t.max())
    assert err_t.mean() < DISPARITY_MEAN_F64_PX and err_j.mean() < DISPARITY_MEAN_F64_PX, (
        err_j.mean(), err_t.mean())


def test_stereo_tie_takes_the_references_branch():
    """Two neighbouring disparities whose SSDs tie exactly (integer images
    at an integer keypoint: every sum is exact in float32): both packages
    take the lower disparity and the parabola's +0.5, bit for bit."""
    H, W = 32, 160
    x = np.arange(W)
    left = np.where(x >= 80, 160.0, 100.0)[None].repeat(H, 0).astype(np.float32)
    # The right image's edge sits between 60 and 61: column 60 at the
    # mean, so disparities 19 and 20 match equally well.
    right = np.where(x >= 61, 160.0, 100.0)[None].repeat(H, 0).astype(np.float32)
    right[:, 60] = 130.0
    uv = np.array([[80.0, 16.0], [100.0, 16.0]], np.float32)
    mask = np.array([True, False])
    params = dict(max_disparity=48)
    d_j, c_j, ok_j = (np.asarray(a) for a in j_stereo.match(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(uv), jnp.asarray(mask),
        j_stereo.StereoParams(**params)))
    d_t, c_t, ok_t = (a.numpy() for a in t_stereo.match(
        torch.from_numpy(left), torch.from_numpy(right), torch.from_numpy(uv),
        torch.from_numpy(mask), t_stereo.StereoParams(**params)))
    assert ok_j[0] and d_j[0] == 19.5, (d_j, c_j)
    assert np.array_equal(d_t, d_j) and np.array_equal(c_t, c_j) and np.array_equal(ok_t, ok_j)
