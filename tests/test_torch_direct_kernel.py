"""The direct GN level pass: its CPU path and wrapper here, and the CUDA
kernel (`viso_tpu_torch/csrc/direct_gn.cu`) against the plain version on
the card.

The card tests carry the `cuda` marker and skip with a reason without an
NVIDIA GPU. This file imports neither jax nor viso_tpu, so it runs on a
machine with only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -q tests/test_torch_direct_kernel.py
"""

import numpy as np
import pytest
import torch

from viso_tpu_torch.geometry import camera as cam_mod
from viso_tpu_torch.geometry import se3
from viso_tpu_torch.ops import direct, pyramid

# The track's four level passes at KITTI's 376x1240 (stereo_vo.drive's
# settings): (level, points, window).
TRACK_SHAPES = [(0, 1024, 16), (1, 1024, 24), (2, 256, 24), (3, 256, 24)]


def _small_case(affine=True, iters=6, n=200, seed=0):
    """A 96x320 image pair (noise shifted by 2 columns) with `n` points in
    front of the camera and their templates at three levels."""
    rng = np.random.default_rng(seed)
    H, W = 96, 320
    img0 = torch.tensor(rng.uniform(0, 255, (H, W)), dtype=torch.float32)
    img1 = torch.roll(img0, 2, 1)
    pyr0, pyr1 = pyramid.build_pyramid(img0, 3), pyramid.build_pyramid(img1, 3)
    intr = cam_mod.Intrinsics.create(200.0, 200.0, 159.5, 47.5)
    pts = torch.tensor(np.stack([rng.uniform(-3, 3, n), rng.uniform(-1, 1, n),
                                 rng.uniform(4, 20, n)], -1), dtype=torch.float32)
    mask = torch.from_numpy(rng.uniform(size=n) < 0.9)
    params = direct.DirectParams(iters=iters, affine=affine)
    R, t = torch.eye(3), torch.tensor([0.01, 0.0, 0.02])
    tmpl = direct.build_templates(pyr0, torch.eye(3), torch.zeros(3), pts, mask, intr, params)
    return pyr1, tmpl, pts, R, t, intr, params


@pytest.mark.parametrize("affine,iters", [(True, 6), (True, 10), (False, 6)])
def test_cpu_pass_is_the_plain_version_bit_for_bit(affine, iters):
    """On CPU tensors the level pass is `level_pass_plain`, bit for bit the
    pass as it was before the kernel (the benchmark reference's frozen
    copy of it), at every level."""
    from vobench.reference.ops import direct as frozen

    pyr, tmpl, pts, R, t, intr, params = _small_case(affine, iters)
    for level in range(len(pyr)):
        args = (pyr[level], tmpl[level], pts, R, t, intr.at_level(level), params)
        before = direct.launch.launches
        got = direct._level_pass_cached(*args)
        assert direct.launch.launches == before
        for ref in (direct.level_pass_plain(*args), frozen._level_pass_cached(*args)):
            assert all(torch.equal(a, b) for a, b in zip(got, ref)), level


def _meta(x):
    return x.to("meta")


@pytest.mark.parametrize("case", ["meta", "cpu", "float64", "half_patch", "points", "template"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    """`launch_level_pass` raises before any launch: on tensors that are
    not CUDA (meta, CPU), a wrong dtype, half_patch other than 4, more than
    1,024 points, a template of another shape."""
    pyr, tmpl, pts, R, t, intr, params = _small_case()
    img, tm = pyr[0], tmpl[0]
    if case == "meta":
        img, tm, pts, R, t = _meta(img), direct.LevelTemplate(*map(_meta, tm)), _meta(pts), \
            _meta(R), _meta(t)
    elif case == "float64":
        pts = pts.double()
    elif case == "half_patch":
        params = params._replace(half_patch=3)
    elif case == "points":
        pts = torch.zeros((1025, 3))
    elif case == "template":
        tm = tm._replace(T=tm.T[:-1])
    with pytest.raises(ValueError):
        direct.launch_level_pass(img, tm, pts, R, t, intr, params)
    if case == "meta":
        with pytest.raises(ValueError):
            direct._level_pass_cached(img, tm, pts, R, t, intr, params)



@pytest.mark.parametrize("track,most", [(1025, 2048), (2048, 1025), (1, 2048), (4096, 4096)])
def test_engine_refuses_a_track_the_kernel_does_not_take(track, most):
    """On a CUDA device the engine refuses at construction a track of
    fewer than 2 or more than 1,024 points (min(track_landmarks,
    max_landmarks)), naming the kernel's limit, before it touches the
    device; the CPU engine and `check_track_points` at 2 and 1,024 do not."""
    from viso_tpu_torch.slam.engine import StereoVO, VOConfig

    cfg = VOConfig(height=96, width=128, track_landmarks=track, max_landmarks=most)
    with pytest.raises(ValueError, match="2 to 1,024 points"):
        StereoVO(cfg, device="cuda")
    for n in (2, 1024):
        direct.check_track_points(n)
    StereoVO(cfg, device="cpu").close()


def test_versions_other_than_the_orders_warn():
    """The library versions the kernel's orders were read from pass in
    silence; any other torch, CUDA or cuBLAS warns and is returned."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert direct.check_versions(dict(direct.ORDERS_READ_ON)) == {}
    for key, other in (("torch", "2.12"), ("cuda", "13.0"), ("cublas", None)):
        versions = dict(direct.ORDERS_READ_ON, **{key: other})
        with pytest.warns(RuntimeWarning, match="bit-equal"):
            assert direct.check_versions(versions) == {key: other}


def _stereo_run(n_frames, device):
    """A small StereoVO on `n_frames` corridor frames: (config, engine)."""
    from viso_tpu_torch.data import synthetic
    from viso_tpu_torch.slam.engine import StereoVO, VOConfig

    H, W = 192, 256
    intr = dict(fx=200.0, fy=200.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5)
    cfg = VOConfig(height=H, width=W, max_keyframes=6, max_landmarks=384, num_features=192,
                   detect_grid=(4, 6), fast_threshold=15.0, baseline=0.3, max_disparity=48,
                   kf_min_gap=2, stats_deterministic=True, **intr)
    scene = synthetic.corridor_scene(np.random.default_rng(7), tex_size=512)
    Rs, ts = synthetic.forward_trajectory(n_frames, step=0.25, yaw_rate=0.004)
    c = cam_mod.Intrinsics.create(**intr)
    vo = StereoVO(cfg, device=device)
    for R, t in zip(Rs, ts):
        vo.process(*synthetic.make_stereo_pair(scene, c, R, t, H, W, baseline=0.3)[:2])
    return cfg, vo


def test_track_launches_holds_the_counter_to_the_track_calls():
    """`profile_direct.TrackLaunches` counts every call of an engine's
    track program (a CPU engine: no launch is owed) and restores the
    programs on exit; the direct counter is one of the programs'
    `COUNTERS`. Told the track ran on the card, it owes min(levels,
    pyramid_levels) x (iters + 1) launches a call, and `held` raises on
    the counter that did not move."""
    from viso_tpu_torch.slam import programs
    from viso_tpu_torch.tools import profile_direct

    assert (direct.launch, "launches") in programs.COUNTERS
    call = programs.Program.__call__
    with profile_direct.TrackLaunches() as tracks:
        tracks.reset()
        cfg, vo = _stereo_run(5, "cpu")
        try:
            assert tracks.calls == vo._kernels["track"].calls == 4
            assert tracks.held("cpu run") == 0
            prog = vo._kernels["track"]
            prog.device = torch.device("cuda")   # graphed stays False: eager on the CPU
            prog(*programs.unflatten(prog.spec, prog.inputs))
        finally:
            vo.close()
        per_call = min(direct.DirectParams().levels, cfg.pyramid_levels) * (cfg.direct_iters + 1)
        assert tracks.calls == 5 and tracks.want == per_call
        with pytest.raises(AssertionError, match=f"0 direct_gn launches for 5 track calls, "
                                                 f"which make {per_call}"):
            tracks.held("told cuda")
    assert programs.Program.__call__ is call


# -- the card -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def corridor():
    """The track's four level passes on two corridor frames at 376x1240
    with a real keyframe template (`profile_direct.corridor_levels`)."""
    from viso_tpu_torch.tools import profile_direct

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return profile_direct.corridor_levels(torch.device("cuda"))


def _level_args(c, level, params):
    return c["args"][level][:-1] + [params]


def _rot_gap(Ra, Rb):
    return float(torch.linalg.norm(se3.so3_log((Ra @ Rb.T).double())))


def _assert_bit_equal(got, ref):
    """The kernel's (R, t, cost) is the plain pass's to the bit: the
    tracking downstream turns a last-bit change of a pose into
    millimetres at the next keyframe."""
    for name, a, b in zip(("R", "t", "cost"), got, ref):
        assert torch.equal(a, b), (name, a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("level,n,win", TRACK_SHAPES)
def test_kernel_matches_plain_at_the_track_shapes_on_cuda(cuda_device, corridor, level, n, win):
    """At each of the track's four level passes on real corridor frames
    (the coarse levels' points strided, as the track hands them): the
    kernel's pose and cost bit-equal to the plain pass's, iters + 1
    launches a call, and two calls bit-equal."""
    params = direct.DirectParams(iters=6)
    args = _level_args(corridor, level, params)
    args[2], _ = direct._level_points(corridor["pts"], None, level)
    assert args[2].shape[0] == n
    assert direct._pass_window(args[0].shape, 4)[1] == win
    before = direct.launch.launches
    got = direct._level_pass_cached(*args)
    again = direct._level_pass_cached(*args)
    torch.cuda.synchronize()
    assert direct.launch.launches == before + 2 * (params.iters + 1)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _assert_bit_equal(got, direct.level_pass_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gated_out", "singular", "no_affine", "iters10"])
def test_kernel_edge_cases_on_cuda(cuda_device, corridor, case):
    """Every point gated out (cost inf, the input pose back), a non-finite
    H (every step zeroed: the input pose back), no affine compensation,
    10 GN steps: the kernel against the plain pass, at levels 0 and 1."""
    for level in (0, 1):
        params = direct.DirectParams(iters=10 if case == "iters10" else 6,
                                     affine=case != "no_affine")
        args = _level_args(corridor, level, params)
        tm = args[1]
        if case == "gated_out":
            args[1] = tm._replace(ok=torch.zeros_like(tm.ok))
        elif case == "singular":
            J6 = tm.J6.clone()
            J6[:, :64] = float("inf")
            args[1] = tm._replace(J6=J6)
        got, ref = direct._level_pass_cached(*args), direct.level_pass_plain(*args)
        torch.cuda.synchronize()
        if case in ("gated_out", "singular"):
            R0, t0 = args[3], args[4]
            for R, t, _ in (got, ref):
                assert torch.equal(R, R0) and torch.equal(t, t0), case
        if case == "gated_out":
            assert float(got[2]) == float("inf") == float(ref[2])
        _assert_bit_equal(got, ref)


@pytest.mark.cuda
def test_estimate_pose_launches_once_a_level_on_cuda(cuda_device, corridor):
    """An eager `estimate_pose_templated` launches the kernel iters + 1
    times per level and K1 once per level, gives the plain passes' pose
    to the bit, and lands near the frame's true pose."""
    from viso_tpu_torch.geometry import extract

    c = corridor
    R0, t0 = c["args"][3][3:5]
    before, k1 = direct.launch.launches, extract.launch.launches
    R, t, cost = direct.estimate_pose_templated(c["tmpl"], c["pyr"], c["pts"], c["intr"],
                                                R0, t0, c["params"])
    torch.cuda.synchronize()
    assert direct.launch.launches == before + 4 * (c["params"].iters + 1)
    assert extract.launch.launches == k1 + 4
    assert bool(torch.isfinite(cost))
    ref = (R0, t0, None)
    for level in range(3, -1, -1):
        pts_l, _ = direct._level_points(c["pts"], None, level)
        ref = direct.level_pass_plain(c["pyr"][level], c["tmpl"][level], pts_l, ref[0], ref[1],
                                      c["intr"].at_level(level), c["params"])
    _assert_bit_equal((R, t, cost), ref)
    Rt, tt = c["truth"]
    assert _rot_gap(R, Rt) < 2e-3 and float(torch.linalg.norm(t - tt)) < 0.05


@pytest.mark.cuda
def test_track_graph_at_the_cells_settings_on_cuda(cuda_device):
    """The track program at stereo_vo.drive's settings (376x1240, 2,048
    landmarks, 1,024 tracked): at most 2,200 kernel nodes, counted at
    capture (`_cuda.graph_nodes`); two replays of its graph on the same inputs give
    bit-equal poses."""
    import dataclasses

    from viso_tpu_torch import _cuda
    from viso_tpu_torch.slam.engine import StereoVO
    from viso_tpu_torch.tools import profile_frame

    cfg = dataclasses.replace(profile_frame.config(), stats_max_lag=8, kf_max_gap=5)
    vo = StereoVO(cfg, device=cuda_device)
    try:
        for il, ir in profile_frame.render(cfg, 5):
            vo.process(il, ir)
        torch.cuda.synchronize()
        prog = vo._kernels["track"]
        assert prog.graph is not None
        nodes = _cuda.graph_nodes(prog.graph.raw_cuda_graph())
        outs = []
        for _ in range(2):
            prog.graph.replay()
            outs.append([x.clone() for x in prog.outputs[:2]])
        torch.cuda.synchronize()
    finally:
        vo.close()
    print(f"track graph: {prog.kernels} kernel nodes, nodes by type {nodes}")
    assert prog.kernels == nodes[_cuda.GRAPH_NODE_KERNEL] <= 2200, nodes
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.cuda
def test_engine_launches_held_to_its_tracks_on_cuda(cuda_device):
    """A StereoVO run on the card: the direct kernel's launches, replays
    included (`programs.COUNTERS`), equal what its track calls owe
    (`profile_direct.TrackLaunches`), three a call's worth for the
    capturing call (two eager warm-ups), and more than zero."""
    from viso_tpu_torch.tools import profile_direct

    with profile_direct.TrackLaunches() as tracks:
        tracks.reset()
        cfg, vo = _stereo_run(6, cuda_device)
        try:
            torch.cuda.synchronize()
            calls = vo._kernels["track"].calls
        finally:
            vo.close()
        per_call = min(direct.DirectParams().levels, cfg.pyramid_levels) * (cfg.direct_iters + 1)
        assert tracks.calls == calls == 5
        assert tracks.held("StereoVO") == (calls + 2) * per_call > 0
