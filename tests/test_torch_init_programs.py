"""The monocular bootstrap's programs and the captured sharded solve on the
CPU.

On a CUDA engine each program is captured as a CUDA graph and replayed;
on the CPU the same static buffers are filled and the function runs
eagerly. Here:

  * `twoview.initialize` as its segments (`slam/programs.Cache.run`)
    against the eager function, bit for bit, with the generator left in
    the same state; and, handed the JAX key's hypotheses, against the JAX
    package's `twoview.initialize` at tests/test_torch_twoview.py's
    tolerances;
  * the init chain's LK program (`init_track`) against JAX `lk.track` at
    tests/test_torch_lk.py's tolerances;
  * no segment or program reads the device on the host
    (tests/test_torch_programs.py's guard), the RANSAC's `eigh` and `svd`
    being the only solver calls outside them;
  * a MonocularVO through its bootstrap and one forced re-init, through
    the programs against the eager segments bit for bit, and against the
    JAX engine within tests/test_torch_mono.py's band;
  * the `ba_solve` program at world 1, bit-equal to `ShardedSolver` and to
    `ba.solve_impl`; over a gloo group the engine runs the solve eagerly
    and lists it so.

The replays on the card: tests/test_torch_cuda.py and chip_smoke.py's
phase 14.
"""

import collections
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from viso_tpu.ops import fast as j_fast
from viso_tpu.ops import lk as j_lk
from viso_tpu.ops import pyramid as j_pyr
from viso_tpu.ops import ransac as jr
from viso_tpu.ops import twoview as jtv
from viso_tpu.slam.engine import MonocularVO as JMonocularVO
from viso_tpu.slam.engine import VOConfig as JVOConfig
from viso_tpu_torch.backend import ba
from viso_tpu_torch.geometry import camera as t_cam
from viso_tpu_torch.ops import ransac as tr
from viso_tpu_torch.ops import twoview as ttv
from viso_tpu_torch.parallel import dist_ba
from viso_tpu_torch.parallel import mesh as mesh_mod
from viso_tpu_torch.slam import programs
from viso_tpu_torch.slam.engine import MonocularVO, StereoVO, VOConfig
from viso_tpu_torch.tools import bench_dist_ba
from viso_tpu_torch.utils import metrics

from tests.test_torch_loop_programs import SegmentGuard, guard_cache, stereo_frames  # noqa: F401
from tests.test_torch_mono import CENTER_BAND, CFG as MONO_CFG, ReplayJaxDraws, render_forward
from tests.test_torch_mono import corridor  # noqa: F401
from tests.test_torch_programs import CFG as STEREO_CFG
from tests.test_torch_twoview import T, _ransac_inputs, _rot_deg

torch.set_num_threads(2)

TWOVIEW_CALLS = 3
# The segments of one `twoview.initialize` (with the homography), in order,
# and their calls: the homography's 4 refits are one program for the
# first 3 (each makes the next refit's system) and one for the last.
SEGMENTS = ["essential_system", "essential_score", "essential_refine", "homography_system",
            "homography_score", "homography_refit", "homography_refit", "twoview_select"]
SEGMENT_CALLS = [1, 1, 1, 1, 1, 3, 1, 1]
# One initialization's solver calls between its segments: the essential
# fit's eigh and svd, the top hypotheses' and the winner's svd, the
# homography fit's eigh, its 4 refits' eigh and its svd.
SOLVER_CALLS = {"_linalg_eigh": 6, "_linalg_svd": 4}
MONO_FRAMES, REINIT_AT = 16, 8


def eager_run(name, fn, statics, *args, counted=False):
    return tr.eager(name, fn, statics, *args)


def _pair(use_homography):
    rng = np.random.default_rng(1)
    x1, x2, mask, *_ = _ransac_inputs(rng, 0.2)
    params = ttv.TwoViewParams(projection_error_thresh=1.0, parallax_thresh_deg=15.0,
                               use_homography=use_homography)
    return T(x1), T(x2), T(mask), params


@pytest.mark.parametrize("use_homography", [True, False])
def test_segmented_initialize_equals_the_eager_function(use_homography):
    """TWOVIEW_CALLS initializations through a cache's programs (the first
    call of each eager, later ones through its static buffers) against the
    eager function with a second generator at the same seed: every field
    bit for bit, and the generators in the same state after them."""
    x1, x2, mask, params = _pair(use_homography)
    cache = programs.Cache("cpu")
    gen, ref_gen = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    for _ in range(TWOVIEW_CALLS):
        got = ttv.initialize(gen, x1, x2, mask, params, run=cache.run)
        want = ttv.initialize(ref_gen, x1, x2, mask, params)
        for field in ttv.TwoViewResult._fields:
            assert torch.equal(getattr(got, field), getattr(want, field)), field
    assert torch.equal(gen.get_state(), ref_gen.get_state())
    assert int(got.num_inliers) > 100 and bool(got.disparity_ok)
    keep = slice(None) if use_homography else [0, 1, 2, 7]
    assert [key[0] for key in cache.programs] == np.array(SEGMENTS)[keep].tolist()
    assert [p.calls for p in cache.programs.values()] == [
        TWOVIEW_CALLS * n for n in np.array(SEGMENT_CALLS)[keep]]


def test_segmented_initialize_with_jax_indices_matches_reference(rng):
    """The segments, handed the hypotheses the JAX key draws, against JAX
    `twoview.initialize` at tests/test_torch_twoview.py's tolerances:
    0.05 deg, 1e-3 on t, inliers within 3, parallax within 0.01 deg."""
    x1, x2, mask, inlier, _, _ = _ransac_inputs(rng, 0.2)
    key = jax.random.PRNGKey(1)
    params_j = jtv.TwoViewParams(projection_error_thresh=1.0, parallax_thresh_deg=15.0)
    params_t = ttv.TwoViewParams(projection_error_thresh=1.0, parallax_thresh_deg=15.0)
    k_e, k_h = jax.random.split(key)
    m = jnp.asarray(mask)
    idx_e = T(np.asarray(jr._sample_indices(k_e, m, 512, 8)))
    idx_h = T(np.asarray(jr._sample_indices(k_h, m, 256, 4)))
    res_j = jtv.initialize(key, jnp.asarray(x1), jnp.asarray(x2), m, params_j)
    cache = programs.Cache("cpu")
    for _ in range(2):    # the second through the static buffers
        res_t = ttv.initialize_from_indices(idx_e, idx_h, T(x1), T(x2), T(mask), params_t,
                                            run=cache.run)
    assert bool(res_t.disparity_ok) and bool(res_j.disparity_ok)
    assert int(res_t.num_tracks) == int(res_j.num_tracks) == mask.sum()
    assert _rot_deg(res_t.R.numpy(), res_j.R) < 0.05
    np.testing.assert_allclose(res_t.t.numpy(), np.asarray(res_j.t), atol=1e-3)
    assert abs(int(res_t.num_inliers) - int(res_j.num_inliers)) <= 3
    assert abs(float(res_t.median_parallax_deg) - float(res_j.median_parallax_deg)) < 0.01
    assert int(res_t.num_inliers) > 100


class InitGuard(SegmentGuard):
    """`SegmentGuard` that counts the ops outside the programs only while
    a two-view initialization runs (`recording`)."""

    def __init__(self, found):
        super().__init__(found)
        self.recording, self.solvers = False, collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if self.recording and not self.inside and "linalg" in name:
            self.solvers[name] += 1
        return super().__torch_dispatch__(func, types, args, kwargs)


def _force_reinit(vo, at):
    """Make `vo` (either package) report lost tracking at frame `at`."""
    real = vo._update_lost
    vo._update_lost = lambda n: vo.frame_idx == at or real(n)


def _guarded(vo, frames):
    """`vo` through `frames` with its cache's programs under `InitGuard`:
    (host reads found inside them, program names run, each two-view
    initialization's solver calls outside them)."""
    found, ran, inits = [], set(), []
    guard = InitGuard(found)
    guard_cache(vo._cache, guard, ran)
    real = ttv.initialize

    def initialize(*args, **kw):
        guard.recording = True
        try:
            return real(*args, **kw)
        finally:
            guard.recording = False
            inits.append(dict(guard.solvers))
            guard.solvers.clear()

    mp = pytest.MonkeyPatch()
    mp.setattr(ttv, "initialize", initialize)
    try:
        with guard:
            for img in frames:
                vo.process(img)
    finally:
        mp.undo()
    return found, ran, inits


@pytest.fixture(scope="module")
def bootstrap_runs(corridor):  # noqa: F811
    """The mono corridor through a bootstrap and a re-init forced at frame
    REINIT_AT: the port through its programs (under `InitGuard`) and
    through eager segments (its own draws), and the JAX engine beside the
    port through its programs (the JAX key's draws, `ReplayJaxDraws`)."""
    frames, _ = render_forward(corridor, MONO_FRAMES)
    runs = {}
    for name in ("programs", "eager"):
        vo = MonocularVO(VOConfig(**MONO_CFG), device="cpu")
        _force_reinit(vo, REINIT_AT)
        if name == "eager":
            vo._cache.run = eager_run
            for img in frames:
                vo.process(img)
        else:
            runs["guard"] = _guarded(vo, frames)
        runs[name] = vo
    mp = pytest.MonkeyPatch()
    mp.setattr(tr, "draw_indices", ReplayJaxDraws(0))
    jvo = JMonocularVO(JVOConfig(**MONO_CFG))
    tvo = MonocularVO(VOConfig(**MONO_CFG), device="cpu")
    try:
        for vo in (jvo, tvo):
            _force_reinit(vo, REINIT_AT)
        for img in frames:
            jvo.process(img)
            tvo.process(img)
    finally:
        mp.undo()
    runs["jax"], runs["replayed"], runs["frames"] = jvo, tvo, frames
    yield runs
    for name in ("programs", "eager", "jax", "replayed"):
        runs[name].close()


def test_bootstrap_programs_read_nothing_on_the_host(bootstrap_runs):
    """Through the bootstrap and the forced re-init, the init chain's
    program and every two-view segment run under the guard with no host
    read, and each initialization's only solver calls outside them are
    SOLVER_CALLS."""
    found, ran, inits = bootstrap_runs["guard"]
    assert found == [] and ran == {"init_track", *SEGMENTS}
    assert len(inits) >= 2 and all(c == SOLVER_CALLS for c in inits)


def test_bootstrap_programs_equal_the_eager_segments(bootstrap_runs):
    """Through the bootstrap and the re-init, the engine on its programs
    ends where the engine on eager segments ends: every pose bit for bit,
    the same states, and its generator in the same state."""
    vo, ref = bootstrap_runs["programs"], bootstrap_runs["eager"]
    states = [r.state for r in vo.results]
    assert vo.num_reinits == ref.num_reinits == 1
    assert states == [r.state for r in ref.results]
    assert states[REINIT_AT + 1] == "init" and states[-1] == "tracking"
    for a, b in zip(vo.trajectory(), ref.trajectory()):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(vo.generator.get_state(), ref.generator.get_state())
    assert {key[0] for key in vo._cache.programs} == {"init_track", *SEGMENTS}
    assert not ref._cache.programs


def test_bootstrap_programs_match_the_jax_engine(bootstrap_runs):
    """With the JAX key's draws, the engine on its programs against the JAX
    engine through the bootstrap and the forced re-init: the same states,
    keyframes and re-inits, camera centres within tests/test_torch_mono.py's
    CENTER_BAND of the distance travelled."""
    jvo, tvo = bootstrap_runs["jax"], bootstrap_runs["replayed"]
    assert [r.state for r in tvo.results] == [r.state for r in jvo.results]
    assert [r.is_keyframe for r in tvo.results] == [r.is_keyframe for r in jvo.results]
    assert tvo.num_reinits == jvo.num_reinits == 1
    cj = metrics.camera_centers(*jvo.trajectory())
    ct = metrics.camera_centers(*tvo.trajectory())
    travel = np.linalg.norm(cj[-1] - cj[0])
    assert np.linalg.norm(ct - cj, axis=-1).max() < CENTER_BAND * travel


def test_init_track_program_matches_jax_lk(bootstrap_runs):
    """The init chain's program (LK, the track count, both ends normalized)
    on the corridor's frames 0 and 2 (pyramids and FAST keypoints from the
    JAX package, as tests/test_torch_lk.py builds them), twice through an
    engine's cache, against JAX `lk.track` (compiled by the JAX engine's
    run): positions within 0.01 px and the accepted sets within 3 %
    (tests/test_torch_lk.py::test_lk_large_motion_matches), the count and
    the normalized coordinates as the outputs give them."""
    frames = bootstrap_runs["frames"]
    cfg = VOConfig(**MONO_CFG)
    pa, pb = (j_pyr.build_pyramid(jnp.asarray(frames[i], jnp.float32), cfg.pyramid_levels)
              for i in (0, 2))
    uv, _, mask = j_fast.detect_grid_pyramid(pa, threshold=cfg.fast_threshold,
                                             grid=cfg.detect_grid, per_cell=8,
                                             levels=cfg.detect_levels)
    kj, _, okj = (np.asarray(x) for x in j_lk.track(pa, pb, uv, mask))
    uv, mask = T(np.asarray(uv)), T(np.asarray(mask))
    vo = MonocularVO(cfg, device="cpu")
    ta, tb = (tuple(T(np.asarray(x)) for x in p) for p in (pa, pb))
    for _ in range(2):
        kp2, ok, n, x1, x2 = vo._cache.run("init_track", vo._init_track_program, {}, ta, tb,
                                           uv, mask, uv, counted=True)
    vo.close()
    kt, okt = kp2.numpy(), ok.numpy()
    both = okj & okt
    assert both.sum() >= 0.97 * okj.sum() and both.sum() >= 0.97 * okt.sum()
    assert np.abs(kt - kj)[both].max() < 1e-2 and okt.sum() > 50
    assert int(n) == okt.sum()
    assert torch.equal(x1, t_cam.normalize(uv, vo.intr))
    assert torch.equal(x2, t_cam.normalize(kp2, vo.intr))
    assert [p.calls for p in vo._cache.programs.values()] == [2]


def test_ba_solve_program_at_world_one_is_bit_equal():
    """The sharded solve's program at world 1 (no group: the reduction is
    the identity), three calls, bit-equal to the solver's eager call and to
    `ba.solve_impl`, its collective record kept; no host read inside."""
    prob = bench_dist_ba.build_problem(6, 256, "cpu", obs_noise=1e-3, pose_noise=0.01)
    params = ba.BAParams(iters=4, num_fixed=2)
    mesh = mesh_mod.make_mesh(device="cpu")
    solver = dist_ba.ShardedSolver(mesh, params)
    program = solver.program(programs.Cache("cpu"))
    out_1, info_1 = ba.solve_impl(prob, params)
    found = []
    for _ in range(3):
        with SegmentGuard(found) as guard:
            guard.inside = True
            out_p, info_p = program(prob)
    out_s, info_s = solver(prob)
    for out, info in ((out_p, info_p), (out_s, info_s)):
        for name in ("R", "t", "points"):
            assert torch.equal(getattr(out, name), getattr(out_1, name)), name
        for key in info_1:
            assert torch.equal(info[key], info_1[key]), key
    assert found == [] and program.name == "ba_solve" and program.calls == 3
    assert solver.stats.per_iter(4)[:2] == (2, dist_ba.psum_bytes_per_iter(6))


def test_gloo_group_runs_the_solve_eagerly_and_lists_it(stereo_frames, tmp_path):  # noqa: F811
    """Over a gloo group (world 1 here) the solve cannot be captured: the
    solver refuses to become a program, and a distributed engine runs its
    prep and finish as programs around the eager solve, its listing saying
    "eager (gloo)", and ends where the single-device engine ends."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = mesh_mod.make_mesh(device="cpu")
        assert mesh.group is not None and not dist_ba.capturable(mesh)
        with pytest.raises(ValueError, match="gloo"):
            dist_ba.ShardedSolver(mesh, ba.BAParams()).program(None)
        vo = StereoVO(VOConfig(**STEREO_CFG, distribute_ba=True), device="cpu")
        for il, ir in stereo_frames:
            vo.process(il, ir)
        listing = vo.program_listing()
        kernels = set(vo._kernels)
        dist_poses = vo.trajectory()
        vo.close()
    finally:
        dist.destroy_process_group()
    assert listing["ba_solve"] == "eager (gloo)"
    assert listing["ba_prep"] == listing["ba_finish"] == listing["track"] == "eager (cpu)"
    assert "ba_solve" not in kernels and {"ba_prep", "ba_finish"} <= kernels
    vo = StereoVO(VOConfig(**STEREO_CFG), device="cpu")
    for il, ir in stereo_frames:
        vo.process(il, ir)
    for a, b in zip(dist_poses, vo.trajectory()):
        np.testing.assert_array_equal(a, b)
    vo.close()
