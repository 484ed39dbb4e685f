"""The SLAM loop layer's programs (`slam/programs.Cache`) on the CPU.

On a CUDA engine each is captured as a CUDA graph at its second call and
replayed after; on the CPU the same static buffers are filled and the
function runs eagerly. Here:

  * the pose-graph solve through its program, SE(3) and Sim(3), at two
    dense buckets (16 and 32 nodes) and one PCG bucket, against the JAX
    package's jitted `solve` on the same padded graph, at the tolerances
    of tests/test_torch_pose_graph.py and tests/test_torch_pose_graph_sim3.py;
    a second graph at a bucket is read anew, a larger one makes a new
    program;
  * loop detection as segments (a program each) between the draw and the
    solver calls: equal to the eager function bit for bit with the
    database's generator left in the same state, and with the JAX key's
    hypotheses within tests/test_torch_slam.py's tolerances of the JAX
    kernels;
  * the keyframe digest's program against the JAX digest, and two digests
    in flight that do not alias;
  * no program reads the device on the host (tests/test_torch_programs.py's
    guard), the detection's `eigh` and `svd` being the only solver calls
    outside its segments; the distributed engine's BA prep and finish.

The replays on the card: tests/test_torch_cuda.py and chip_smoke.py's
phase 13.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from viso_tpu.backend import pose_graph as j_pg
from viso_tpu.backend import pose_graph_sim3 as j_pgs
from viso_tpu.geometry import camera as j_cam
from viso_tpu.mapping import map_state as j_ms
from viso_tpu.slam import full as j_full
from viso_tpu.slam import loop_closure as j_lc
from viso_tpu_torch.backend import pose_graph as t_pg
from viso_tpu_torch.backend import pose_graph_sim3 as t_pgs
from viso_tpu_torch.geometry import camera as t_cam
from viso_tpu_torch.ops import pnp as t_pnp
from viso_tpu_torch.slam import loop_closure as t_lc
from viso_tpu_torch.slam import programs
from viso_tpu_torch.slam.engine import StereoVO, VOConfig
from viso_tpu_torch.slam.full import StereoSLAM
from viso_tpu_torch.slam.loop_closure import LoopParams

from tests.test_torch_pose_graph import _loop_graph
from tests.test_torch_pose_graph_sim3 import centers, drift_problem
from tests.test_torch_programs import CFG, NoHostSync, guard_programs
from tests.test_torch_slam import INTR_ARGS, THRESH, _detection_scene, _jax_draw, _query_args

torch.set_num_threads(2)

# (node count, linear solver): buckets 16 and 32 dense, 16 by PCG.
SOLVE_CASES = [(12, "dense"), (24, "dense"), (12, "pcg")]
DETECTIONS = 3


def _se3_graph(K, seed=1):
    return _loop_graph(np.random.default_rng(seed), K=K, loops=((0, K - 1), (1, K - 2)))


def _jax_tree(g, cls):
    return cls(*(jnp.asarray(x.numpy()) for x in g))


# -- the pose-graph solves ---------------------------------------------------

@pytest.mark.parametrize("K, solver", SOLVE_CASES)
def test_se3_solve_program_matches_jax(K, solver):
    """The program of the graph's bucket against the JAX package's jitted
    `solve` on the same padded graph: poses within 1e-4, the final cost
    to 1e-4 relative (tests/test_torch_pose_graph.py:82-84)."""
    pR, pt, edges = _se3_graph(K)
    params = t_pg.PGParams(iters=25, solver=solver)
    cache = programs.Cache("cpu")
    out, info = t_pg.solve_padded(pR, pt, edges, params, device="cpu", programs=cache)
    g = t_pg.pad_graph(pR, pt, edges, device="cpu")
    Kp, Ep = g.R.shape[0], g.edge_i.shape[0]
    assert list(cache.programs) == [("pose_graph", Kp, Ep, params)]
    assert Kp == (16 if K <= 16 else 32)
    outj, infoj = j_pg.solve(_jax_tree(g, j_pg.PoseGraph),
                             j_pg.PGParams(iters=25, solver=solver))
    np.testing.assert_allclose(out.R[:K].numpy(), np.asarray(outj.R)[:K], atol=1e-4)
    np.testing.assert_allclose(out.t[:K].numpy(), np.asarray(outj.t)[:K], atol=1e-4)
    np.testing.assert_allclose(float(info["final_cost"]), float(infoj["final_cost"]),
                               rtol=1e-4)
    assert float(info["final_cost"]) < 0.2 * float(info["initial_cost"])
    assert info["cost_history"].shape == (25,)


@pytest.mark.parametrize("K, solver", SOLVE_CASES)
def test_sim3_solve_program_matches_jax(K, solver):
    """tests/test_torch_pose_graph_sim3.py's drifting circle through the
    program of its bucket against the JAX package's jitted `solve` on the
    same padded graph: scales within 1e-4 and metric centres within 1e-2
    m (tests/test_torch_pose_graph_sim3.py:132-133)."""
    edges, pg_s, pg_R, pg_t, _, _ = drift_problem(K, 1.005)
    kw = dict(iters=30, solver=solver, pcg_iters=192)
    params = t_pgs.PGParams(**kw)
    cache = programs.Cache("cpu")
    out, info = t_pgs.solve_padded(pg_s, pg_R, pg_t, edges, params, device="cpu",
                                   programs=cache)
    g = t_pgs.pad_graph(pg_s, pg_R, pg_t, edges, device="cpu")
    assert list(cache.programs) == [("pose_graph_sim3", g.R.shape[0], g.edge_i.shape[0],
                                     params)]
    outj, _ = j_pgs.solve(_jax_tree(g, j_pgs.Sim3Graph), j_pgs.PGParams(**kw))
    s_out = out.s[:K].numpy()
    np.testing.assert_allclose(s_out, np.asarray(outj.s)[:K], atol=1e-4)
    c_out = centers(s_out, out.R[:K].numpy(), out.t[:K].numpy())
    c_j = centers(np.asarray(outj.s)[:K], np.asarray(outj.R)[:K], np.asarray(outj.t)[:K])
    assert np.abs(c_out - c_j).max() < 1e-2
    assert float(info["final_cost"]) < 0.05 * float(info["initial_cost"])


def test_solve_program_reads_each_graph_anew():
    """A second graph at the same bucket goes through the same program and
    gives its own solution (the eager solve's, bit for bit on the CPU), in
    the same output tensors: inputs are re-read, not baked in."""
    cache = programs.Cache("cpu")
    params = t_pg.PGParams(iters=10)
    outs = []
    for seed in (1, 2):
        pR, pt, edges = _se3_graph(12, seed)
        out, _ = t_pg.solve_padded(pR, pt, edges, params, device="cpu", programs=cache)
        ref, _ = t_pg.solve_padded(pR, pt, edges, params, device="cpu")
        assert torch.equal(out.R, ref.R) and torch.equal(out.t, ref.t)
        outs.append((out.R.data_ptr(), out.R.clone()))
    assert len(cache.programs) == 1 and outs[0][0] == outs[1][0]
    assert not torch.equal(outs[0][1], outs[1][1])


def test_growing_past_a_bucket_makes_a_new_program():
    cache = programs.Cache("cpu")
    params = t_pg.PGParams(iters=2)
    for K in (15, 16, 17, 30):
        t_pg.solve_padded(*_se3_graph(K), params, device="cpu", programs=cache)
    keys = list(cache.programs)
    assert [k[1:3] for k in keys] == [(16, 16), (16, 32), (32, 32)], keys
    assert [cache.programs[k].calls for k in keys] == [1, 1, 2]


# -- loop detection in segments ----------------------------------------------

def _query(q, sim3):
    desc, mask, kps = _query_args(q, "port")
    if not sim3:
        return (desc, mask, kps)
    return (desc, mask, kps, *(torch.from_numpy(q[k]) for k in ("pts", "pts_ok", "R", "t")))


def _eager_packed(db, query, eligible, intr, draw):
    p = db.params
    args = (*query, db.desc, db.desc_mask, db.points_w_dev, db.points_ok_dev,
            torch.from_numpy(eligible), intr, (p.pnp_threshold_px / float(intr.fx)) ** 2,
            p.min_matches, p.min_inliers, draw)
    kernel = t_lc._detect_fused_sim3_kernel if len(query) > 3 else t_lc._detect_fused_kernel
    return kernel(*args).numpy()


@pytest.mark.parametrize("sim3", [False, True])
def test_segmented_detection_equals_the_eager_function(sim3):
    """DETECTIONS detections through the database's programs (its own
    draws) against the eager function with draws from a second database
    at the same seed: the same packed vectors bit for bit, and the two
    generators in the same state after them."""
    _, tdb, q, _ = _detection_scene(sigma=1.5 if sim3 else 1.0)
    _, ref_db, _, _ = _detection_scene(sigma=1.5 if sim3 else 1.0)
    intr = t_cam.Intrinsics.create(*INTR_ARGS)
    query = _query(q, sim3)
    for _ in range(DETECTIONS):
        got = tdb._detect_packed(query, intr)
        ref = _eager_packed(ref_db, query, tdb._eligible(), intr,
                            functools.partial(t_pnp.draw_hypotheses, ref_db.generator))
        assert got.shape == ((29,) if sim3 else (16,))
        np.testing.assert_array_equal(got, ref)
        assert got[3] >= 40
    assert torch.equal(tdb.generator.get_state(), ref_db.generator.get_state())
    names = sorted({k[0] for k in tdb.programs.programs})
    tail = ["detect_pnp_sim3", "detect_umeyama"] if sim3 else ["detect_pnp"]
    assert names == sorted(["detect_dlt", "detect_dlt_sign", "detect_match"] + tail)
    assert all(p.calls == DETECTIONS for p in tdb.programs.programs.values())


@pytest.mark.parametrize("sim3", [False, True])
def test_segmented_detection_with_the_jax_draw_matches_reference(sim3):
    """The segments, handed the hypotheses the JAX key draws, against the
    JAX package's fused kernels (tests/test_torch_slam.py:178-201): counts
    and slot exactly, the PnP pose (and the Umeyama similarity) to 1e-4."""
    jdb, tdb, q, _ = _detection_scene(sigma=1.5 if sim3 else 1.0)
    key = jax.random.PRNGKey(3)
    eligible = jdb.insert_seq >= 0
    intr_j = j_cam.Intrinsics.create(*INTR_ARGS)
    args_j = _query_args(q, "jax")
    if sim3:
        args_j += tuple(jnp.asarray(q[k]) for k in ("pts", "pts_ok", "R", "t"))
    kernel_j = j_lc._detect_fused_sim3_kernel if sim3 else j_lc._detect_fused_kernel
    packed_j = np.asarray(kernel_j(
        *args_j, jdb.desc, jdb.desc_mask, jdb.points_w_dev, jdb.points_ok_dev,
        jnp.asarray(eligible), intr_j, jnp.asarray(THRESH, jnp.float32),
        jnp.asarray(20, jnp.int32), jnp.asarray(15, jnp.int32), key))
    db = (tdb.desc, tdb.desc_mask, tdb.points_w_dev, tdb.points_ok_dev)
    packed_t = t_lc._detect(tdb.programs.run, _query(q, sim3), db, torch.from_numpy(eligible),
                            t_cam.Intrinsics.create(*INTR_ARGS), THRESH, 20, 15,
                            _jax_draw(key)).numpy()
    np.testing.assert_array_equal(packed_t[:4], packed_j[:4])
    assert packed_t[1] == 2 and packed_t[3] >= 40
    np.testing.assert_allclose(packed_t[4:], packed_j[4:], atol=1e-4)


# -- the keyframe digest -----------------------------------------------------

DIGEST_HW, DIGEST_NF = (96, 128), 32


@pytest.fixture
def digest_slam():
    """A StereoSLAM whose map holds seeded keyframe images, observations
    and landmarks; its keyframe hooks are kept, not run."""
    H, W = DIGEST_HW
    cfg = VOConfig(height=H, width=W, max_keyframes=4, max_landmarks=64, num_features=48,
                   fx=100.0, fy=100.0, cx=63.5, cy=47.5)
    slam = StereoSLAM(cfg, LoopParams(capacity=8, num_features=DIGEST_NF), device="cpu")
    rng = np.random.default_rng(4)
    m = slam.map
    with torch.no_grad():
        for lvl in m.kf_pyr:
            lvl.copy_(torch.from_numpy(rng.uniform(0, 255, lvl.shape).astype(np.float32)))
        m.obs_mask.copy_(torch.from_numpy(rng.uniform(size=m.obs_mask.shape) < 0.4))
        m.obs_uv.copy_(torch.from_numpy(np.stack(
            [rng.uniform(20, W - 20, m.obs_mask.shape), rng.uniform(20, H - 20, m.obs_mask.shape)],
            -1).astype(np.float32)))
        m.points.copy_(torch.from_numpy(rng.normal(0, 2, m.points.shape).astype(np.float32)))
    hooks = []
    slam._hook_pool.shutdown(wait=True)
    slam._hook_pool = types.SimpleNamespace(submit=lambda fn, *a: hooks.append(a),
                                            shutdown=lambda wait: None)
    yield slam, hooks
    slam.close()


def test_digest_program_matches_jax(digest_slam):
    """The digest's program against the JAX package's jitted digest on the
    same map and the keyframe's image: keypoints, mask and landmarks
    equal, at most 1 % of the descriptor bits apart
    (tests/test_torch_descriptors.py's bound)."""
    slam, hooks = digest_slam
    m = slam.map
    mj = j_ms.MapState(*(tuple(jnp.asarray(x.numpy()) for x in f) if isinstance(f, tuple)
                         else jnp.asarray(f.numpy()) for f in m))
    digest_j = j_full.make_digest_kernel(DIGEST_NF)
    for slot in (2, 0):
        slam._post_keyframe(slot, None)
        kps, mask, desc, pts = (x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
                                for x in hooks[-1][1])
        kj, mj_, dj, pj = (np.asarray(x).astype(np.float32) if x.dtype == jnp.bfloat16
                           else np.asarray(x) for x in digest_j(mj, slot, mj.kf_pyr[0][slot]))
        np.testing.assert_array_equal(kps, kj)
        np.testing.assert_array_equal(mask, mj_)
        np.testing.assert_array_equal(pts, pj)
        assert 5 < mask.sum() <= DIGEST_NF
        assert (desc != dj).sum() <= 0.01 * (dj != 0).sum()
    prog = slam._loop_programs.programs[("digest",)]
    assert prog.calls == 2       # the map, read in place
    assert all(a is b for a, b in zip(prog.inputs, programs.flatten(m)[0]))


def test_two_digests_in_flight_do_not_alias(digest_slam):
    """A hook's digest is its own: the next keyframe's digest (the same
    program, whose outputs it overwrites) leaves it as it was."""
    slam, hooks = digest_slam
    slam._post_keyframe(1, None)
    first = [x.clone() for x in hooks[0][1]]
    slam._post_keyframe(3, None)
    prog = slam._loop_programs.programs[("digest",)]
    outs = {x.data_ptr() for x in programs.flatten(prog.outputs)[0]}
    for a, b, c in zip(hooks[0][1], first, hooks[1][1]):
        assert torch.equal(a, b) and a.data_ptr() not in outs and c.data_ptr() not in outs
    assert not torch.equal(hooks[0][1][0], hooks[1][1][0])


# -- no host reads -----------------------------------------------------------

class SegmentGuard(TorchDispatchMode):
    """`NoHostSync` inside the programs (`inside` set by their wrapper),
    and the names of the ops outside them."""

    def __init__(self, found):
        super().__init__()
        self.found, self.inside, self.outside = found, False, set()
        self.check = NoHostSync(found)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.inside:
            return self.check.__torch_dispatch__(func, types, args, kwargs)
        self.outside.add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def guard_cache(cache, guard, ran):
    """Wraps the function of every program `cache` makes from now on."""
    real = cache.get

    def get(key, fn, **kw):
        def guarded(*args):
            ran.add(key[0])
            guard.inside = True
            try:
                return fn(*args)
            finally:
                guard.inside = False

        return real(key, guarded, **kw)

    cache.get = get


@pytest.mark.parametrize("sim3", [False, True])
def test_detection_segments_read_nothing_on_the_host(sim3):
    """Each segment runs under the guard with no host read; outside them
    the only solver calls are the DLT's `eigh` and `svd` (and the
    Umeyama fit's `svd`), the calls that check their status on the host
    on CUDA."""
    _, tdb, q, _ = _detection_scene(sigma=1.5 if sim3 else 1.0)
    found, ran = [], set()
    guard = SegmentGuard(found)
    guard_cache(tdb.programs, guard, ran)
    with guard:
        for _ in range(2):
            packed = tdb._detect_packed(_query(q, sim3), t_cam.Intrinsics.create(*INTR_ARGS))
    assert found == [] and packed[3] >= 40
    assert len(ran) == (5 if sim3 else 4)
    assert {n for n in guard.outside if "linalg" in n} == {"_linalg_eigh", "_linalg_svd"}


@pytest.mark.parametrize("sim3", [False, True])
def test_solve_programs_read_nothing_on_the_host(sim3):
    cache = programs.Cache("cpu")
    found, ran = [], set()
    guard = SegmentGuard(found)
    guard_cache(cache, guard, ran)
    with guard:
        for solver in ("dense", "pcg"):
            if sim3:
                edges, pg_s, pg_R, pg_t, _, _ = drift_problem(12, 1.005)
                t_pgs.solve_padded(pg_s, pg_R, pg_t, edges,
                                   t_pgs.PGParams(iters=3, solver=solver), device="cpu",
                                   programs=cache)
            else:
                t_pg.solve_padded(*_se3_graph(12), t_pg.PGParams(iters=3, solver=solver),
                                  device="cpu", programs=cache)
    assert found == [] and ran == {"pose_graph_sim3" if sim3 else "pose_graph"}
    assert len(cache.programs) == 2


def test_digest_program_reads_nothing_on_the_host(digest_slam):
    slam, _ = digest_slam
    found, ran = [], set()
    guard = SegmentGuard(found)
    guard_cache(slam._loop_programs, guard, ran)
    with guard:
        for slot in (0, 1, 2):
            slam._post_keyframe(slot, None)
    assert found == [] and ran == {"digest"}


def test_distributed_ba_prep_and_finish_are_programs(stereo_frames):
    """A distributed engine (world of one) runs its window BA as the
    `ba_prep`, `ba_solve` (the sharded solver) and `ba_finish` programs,
    none reading the device on the host, and ends where the single-device
    engine ends, bit for bit."""
    poses = []
    for distribute in (False, True):
        vo = StereoVO(VOConfig(**CFG, distribute_ba=distribute), device="cpu")
        found, ran = [], set()
        guard_programs(vo, found, ran)
        for il, ir in stereo_frames:
            vo.process(il, ir)
        poses.append(vo.trajectory())
        vo.close()
        assert found == []
        assert ran == ({"track", "templates", "stereo_kf"}
                       | ({"ba_prep", "ba_solve", "ba_finish"} if distribute else {"ba"}))
    for a, b in zip(*poses):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def stereo_frames():
    """tests/test_torch_programs.py's stereo corridor, 8 frames."""
    from viso_tpu.data import synthetic as j_syn

    corridor = j_syn.corridor_scene(np.random.default_rng(7), tex_size=512)
    H, W = CFG["height"], CFG["width"]
    intr = j_cam.Intrinsics.create(CFG["fx"], CFG["fy"], CFG["cx"], CFG["cy"])
    Rs, ts = j_syn.forward_trajectory(8, step=0.25, yaw_rate=0.004)
    out = []
    for R, t in zip(Rs, ts):
        il, ir, _ = j_syn.make_stereo_pair(corridor, intr, R, t, H, W, baseline=0.3)
        out.append((np.clip(il, 0, 255).astype(np.uint8), np.clip(ir, 0, 255).astype(np.uint8)))
    return out
