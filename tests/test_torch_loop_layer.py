"""White-box tests of the port's SLAM loop layer (`slam/full.py`,
`LoopLayer`) on both StereoSLAM and MonoSLAM: tests/test_loop_layer.py's
cases, run against the port. The worker-side hook runs synchronously with
the descriptor database stubbed out, so the throttle, flush and rollback
contracts are exercised directly:

  * join() flushes a solve left pending behind the event throttle;
  * a rejected solve rolls back every loop edge accumulated since the last
    accepted solve, not just the newest, and rewinds the throttle clock,
    also when the damage of the solve lies mid-trajectory;
  * a failed hook appends a placeholder node, so node ids stay dense;
  * the mono solve-health gate rejects an absurd (50x) scale edge;
  * a non-finite solve: the mono gate rejects it, the stereo gate keeps
    it, on both packages.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from viso_tpu_torch.backend import pose_graph
from viso_tpu_torch.backend import pose_graph_sim3 as pgs
from viso_tpu_torch.slam.engine import VOConfig
from viso_tpu_torch.slam.full import StereoSLAM
from viso_tpu_torch.slam.loop_closure import LoopCandidate, LoopParams
from viso_tpu_torch.slam.mono_full import MonoSLAM

torch.set_num_threads(2)


def _tiny_cfg():
    return VOConfig(
        height=64, width=80, max_keyframes=2, max_landmarks=64,
        num_features=32, pyramid_levels=2, track_landmarks=32,
    )


@pytest.fixture(params=["stereo", "mono"])
def slam(request):
    cls = MonoSLAM if request.param == "mono" else StereoSLAM
    s = cls(_tiny_cfg(), LoopParams(capacity=16, num_features=8, guard=0), device="cpu")
    # The database is not under test: detection results are injected
    # per push (_push below).
    s.loop_db.add = lambda *a, **k: None
    yield s
    s.close()


class _Host:
    """Stands in for the HostFetch of a keyframe's digest: the pose and
    empty keypoints, mask and landmarks."""

    def __init__(self, R, t):
        self.arrays = [R, t, None, None, None]

    def result(self):
        return self.arrays


def _push(s, node_id, center, cand=None):
    """Run the worker-side hook synchronously for a node at the given
    camera centre (R = I, world->cam t = -center)."""
    s.loop_db.detect_fused = lambda *a, **k: cand
    s.loop_db.detect_fused_sim3 = lambda *a, **k: cand
    R = np.eye(3, dtype=np.float32)
    t = -np.asarray(center, np.float32)
    s._next_node = node_id + 1
    s._hook_task_impl(node_id, (None,) * 4, _Host(R, t), node_id * 3, 100, -(10**9))


def _candidate(s, c_cur, c_cand, s_rel=1.0, inliers=60):
    """A loop candidate that measures the current node at `c_cur` and the
    candidate at `c_cand` (both R = I), in the convention of the class:
    stereo's is T_cur o T_cand^-1, mono's the Umeyama G = S_cand o S_cur^-1."""
    d = np.asarray(c_cur, np.float32) - np.asarray(c_cand, np.float32)
    t_rel = d if isinstance(s, MonoSLAM) else -d
    return LoopCandidate(db_index=0, matches=50, inliers=inliers,
                         R_rel=np.eye(3, dtype=np.float32), t_rel=t_rel, s_rel=s_rel)


def _scales(s):
    return np.asarray(s.pg_s) if isinstance(s, MonoSLAM) else np.ones(len(s.pg_R))


def test_join_flushes_pending_solve(slam):
    s = slam
    # Block the event throttle so the loop edge stays pending.
    s.loop_params.min_event_gap_kf = 100
    s._last_event_node = 0
    # Consistent with raw odometry: node 5 at x = 5, node 0 at x = 0.
    cand = _candidate(s, [5.0, 0.0, 0.0], [0.0, 0.0, 0.0])
    for k in range(6):
        _push(s, k, [float(k), 0.0, 0.0], cand=cand if k == 5 else None)
    assert s._pg_dirty and len(s._pending_loop_edges) == 1
    assert len(s.pg_edges) == 6           # 5 sequential + 1 loop
    # The throttle blocked the solve; join() must flush it.
    s.join()
    assert not s._pg_dirty
    assert s._pending_loop_edges == []    # accepted => made permanent
    assert len(s.loops) == 1 and len(s.pg_edges) == 6
    # Solved estimates stay close to the (consistent) odometry.
    assert np.linalg.norm(s.pg_t[5] - (-np.asarray([5, 0, 0]))) < 0.2
    assert np.abs(_scales(s) - 1.0).max() < 0.05


def test_rejected_solve_rolls_back_all_pending_edges(slam):
    s = slam
    s.loop_params.min_event_gap_kf = 100
    s.loop_params.max_correction_m = 0.05
    s._last_event_node = 0
    # Two aliased candidates: each claims the current node sits at node 0
    # while odometry places it metres away.
    alias = _candidate(s, [0.0, 0.0, 0.0], [0.0, 0.0, 0.0], inliers=90)
    for k in range(6):
        _push(s, k, [float(k), 0.0, 0.0], cand=alias if k in (4, 5) else None)
    assert len(s._pending_loop_edges) == 2
    assert len(s.pg_edges) == 5 + 2
    s.join()   # flush -> the solve moves nodes beyond the ceiling -> reject
    assert s._pending_loop_edges == [] and s._pending_loops == []
    assert len(s.pg_edges) == 5           # both loop edges dropped
    assert s.loops == []
    assert s._last_event_node < 0         # throttle clock rewound
    # Odometry estimates survive untouched.
    for k in range(6):
        assert np.allclose(s.pg_t[k], -np.asarray([k, 0, 0]), atol=1e-5)
    assert np.all(_scales(s) == 1.0)


def test_hook_failure_appends_placeholder_node(slam):
    s = slam
    real_impl = s._hook_task_impl

    def boom(*a, **k):
        raise RuntimeError("synthetic device error")

    s._hook_task_impl = boom
    R = np.eye(3, dtype=np.float32)
    t = np.zeros(3, np.float32)
    s._next_node = 1
    s._hook_task(0, (None,) * 4, _Host(R, t), 0, 100, -(10**9))
    assert len(s.hook_errors) == 1
    assert len(s.pg_raw_R) == len(s.pg_R) == len(s.pg_frame) == 1
    assert list(_scales(s)) == [1.0]      # a mono placeholder has s = 1
    # Node ids stay dense: the next (healthy) hook keys off node 1.
    s._hook_task_impl = real_impl
    _push(s, 1, [1.0, 0.0, 0.0])
    assert len(s.pg_raw_R) == len(_scales(s)) == 2
    assert len(s.pg_edges) == 1           # sequential edge 0 -> 1


def test_rejected_midtrajectory_alias_despite_calm_newest_node(slam):
    """A diverged solve whose damage concentrates mid-trajectory is
    rejected even when the newest node barely moves: a long out-and-back
    line whose endpoints coincide, with an aliased edge binding the
    midpoint (the far end of the line) to node 0, while a consistent edge
    pins the newest node."""
    s = slam
    s.loop_params.min_event_gap_kf = 100
    s.loop_params.max_correction_m = 0.5
    s._last_event_node = 0
    n = 13          # out to x=6 at node 6, back to x=0 at node 12
    centers = [min(k, (n - 1) - k) * 1.0 for k in range(n)]
    # The alias claims node 6 (at x=6) sits at node 0 (x=0); the
    # consistent edge closes the real loop (node 12 at x=0 == node 0).
    alias = _candidate(s, [0.0, 0.0, 0.0], [0.0, 0.0, 0.0], inliers=90)
    for k in range(n):
        cand = alias if k in (6, n - 1) else None
        _push(s, k, [centers[k], 0.0, 0.0], cand=cand)
    assert len(s._pending_loop_edges) == 2
    edges = list(s.pg_edges)
    R_init = [r.copy() for r in s.pg_R]
    t_init = [t.copy() for t in s.pg_t]
    s.join()
    # The scenario discriminates: the solve of the rejected graph moves the
    # newest node less than the ceiling while a mid-trajectory node blows
    # past it.
    if isinstance(s, MonoSLAM):
        out, _ = pgs.solve_padded([1.0] * n, R_init, t_init, edges, pgs.PGParams(iters=25),
                                  device="cpu")
        s_sol = out.s[:n].numpy()
    else:
        out, _ = pose_graph.solve_padded(R_init, t_init, edges, pose_graph.PGParams(iters=25),
                                         device="cpu")
        s_sol = np.ones(n)
    c_init = -np.einsum("nji,nj->ni", np.stack(R_init), np.stack(t_init))
    c_sol = -np.einsum("nji,nj->ni", out.R[:n].numpy(), out.t[:n].numpy()) / s_sol[:, None]
    jumps = np.linalg.norm(c_sol - c_init, axis=-1)
    assert jumps[-1] <= s.loop_params.max_correction_m, jumps
    assert jumps.max() > s.loop_params.max_correction_m, jumps
    assert s._pending_loop_edges == [] and s.loops == []
    assert len(s.pg_edges) == n - 1       # both loop edges dropped
    for k in range(n):
        assert np.allclose(s.pg_t[k], -np.asarray([centers[k], 0, 0]), atol=1e-5)


def test_mono_sim3_rejects_absurd_scale_edge():
    """A scale-carrying loop edge claiming a 50x relative scale: the
    solve-health scale gate rejects it and rolls it back."""
    s = MonoSLAM(_tiny_cfg(), LoopParams(capacity=16, num_features=8, guard=0), device="cpu")
    s.loop_db.add = lambda *a, **k: None
    try:
        s.loop_params.min_event_gap_kf = 100
        s._last_event_node = 0
        cand = LoopCandidate(db_index=0, matches=50, inliers=90,
                             R_rel=np.eye(3, dtype=np.float32),
                             t_rel=np.asarray([-5.0, 0.0, 0.0], np.float32), s_rel=50.0)
        for k in range(6):
            _push(s, k, [float(k), 0.0, 0.0], cand=cand if k == 5 else None)
        assert len(s._pending_loop_edges) == 1
        s.join()
        assert s._pending_loop_edges == []
        assert len(s.pg_edges) == 5       # loop edge rolled back
        assert s.loops == []
        assert all(abs(sc - 1.0) < 1e-3 for sc in s.pg_s)
    finally:
        s.close()


def test_mono_edges_and_loop_records_carry_scale():
    """Mono graph bookkeeping: odometry edges are scale-blind 6-tuples
    (i, j, 1.0, R, t, w), a loop edge carries the candidate's s_rel, and
    the loop record its s_rel too; a node's estimate composes the raw
    forward increment onto the previous solved similarity (scale rides
    along)."""
    s = MonoSLAM(_tiny_cfg(), LoopParams(capacity=16, num_features=8, guard=0), device="cpu")
    s.loop_db.add = lambda *a, **k: None
    try:
        s.loop_params.min_event_gap_kf = 100
        s._last_event_node = 0
        for k in range(3):
            _push(s, k, [float(k), 0.0, 0.0])
        s.pg_s[2] = 2.0                    # as if a solve had rescaled node 2
        s.pg_t[2] = 2.0 * s.pg_t[2]
        cand = _candidate(s, [3.0, 0.0, 0.0], [0.0, 0.0, 0.0], s_rel=0.8)
        _push(s, 3, [3.0, 0.0, 0.0], cand=cand)
        assert [e[2] for e in s.pg_edges] == [1.0, 1.0, 1.0, 0.8]
        assert all(len(e) == 6 for e in s.pg_edges)
        assert s.loops == [{"from": 3, "to": 0, "frame": 9, "inliers": 60, "s_rel": 0.8}]
        # (1, I, t_fwd) o (2, I, t_2): s = 2, t = t_2 + t_fwd = -4 - 1.
        assert s.pg_s[3] == 2.0
        np.testing.assert_allclose(s.pg_t[3], [-5.0, 0.0, 0.0], atol=1e-6)
        # Metric outputs divide by the node scale.
        _, t_graph, frames = s.graph_trajectory()
        np.testing.assert_allclose(t_graph[2:], [[-2.0, 0.0, 0.0], [-2.5, 0.0, 0.0]], atol=1e-6)
        assert frames == [0, 3, 6, 9]
    finally:
        s.close()


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("kind", ["stereo", "mono"])
def test_non_finite_solve(kind, package, monkeypatch):
    """A pose-graph solve that returns NaN poses, flushed by join(). The
    mono gate rejects it (a non-finite camera-centre jump counts as
    infinite) and rolls the pending loop edge back. The stereo gate
    compares the NaN jump and angle with its ceilings, which is false, and
    keeps the solve: the JAX package's stereo gate does so
    (`viso_tpu/slam/full.py:423-427`) and the port keeps that fault.
    Pinned on both packages: a fix belongs to both."""
    mono = kind == "mono"
    if package == "jax":
        from viso_tpu.slam import full as j_full
        from viso_tpu.slam import loop_closure as j_lc
        from viso_tpu.slam import mono_full as j_mono
        from viso_tpu.slam.engine import VOConfig as JVOConfig

        cfg = JVOConfig(**{f: getattr(_tiny_cfg(), f) for f in (
            "height", "width", "max_keyframes", "max_landmarks", "num_features",
            "pyramid_levels", "track_landmarks")})
        s = (j_mono.MonoSLAM if mono else j_full.StereoSLAM)(
            cfg, j_lc.LoopParams(capacity=16, num_features=8, guard=0))
        solver, Candidate, array = ((j_mono.pgs if mono else j_full.pose_graph),
                                    j_lc.LoopCandidate, np.full)

        def push(node_id, center, cand):
            s.loop_db.detect_fused = s.loop_db.detect_fused_sim3 = lambda *a, **k: cand
            s._next_node = node_id + 1
            s._hook_task_impl(node_id, None, None, None, None, np.eye(3, dtype=np.float32),
                              -np.asarray(center, np.float32), node_id * 3, 100, -(10**9))
    else:
        s = (MonoSLAM if mono else StereoSLAM)(
            _tiny_cfg(), LoopParams(capacity=16, num_features=8, guard=0), device="cpu")
        solver, Candidate = (pgs if mono else pose_graph), LoopCandidate

        def array(shape, v):
            return torch.full(shape, v)

        def push(node_id, center, cand):
            _push(s, node_id, center, cand=cand)
    s.loop_db.add = lambda *a, **k: None

    def nan_solve(*a, **k):
        n = 16
        out = SimpleNamespace(s=array((n,), 1.0), R=array((n, 3, 3), np.nan),
                              t=array((n, 3), np.nan))
        return out, {"initial_cost": 0.0, "final_cost": 0.0}

    monkeypatch.setattr(solver, "solve_padded", nan_solve)
    try:
        s.loop_params.min_event_gap_kf = 100
        s._last_event_node = 0
        t_rel = np.asarray([5.0, 0.0, 0.0] if mono else [-5.0, 0.0, 0.0], np.float32)
        cand = Candidate(db_index=0, matches=50, inliers=60, R_rel=np.eye(3, dtype=np.float32),
                         t_rel=t_rel, s_rel=1.0)
        for k in range(6):
            push(k, [float(k), 0.0, 0.0], cand if k == 5 else None)
        assert len(s._pending_loop_edges) == 1
        s.join()
        assert s._pending_loop_edges == []
        if mono:
            assert s.loops == [] and len(s.pg_edges) == 5
            assert np.isfinite(np.stack(s.pg_t)).all()
        else:
            assert len(s.loops) == 1 and len(s.pg_edges) == 6
            assert np.isnan(np.stack(s.pg_t)).all()
    finally:
        s.close()
