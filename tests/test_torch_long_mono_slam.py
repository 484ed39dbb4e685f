"""The long monocular SLAM path on both packages, on the CPU: MonoSLAM past
the loop database's capacity with the Sim(3) pose graph on its PCG route
(chip_smoke phase 15(c) at a size the CPU runs in a minute).

The run is tests/test_torch_mono_slam.py's (the 120-frame 2.4-turn orbit
at 160x224 with the sensor dropout that forces a re-init, the JAX
package's draws replayed in the port), with two changes: a database that
wraps (capacity 12, `retain_recent` 4, against ~39 keyframes), and the
Sim(3) graph's `pcg_threshold` lowered to PCG_THRESHOLD in both packages
(`PGParams` patched where each MonoSLAM makes it), so that every solve
past 16 nodes takes the PCG route, as the loop layer's solves past 256
nodes do at full size (tests/test_torch_pose_graph_sim3.py patches it
the same way for one solve). The route is recorded where each package
picks it: the port's LM calls `pose_graph.pcg_delta` or `dense_delta` at
every iteration; the JAX package's `solve` traces `_gn_step_pcg` or
`_gn_step` once per bucket.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mono import ReplayJaxDraws
from test_torch_mono_slam import CFG, LOOP, ReplayLoopDraws, _ates, _seam, orbit_frames

from viso_tpu.backend import pose_graph_sim3 as j_pgs
from viso_tpu.slam import loop_closure as j_lc
from viso_tpu.slam.engine import VOConfig as JVOConfig
from viso_tpu.slam.mono_full import MonoSLAM as JMonoSLAM
from viso_tpu_torch.backend import pose_graph as t_pg
from viso_tpu_torch.backend import pose_graph_sim3 as t_pgs
from viso_tpu_torch.ops import ransac as t_ransac
from viso_tpu_torch.slam import loop_closure as t_lc
from viso_tpu_torch.slam.engine import VOConfig
from viso_tpu_torch.slam.mono_full import MonoSLAM

torch.set_num_threads(2)

# tests/test_slam.py::test_slam_loop_beyond_ring_horizon's database size
# (12 entries, 4 protected) with test_torch_mono_slam.py's loop gates.
RING = dict(LOOP, capacity=12, retain_recent=4)
PCG_THRESHOLD = 16
# The corrected keyframe trajectories of the two packages, scale-aligned
# keyframe ATE against ground truth: test_torch_mono_slam.py's bands on the
# same run (its readings: the graph ATE gap 0.029-0.205 m over VOConfig
# seeds 0-3 with the 64-entry database), and the raw odometry's. Measured
# here on the CPU: 39 nodes, 1 re-init, one loop (38 -> 9) and one solve
# in both packages; corrected 0.521500 m (JAX) and 0.529595 m (port), raw
# 1.514425 and 1.521446 m; node scales 1.0-1.4325 and 1.0-1.4519.
GRAPH_ATE_BAND_M = 0.3
RAW_ATE_BAND_M = 0.02


def _recorded(slam):
    """Every `loop_db.add` of the engine: (node id, raw pose, slot written)."""
    inserts, real = [], slam.loop_db.add

    def add(*a, **kw):
        slot = real(*a, **kw)
        inserts.append((kw["node_id"], np.array(a[5]), np.array(a[6]), slot))
        return slot

    slam.loop_db.add = add
    return inserts


def _noting(routes, name, fn):
    def call(*a, **kw):
        routes.append(name)
        return fn(*a, **kw)
    return call


@pytest.fixture(scope="module")
def runs():
    frames, Rs, ts = orbit_frames()
    mp = pytest.MonkeyPatch()
    routes = {"jax": [], "port": []}
    replay = ReplayLoopDraws(1)
    mp.setattr(t_ransac, "draw_indices", ReplayJaxDraws(0))
    mp.setattr(t_lc.pnp, "draw_hypotheses", replay)
    for mod in (j_pgs, t_pgs):
        real = mod.PGParams
        mp.setattr(mod, "PGParams",
                   lambda _real=real, **kw: _real(**dict(kw, pcg_threshold=PCG_THRESHOLD)))
    mp.setattr(t_pg, "pcg_delta", _noting(routes["port"], "pcg", t_pg.pcg_delta))
    mp.setattr(t_pg, "dense_delta", _noting(routes["port"], "dense", t_pg.dense_delta))
    mp.setattr(j_pgs, "_gn_step_pcg", _noting(routes["jax"], "pcg", j_pgs._gn_step_pcg))
    mp.setattr(j_pgs, "_gn_step", _noting(routes["jax"], "dense", j_pgs._gn_step))
    engines = {"jax": _seam(JMonoSLAM)(JVOConfig(**CFG), j_lc.LoopParams(**RING)),
               "port": _seam(MonoSLAM)(VOConfig(**CFG), t_lc.LoopParams(**RING), device="cpu")}
    out = {}
    try:
        for name, slam in engines.items():
            inserts = _recorded(slam)
            for img in frames:
                slam.process(img)
            slam.join()
            out[name] = (slam, inserts)
    finally:
        mp.undo()
        for slam in engines.values():
            slam.close()
    return out, routes, Rs, ts


def test_reference_ring_assertions_hold_in_both_packages(runs):
    """tests/test_slam.py::test_slam_loop_after_db_wrap's assertions on
    each package's MonoSLAM: the database past its capacity, a loop closed
    after the wrap, every loop edge pointing back; and no hook error."""
    out, _, _, _ = runs
    cap = RING["capacity"]
    for pkg, (slam, _) in out.items():
        assert slam.hook_errors == [], (pkg, slam.hook_errors)
        assert slam.loop_db.total > cap, (pkg, slam.loop_db.total)
        assert [lp for lp in slam.loops if lp["from"] >= cap], (pkg, slam.loops)
        assert all(0 <= lp["to"] < lp["from"] for lp in slam.loops), (pkg, slam.loops)


def test_insert_slots_across_packages(runs):
    """Eviction is the same function of its inputs in both packages: each
    engine's insert sequence (node ids and raw poses) fed to a new database
    of either package (the engines' seed) gives the slot the engine wrote
    at every insert. The two engines write the same slots through insert
    30 of 39 (node 30, frame 95). There the two odometries, 6.6 mm apart at
    that node, put the two most redundant unprotected slots within the
    eviction's 1 % jitter of each other (removal harm, slots 3 and 4:
    0.24056 / 0.23983 in the JAX run, 0.24383 / 0.24942 in the port's), so
    the JAX engine recycles slot 4 and the port slot 3; the next insert
    recycles the other, and from there the two databases store the same
    nodes after every insert (slots 3 and 4 swapped)."""
    out, _, _, _ = runs
    (jslam, jins), (tslam, tins) = out["jax"], out["port"]
    lp = RING
    nf = lp["num_features"]
    kps, mask, pts = np.zeros((nf, 2), np.float32), np.ones(nf, bool), np.zeros((nf, 3), np.float32)
    stored = {}
    for pkg, inserts in (("jax", jins), ("port", tins)):
        dbs = {"jax": j_lc.LoopDatabase(j_lc.LoopParams(**lp), seed=1),
               "port": t_lc.LoopDatabase(t_lc.LoopParams(**lp), seed=1, device="cpu")}
        desc = {"jax": jnp.zeros((nf, 256), jnp.bfloat16),
                "port": torch.zeros((nf, 256), dtype=torch.bfloat16)}
        for db_pkg, db in dbs.items():
            slots, sets = [], []
            for node, R, t, _ in inserts:
                slots.append(db.add(None, kps, mask, pts, mask, R, t, 0, node_id=node,
                                    desc=desc[db_pkg]))
                sets.append(sorted(db.node_id.tolist()))
            assert slots == [s for *_, s in inserts], (pkg, db_pkg)
        stored[pkg] = sets
    assert len(tins) == len(jins) > 3 * lp["capacity"]
    first = next(k for k, (a, b) in enumerate(zip(jins, tins)) if a[-1] != b[-1])
    assert first == 30 and jslam.pg_frame[first] == 95, (first, [s for *_, s in jins],
                                                          [s for *_, s in tins])
    assert [k for k, (a, b) in enumerate(zip(stored["jax"], stored["port"])) if a != b] == [30]
    np.testing.assert_array_equal(np.sort(tslam.loop_db.node_id), np.sort(jslam.loop_db.node_id))


def test_keyframes_nodes_and_reinits_across_packages(runs):
    out, _, _, _ = runs
    (jslam, _), (tslam, _) = out["jax"], out["port"]
    assert [r.is_keyframe for r in tslam.results] == [r.is_keyframe for r in jslam.results]
    assert tslam.pg_frame == jslam.pg_frame and len(tslam.pg_s) == len(jslam.pg_s)
    assert tslam.num_reinits == jslam.num_reinits >= 1


def test_solves_take_the_pcg_route_in_both_packages(runs):
    """Past PCG_THRESHOLD nodes every solve's linear solver is PCG: the
    port's LM took only PCG steps (25 per solve), and the JAX package
    traced only its PCG step."""
    out, routes, _, _ = runs
    assert len(out["port"][0].pg_s) > 2 * PCG_THRESHOLD
    assert routes["port"] and set(routes["port"]) == {"pcg"}, routes["port"][:5]
    assert len(routes["port"]) % 25 == 0
    assert routes["jax"] and set(routes["jax"]) == {"pcg"}, routes["jax"]


def test_corrected_trajectories_agree(runs):
    """Scale-aligned keyframe ATE of each package's corrected graph and raw
    odometry nodes within the bands of test_torch_mono_slam.py, and the
    loops the same pairs."""
    out, _, Rs, ts = runs
    (jslam, _), (tslam, _) = out["jax"], out["port"]
    assert [(lp["from"], lp["to"]) for lp in tslam.loops] == \
        [(lp["from"], lp["to"]) for lp in jslam.loops]
    (pg_t, raw_t), (pg_j, raw_j) = _ates(tslam, Rs, ts), _ates(jslam, Rs, ts)
    assert abs(pg_t - pg_j) < GRAPH_ATE_BAND_M, (pg_t, pg_j)
    assert abs(raw_t - raw_j) < RAW_ATE_BAND_M, (raw_t, raw_j)
