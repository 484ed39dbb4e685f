"""`viso_tpu_torch.tools.diag_loops.LoopRecorder` (chip_smoke phases 9 and
15(c)) on a short MonoSLAM run on the CPU: tests/test_torch_mono_slam.py's
run (the 120-frame 2.4-turn orbit at 160x224 with the dropout that forces
a re-init, the JAX package's draws replayed in the port) with a database
that wraps (tests/test_torch_long_mono_slam.py's capacity 12, 4
protected), so that the recorder rebuilds databases past an eviction.

Each recorded detection, run again from the recorder's copy of its
inputs (the database rebuilt from the insert log), equals the run's own
bit for bit, and its hold on the CPU agrees within phase 9's bounds.
"""

import numpy as np
import pytest
import torch
from test_torch_mono import ReplayJaxDraws
from test_torch_mono_slam import CFG, LOOP, ReplayLoopDraws, _seam, orbit_frames

from viso_tpu_torch.ops import ransac as t_ransac
from viso_tpu_torch.slam import loop_closure as t_lc
from viso_tpu_torch.slam.engine import VOConfig
from viso_tpu_torch.slam.mono_full import MonoSLAM
from viso_tpu_torch.tools import diag_loops

torch.set_num_threads(2)

RING = dict(LOOP, capacity=12, retain_recent=4)


@pytest.fixture(scope="module")
def recorded():
    frames, _, _ = orbit_frames()
    mp = pytest.MonkeyPatch()
    mp.setattr(t_ransac, "draw_indices", ReplayJaxDraws(0))
    mp.setattr(t_lc.pnp, "draw_hypotheses", ReplayLoopDraws(1))
    slam = _seam(MonoSLAM)(VOConfig(**CFG), t_lc.LoopParams(**RING), device="cpu")
    db_rows = []
    real_detect = slam.loop_db.detect_fused_sim3

    def detect(*a, **kw):
        # The database as the detection reads it, to hold the rebuilt one.
        db = slam.loop_db
        rows = [x.clone() for x in (db.desc, db.desc_mask, db.points_w_dev, db.points_ok_dev)]
        cand = real_detect(*a, **kw)
        if cand is not None:
            db_rows.append(rows)
        return cand

    slam.loop_db.detect_fused_sim3 = detect
    recorder = diag_loops.LoopRecorder(slam)
    funnel = diag_loops.Funnel(slam)
    try:
        for img in frames:
            slam.process(img)
        slam.join()
        yield slam, recorder, funnel.counts(), db_rows
    finally:
        recorder.close()
        slam.close()
        mp.undo()


def test_recorder_records_every_candidate_past_the_wrap(recorded):
    slam, recorder, counts, db_rows = recorded
    cap = RING["capacity"]
    assert slam.hook_errors == [] and slam.loop_db.total > cap
    assert len(recorder.calls) == counts["scale_gate"] == len(db_rows) >= 1
    assert counts["loops"] == len(slam.loops)
    assert len(recorder.inserts) == slam.loop_db.total
    # The databases rebuilt from the insert log equal the live ones.
    for (rec, db), rows in zip(recorder.databases("cpu"), db_rows):
        for rebuilt, live in zip(db[:4], rows):
            assert torch.equal(rebuilt, live)
        assert rec["eligible"].dtype == torch.bool and int(rec["eligible"].sum()) > 0


def test_recorded_detections_replay_and_hold(recorded):
    """Every recorded detection replayed on the CPU equals the run's own,
    inliers and s_rel bit for bit; its hold within 1 inlier and
    diag_loops.HOLD_LOG_TOL, the CPU's own PnP on the same inputs equal."""
    _, recorder, _, _ = recorded
    holds = recorder.holds("cpu", diag_loops.HOLD_LOG_TOL, cpu_pnp=True)
    assert len(holds) == len(recorder.calls)
    for g, rec in zip(holds, recorder.calls):
        assert g["same_as_run"] and g["held"], g
        assert g["inliers"][0] == rec["inliers"] and g["s"][0] == rec["s_rel"]
        assert g["cpu_pnp"][0] == rec["inliers"]
        assert abs(g["inliers"][0] - g["inliers"][1]) <= 1
        assert g["log_gap"] <= diag_loops.HOLD_LOG_TOL
    # A selection holds only what it picks, in call order.
    some = recorder.holds("cpu", diag_loops.HOLD_LOG_TOL, select=lambda i, r: i % 2 == 1)
    assert [g["node"] for g in some] == [r["node"] for r in recorder.calls[1::2]]


def test_mono_cell_hold_entry(capsys):
    """`mono_cell --slam --cycles N --hold` (the entry that holds every loop
    of chip_smoke phase 15(c)'s run): the frames cycled, the funnel and the
    holds in its JSON line; both flags refused without --slam."""
    import json

    from viso_tpu_torch.tools import mono_cell

    assert mono_cell.main(["--slam", "--frames", "6", "--cycles", "2", "--hold", "--seeds",
                           "1", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    run = out["runs"][0]
    assert out["frames"] == 12 and out["cycles"] == 2
    assert run["funnel"]["keyframes"] == run["nodes"] and run["funnel"]["loops"] == 0
    assert run["holds"] == run["held"] == 0 and run["not_held"] == []
    for argv in (["--cycles", "2"], ["--hold"]):
        with pytest.raises(SystemExit):
            mono_cell.main(argv + ["--frames", "2", "--device", "cpu"])


def test_multiprocess_cell_arguments():
    """`multiprocess_ba --slam --cell FRAMES` runs chip_smoke phase 10(e)'s
    cell: the orbit's first frames as uint8 pairs, the loop cell's
    configuration with distribute_ba and stats_deterministic, bench.py's
    loop parameters; --cell without --slam is refused."""
    from viso_tpu_torch.tools import diag_loops, multiprocess_ba

    frames, cfg, lp = multiprocess_ba.loop_cell(diag_loops.render_stereo(2)[0])
    assert frames.shape == (2, 2, 184, 616) and frames.dtype == np.uint8
    assert cfg.distribute_ba and cfg.stats_deterministic
    assert cfg.num_features == diag_loops.stereo_config().num_features
    assert (lp.min_inliers, lp.max_correction_m) == (40, 4.0)
    with pytest.raises(SystemExit):
        multiprocess_ba.main(["--cell", "4", "--device", "cpu"])
