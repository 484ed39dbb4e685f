"""The check against runs whose timed path is broken underneath: each
fault a visual odometry cell can have must make `correct` false. The
harness's look for a chip is skipped (the CPU); the rest of a run is
driven as the benchmark drives it."""

import pytest
import torch

from viso_tpu_torch.slam import engine as eng
from vobench import run
from vobench.tests import small


def unchanged(out, R, t, vel):
    """The track step returns the state it was given."""
    out[0], out[1], out[6] = R.clone(), t.clone(), vel.clone()


def altered(out, R, t, vel):
    """The pose is altered where it is produced (1 mm along x)."""
    out[1] = out[1] + torch.tensor([1e-3, 0.0, 0.0], device=out[1].device)


def half_the_landmarks(m, templates, active):
    """Half of the batch left out: the second half of the active
    landmarks count as invalid in the map and in every level's template,
    so the pose is estimated on the rest."""
    A = active.shape[0]
    m = m._replace(point_mask=m.point_mask.clone().index_fill_(0, active[A // 2:], False))
    templates = tuple(lvl._replace(ok=torch.cat([lvl.ok[: lvl.ok.shape[0] // 2],
                                                 torch.zeros_like(lvl.ok[lvl.ok.shape[0] // 2:])]))
                      for lvl in templates)
    return m, templates


@pytest.mark.parametrize("fault", [unchanged, altered, half_the_landmarks])
def test_fault_makes_correct_false(monkeypatch, fault):
    real = eng.BaseVO._track

    def broken(self, m, templates, active, img, R, t, vel_xi):
        if fault is half_the_landmarks:
            m, templates = fault(m, templates, active)
            return real(self, m, templates, active, img, R, t, vel_xi)
        out = list(real(self, m, templates, active, img, R, t, vel_xi))
        fault(out, R, t, vel_xi)
        return tuple(out)

    monkeypatch.setattr(eng.BaseVO, "_track", broken)
    res = run.run_cell(small.stereo_cell(), 7, small.SECONDS, False, device="cpu")
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["check"].values())
