"""The check's control on the card: the plain reference computed with
TF32 matrix products (the nearest precision below the float32 the
configurations state) in the engine's place must fail the check, while
the engine passes it. At a size a test run holds (`small`); the
benchmark's own runs never run it, and `python -m vobench.control` reads
it at each cell's own size."""

import pytest

from vobench import check, run
from vobench.tests import small


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [101, 202, 303])
def test_tf32_control_fails_the_check(card, seed):
    res = run.run_cell(small.stereo_cell(), seed, 4.0, False, device=str(card), control=True)
    limits = res["check"]
    assert res["correct"] is True
    control_ok, _ = check.verdict(res["control"], {k: v["limit"] for k, v in limits.items()})
    assert not control_ok, res["control"]
