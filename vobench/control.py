"""The readings that the check's limits are set from, on the card.

    python3 -m vobench.control --workload <cell> --seeds 1 2 3 [--seconds 4]

For each seed, one run of the cell as `vobench.run` makes it (its window
`--seconds` long), in this one process, on a corridor of its own: the
traffic's textures drawn from the seed, so that the readings cover as
many image sequences as seeds (a benchmark run drives the traffic's one
corridor). Each run gives the engine's gaps to the plain reference (the
lower readings) and the control's, the reference computed
with TF32 matrix products in place of the engine, the nearest precision
below the float32 the configuration states (the upper readings), and
the control held to the configuration's limits (`check.verdict`), whose
`control_correct` must read false. One JSON line a seed, then the largest
lower and the smallest upper reading of each number. Not run by the
benchmark's own runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from vobench import check, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    args = p.parse_args(argv)
    run.setup_environment()
    cell = run.cell_of(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 3
    lower, upper = {}, {}
    for seed in args.seeds:
        own = dataclasses.replace(cell, traffic=dict(cell.traffic, texture_seed=seed))
        res = run.run_cell(own, seed, args.seconds, False, control=True)
        got = {k: res["check"][k]["value"] for k in check.NUMBERS}
        ctl = res["control"]
        control_ok, _ = check.verdict(ctl, cell.config["check"]["limits"])
        for k in check.NUMBERS:
            lower[k] = max(lower.get(k, 0.0), got[k])
            upper[k] = min(upper.get(k, float("inf")), ctl[k])
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "control_correct": bool(control_ok), "attempted": res["attempted"],
                          "engine": got, "control": ctl,
                          "fps": res["metrics"].get("fps", {}).get("value")}), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, "lower": lower,
                      "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
