"""The long monocular SLAM run (chip_smoke phase 15(c)) through the JAX
package's MonoSLAM and the port's, on the CPU: the reference's own
figures for the run past the loop database's capacity and the Sim(3)
pose graph's PCG threshold.

    JAX_PLATFORMS=cpu python tests/mono_long_parity.py --package jax
    JAX_PLATFORMS=cpu python tests/mono_long_parity.py --package port

The frames are phase 9's: the left images of the 500-frame loop orbit at
184x616 (`viso_tpu_torch/tools/mono_cell.py --slam`, `bench.py:452-534`),
cycled `--cycles` times (6: 3,000 frames; the orbit's frame 499 has frame
0's pose, so a cycle goes on where the last ended), with the cell's
configuration uncut (`mono_cell.slam_config(seed)`, `LoopParams(
min_inliers=40, max_correction_m=4.0)`: capacity 256, retain_recent 64).
Each run goes through `tests/mono_slam_cell_parity.run`: the port replays
the JAX package's draws of the seed. Prints nodes, loops (and those after
the wrap: from node `capacity` on), re-inits, the pose-graph solves the
health gate accepted and rejected, the node scales' range, the
scale-aligned keyframe ATE corrected and raw, the loop funnel
(`diag_loops.Funnel`, as chip_smoke phase 15(c) prints it), then one
JSON line. About
20-40 min a package on 8 cores; the JAX package's result moves with XLA's
CPU threading, so give the core count beside a reading.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CYCLES = 6
CAPACITY = 256


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cycles", type=int, default=CYCLES)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from mono_slam_cell_parity import run

    from viso_tpu_torch.tools import mono_cell

    torch.set_num_threads(2)
    imgs, Rs, ts = mono_cell.render_orbit()
    imgs = imgs * args.cycles
    Rs, ts = (np.concatenate([x] * args.cycles) for x in (Rs, ts))
    r = run(args.package, args.seed, imgs, Rs, ts, funnel=True)
    after = [lo for lo in r["loops"] if lo[0] >= CAPACITY]
    r.update(frames=len(imgs), cycles=args.cycles,
             loops_after_wrap=len(after),
             loops_after_wrap_to_new_node=sum(lo[1] >= CAPACITY for lo in after))
    print(f"{r['package']} seed {args.seed}, {len(imgs)} frames ({args.cycles} cycles): "
          f"{r['nodes']} nodes, {len(r['loops'])} loops ({len(after)} after the wrap, "
          f"{r['loops_after_wrap_to_new_node']} of them to a node stored after it), "
          f"{r['reinits']} re-inits, solves accepted {r['solves_accepted']}, rejected "
          f"{r['solves_rejected']}; node scales {r['s_min']:.4f}-{r['s_max']:.4f}; "
          f"scale-aligned keyframe ATE {r['ate_m']:.6f} m corrected, {r['ate_raw_m']:.6f} m "
          f"raw; {r['hook_errors']} hook errors, {r['seconds']:.1f} s [cpu]", flush=True)
    print("loop funnel: " + ", ".join(f"{k} {v}" for k, v in r["funnel"].items()), flush=True)
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
