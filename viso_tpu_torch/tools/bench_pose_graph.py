"""The pose-graph solve on the card, as the loop layer runs it: per graph,
`--reps` eager solves and `--reps` replays of its captured program (a
`slam/programs.Cache`, the program's first call eager, its second
captured), each held against the first eager solve bit for bit (the
nodes, the final cost and the cost history); the capture's seconds on the
host clock; one replay's host enqueue ms, device ms and kernels
(`utils/profiling.profile_stage`); the bytes of the program's CUDA graph
pool and the device's peak allocation over the graph's runs.

    python -m viso_tpu_torch.tools.bench_pose_graph [--device cuda] [--reps 5]

The graphs are `data/synthetic.ring_graph` rings, SE(3) and Sim(3), at 50
nodes (node bucket 64: the dense route) and 300 (bucket 512: PCG), each
sequential edge doubled by a parallel one whose measurement is perturbed
(the padded edge buckets 128 and 1024). One JSON line per graph, then one
of them all with the card's name and power limit ("cpu" with `--device
cpu`, where the program runs eagerly and the device numbers are None).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from viso_tpu_torch.tools import target

NODES = (50, 300)


def graph(K, sim3, seed=0):
    """A `ring_graph` of K nodes with a perturbed parallel edge beside each
    sequential one (rotation and translation moved by 1e-3, log scale by
    1e-3, weight 0.5): the leading arguments of `solve_padded`."""
    from viso_tpu_torch.data.synthetic import ring_graph, so3_exp

    args, _ = ring_graph(K, sim3=sim3, seed=seed)
    rng = np.random.default_rng(seed + 1)
    edges = list(args[-1])
    for e in args[-1]:
        if e[1] != e[0] + 1:
            continue
        *head, R_ij, t_ij, _ = e
        R_ij = (so3_exp(rng.normal(0, 1e-3, 3)) @ R_ij).astype(np.float32)
        t_ij = (t_ij + rng.normal(0, 1e-3, 3)).astype(np.float32)
        if sim3:
            head[2] = float(head[2] * np.exp(rng.normal(0, 1e-3)))
        edges.append((*head, R_ij, t_ij, 0.5))
    return (*args[:-1], edges)


def pool_bytes(prog):
    """Bytes reserved by the CUDA graph pool of a captured program (None
    uncaptured: on the CPU)."""
    if prog.graph is None:
        return None
    pool = tuple(prog.graph.pool())
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", (0, 0))) == pool)


def run(args, sim3, device, reps, label):
    """`reps` eager solves and `reps` replays of one graph, as the
    module's docstring says (on the CPU the program runs eagerly through
    its static buffers, and the device numbers are None). Returns the
    record (a dict)."""
    from viso_tpu_torch.backend import pose_graph, pose_graph_sim3
    from viso_tpu_torch.slam import programs
    from viso_tpu_torch.utils import profiling

    mod = pose_graph_sim3 if sim3 else pose_graph
    params = mod.PGParams(iters=25)
    names = ("s", "R", "t") if sim3 else ("R", "t")
    card = device.type == "cuda"

    def solve(cache=None):
        out, info = mod.solve_padded(*args, params, device=device, programs=cache)
        return [x.detach().clone() for x in [getattr(out, k) for k in names]
                + [info["final_cost"], info["cost_history"]]]

    if card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    eager = [solve() for _ in range(reps)]
    cache = programs.Cache(device)
    first = solve(cache)
    ((key, prog),) = cache.programs.items()
    captured = prog.capture
    held = {}

    def timed():
        t0 = time.perf_counter()
        captured()
        torch.cuda.synchronize(device)
        held["capture_s"] = time.perf_counter() - t0

    prog.capture = timed
    replays = [solve(cache) for _ in range(reps)]
    ref = eager[0]
    results = eager[1:] + [first] + replays
    gaps = [max(float((a.double() - b.double()).abs().max()) for a, b in zip(r, ref))
            for r in results]
    equal = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                for r in results for a, b in zip(r, ref))
    replayed = prog.replays
    staged = programs.unflatten(prog.spec, prog.inputs)
    prof = profiling.profile_stage(label, lambda: prog(*staged), reps=1)
    return dict(
        graph=label, key=list(key[:3]), eager=reps, replays=replayed,
        bit_equal=equal, max_gap=max(gaps), capture_s=held.get("capture_s"),
        host_ms=prof["host_ms"], device_ms=prof["device_ms"], kernels=prof["kernels"],
        profiler_windows=prof["tries"], pool_bytes=pool_bytes(prog),
        max_memory_allocated=torch.cuda.max_memory_allocated(device) if card else None,
        final_cost=float(ref[-2]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--nodes", type=int, nargs="+", default=list(NODES))
    a = ap.parse_args(argv)
    device, where = target("bench_pose_graph", a.device)
    rows = []
    for K in a.nodes:
        for sim3 in (False, True):
            label = f"{'sim3' if sim3 else 'se3'} {K} nodes"
            rows.append(run(graph(K, sim3), sim3, device, a.reps, label))
            print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"device": where, "torch": torch.__version__, "graphs": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
