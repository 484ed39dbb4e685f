"""Micro-benchmark of window extraction on the card (port of
`tools/bench_extract.py`), and the timers the port's kernel records use.

    python -m viso_tpu_torch.tools.bench_extract

On a 376x1240 float32 image, for N in {1024, 2048} feature centres and
square windows win in {16, 24}, it times:

  * the current path, `sampling.extract_windows` (kernel K1, exact
    win x win windows), and K1's plain PyTorch version;
  * kernel K2 (`geometry/extract_aligned.py`, row-aligned (win + 8, win)
    tiles) for each K in {64, 128, 256} that divides N, and K2's plain
    version;

and checks the tool's value oracle: `sample_patch_grid` with half-width
win // 4 over K2's tiles must agree with the same samples over K1's
windows to within 1e-3, K2 must equal its plain version bit for bit (and
give the same tiles and origins at every K), and a replay of a captured
CUDA graph of K2 must equal the eager call.
One line per shape; the exit status is 1 if any shape fails a check. Needs
a CUDA device and raises without one.

The timers, per call of an entry point `fn`:

  * `cuda_ms`: CUDA events around REPS back-to-back eager calls. While the
    host enqueues slower than the card copies, this is the entry point's
    host cost (checks, allocation, the ctypes call) more than the copy;
  * `device_ms`: REPS calls captured in one CUDA graph, the graph replayed
    and its event time divided by the calls: the device's own time;
  * `host_ms`: the host clock around REPS eager calls with no sync inside:
    the enqueue cost a host-bound frame pays;
  * `floor_ms`: `device_ms` of the kernel library's empty kernel: the
    card's launch floor;
  * `bound_ms`: the least time for the bytes of the copy, each window
    read once and written once, at the H100's 3.35 TB/s;
  * `library_ms`: `device_ms` of one `torch.take` over the flattened
    source with the int64 flat index built beforehand: the copy alone,
    a yardstick the port never calls.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from viso_tpu_torch.geometry import extract, extract_aligned, sampling

H, W = 376, 1240
NS = (1024, 2048)
WINS = (16, 24)
KS = (64, 128, 256)
ORACLE_TOL = 1e-3
REPS = 50          # timed calls per measurement
REPLAYS = 5        # graph replays per device measurement
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA's data sheet


def cuda_ms(fn) -> float:
    """Mean ms per call over REPS back-to-back calls (CUDA events),
    after a warmup."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def capture(fn, calls: int = 1):
    """(graph, output of the last captured call): `calls` calls of `fn`
    captured in one CUDA graph, after the warmup on a side stream that
    capture requires."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            out = fn()
    return graph, out


def device_ms(fn) -> float:
    """Device ms per call: REPS calls in one CUDA graph, replayed REPLAYS
    times between two CUDA events (after one warm replay)."""
    graph, _ = capture(fn, REPS)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (REPLAYS * REPS)
    del graph
    return ms


def host_ms(fn) -> float:
    """Host ms per call: the host clock around REPS eager calls, no sync
    inside (after a warmup); the card drains afterwards."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / REPS


def floor_ms(lib) -> float:
    """`device_ms` of the library's empty kernel (`_cuda.launch_empty`)."""
    from viso_tpu_torch import _cuda

    return device_ms(lambda: _cuda.launch_empty(lib))


def bound_ms(n: int, h: int, w: int) -> float:
    """Least ms to copy n (h, w) float32 windows: each window read once and
    written once, 2 * n * h * w * 4 bytes over the H100's HBM rate."""
    return 2.0 * n * h * w * 4 / HBM_BYTES_PER_S * 1e3


def flat_index(shape, base, h: int, w: int, k=None):
    """int64 (N, h, w) flat index into a source of `shape` ((H, W) or
    (K, H, W)) for the windows at origins `base` (N, 2) (x0, y0) of
    image k[n], with the kernels' `dynamic_slice` clamping."""
    Hs, Ws = shape[-2], shape[-1]
    dev = base.device
    x0 = extract._slice_start(base[:, 0].long(), Ws, w)
    y0 = extract._slice_start(base[:, 1].long(), Hs, h)
    rows = y0[:, None] + torch.arange(h, device=dev)
    if k is not None:
        rows = rows + (extract._slice_start(k.long(), shape[0], 1) * Hs)[:, None]
    cols = x0[:, None] + torch.arange(w, device=dev)
    return rows[:, :, None] * Ws + cols[:, None, :]


def library_ms(src, idx) -> float:
    """`device_ms` of `torch.take(src.reshape(-1), idx)`: the copy alone."""
    flat = src.reshape(-1)
    return device_ms(lambda: torch.take(flat, idx))


def graph_matches_eager(fn) -> bool:
    """A replay of one captured call of `fn` gives what an eager call gives
    (`torch.equal` on every output tensor)."""
    eager = fn()
    graph, out = capture(fn, 1)
    graph.replay()
    torch.cuda.synchronize()
    eager = eager if isinstance(eager, tuple) else (eager,)
    out = out if isinstance(out, tuple) else (out,)
    return len(eager) == len(out) and all(torch.equal(a, b) for a, b in zip(eager, out))


def times(fn, lib, n: int, h: int, w: int, src, idx) -> dict:
    """The five numbers of one call: device_ms, host_ms, floor_ms,
    bound_ms, library_ms (ms)."""
    return dict(
        device_ms=device_ms(fn), host_ms=host_ms(fn), floor_ms=floor_ms(lib),
        bound_ms=bound_ms(n, h, w), library_ms=library_ms(src, idx),
    )


def times_line(t: dict) -> str:
    return " ".join(f"{k}={t[k]:.6f}" for k in
                    ("device_ms", "host_ms", "floor_ms", "bound_ms", "library_ms"))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def inputs(device):
    """The tool's image and, per N, its centres (20 px from the borders),
    drawn from one numpy generator as `tools/bench_extract.py` draws them."""
    rng = np.random.default_rng(0)
    img = torch.tensor(rng.uniform(0, 255, (H, W)), dtype=torch.float32, device=device)
    centers = {}
    for n in NS:
        c = np.stack([rng.uniform(20, W - 20, n), rng.uniform(20, H - 20, n)], -1)
        centers[n] = torch.tensor(c, dtype=torch.float32, device=device)
    return img, centers


def run(device):
    """Time and check every shape; returns one record per (N, win, K)."""
    img, centers = inputs(device)
    lib = extract_aligned.load_library()
    records = []
    for n in NS:
        c = centers[n]
        for win in WINS:
            half = win // 4
            ms_cur = cuda_ms(lambda: sampling.extract_windows(img, c, win))
            ms_cur_plain = cuda_ms(
                lambda: extract.extract_plain(img, extract.centered_base(img.shape, c, win),
                                              win, win))
            got_ref, base_ref = sampling.extract_windows(img, c, win)
            vals_ref = sampling.sample_patch_grid(got_ref, base_ref, c, half)
            first = None
            for K in KS:
                if n % K:
                    continue
                fn = lambda: extract_aligned.extract_windows_aligned(img, c, win, K)  # noqa: E731
                tiles, base = fn()
                first = (tiles, base) if first is None else first
                p_tiles, p_base = extract_aligned.extract_plain(img, c, win, K)
                equal = bool(torch.equal(tiles, p_tiles) and torch.equal(base, p_base)
                             and torch.equal(tiles, first[0]) and torch.equal(base, first[1]))
                vals = sampling.sample_patch_grid(tiles, base, c, half)
                oracle = float(torch.max(torch.abs(vals - vals_ref)))
                rows = win + extract_aligned.ROW_PAD
                t = times(fn, lib, n, rows, win, img, flat_index(img.shape, base, rows, win))
                records.append(dict(
                    N=n, win=win, K=K, k2_ms=cuda_ms(fn),
                    k2_plain_ms=device_ms(lambda: extract_aligned.extract_plain(img, c, win, K)),
                    k1_ms=ms_cur, k1_plain_ms=ms_cur_plain, equal=equal,
                    graph_ok=graph_matches_eager(fn),
                    max_abs_err=float(torch.max(torch.abs(tiles - p_tiles))),
                    oracle_err=oracle, oracle_ok=oracle < ORACLE_TOL, **t,
                ))
    return records


def report(records, card: str) -> int:
    """Print one line per record, tagged with `card`; 0 if every shape
    passes its checks."""
    for r in records:
        print(f"N={r['N']} win={r['win']} K={r['K']}: K2 {times_line(r)} "
              f"entry_ms={r['k2_ms']:.6f} plain_device_ms={r['k2_plain_ms']:.6f}, "
              f"current K1 entry_ms={r['k1_ms']:.6f} (plain {r['k1_plain_ms']:.6f}), "
              f"equal={r['equal']} graph_ok={r['graph_ok']} "
              f"oracle {r['oracle_err']:.3g} (ok={r['oracle_ok']}) [{card}]")
    return 0 if all(r["equal"] and r["oracle_ok"] and r["graph_ok"] for r in records) else 1


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_extract needs a CUDA device")
    return report(run(torch.device("cuda", 0)), card_line())


if __name__ == "__main__":
    sys.exit(main())
