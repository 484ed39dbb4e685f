"""Micro-benchmark of window extraction on the card (port of
`tools/bench_extract.py`).

    python -m viso_tpu_torch.tools.bench_extract

On a 376x1240 float32 image, for N in {1024, 2048} feature centres and
square windows win in {16, 24}, it times with CUDA events:

  * the current path, `sampling.extract_windows` (kernel K1, exact
    win x win windows), and K1's plain PyTorch version;
  * kernel K2 (`geometry/extract_aligned.py`, row-aligned (win + 8, win)
    tiles) for each K in {64, 128, 256} that divides N, and K2's plain
    version;

and checks the tool's value oracle: `sample_patch_grid` with half-width
win // 4 over K2's tiles must agree with the same samples over K1's
windows to within 1e-3, and K2 must equal its plain version bit for bit.
One line per shape; the exit status is 1 if any shape fails a check. Needs
a CUDA device and raises without one.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from viso_tpu_torch.geometry import extract, extract_aligned, sampling

H, W = 376, 1240
NS = (1024, 2048)
WINS = (16, 24)
KS = (64, 128, 256)
ORACLE_TOL = 1e-3
REPS = 50          # timed calls per measurement


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
            for K in KS:
                if n % K:
                    continue
                tiles, base = extract_aligned.extract_windows_aligned(img, c, win, K)
                p_tiles, p_base = extract_aligned.extract_plain(img, c, win, K)
                equal = bool(torch.equal(tiles, p_tiles) and torch.equal(base, p_base))
                vals = sampling.sample_patch_grid(tiles, base, c, half)
                oracle = float(torch.max(torch.abs(vals - vals_ref)))
                ms = cuda_ms(lambda: extract_aligned.extract_windows_aligned(img, c, win, K))
                ms_plain = cuda_ms(lambda: extract_aligned.extract_plain(img, c, win, K))
                records.append(dict(
                    N=n, win=win, K=K, k2_ms=ms, k2_plain_ms=ms_plain,
                    k1_ms=ms_cur, k1_plain_ms=ms_cur_plain, equal=equal,
                    max_abs_err=float(torch.max(torch.abs(tiles - p_tiles))),
                    oracle_err=oracle, oracle_ok=oracle < ORACLE_TOL,
                ))
    return records


def report(records) -> int:
    """Print one line per record; 0 if every shape passes its checks."""
    name = torch.cuda.get_device_name(0)
    for r in records:
        print(f"N={r['N']} win={r['win']} K={r['K']}: K2 {r['k2_ms']:.6f} ms "
              f"(plain {r['k2_plain_ms']:.6f}), current K1 {r['k1_ms']:.6f} ms "
              f"(plain {r['k1_plain_ms']:.6f}), equal={r['equal']} "
              f"oracle {r['oracle_err']:.3g} (ok={r['oracle_ok']}) [{name}]")
    return 0 if all(r["equal"] and r["oracle_ok"] for r in records) else 1


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_extract needs a CUDA device")
    return report(run(torch.device("cuda", 0)))


if __name__ == "__main__":
    sys.exit(main())
