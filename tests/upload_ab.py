"""The frame upload's two designs on the card, in the degraded 500-frame
loop cell (chip_smoke.py phase 16(b)), alternated in one process:

    python3 tests/upload_ab.py [--pairs 3]

"ring" is the engine's own `FrameStaging` (pinned buffers reused once the
event after their copy has completed); "caching" takes one pinned block a
frame from PyTorch's caching host allocator (`programs.host_tensors`) and
copies from it without waiting, the allocator holding the block until that
copy has completed. Prints each run's phase 16(b) lines (frames/s, the host
ms of the upload enqueue), then the upload alone, 200 calls on a 184x616
image behind a busy stream, for each design. Needs a CUDA card; pytest
does not collect it.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def caching_upload(self, a, device):
    """The alternative: one pinned block a frame from the caching host
    allocator."""
    from viso_tpu_torch.slam import programs

    return programs.host_tensors([np.ascontiguousarray(a)], device)[0].to(device,
                                                                        non_blocking=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs
    from viso_tpu_torch import _cuda
    from viso_tpu_torch.data import native, png_io, synthetic
    from viso_tpu_torch.geometry import extract
    from viso_tpu_torch.slam import engine
    from viso_tpu_torch.tools import bench_extract
    from viso_tpu_torch.utils import metrics

    if not torch.cuda.is_available():
        print("upload_ab: no CUDA device", file=sys.stderr)
        return 1
    card = bench_extract.card_line()
    print(card)
    _cuda.build_all()
    extract.load_library()
    dev = torch.device("cuda", 0)
    ring = engine.FrameStaging.upload
    designs = {"ring": ring, "caching": caching_upload}
    orbit, Rs, ts = cs.render_orbit(synthetic)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            paths, _ = cs.write_sequence(png_io, tmp, orbit)
            for i in range(2 * args.pairs):   # caching, ring, ring, caching, ...
                name = ("caching", "ring")[(i + i // 2) % 2]
                engine.FrameStaging.upload = designs[name]
                print(f"=== run {i}: upload through {name}", flush=True)
                cs.degraded_phase(torch, extract, native, metrics, paths, Rs, ts, dev, card)
        img = np.random.default_rng(0).integers(0, 256, (184, 616), dtype=np.uint8)
        for name in ("caching", "ring", "ring", "caching"):
            engine.FrameStaging.upload = designs[name]
            staging = engine.FrameStaging()
            x = torch.rand((2048, 2048), device=dev)
            for _ in range(30):   # keeps the stream busy behind the copies
                x = x @ x
                x = x / x.norm()
            sec = []
            for _ in range(200):
                t0 = time.perf_counter()
                staging.upload(img, dev)
                sec.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            print(f"upload alone through {name}: median {1e3 * np.median(sec):.4f} ms, mean "
                  f"{1e3 * np.mean(sec):.4f} ms, max {1e3 * np.max(sec):.4f} ms [{card}]")
    finally:
        engine.FrameStaging.upload = ring
    return 0


if __name__ == "__main__":
    sys.exit(main())
