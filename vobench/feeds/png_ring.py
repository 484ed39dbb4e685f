"""Feed `png_ring`: the CLI's ingestion path. In set-up the period's
frames are written as 8-bit PNGs in KITTI's layout
(`sequences/00/image_0/000000.png`, `image_1/` for the right camera)
under a temporary directory of `TMPDIR`, by the benchmark's encoder. In
the window they are read back by the port's native decoder and prefetch
ring (`viso_tpu_torch.data.native.Prefetcher`, left and right
interleaved, the path list cycled over the period), cast to uint8 and
staged on the card one frame ahead through the engine's `to_device`, as
`viso_tpu_torch.run` and `bench.py`'s ingestion cell do. `waits` holds
the host seconds each frame blocked in the ring."""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from vobench import pngenc

ENCODE_THREADS = 4


def as_u8(img):
    return np.clip(img, 0, 255).astype(np.uint8)


class Feed:
    def __init__(self, ctx):
        from viso_tpu_torch.data import native

        if not ctx.stereo:
            raise ValueError("png_ring feeds a stereo rig")
        if not native.available():
            raise RuntimeError(f"the native decoder is unavailable: {native._load_error}")
        t = ctx.traffic
        self.root = tempfile.mkdtemp(prefix="vobench_png_")
        seq = os.path.join(self.root, "sequences", "00")
        P = len(ctx.frames_host)
        jobs = []
        for side, cam in enumerate(("image_0", "image_1")):
            os.makedirs(os.path.join(seq, cam))
            jobs += [(os.path.join(seq, cam, f"{k:06d}.png"), ctx.frames_host[k, side])
                     for k in range(P)]
        with ThreadPoolExecutor(ENCODE_THREADS) as pool:
            list(pool.map(lambda job: pngenc.write_gray(*job), jobs))
        n = ctx.max_frames
        paths = []
        for i in range(n):
            k = i % P
            paths += [os.path.join(seq, "image_0", f"{k:06d}.png"),
                      os.path.join(seq, "image_1", f"{k:06d}.png")]
        self.ring = native.Prefetcher(paths, ring=t["ring"], threads=t["threads"])
        self.engine = ctx.engine
        self.waits = []
        self.nxt = self._read()

    def _read(self):
        t0 = time.perf_counter()
        il, ir = next(self.ring), next(self.ring)
        self.waits.append(time.perf_counter() - t0)
        return self.engine.to_device(as_u8(il), as_u8(ir))

    def next(self):
        cur, self.nxt = self.nxt, self._read()
        return cur

    def close(self):
        self.ring.close()
        shutil.rmtree(self.root, ignore_errors=True)
