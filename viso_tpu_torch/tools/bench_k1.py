"""K1's explicit-origin kernel from one or more sources, timed on the card
at every shape the main paths give K1.

    python -m viso_tpu_torch.tools.bench_k1 [SOURCE.cu ...]

Each source (default: the package's `csrc/extract_windows.cu`) must export
`viso_extract_windows` with the package's C signature; an older revision
of the kernel (`git show REV:viso_tpu_torch/csrc/extract_windows.cu`) or a
variant with other constants compares against the current one this way.
Every source is built with the package's nvcc flags, checked bit-equal to
the first at each shape, and timed with `bench_extract.device_ms` (a CUDA
graph replay) in turns, the first source once more at the end, so that
versions compare within one run on one card. One line per shape, then the
sums. Needs a CUDA device and raises without one.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from viso_tpu_torch import _cuda
from viso_tpu_torch.tools import bench_extract

H, W = 376, 1240            # the bench headline (StereoVO)
SLAM_H, SLAM_W = 184, 616   # the 500-frame loop SLAM cell
CLI_H, CLI_W = 240, 320     # `viso_tpu_torch.run`'s synthetic sequence
MP_H, MP_W = 120, 160       # `multiprocess_ba --engine`'s StereoVO

# (name, image shape, window (h, w), N, source) -- every call the
# headline's stereo VO path, the SLAM cell, the mono cell and the CLI's
# synthetic runs make, with its caller. source: False for one image, "two" for the two-source entry
# (a stack and the current image, the last image of the case's stack),
# "stack" for the indexed entry over a stack.
MAIN_PATH_CASES = [
    # direct.py build_level_template (templates, every keyframe): win 10
    ("templates L0 win10", (H, W), (10, 10), 1024, False),
    ("templates L1 win10", (H // 2, W // 2), (10, 10), 1024, False),
    ("templates L2 win10", (H // 4, W // 4), (10, 10), 256, False),
    ("templates L3 win10", (H // 8, W // 8), (10, 10), 256, False),
    # direct.py _level_pass_cached (track, every frame): win 16 / 24
    ("track direct L0 win16", (H, W), (16, 16), 1024, False),
    ("track direct L1 win24", (H // 2, W // 2), (24, 24), 1024, False),
    ("track direct L2 win24", (H // 4, W // 4), (24, 24), 256, False),
    ("track direct L3 win24", (H // 8, W // 8), (24, 24), 256, False),
    # align.py _align_level (track, every frame): two sources, the
    # 8-keyframe stack and the current image, 1024 windows each (the last
    # image of the (9, h, w) case is the current image)
    ("track align L1 idx win16", (9, H // 2, W // 2), (16, 16), 2048, "two"),
    ("track align L0 idx win16", (9, H, W), (16, 16), 2048, "two"),
    # stereo.py match (stereo_kf, every keyframe)
    ("stereo left win12", (H, W), (12, 12), 504, False),
    ("stereo right rect 12x140", (H, W), (12, 140), 504, False),
    # descriptors.py compute (the SLAM keyframe digest): 34x34 windows,
    # N = LoopParams.num_features, at the SLAM cell's and the headline's size
    ("descriptors 184x616 win34", (SLAM_H, SLAM_W), (34, 34), 256, False),
    ("descriptors 376x1240 win34", (H, W), (34, 34), 256, False),
    # The SLAM cell's VO calls (184x616, 256 features, 1024 landmarks,
    # disparity 96). Every level is at most 200 px high, so direct.py's
    # track windows are 24 px, clipped to the 23 px of level 3.
    ("slam templates L0 win10", (SLAM_H, SLAM_W), (10, 10), 1024, False),
    ("slam templates L1 win10", (SLAM_H // 2, SLAM_W // 2), (10, 10), 1024, False),
    ("slam templates L2 win10", (SLAM_H // 4, SLAM_W // 4), (10, 10), 256, False),
    ("slam templates L3 win10", (SLAM_H // 8, SLAM_W // 8), (10, 10), 256, False),
    ("slam track direct L0 win24", (SLAM_H, SLAM_W), (24, 24), 1024, False),
    ("slam track direct L1 win24", (SLAM_H // 2, SLAM_W // 2), (24, 24), 1024, False),
    ("slam track direct L2 win24", (SLAM_H // 4, SLAM_W // 4), (24, 24), 256, False),
    ("slam track direct L3 win23", (SLAM_H // 8, SLAM_W // 8), (23, 23), 256, False),
    ("slam track align L1 idx win16", (9, SLAM_H // 2, SLAM_W // 2), (16, 16), 2048, "two"),
    ("slam track align L0 idx win16", (9, SLAM_H, SLAM_W), (16, 16), 2048, "two"),
    ("slam stereo left win12", (SLAM_H, SLAM_W), (12, 12), 256, False),
    ("slam stereo right rect 12x108", (SLAM_H, SLAM_W), (12, 108), 256, False),
    # The mono cell (184x616, 256 features, 1024 landmarks, 8 keyframes).
    # lk.py _single_level (every keyframe and init frame): the reference
    # and current level images as two sources, 256 windows each of
    # 4*half+8 = 24 px, clipped to the 23 px of level 3.
    ("mono lk L3 win23", (2, SLAM_H // 8, SLAM_W // 8), (23, 23), 512, "two"),
    ("mono lk L2 win24", (2, SLAM_H // 4, SLAM_W // 4), (24, 24), 512, "two"),
    ("mono lk L1 win24", (2, SLAM_H // 2, SLAM_W // 2), (24, 24), 512, "two"),
    ("mono lk L0 win24", (2, SLAM_H, SLAM_W), (24, 24), 512, "two"),
    # ba_photometric.py _precompute_windows (every keyframe's window BA):
    # one 16x16 window per (keyframe, landmark) from the level-1 stack.
    ("mono photo-BA win16", (8, SLAM_H // 2, SLAM_W // 2), (16, 16), 8 * 1024, "stack"),
    # The CLI's synthetic sequence (run.py defaults: 240x320, 512
    # features, 2048 landmarks, 8 keyframes), logged from its stereo, slam
    # and mono runs: stereo matches 504 features, LK tracks 504 per source.
    ("cli templates L0 win10", (CLI_H, CLI_W), (10, 10), 1024, False),
    ("cli templates L1 win10", (CLI_H // 2, CLI_W // 2), (10, 10), 1024, False),
    ("cli templates L2 win10", (CLI_H // 4, CLI_W // 4), (10, 10), 256, False),
    ("cli templates L3 win10", (CLI_H // 8, CLI_W // 8), (10, 10), 256, False),
    ("cli track direct L0 win16", (CLI_H, CLI_W), (16, 16), 1024, False),
    ("cli track direct L1 win24", (CLI_H // 2, CLI_W // 2), (24, 24), 1024, False),
    ("cli track direct L2 win24", (CLI_H // 4, CLI_W // 4), (24, 24), 256, False),
    ("cli track direct L3 win24", (CLI_H // 8, CLI_W // 8), (24, 24), 256, False),
    ("cli track align L1 idx win16", (9, CLI_H // 2, CLI_W // 2), (16, 16), 2048, "two"),
    ("cli track align L0 idx win16", (9, CLI_H, CLI_W), (16, 16), 2048, "two"),
    ("cli stereo left win12", (CLI_H, CLI_W), (12, 12), 504, False),
    ("cli stereo right rect 12x140", (CLI_H, CLI_W), (12, 140), 504, False),
    ("cli descriptors win34", (CLI_H, CLI_W), (34, 34), 256, False),
    ("cli lk L3 win24", (2, CLI_H // 8, CLI_W // 8), (24, 24), 1008, "two"),
    ("cli lk L2 win24", (2, CLI_H // 4, CLI_W // 4), (24, 24), 1008, "two"),
    ("cli lk L1 win24", (2, CLI_H // 2, CLI_W // 2), (24, 24), 1008, "two"),
    ("cli lk L0 win24", (2, CLI_H, CLI_W), (24, 24), 1008, "two"),
    ("cli photo-BA win16", (8, CLI_H // 2, CLI_W // 2), (16, 16), 8 * 2048, "stack"),
    # The distributed engine runs (chip_smoke phase 10). The mesh dryrun's
    # StereoSLAM (240x320, 192 features, 2048 landmarks, 64 loop
    # features) tracks and builds templates at the CLI's shapes; its
    # stereo match and digest are its own.
    ("dist stereo left win12", (CLI_H, CLI_W), (12, 12), 192, False),
    ("dist stereo right rect 12x60", (CLI_H, CLI_W), (12, 60), 192, False),
    ("dist descriptors win34", (CLI_H, CLI_W), (34, 34), 64, False),
    # `multiprocess_ba --engine` (120x160, 96 features, 256 landmarks, 4
    # keyframes: align's stack is 4 keyframes and the current image);
    # levels 1-2 are at the CLI's level 2-3 shapes.
    ("mp templates L0 win10", (MP_H, MP_W), (10, 10), 256, False),
    ("mp templates L3 win10", (MP_H // 8, MP_W // 8), (10, 10), 256, False),
    ("mp track direct L0 win24", (MP_H, MP_W), (24, 24), 256, False),
    ("mp track direct L3 win15", (MP_H // 8, MP_W // 8), (15, 15), 256, False),
    ("mp track align L1 idx win16", (5, MP_H // 2, MP_W // 2), (16, 16), 512, "two"),
    ("mp track align L0 idx win16", (5, MP_H, MP_W), (16, 16), 512, "two"),
    ("mp stereo left win12", (MP_H, MP_W), (12, 12), 96, False),
    ("mp stereo right rect 12x60", (MP_H, MP_W), (12, 60), 96, False),
]
TRACK_CASES = [c[0] for c in MAIN_PATH_CASES if c[0].startswith("track")]


def load(source):
    """Build one K1 source (the package's flags) and bind its explicit-
    origin entry."""
    lib = ctypes.CDLL(str(_cuda.build_library(source)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.viso_extract_windows.argtypes = [p, i, i, i, p, p, i, i, i, p, p]
    lib.viso_extract_windows.restype = i
    return lib


def run(sources, device):
    """{case name: [device ms per source in turn order]}; the turn order is
    the sources, then the first one again."""
    libs = [load(s) for s in sources]
    order = libs + libs[:1]
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    results = {}
    for name, shape, (h, w), n, indexed in MAIN_PATH_CASES:
        img = torch.rand(shape, generator=gen, device=device) * 255.0
        Hh, Ww = shape[-2], shape[-1]
        c = torch.rand((n, 2), generator=gen, device=device) * torch.tensor(
            [Ww, Hh], dtype=torch.float32, device=device)
        base = torch.stack(
            [torch.clamp(torch.floor(c[:, 0]).to(torch.int32) - w // 2, 0, Ww - w),
             torch.clamp(torch.floor(c[:, 1]).to(torch.int32) - h // 2, 0, Hh - h)], -1
        ).contiguous()
        k = (torch.randint(0, shape[0], (n,), generator=gen, device=device, dtype=torch.int32)
             if indexed else None)
        K = shape[0] if indexed else 1
        ref, times = None, []
        for lib in order:
            out = torch.empty((n, h, w), dtype=torch.float32, device=device)

            def call(lib=lib, out=out):
                err = lib.viso_extract_windows(
                    img.data_ptr(), K, Hh, Ww, base.data_ptr(),
                    None if k is None else k.data_ptr(), n, h, w, out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
                return out

            got = call().clone()
            torch.cuda.synchronize()
            ref = got if ref is None else ref
            if not torch.equal(got, ref):
                raise AssertionError(f"{name}: sources disagree")
            times.append(bench_extract.device_ms(call))
        results[name] = times
    return results


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_k1 needs a CUDA device")
    sources = list(argv if argv is not None else sys.argv[1:]) or [_cuda.CSRC / "extract_windows.cu"]
    results = run(sources, torch.device("cuda", 0))
    card = bench_extract.card_line()
    print("device ms per call (CUDA graph replay), in turns: "
          + ", ".join(str(s) for s in sources) + f", {sources[0]} [{card}]")
    for name, times in results.items():
        print(f"{name:32s} " + " ".join(f"{t:.6f}" for t in times))
    sums = [sum(t[i] for t in results.values()) for i in range(len(sources) + 1)]
    print(f"{'sum':32s} " + " ".join(f"{t:.6f}" for t in sums) + f" [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
