#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (viso_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines with its wall time; any failure
raises and exits non-zero:

  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. the build: compiles every kernel source in viso_tpu_torch/csrc/ (one
     nvcc per source, all started together; or reuses the builds keyed by
     their source hashes);
  3. K1, the window-extraction kernel, against its plain PyTorch version
     at every shape the headline's stereo VO path and the SLAM cell give
     it (the 34x34 descriptor windows and the SLAM cell's pyramid levels
     included), plus edge cases: torch.equal (a pure copy is bit-exact),
     kernel and plain times from CUDA events;
  4. StereoVO at the bench-headline configuration (376x1240, KITTI
     intrinsics, 44-frame rng-42 corridor): an instrumented run for
     per-program times and the synchronising-call count, then a clean run
     for frames/s over 32 frames after a 12-frame warmup. K1's launch
     counter must rise during the run, and the ATE against ground truth
     (no scale alignment) must stay below 0.05 m;
  5. K2, the row-aligned extraction kernel, on its main path: the
     extraction micro-benchmark (`python -m
     viso_tpu_torch.tools.bench_extract`), which holds K2 against its
     plain version at all 12 of its shapes (torch.equal on tiles and
     origins) and against K1 through its value oracle (< 1e-3);
  6. StereoSLAM at the reference's 500-frame loop configuration
     (`bench.py:604-692`: 184x616, half-KITTI intrinsics, the room orbit
     over two laps, frames quantised to uint8 as the bench's PNGs are):
     60 warmup frames, frames 60-499 timed on the host clock, then
     join(). 500 finite poses, no hook errors, at least one loop, ATE
     (no scale alignment) below 0.15 m, and K1 launched during the run;
  7. one JSON line with the kernel records (`launches`: the kernel's
     launches summed over the main paths it is on, each counted from 0
     just before its path and read just after), then the last line
     {"ok": true, "device": {...}}.

Imports nothing of JAX or viso_tpu. Needs one CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

H, W = 376, 1240
KITTI_FULL = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157)
N_FRAMES, WARMUP = 44, 12
ATE_LIMIT_M = 0.05

# The reference's 500-frame loop-closure cell (bench.py:604-692).
SLAM_H, SLAM_W = 184, 616
SLAM_FRAMES, SLAM_WARMUP = 500, 60
SLAM_ATE_LIMIT_M = 0.15     # ~2x the JAX package's 0.0684 m on the v5e (BENCH_r05)

# (name, image shape, window (h, w), N, indexed) -- every call the
# headline's stereo VO path and the SLAM cell make, with its caller.
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
    # align.py _align_level (track, every frame): indexed over K+1 = 9
    ("track align L1 idx win16", (9, H // 2, W // 2), (16, 16), 2048, True),
    ("track align L0 idx win16", (9, H, W), (16, 16), 2048, True),
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
    ("slam track align L1 idx win16", (9, SLAM_H // 2, SLAM_W // 2), (16, 16), 2048, True),
    ("slam track align L0 idx win16", (9, SLAM_H, SLAM_W), (16, 16), 2048, True),
    ("slam stereo left win12", (SLAM_H, SLAM_W), (12, 12), 256, False),
    ("slam stereo right rect 12x108", (SLAM_H, SLAM_W), (12, 108), 256, False),
]
TRACK_CASES = [c[0] for c in MAIN_PATH_CASES if c[0].startswith("track")]


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_cases(torch, extract, dev, card):
    """Phase 3. Returns (per-case results, max abs error)."""
    from viso_tpu_torch.tools.bench_extract import cuda_ms

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results = {}
    max_err = 0.0

    def check(name, shape, hw, n, indexed, edge=False):
        nonlocal max_err
        h, w = hw
        img = torch.rand(shape, generator=gen, device=dev) * 255.0
        Hh, Ww = shape[-2], shape[-1]
        centers = torch.rand((n, 2), generator=gen, device=dev) * torch.tensor(
            [Ww, Hh], dtype=torch.float32, device=dev
        )
        if edge:
            # Centres at all four borders and beyond them.
            border = torch.tensor(
                [[-5.0, -5.0], [0.0, 0.0], [Ww - 1.0, Hh - 1.0], [Ww + 9.0, Hh + 9.0],
                 [-0.5, Hh / 2], [Ww / 2, -0.7], [Ww - 0.2, Hh / 2], [Ww / 2, Hh - 0.01]],
                device=dev,
            )
            centers[: min(n, len(border))] = border[: min(n, len(border))]
        k = None
        if indexed:
            k = torch.randint(0, shape[0], (n,), generator=gen, device=dev, dtype=torch.int32)
            if edge:
                k[: min(n, 4)] = torch.tensor([0, shape[0] - 1, -1, shape[0] + 3],
                                              dtype=torch.int32, device=dev)[: min(n, 4)]
        if h == w:
            base = extract.centered_base(shape[-2:], centers, w)
        else:   # stereo strip origins, as stereo.match computes them (half_patch 4)
            base = torch.stack(
                [torch.clamp(torch.floor(centers[:, 0]).to(torch.int32) - (w - 8), 0, Ww - w),
                 torch.clamp(torch.floor(centers[:, 1]).to(torch.int32) - 6, 0, Hh - h)], -1)
            if edge:
                base[:2] = torch.tensor([[-7, -3], [Ww, Hh]], dtype=torch.int32, device=dev)
        got = extract.launch(img, base, h, w, k=k)
        torch.cuda.synchronize()
        ref = extract.extract_plain(img, base, h, w, k=k)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.equal(got, ref):
            raise AssertionError(f"kernel != plain for {name}")
        err = float((got - ref).abs().max()) if got.numel() else 0.0
        max_err = max(max_err, err)
        ms = cuda_ms(lambda: extract.launch(img, base, h, w, k=k))
        plain_ms = cuda_ms(lambda: extract.extract_plain(img, base, h, w, k=k))
        results[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err)
        print(f"K1 {name}: shape {tuple(shape)} window {h}x{w} N={n} equal=True "
              f"max_abs_err={err} kernel_ms={ms:.6f} plain_ms={plain_ms:.6f} [{card}]")

    for name, shape, hw, n, indexed in MAIN_PATH_CASES:
        check(name, shape, hw, n, indexed)
    check("edge square borders", (H, W), (16, 16), 64, False, edge=True)
    check("edge N=1", (H // 8, W // 8), (24, 24), 1, False, edge=True)
    check("edge indexed k at ends", (9, H, W), (16, 16), 64, True, edge=True)
    check("edge rect borders", (H, W), (12, 140), 16, False, edge=True)
    return results, max_err


def render_frames(synthetic, scene, intr, h, w, Rs, ts, quantise=False):
    """Stereo pairs rendered on the host, one after another; with
    `quantise`, 8-bit, as the bench writes its PNGs."""
    frames = []
    for R, t in zip(Rs, ts):
        il, ir, _ = synthetic.make_stereo_pair(scene, intr, R, t, h, w, baseline=0.537)
        if quantise:
            il = np.clip(il, 0, 255).astype(np.uint8)
            ir = np.clip(ir, 0, 255).astype(np.uint8)
        frames.append((il, ir))
    return frames


def render_headline(synthetic, camera):
    """bench.py's headline sequence: the rng-42 corridor, 44 frames."""
    scene = synthetic.corridor_scene(np.random.default_rng(42), tex_size=1024, far_z=60.0)
    intr = camera.Intrinsics.create(**KITTI_FULL)
    Rs, ts = synthetic.forward_trajectory(N_FRAMES, step=0.8, yaw_rate=0.003)
    return render_frames(synthetic, scene, intr, H, W, Rs, ts), Rs, ts


def headline_config(VOConfig):
    return VOConfig(
        height=H, width=W, baseline=0.537, num_features=512, max_landmarks=2048,
        detect_grid=(6, 12), fast_threshold=20.0, max_disparity=128,
        stats_max_lag=8, kf_max_gap=5, **KITTI_FULL,
    )


def instrument(vo, torch, times):
    """Wrap the engine's four programs with CUDA events (no host sync)."""
    for attr, name in (("_track", "track"), ("_stereo_kf_program", "stereo_kf"),
                       ("_ba_program", "ba"), ("_templates_program", "templates")):
        fn = getattr(vo, attr)

        def timed(*a, _fn=fn, _name=name, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = _fn(*a, **kw)
            e.record()
            times.setdefault(_name, []).append((s, e))
            return out

        setattr(vo, attr, timed)


def ate_of(vo, metrics, Rs, ts):
    R_est, t_est = vo.trajectory()
    if len(R_est) != N_FRAMES or not (np.isfinite(R_est).all() and np.isfinite(t_est).all()):
        raise AssertionError("trajectory has the wrong length or non-finite poses")
    return metrics.ate_rmse(
        metrics.camera_centers(R_est, t_est), metrics.camera_centers(Rs, ts),
        align=True, with_scale=False,
    )


def k2_phase(torch, extract, extract_aligned, card):
    """Phase 5. K2's main path, the micro-benchmark tool, with the counts
    from 0: at each of its 12 shapes K2 must equal its plain version
    (torch.equal on tiles and origins) and agree with K1 through the
    tool's value oracle. Returns the kernel record's numbers (ms: one
    sweep, the 12 calls summed)."""
    from viso_tpu_torch.tools import bench_extract

    extract.launch.launches = 0
    extract_aligned.launch.launches = 0
    records = bench_extract.run(torch.device("cuda", 0))
    launches = extract_aligned.launch.launches
    bench_extract.report(records)
    bad = [r for r in records if not (r["equal"] and r["oracle_ok"])]
    ms = sum(r["k2_ms"] for r in records)
    plain_ms = sum(r["k2_plain_ms"] for r in records)
    print(f"K2 one sweep ({len(records)} calls): kernel_ms={ms:.6f} plain_ms={plain_ms:.6f} "
          f"[{card}]")
    print(f"K2 launches during the tool run: {launches} (K1: {extract.launch.launches})")
    if len(records) != 12 or bad or launches <= 0:
        raise AssertionError(f"bench_extract: {len(records)} shapes, failing {bad}, "
                             f"K2 launches {launches}")
    return dict(launches=launches, max_abs_err=max(r["max_abs_err"] for r in records),
                ms=ms, plain_ms=plain_ms)


def slam_phase(torch, extract, extract_aligned, synthetic, camera, metrics, dev, card):
    """Phase 6. StereoSLAM on the reference's 500-frame loop cell; returns
    K1's launches during the run."""
    from viso_tpu_torch.slam.engine import VOConfig
    from viso_tpu_torch.slam.full import StereoSLAM
    from viso_tpu_torch.slam.loop_closure import LoopParams

    t0 = time.perf_counter()
    scene = synthetic.room_scene(np.random.default_rng(11), tex_size=768, half=5.5)
    half = {k: KITTI_FULL[k] / 2 for k in ("fx", "fy", "cx", "cy")}
    intr = camera.Intrinsics.create(**half)
    Rs, ts = synthetic.orbit_trajectory(SLAM_FRAMES, radius=2.5, total_angle=4 * np.pi)
    frames = render_frames(synthetic, scene, intr, SLAM_H, SLAM_W, Rs, ts, quantise=True)
    print(f"rendered {len(frames)} stereo frames {SLAM_H}x{SLAM_W} (uint8) in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    cfg = VOConfig(
        height=SLAM_H, width=SLAM_W, baseline=0.537, **half,
        num_features=256, max_landmarks=1024, detect_grid=(4, 8),
        fast_threshold=6.0, max_disparity=96,
        stats_max_lag=8, kf_max_gap=8, kf_min_gap=2,
    )
    extract.launch.launches = 0
    extract_aligned.launch.launches = 0
    slam = StereoSLAM(cfg, LoopParams(min_inliers=40, max_correction_m=4.0), device=dev)
    try:
        nxt = slam.to_device(*frames[0])
        for i in range(SLAM_WARMUP):
            cur, nxt = nxt, slam.to_device(*frames[i + 1])
            slam.process(*cur)
        torch.cuda.synchronize()
        per_frame = []
        t0 = time.perf_counter()
        for i in range(SLAM_WARMUP, SLAM_FRAMES):
            tf = time.perf_counter()
            cur = nxt
            nxt = slam.to_device(*frames[i + 1]) if i + 1 < SLAM_FRAMES else None
            slam.process(*cur)
            per_frame.append(time.perf_counter() - tf)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        t1 = time.perf_counter()
        slam.join()
        join_s = time.perf_counter() - t1
        R_est, t_est = slam.trajectory()
        launches = extract.launch.launches
        k2_launches = extract_aligned.launch.launches
        n_kf = sum(r.is_keyframe for r in slam.results)
        nodes = len(slam.pg_R)
        loops = list(slam.loops)
        errors = list(slam.hook_errors)
    finally:
        slam.close()
    n_timed = SLAM_FRAMES - SLAM_WARMUP
    med = float(np.median(per_frame))
    print(f"StereoSLAM 500-frame loop cell: {n_timed / elapsed:.3f} frames/s mean, "
          f"{1.0 / med:.3f} frames/s median per frame ({1e3 * med:.3f} ms) over {n_timed} "
          f"frames after {SLAM_WARMUP} warmup; join {join_s:.2f} s [{card}]")
    print(f"StereoSLAM: {n_kf} keyframes, {nodes} pose-graph nodes, {len(loops)} loops "
          f"closed {[(lp['from'], lp['to'], lp['inliers']) for lp in loops]}")
    if len(R_est) != SLAM_FRAMES or not (np.isfinite(R_est).all() and np.isfinite(t_est).all()):
        raise AssertionError("SLAM trajectory has the wrong length or non-finite poses")
    ate = metrics.ate_rmse(metrics.camera_centers(R_est, t_est), metrics.camera_centers(Rs, ts),
                           align=True, with_scale=False)
    print(f"StereoSLAM ATE (no scale alignment): {ate:.6f} m; limit {SLAM_ATE_LIMIT_M} m")
    print(f"K1 launches during the SLAM run: {launches} (K2: {k2_launches})")
    if errors:
        raise AssertionError(f"{len(errors)} keyframe hook errors, first: {errors[0]!r}")
    if not loops:
        raise AssertionError("no loop closed on the 500-frame orbit")
    if not ate < SLAM_ATE_LIMIT_M:
        raise AssertionError(f"SLAM ATE {ate:.4f} m over {SLAM_ATE_LIMIT_M} m")
    if launches <= 0:
        raise AssertionError("the SLAM path never launched the extraction kernel")
    return launches


def main() -> int:
    # The run uses one card: show torch only the first visible one, so the
    # device count in the last line is the number of cards the run used.
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = "0" if visible is None else visible.split(",")[0]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if not (REPO / "viso_tpu_torch" / "csrc" / "extract_windows.cu").is_file():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from viso_tpu_torch import _cuda
    from viso_tpu_torch.data import synthetic
    from viso_tpu_torch.geometry import camera, extract, extract_aligned
    from viso_tpu_torch.slam.engine import StereoVO, VOConfig
    from viso_tpu_torch.utils import metrics
    t_start = time.perf_counter()

    # Phase 1: the card.
    if torch.cuda.device_count() != 1:
        raise AssertionError(f"expected one visible card, got {torch.cuda.device_count()}")
    card = card_line()
    dev = torch.device("cuda", 0)
    print(card)   # exactly as nvidia-smi gives it: name, power limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # Phase 2: the build.
    t0 = time.perf_counter()
    paths = _cuda.build_all()
    extract.load_library()
    extract_aligned.load_library()
    print(f"build: {', '.join(str(p.relative_to(REPO)) for p in paths)} in "
          f"{time.perf_counter() - t0:.2f} s")

    # Phase 3: K1 against its plain version.
    t0 = time.perf_counter()
    cases, max_err = kernel_cases(torch, extract, dev, card)
    frame_ms = sum(cases[n]["ms"] for n in TRACK_CASES)
    frame_plain_ms = sum(cases[n]["plain_ms"] for n in TRACK_CASES)
    print(f"K1 per tracked frame (6 calls): kernel_ms={frame_ms:.6f} "
          f"plain_ms={frame_plain_ms:.6f} [{card}]")
    print(f"phase 3 wall {time.perf_counter() - t0:.1f} s")

    # Phase 4: StereoVO on the headline sequence.
    t_phase = t0 = time.perf_counter()
    frames, Rs, ts = render_headline(synthetic, camera)
    print(f"rendered {len(frames)} stereo frames {H}x{W} in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    cfg = headline_config(VOConfig)

    # 4a: instrumented run -- per-program ms and synchronising calls.
    times: dict = {}
    vo = StereoVO(cfg, device=dev)
    instrument(vo, torch, times)
    for il, ir in frames[:WARMUP]:
        vo.process(il, ir)
    timed = [vo.to_device(il, ir) for il, ir in frames[WARMUP:]]
    torch.cuda.synchronize()
    for v in times.values():
        v.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for il, ir in timed:
                vo.process(il, ir)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    n_sync = sum(1 for w in caught if "synchroniz" in str(w.message).lower())
    ate_a = ate_of(vo, metrics, Rs, ts)
    vo.close()
    prog_ms = {
        name: sum(s.elapsed_time(e) for s, e in v) / len(v)
        for name, v in times.items() if v
    }
    calls = {name: len(v) for name, v in times.items()}
    for name in ("track", "stereo_kf", "ba", "templates"):
        if name not in prog_ms:
            raise AssertionError(f"program {name} never ran in the timed frames")
        print(f"program {name}: mean {prog_ms[name]:.3f} ms over {calls[name]} calls "
              f"(CUDA events, stream time) [{card}]")
    print(f"synchronising calls over {len(timed)} timed frames "
          f"(set_sync_debug_mode warn): {n_sync} [{card}]")

    # 4b: the main path, clean: counts reset just before, read just after.
    extract.launch.launches = 0
    extract_aligned.launch.launches = 0
    vo = StereoVO(cfg, device=dev)
    for il, ir in frames[:WARMUP]:
        vo.process(il, ir)
    timed = [vo.to_device(il, ir) for il, ir in frames[WARMUP:]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stamps = [t0]
    for il, ir in timed:
        vo.process(il, ir)
        stamps.append(time.perf_counter())
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = extract.launch.launches
    fps = len(timed) / elapsed
    # Host time per process() call, no per-frame sync: the path is
    # launch-bound, so the host clock is the frame's critical path.
    per_frame = sorted(b - a for a, b in zip(stamps, stamps[1:]))
    ate = ate_of(vo, metrics, Rs, ts)
    n_kf = sum(r.is_keyframe for r in vo.results)
    vo.close()
    print(f"StereoVO headline: {fps:.3f} frames/s over {len(timed)} frames after "
          f"{WARMUP} warmup, {n_kf} keyframes in {N_FRAMES} frames [{card}]")
    print(f"StereoVO per-frame host ms over {len(per_frame)} frames: median "
          f"{1e3 * per_frame[len(per_frame) // 2]:.3f} max {1e3 * per_frame[-1]:.3f} "
          f"[{card}]")
    print(f"ATE (no scale alignment): {ate:.6f} m clean run, {ate_a:.6f} m "
          f"instrumented run; limit {ATE_LIMIT_M} m")
    print(f"K1 launches during the run: {launches}")
    if launches <= 0:
        raise AssertionError("the main path never launched the extraction kernel")
    if not (ate < ATE_LIMIT_M and ate_a < ATE_LIMIT_M):
        raise AssertionError(f"ATE {ate:.4f} / {ate_a:.4f} m over {ATE_LIMIT_M} m")

    print(f"phase 4 wall {time.perf_counter() - t_phase:.1f} s")

    # Phase 5: K2 against its plain version, then the tool as its path.
    t0 = time.perf_counter()
    k2 = k2_phase(torch, extract, extract_aligned, card)
    print(f"phase 5 wall {time.perf_counter() - t0:.1f} s")

    # Phase 6: StereoSLAM on the 500-frame loop cell.
    t0 = time.perf_counter()
    slam_k1 = slam_phase(torch, extract, extract_aligned, synthetic, camera, metrics, dev,
                         card)
    print(f"phase 6 wall {time.perf_counter() - t0:.1f} s")

    # Phase 7: results.
    print(f"total wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {
            "name": "extract_windows",
            "route": "cuda",
            "source": "viso_tpu_torch/csrc/extract_windows.cu",
            "replaces": "viso_tpu/geometry/extract_pallas.py:64",
            "launches": launches + slam_k1,
            "max_abs_err": max_err,
            "ms": frame_ms,
            "plain_ms": frame_plain_ms,
        },
        {
            "name": "extract_aligned",
            "route": "cuda",
            "source": "viso_tpu_torch/csrc/extract_aligned.cu",
            "replaces": "tools/bench_extract.py:37",
            "launches": k2["launches"],
            "max_abs_err": k2["max_abs_err"],
            "ms": k2["ms"],
            "plain_ms": k2["plain_ms"],
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
