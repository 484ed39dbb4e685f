#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (viso_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines with its wall time; any failure
raises and exits non-zero:

  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. the build: compiles every kernel source in viso_tpu_torch/csrc/ (one
     nvcc per source, all started together; or reuses the builds keyed by
     their source hashes);
  3. K1, the window-extraction kernel, at every shape the headline's
     stereo VO path, the SLAM cell, the mono cells and phase 8's CLI runs
     give it (`tools/bench_k1.MAIN_PATH_CASES`; the 34x34
     descriptor windows, LK's two-source calls at each level and the
     photometric BA's 8,192 windows of 16x16 from the level-1 keyframe
     stack included), plus edge, NaN and +-inf cases: the explicit-origin
     kernel and the entry the main path calls (centred, two-source for
     align and LK, indexed over a stack for photometric BA, rect for the
     stereo strip) each torch.equal to its plain version (a pure copy is
     bit-exact), a replay of a captured CUDA graph of the entry equal to
     its eager call; then the entry's five timings (`bench_extract`:
     device_ms from a CUDA graph replay, host_ms on the host clock,
     floor_ms of an empty kernel, bound_ms from the bytes, library_ms of
     one torch.take), its plain version's device time and its eager
     entry time from CUDA events;
  4. StereoVO at the bench-headline configuration (376x1240, KITTI
     intrinsics, 44-frame rng-42 corridor), its programs captured as CUDA
     graphs and replayed (`viso_tpu_torch/slam/programs.py`, as in every
     engine run below): an instrumented run for per-program times (each
     replay between CUDA events) and the synchronising-call count, one more tracked
     frame under torch.profiler (no copy of the keyframe stack), then a
     clean run for frames/s over 32 frames after a 12-frame warmup. K1's
     launch counter must rise during the run, and the ATE against ground
     truth (no scale alignment) must stay below 0.05 m;
  5. K2, the row-aligned extraction kernel, on its main path: the
     extraction micro-benchmark (`python -m
     viso_tpu_torch.tools.bench_extract`), which holds K2 against its
     plain version at all 12 of its shapes (torch.equal on tiles and
     origins, the same at every K), a graph replay against the eager
     call, and K1 through its value oracle (< 1e-3), with the five
     timings at each shape and their spread over K;
  6. StereoSLAM at the reference's 500-frame loop configuration
     (`bench.py:604-692`: 184x616, half-KITTI intrinsics, the room orbit
     over two laps, frames quantised to uint8 as the bench's PNGs are):
     60 warmup frames, frames 60-499 timed on the host clock, then
     join(). 500 finite poses, no hook errors, at least one loop, ATE
     (no scale alignment) below 0.15 m, and K1 launched during the run;
     the pose-graph solves (accepted of run) and their ms each on the
     worker, eager or replayed, and the ms of each capture the worker
     asked for, made on the dispatch thread inside an engine call; the
     programs captured and the bytes of their CUDA graphs' memory pools; the loop funnel (`tools/diag_loops.Funnel`: keyframes, queries,
     eligible, matches, 3-D, PnP inliers, drift gate, loops) printed, each
     stage at most the one before and the last the run's loops;
  7. MonocularVO at the reference's mono configuration (`bench.py:
     329-449`: 184x616, half-KITTI intrinsics, 256 features, the rng-5
     corridor over 500 frames, uint8 frames, BA backend "auto", so
     photometric): frames/s over frames 60-499 on the host clock, the
     scale-aligned ATE, scale drift and end rotation error, keyframes,
     re-inits, the first tracking frame, synchronising calls, K1 launches
     by call site (track, LK, photometric BA, templates), then one more
     keyframe frame under torch.profiler (its kernels and the device's
     busy share). It must reach tracking with a finite ATE below 4.0 m
     (the spread over RANSAC seeds sets the band: MONO_ATE_LIMIT_M), and
     K1 must launch from both LK and photometric BA;
  8. the CLI on the card: `viso_tpu_torch.run.main` on its synthetic
     sequence, 30 frames in each of --mode stereo, slam, mono and
     mono-slam (the SLAM modes with a checkpoint every 8 frames), each
     summary within tests/test_run_cli.py's bounds (ATE below 0.2, 0.3,
     2.0 and 2.0 m) with its trajectory, per-frame log (one line per
     frame), summary (and slam.npz) written;
  9. MonoSLAM at the reference's mono SLAM configuration (`bench.py:
     452-534`, `tools/mono_cell.py --slam`: phase 7's configuration with
     FAST 6, `LoopParams(min_inliers=40, max_correction_m=4.0)`) on the
     left images of phase 6's orbit: 40 warmup frames, frames 40-499 on
     the host clock ending in synchronize, then join(). Frames/s (mean and
     median per frame), the join time, keyframes, nodes, re-inits, each
     loop (from, to, inliers, s_rel, and the ratio ground truth implies),
     the range of node scales, the pose-graph solves (accepted of run) and
     their ms each on the worker with the worker's captures as phase 6's,
     the programs captured and their graph
     pools' bytes, the scale-aligned keyframe ATE after
     the Sim(3) correction and raw, K1 launches by call site; then each
     loop detection again on the card from the run's inputs and
     hypotheses, its PnP pose's inliers and Umeyama fit again on the CPU,
     and the final graph solved from the raw odometry on both. 500 finite poses, no hook errors, at least one loop, the
     corrected ATE below MONO_SLAM_ATE_LIMIT_M and no more than
     MONO_SLAM_OVER_RAW_M above the raw ATE; a correction that does
     something (an accepted solve, node scales off 1, loops' s_rel near
     ground truth's ratios: MONO_SLAM_SCALE_MOVE, MONO_SLAM_TRUTH_*); the
     card and the CPU agreeing (MONO_SLAM_HOLD_LOG_TOL,
     MONO_SLAM_SOLVE_TOL); K1 launched from the digest, LK and
     photometric BA; and the loop funnel as phase 6's, with the |log s|
     scale gate;
 10. the distributed window BA (`viso_tpu_torch/parallel/dist_ba.py`):
     (a) `tools/bench_dist_ba`'s problem (C=16, L=65,536, 10 LM
     iterations) over an NCCL group of one rank, bit-equal to
     `ba.solve_impl`, with the bytes and calls handed to all_reduce per LM
     iteration (39,948 bytes in 2 calls), the all-reduce ms per iteration
     (CUDA events) and LM iters/s; (b) the same problem over 2 and 4
     spawned gloo ranks sharing the card (NCCL takes one rank per GPU),
     each within R 1e-4, t 1e-3, points 1e-2, cost 1e-3 relative of the
     single-device solve and every rank equal, the same numbers labelled
     "ranks sharing one card" (not a scaling number); (c) the mesh
     dryrun's StereoSLAM (`__graft_entry__.py` `dryrun_multichip`: 240x320,
     C=8, L=2048, 10 frames) with distribute_ba on the NCCL group (its
     window BA the programs `ba_prep`, `ba_solve` and `ba_finish`, the
     solve replayed from the second BA on, the others at every BA; each
     BA's ms on the host clock), under the dryrun's assertions and within
     1e-5 m of the same run without distribute_ba, K1 launched; (d)
     `multiprocess_ba --engine`'s StereoVO over 2 gloo ranks on the card,
     each within 0.05 m of its single-rank run, ATEs below 0.08 m, ranks
     equal, K1 launched, the solve run "eager (gloo)"; (e) phase 6's cell
     (the 500-frame orbit at 184x616, 256 features, 1024 landmarks)
     with distribute_ba and stats_deterministic at world size 1 and over
     2 gloo ranks sharing the card, rank 0 synchronising the whole device
     after every `process()` call: per run frames/s (mean and median per
     call), loops, ATE below 0.15 m, no hook error, K1 launched; the
     ranks' raw trajectories equal, their corrected centres within
     DIST_CELL_RANK_GAP_M, each within DIST_CELL_BAND_M of world 1's;
     (f) `run.main(["--distribute", "--mode", "mono-slam", ...])` on the
     CLI's synthetic run over 2 gloo ranks: tracking reached, the ranks'
     trajectories equal, ATE below 2.0 m, no hook error, K1 launched;
 11. the stats-delay scenario and the diagnostic and profiling tools
     (`viso_tpu_torch/tools/`): (a) tests/test_torch_stats_stress.py's
     corridor with every stats sample delayed 0-10 frames (rng 3, 60
     frames) and 10 frames (40 frames) through the real pinned copies and
     events: the fixed delay at the engine's default hard lag (8 on the
     card), keyframe gaps within [2, 8] and no forced recovery; the
     random delay at the CPU's hard lag 4, gaps within [2, 8] and its ATE
     below 0.08 m (at 8 the JAX package breaks that bound too, given the
     same delays: tests/stats_lag_parity.py);
     (b) `diag_drift` at 60 frames: the drift split into tracked and
     keyframe frames, ATE below 0.15 m; (c) `diag_track_bias` at its
     defaults, its first 4 frames held on the CPU (step lengths within
     5e-5 m), refined step errors below 0.05 m; (d) `diag_mono_seam`: a
     re-init, no hook errors, the loops' s_rel beside the nodes' realized
     scales; (e) `profile_frame`, `profile_track` and `profile_direct` at
     376x1240 (`profile_frame` on phase 4's first 16 frames, its own
     sequence), 1 call a stage: host, wall, stream and device ms, kernels
     and K1's launches per stage (device time and kernels above 0 for
     every stage of more than one kernel, one K1 launch in each K1 stage,
     6 in the track program, replayed and eager);
 12. the captured programs, at the headline's shape (StereoVO: track,
     templates, stereo keyframe, reprojection BA) and at the mono cell's
     (MonocularVO on phase 7's first frames: track, templates, mono
     keyframe, photometric BA): each program's second to fourth calls,
     replays of its graph on new inputs, each bit-equal to an eager call
     of its bare function on the same inputs (no program accumulates with
     atomics) with the eager call's K1 launches and outputs unlike the
     previous call's; a tracked frame and a keyframe frame with its window
     BA under `torch.cuda.set_sync_debug_mode("error")`; each program's
     host enqueue ms, device ms and kernels, replayed and eager;
 13. the SLAM loop layer's programs (`slam/programs.Cache`): StereoSLAM
     on phase 6's cell and MonoSLAM on phase 9's, each until every
     detection segment has had REPLAY_CHECKS checked replays, then 2 +
     REPLAY_CHECKS solves of the run's last graph (its node estimates
     moved by seeded noise) through the program of its bucket on the
     worker, each followed by `join()`: the first REPLAY_CHECKS replays
     of the keyframe digest and of each detection segment (the graphs
     between the draw, `eigh` and `svd`; the worker's captured on the
     dispatch thread at the drain after it asked), and the first
     REPLAY_CHECKS of those solves that replay, held against an
     eager call of the bare function on the same
     inputs, bit for bit (the solves, whose scatter-adds use atomics,
     within LOOP_SOLVE_TOL), with new outputs at new inputs and the
     digest's K1 launches; a keyframe hook's digest on the dispatch
     thread and a solve on the worker under
     `set_sync_debug_mode("error")`; each program's host enqueue ms,
     device ms and kernels, replayed and eager; the graph pools' bytes;
 14. the monocular bootstrap's programs (the init chain's LK, the
     two-view segments) and the captured sharded solve: (a) MonocularVO
     on the mono cell's first BOOT_FRAMES frames with re-inits forced at
     BOOT_REINITS, its bootstrap eager and through its programs, with the
     synchronising calls and host ms per init frame and the calls' sites
     (file:line), the poses of the two runs against each other, then
     through its programs with calls 3 to 2 + REPLAY_CHECKS of each held
     against an eager call bit for bit (K1's launches too) and a chained
     init frame's programs under `set_sync_debug_mode("error")` but for
     the two-view `eigh` and `svd`; (b) phase 10's problem over an NCCL
     group of one rank as the `ba_solve` program: its first call eager,
     its second captured, every call bit-equal to `ba.solve_impl`, the
     all-reduce record restored after a replay, LM iters/s replayed
     against eager and one replay's CUDA-event ms;
 15. one JSON line with the kernel records (`launches`: the kernel's
     launches summed over the main paths it is on, each counted from 0
     just before its path and read just after; the times: K1 summed over
     a tracked frame's 6 calls, K2 over the tool's 12), then the last
     line {"ok": true, "device": {...}}.

Imports nothing of JAX or viso_tpu. Needs one CUDA device.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import sys
import threading
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

# The reference's monocular VO cell (bench.py:329-449): 500 frames of the
# rng-5 corridor at 184x616, frames 60-499 timed.
MONO_FRAMES, MONO_WARMUP = 500, 60
# The cell's ATE depends on its RANSAC seed (tools/mono_cell.py, PERF.md):
# 0.85-2.99 m on the H100 over the seeds whose run re-initializes once,
# 8.3-9.5 m over those that never do (the scale drifts away unchecked).
# The band lies between the two; seed 0, run here, reads 1.48 m.
MONO_ATE_LIMIT_M = 4.0
# The reference's monocular SLAM cell (bench.py:452-534): phase 6's orbit,
# left images, frames 40-499 timed.
MONO_SLAM_WARMUP = 40
# The scale-aligned keyframe ATE after the Sim(3) correction (about 2.4x
# the JAX package's 0.4149 m, BENCH_r05, on the v5e), and how far it may
# stand above the raw odometry nodes' ATE. From the cell's spread over
# RANSAC seeds 0-7 on the H100 (`tools/mono_cell.py --slam`, PERF.md):
# corrected 0.187-0.783 m, but 1.771 m at seed 7, whose odometry alone
# reads 2.060 m; corrected minus raw -0.393 to +0.033 m, above zero in 3
# of 8 seeds. The JAX package's own MonoSLAM on this cell ends above its
# raw ATE too (seed 4 on a CPU: 0.963782 against 0.901288 m;
# tests/mono_slam_cell_parity.py, PERF.md), so corrected < raw is not the
# reference's property at every seed. Seed 0, run here, reads 0.778
# against 0.745 m raw.
MONO_SLAM_ATE_LIMIT_M = 1.0
MONO_SLAM_OVER_RAW_M = 0.1
# What a correction that does nothing would fail (a solve never accepted,
# node scales stuck at 1, s_rel stuck at 1): at least one accepted solve;
# node scales moving off 1 by at least half the median |log| of the
# scale ratios ground truth implies for the loops
# (`mono_cell.loop_scale_truth`); and at least half of the loops' s_rel
# within 0.15 in log of that ratio. The last held in 15 of 16 runs of the
# cell with ground truth beside them (H100 seeds 0, 4-7; the JAX package
# on a CPU, seeds 0-2, 4-6; the port on a CPU, seeds 0-3, where seed 2
# reads 1 of 6); seed 0 here reads 6 of 7, within 0.03.
MONO_SLAM_SCALE_MOVE = 0.5
MONO_SLAM_TRUTH_LOG_BAND = 0.15
MONO_SLAM_TRUTH_SHARE = 0.5
# Each loop detection of the run again on the card, from the run's
# inputs and PnP hypotheses: the same packed result. Then on the CPU, the
# card's PnP pose's inlier count (within 1) and the Umeyama fit over those
# inliers (s_rel within this in log). The CPU's own PnP is only printed:
# the DLT's null vector comes from a float32 `eigh` of an ill-conditioned
# A^T A, and the card's and the CPU's solvers part there (ROADMAP Queue
# 3). And the final graph solved from the raw odometry on the card and on
# the CPU: node scales (in log) and camera centres (m) within this.
MONO_SLAM_HOLD_LOG_TOL = 1e-3
MONO_SLAM_SOLVE_TOL = 1e-3
# The engine programs (and the SLAM loop layer's digest) that call K1, for
# its launch counts by call site.
K1_SITES = {"_track": "track", "_templates_program": "templates",
            "_mono_kf_program": "lk", "_try_initialize": "lk", "_init_track_program": "lk",
            "init_track": "lk", "_ba_program": "photo-BA", "_stereo_kf_program": "stereo_kf",
            "digest": "digest"}
CLI_FRAMES = 30
# tests/test_run_cli.py's bounds on the summary's ATE.
CLI_ATE_LIMITS = {"stereo": 0.2, "slam": 0.3, "mono": 2.0, "mono-slam": 2.0}

# Phase 10: bench_dist_ba's problem (C=16, L=65,536, 10 LM iterations,
# seed 0), timed over bench_dist_ba.REPS solves; the solver tolerances of
# tests/test_dist_ba.py for ranks against the single-device solve (the
# cost's absolute floor: the problem's observations are exact, so its
# final cost ends near 0); the dryrun's centres with and without
# distribute_ba at world size 1 (bit-equal solves: any gap is a fault);
# the spawned ranks' time limit.
DIST_CAMS, DIST_LANDMARKS, DIST_ITERS = 16, 65536, 10
DIST_R_TOL, DIST_T_TOL, DIST_P_TOL, DIST_COST_RTOL, DIST_COST_ATOL = 1e-4, 1e-3, 1e-2, 1e-3, 1e-9
DIST_SLAM_GAP_M = 1e-5
DIST_SPAWN_TIMEOUT_S = 120.0
# Phase 10(e): the 500-frame loop SLAM cell with distribute_ba and
# stats_deterministic over DIST_CELL_RANKS gloo ranks sharing the card, and
# at world size 1. The ranks' raw trajectories must be equal. Their
# corrected camera centres within DIST_CELL_RANK_GAP_M of each other: each
# rank solves its own pose graphs, which accumulate with atomics (an H100
# read 9.61e-05 and 1.17e-04 m). Each rank's centres, raw and corrected,
# within DIST_CELL_BAND_M of the world-1 run's: the sharded window BA sums
# the ranks' halves in another order than one rank sums the whole, so its
# LM iterates part from one rank's (phase (b): points up to 2.15e-3 m off
# the single solve), and the orbit carries that on as drift of the cell's
# own size (an H100 read 0.141 m raw and 0.137 m corrected, the raw
# centres first 1 mm apart at frame 16, the ranks' ATE 0.0626 m against
# world 1's 0.0797 m).
DIST_CELL_RANKS = 2
DIST_CELL_RANK_GAP_M = 1e-3
DIST_CELL_BAND_M = 0.2
DIST_CELL_TIMEOUT_S = 600.0
# Phase 11: tests/test_torch_stats_stress.py's corridor and its ATE bound
# under random stats delays; diag_drift's frames on the loop orbit;
# diag_track_bias's frames held on the CPU and the step gap allowed (the
# card's and the CPU's f32 sums part in GN, alignment and the PnP refine:
# the card against the CPU read 7e-7 m; the CPU against the JAX ops 6e-6
# m, held within this same 5e-5 by tests/test_torch_diag_tools.py);
# the profiles' calls per stage.
STRESS_HW, STRESS_ATE_M, STRESS_HARD_LAG = (192, 256), 0.08, 4
STRESS_INTR = dict(fx=200.0, fy=200.0, cx=STRESS_HW[1] / 2 - 0.5, cy=STRESS_HW[0] / 2 - 0.5)
DRIFT_FRAMES = 60
TRACK_BIAS_CPU_FRAMES, TRACK_BIAS_TOL_M = 4, 5e-5
PROFILE_REPS = 1
# Phase 12: the checked replays of each program, the mono cell's frames
# the engine may take to reach them, and the calls a program's timing takes.
REPLAY_CHECKS = 3
PROGRAM_MONO_FRAMES = 160
PROGRAM_TIME_REPS = 3
# Phase 13: a replayed pose-graph solve against an eager one, largest
# absolute gap over every float output (poses, scales, costs): the solves
# scatter-add with atomics (`index_add_`), so two eager solves need not
# agree bit for bit either, and an accept test that flips on a last-bit
# cost gap moves the rest of the LM run. Phase 9's bound for the same
# solve on the card against the CPU (MONO_SLAM_SOLVE_TOL); on an H100 the
# stereo cell's graphs read gaps of 0 to 2.5e-4, and two eager solves on
# the same inputs up to 1.5e-4 (PERF.md).
LOOP_SOLVE_TOL = 1e-3
# Phase 14: the mono cell's first frames with re-inits forced at
# BOOT_REINITS (the cell's engine tracks from frame 5, and a bootstrap
# takes 4 chained frames: 2 calls of each program, then its checked
# replays, then a chained frame under the error mode); the two-view
# solvers left out of the error-mode check (they read their status on the
# host on CUDA: ops/twoview.py); phase 10's solve, timed over REPS calls.
BOOT_FRAMES, BOOT_REINITS = 80, (30, 50)
BOOT_SOLVERS = ("eigh", "svd")
# init_track and the two-view segments (the homography's refit twice:
# with and without the next refit's system).
BOOT_PROGRAMS = 9
STRICT_RAN = ["init_track", "twoview.initialize"]
# The timings summed over a tracked frame's calls (K1) or the tool's sweep (K2).
FRAME_KEYS = ("device_ms", "host_ms", "floor_ms", "bound_ms", "library_ms", "plain_ms",
              "entry_ms")


def kernel_cases(torch, extract, cases, dev, card):
    """Phase 3. Every case: the kernel at explicit origins (`launch`) and
    the entry point the main path calls (centred, two-source or rect), each
    bit-equal to its plain version, a graph replay of the entry equal to
    its eager call; the entry's five timings (device, host, launch floor,
    bound, library yardstick) and the explicit-origin kernel's device and
    host time. Returns (per-case results, max abs error)."""
    from viso_tpu_torch.tools import bench_extract as bx

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    lib = extract.load_library()
    results = {}
    max_err = 0.0
    inf, nan = float("inf"), float("nan")
    nonfinite_centres = torch.tensor(
        [[nan, 5.0], [5.0, nan], [inf, 5.0], [-inf, 5.0], [5.0, inf], [5.0, -inf],
         [nan, nan], [inf, -inf]], device=dev)

    def same(got, ref, what):
        nonlocal max_err
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for a, b in zip(got, ref):
            if a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"kernel != plain for {what}")
            if a.numel():
                max_err = max(max_err, float((a.double() - b.double()).abs().max()))

    def check(name, shape, hw, n, source, edge=False, nonfinite=False):
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
        if nonfinite:
            centers[: min(n, 8)] = nonfinite_centres[: min(n, 8)]
        k = None
        if source:
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
        launch = lambda: extract.launch(img, base, h, w, k=k)  # noqa: E731
        same(launch(), extract.extract_plain(img, base, h, w, k=k), name)
        # The entry point the main path calls, its plain version, and the
        # source and flat index of its copy for the library yardstick.
        if h != w:
            entry = lambda: extract.extract_rects_fast(img, base, h, w)  # noqa: E731
            plain = lambda: (extract.extract_plain(img, base, h, w), base)  # noqa: E731
            src, idx = img, bx.flat_index(img.shape, base, h, w)
        elif source == "stack":
            # ba_photometric.py's call: every window from the stack.
            entry = lambda: extract.extract_windows_indexed_fast(img, k, centers, w)  # noqa: E731
            plain = lambda: extract.centered_plain(img, centers, w, k=k)  # noqa: E731
            src, idx = img, bx.flat_index(img.shape, plain()[1], w, w, k=k)
        elif source:
            # align.py's and lk.py's call: half the windows from the stack
            # (all but the last image), half from the current image.
            m = n // 2
            stack, cur = img[:-1], img[-1]
            k_ref = k[:m] if edge else torch.clamp(k[:m], 0, stack.shape[0] - 1)
            c_ref, c_cur = centers[:m], centers[m:2 * m]
            entry = lambda: extract.extract_windows_two_source(  # noqa: E731
                stack, k_ref, c_ref, cur, c_cur, w)
            plain = lambda: extract.two_source_plain(  # noqa: E731
                stack, k_ref, c_ref, cur, c_cur, w)
            # The yardstick indexes the (9, H, W) stack made beforehand.
            k_all = torch.cat([torch.clamp(k_ref, 0, stack.shape[0] - 1),
                               torch.full_like(k_ref, stack.shape[0])])
            src, idx = img, bx.flat_index(img.shape, plain()[1], w, w, k=k_all)
        else:
            entry = lambda: extract.extract_windows_fast(img, centers, w)  # noqa: E731
            plain = lambda: extract.centered_plain(img, centers, w)  # noqa: E731
            src, idx = img, bx.flat_index(img.shape, base, h, w)
        same(entry(), plain(), name + " entry")
        if edge or nonfinite:
            print(f"K1 {name}: shape {tuple(shape)} window {h}x{w} N={n} equal=True [{card}]")
            return
        if not bx.graph_matches_eager(entry):
            raise AssertionError(f"graph replay != eager call for {name}")
        t = bx.times(entry, lib, n, h, w, src, idx)
        t.update(plain_ms=bx.device_ms(plain), entry_ms=bx.cuda_ms(entry),
                 launch_device_ms=bx.device_ms(launch), launch_host_ms=bx.host_ms(launch))
        results[name] = t
        print(f"K1 {name}: shape {tuple(shape)} window {h}x{w} N={n} equal=True graph=True "
              f"{bx.times_line(t)} plain_ms={t['plain_ms']:.6f} entry_ms={t['entry_ms']:.6f} "
              f"launch_device_ms={t['launch_device_ms']:.6f} "
              f"launch_host_ms={t['launch_host_ms']:.6f} [{card}]")

    for name, shape, hw, n, source in cases:
        check(name, shape, hw, n, source)
    check("edge square borders", (H, W), (16, 16), 64, False, edge=True)
    check("edge N=1", (H // 8, W // 8), (24, 24), 1, False, edge=True)
    check("edge indexed k at ends", (9, H, W), (16, 16), 64, "two", edge=True)
    check("edge stack k at ends", (8, SLAM_H // 2, SLAM_W // 2), (16, 16), 64, "stack",
          edge=True)
    check("edge rect borders", (H, W), (12, 140), 16, False, edge=True)
    check("edge centred NaN/inf", (H, W), (10, 10), 64, False, nonfinite=True)
    check("edge two-source NaN/inf", (9, H // 2, W // 2), (16, 16), 64, "two", edge=True,
          nonfinite=True)
    check("edge descriptors NaN/inf", (SLAM_H, SLAM_W), (34, 34), 16, False, nonfinite=True)
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
    """Wrap each program as the engine runs it (the replay of its captured
    graph) with CUDA events (no host sync)."""
    real = vo._program

    def program(name):
        prog = real(name)

        def timed(*a):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = prog(*a)
            e.record()
            times.setdefault(name, []).append((s, e))
            return out

        return timed

    vo._program = program


def profile_frame(torch, vo, frame, stack_bytes):
    """One tracked frame under torch.profiler: (device kernel ms, kernel
    count, K1 kernels, the bytes of every aten::cat that allocates at
    least `stack_bytes` -- a copy of the keyframe stack)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 profile_memory=True) as prof:
        vo.process(*frame)
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time for e in kernels) / 1e3
    k1 = sum(1 for e in kernels if "extract_windows_kernel" in e.name)
    copies = [e.cpu_memory_usage + e.device_memory_usage for e in events
              if e.name == "aten::cat"
              and e.cpu_memory_usage + e.device_memory_usage >= stack_bytes]
    return device_ms, len(kernels), k1, copies


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
    bench_extract.report(records, card)
    bad = [r for r in records if not (r["equal"] and r["oracle_ok"] and r["graph_ok"])]
    for r in records:
        r.update(plain_ms=r["k2_plain_ms"], entry_ms=r["k2_ms"])
    sweep = {key: sum(r[key] for r in records) for key in FRAME_KEYS}
    print(f"K2 one sweep ({len(records)} calls): "
          + " ".join(f"{key}={sweep[key]:.6f}" for key in FRAME_KEYS) + f" [{card}]")
    for n in bench_extract.NS:
        for win in bench_extract.WINS:
            dms = [r["device_ms"] for r in records if r["N"] == n and r["win"] == win]
            print(f"K2 N={n} win={win}: device_ms over K max/min {max(dms) / min(dms):.3f} "
                  f"[{card}]")
    print(f"K2 launches during the tool run: {launches} (K1: {extract.launch.launches})")
    if len(records) != 12 or bad or launches <= 0:
        raise AssertionError(f"bench_extract: {len(records)} shapes, failing {bad}, "
                             f"K2 launches {launches}")
    return dict(launches=launches, max_abs_err=max(r["max_abs_err"] for r in records),
                **sweep)


def render_orbit(synthetic):
    """The 500-frame loop orbit (`tools/mono_cell.orbit`, bench.py:604-692)
    as uint8 stereo pairs, and its ground truth. Phase 9 runs on the left
    images: the same render as `mono_cell.render_orbit`'s."""
    from viso_tpu_torch.tools import mono_cell

    t0 = time.perf_counter()
    scene, intr, Rs, ts = mono_cell.orbit()
    frames = render_frames(synthetic, scene, intr, SLAM_H, SLAM_W, Rs, ts, quantise=True)
    print(f"rendered {len(frames)} stereo frames {SLAM_H}x{SLAM_W} (uint8) in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    return frames, Rs, ts


def dispatch_stream(torch, dev):
    """The stream a SLAM run's frames are enqueued on. Its timed windows end
    in a synchronise of this stream alone: they time the frames, not the
    loop worker's work still in flight on the worker's stream."""
    return torch.cuda.current_stream(dev)


class SolveTimer:
    """The pose-graph solves of a SLAM run on its worker thread: their
    host time (each ends in the copy of its result to the host), what
    each was (eager: a bucket's first call, or one before its capture is
    in place; or a replay) and the ones the health gate accepts (each
    stores its solution); and the loop programs' captures, which the
    dispatch thread makes inside engine calls (`programs.Cache.drain`)."""

    def __init__(self, slam):
        self.times, self.kinds, self.accepted = [], [], []
        self.captures = slam._loop_programs.captures
        real_solve, real_store = slam._solve, slam._store_solution

        def replays():
            return sum(p.replays for k, p in slam._loop_programs.programs.items()
                       if k[0].startswith("pose_graph"))

        def timed_solve(*a):
            before = replays()
            t = time.perf_counter()
            out = real_solve(*a)
            self.times.append(time.perf_counter() - t)
            self.kinds.append("replay" if replays() > before else "eager")
            return out

        def counted_store(*a):
            self.accepted.append(len(self.times))
            return real_store(*a)

        slam._solve, slam._store_solution = timed_solve, counted_store

    def line(self, label, card):
        ms = [1e3 * t for t in self.times]
        shown = ", ".join(f"{k} {v:.3f}" for k, v in zip(self.kinds, ms))
        mean = float(np.mean(ms)) if ms else float("nan")
        caps = ", ".join(f"{name} {1e3 * sec:.3f}" for name, sec in self.captures)
        return (f"{label}: {len(ms)} pose-graph solves ({len(self.accepted)} accepted), mean "
                f"{mean:.3f} ms per solve (worker thread, host clock; each: {shown}); "
                f"{len(self.captures)} captures the worker asked for, made on the dispatch "
                f"thread inside engine calls (ms each: {caps}) [{card}]")


def graph_pools(torch, slam):
    """How many of the engine's programs are captured, how many there are,
    and the bytes their CUDA graphs' private memory pools hold, reserved
    and allocated (`torch.cuda.memory_snapshot`: the segments of those
    pools)."""
    progs = (list(slam._loop_programs.programs.values()) + list(slam._kernels.values())
             + list(slam._cache.programs.values()))
    pools = {tuple(p.graph.pool()) for p in progs if p.graph is not None}
    segs = [s for s in torch.cuda.memory_snapshot()
            if tuple(s.get("segment_pool_id", (0, 0))) in pools]
    return (len(pools), len(progs), sum(s["total_size"] for s in segs),
            sum(s["allocated_size"] for s in segs))


def slam_phase(torch, extract, extract_aligned, frames, Rs, ts, metrics, dev, card):
    """Phase 6. StereoSLAM on the reference's 500-frame loop cell (the
    configuration of `tools/diag_loops.stereo_config`) with the loop funnel
    installed; returns K1's launches during the run."""
    from viso_tpu_torch.slam.full import StereoSLAM
    from viso_tpu_torch.slam.loop_closure import LoopParams
    from viso_tpu_torch.tools import diag_loops

    extract.launch.launches = 0
    extract_aligned.launch.launches = 0
    slam = StereoSLAM(diag_loops.stereo_config(), LoopParams(min_inliers=40, max_correction_m=4.0),
                      device=dev)
    solves = SolveTimer(slam)
    funnel = diag_loops.Funnel(slam)
    dispatch = dispatch_stream(torch, dev)
    try:
        nxt = slam.to_device(*frames[0])
        for i in range(SLAM_WARMUP):
            cur, nxt = nxt, slam.to_device(*frames[i + 1])
            slam.process(*cur)
        dispatch.synchronize()
        per_frame = []
        t0 = time.perf_counter()
        for i in range(SLAM_WARMUP, SLAM_FRAMES):
            tf = time.perf_counter()
            cur = nxt
            nxt = slam.to_device(*frames[i + 1]) if i + 1 < SLAM_FRAMES else None
            slam.process(*cur)
            per_frame.append(time.perf_counter() - tf)
        dispatch.synchronize()
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
        counts = funnel.counts()
        pools = graph_pools(torch, slam)
    finally:
        slam.close()
    n_timed = SLAM_FRAMES - SLAM_WARMUP
    med = float(np.median(per_frame))
    print(f"StereoSLAM 500-frame loop cell: {n_timed / elapsed:.3f} frames/s mean, "
          f"{1.0 / med:.3f} frames/s median per frame ({1e3 * med:.3f} ms) over {n_timed} "
          f"frames after {SLAM_WARMUP} warmup; join {join_s:.2f} s [{card}]")
    print(solves.line("StereoSLAM", card))
    print(f"StereoSLAM programs: {pools[0]} of {pools[1]} captured; CUDA graph pools "
          f"{pools[2]} bytes reserved, {pools[3]} allocated [{card}]")
    print(f"StereoSLAM: {n_kf} keyframes, {nodes} pose-graph nodes, {len(loops)} loops "
          f"closed {[(lp['from'], lp['to'], lp['inliers']) for lp in loops]}")
    if len(R_est) != SLAM_FRAMES or not (np.isfinite(R_est).all() and np.isfinite(t_est).all()):
        raise AssertionError("SLAM trajectory has the wrong length or non-finite poses")
    ate = metrics.ate_rmse(metrics.camera_centers(R_est, t_est), metrics.camera_centers(Rs, ts),
                           align=True, with_scale=False)
    print(f"StereoSLAM ATE (no scale alignment): {ate:.6f} m; limit {SLAM_ATE_LIMIT_M} m")
    print(f"K1 launches during the SLAM run: {launches} (K2: {k2_launches})")
    check_funnel("StereoSLAM", counts, loops)
    if errors:
        raise AssertionError(f"{len(errors)} keyframe hook errors, first: {errors[0]!r}")
    if not loops:
        raise AssertionError("no loop closed on the 500-frame orbit")
    if not ate < SLAM_ATE_LIMIT_M:
        raise AssertionError(f"SLAM ATE {ate:.4f} m over {SLAM_ATE_LIMIT_M} m")
    if launches <= 0:
        raise AssertionError("the SLAM path never launched the extraction kernel")
    return launches


def check_funnel(name, counts, loops):
    """Print a run's loop funnel (`tools/diag_loops.Funnel`); each stage
    at most the one before, the last the run's loops."""
    print(f"{name} loop funnel: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    values = list(counts.values())
    if any(a < b for a, b in zip(values, values[1:])) or counts["loops"] != len(loops):
        raise AssertionError(f"{name} loop funnel inconsistent: {counts}, {len(loops)} loops")


class K1Sites:
    """K1 launches by the engine program that made them: wraps the one
    function every K1 entry launches through and, at each launch, looks up
    the call stack for the first engine program (K1_SITES); and each
    replay of a captured program (`Program._replayed`), which adds the
    launches its graph holds to the program's site. A launch made while a
    graph is captured is no launch and is not counted (the counter takes
    it back too)."""

    def __init__(self, torch, extract):
        from viso_tpu_torch.slam import programs

        self.torch, self.extract, self.programs = torch, extract, programs
        self.real = extract._run
        self.real_replayed = programs.Program._replayed
        self.counts = {}

    def __enter__(self):
        torch, counts = self.torch, self.counts
        key = (self.extract.launch, "launches")

        def run(*args, _real=self.real):
            _real(*args)
            if torch.cuda.is_current_stream_capturing():
                return
            frame = sys._getframe(1)
            while frame is not None and frame.f_code.co_name not in K1_SITES:
                frame = frame.f_back
            site = K1_SITES[frame.f_code.co_name] if frame is not None else "other"
            counts[site] = counts.get(site, 0) + 1

        def replayed(prog, _real=self.real_replayed):
            _real(prog)
            if prog.counts.get(key):
                site = K1_SITES.get(prog.name, "other")
                counts[site] = counts.get(site, 0) + prog.counts[key]

        self.extract._run = run
        self.programs.Program._replayed = replayed
        return self

    def __exit__(self, *exc):
        self.extract._run = self.real
        self.programs.Program._replayed = self.real_replayed


def render_mono():
    """The reference's 500-frame mono corridor (`tools/mono_cell.render`)."""
    from viso_tpu_torch.tools import mono_cell

    t0 = time.perf_counter()
    frames, Rs, ts = mono_cell.render(MONO_FRAMES)
    print(f"rendered {len(frames)} mono frames {mono_cell.H}x{mono_cell.W} (uint8) in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    return frames, Rs, ts


def mono_phase(torch, extract, frames, Rs, ts, dev, card):
    """Phase 7. MonocularVO (photometric window BA) on the reference's
    500-frame mono cell (`tools/mono_cell.py`, seed 0); returns K1's
    launches during the run."""
    from viso_tpu_torch.slam.engine import MonocularVO
    from viso_tpu_torch.tools import mono_cell

    cfg = mono_cell.config()

    extract.launch.launches = 0
    # The engine's construction builds its templates' storage (K1).
    sites = K1Sites(torch, extract)
    with sites:
        vo = MonocularVO(cfg, device=dev)
    try:
        with sites, warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                nxt = vo.to_device(frames[0])
                per_frame = []   # (syncs, host ms) of each process() call
                for i in range(MONO_FRAMES):
                    if i == MONO_WARMUP:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                    cur = nxt
                    nxt = vo.to_device(frames[i + 1]) if i + 1 < MONO_FRAMES else None
                    n0, t_f = len(caught), time.perf_counter()
                    vo.process(cur)
                    per_frame.append((len(caught) - n0, 1e3 * (time.perf_counter() - t_f)))
                torch.cuda.synchronize()
                elapsed = time.perf_counter() - t0
            finally:
                torch.cuda.set_sync_debug_mode(0)
        launches = extract.launch.launches
        syncs = [w for w in caught if "synchroniz" in str(w.message).lower()]
        sync_sites = collections.Counter(
            f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in syncs).most_common(8)
        R_est, t_est = vo.trajectory()
        states = [r.state for r in vo.results]
        n_kf = sum(r.is_keyframe for r in vo.results)
        reinits = vo.num_reinits
        # One more keyframe frame (the last frame again, the keyframe
        # decision forced) under torch.profiler: its kernels, their device
        # time and the device's busy share of the frame's wall time.
        vo._should_insert_keyframe = lambda n_tracked: True
        prof_kf = profile_keyframe(torch, vo, frames[-1])
        # The keyframe programs' own launch counts: LK from the previous
        # keyframe to the last frame (as the mono keyframe program calls
        # it) and the photometric window BA, each alone under the profiler.
        from viso_tpu_torch.ops import lk

        prev_pyr = tuple(lvl[vo.kf_order[-2]] for lvl in vo.map.kf_pyr)
        uv, _, det = vo._detect(prev_pyr)
        cam_fixed = torch.zeros(cfg.max_keyframes, dtype=torch.bool, device=dev)
        prof_calls = {
            "lk.track": profile_call(torch, lambda: lk.track(prev_pyr, vo.last_pyr, uv, det)),
            "photometric BA": profile_call(torch, lambda: vo._ba_program(
                vo.map, cam_fixed, vo.kf_order[-1], vo.R, vo.t)),
        }
    finally:
        vo.close()
    n_timed = MONO_FRAMES - MONO_WARMUP
    print(f"MonocularVO 500-frame mono cell: {n_timed / elapsed:.3f} frames/s over {n_timed} "
          f"frames after {MONO_WARMUP} warmup (host clock, ending in synchronize) [{card}]")
    if "tracking" not in states:
        raise AssertionError("the mono engine never reached tracking")
    if len(R_est) != MONO_FRAMES or not (np.isfinite(R_est).all() and np.isfinite(t_est).all()):
        raise AssertionError("mono trajectory has the wrong length or non-finite poses")
    ate, drift, rot = mono_cell.accuracy(R_est, t_est, Rs, ts)
    print(f"MonocularVO: scale-aligned ATE {ate:.6f} m (limit {MONO_ATE_LIMIT_M} m), scale "
          f"drift end/start {drift:.3f}, end rotation error {rot:.3f} deg")
    print(f"MonocularVO: {n_kf} keyframes, {reinits} re-inits, first tracking frame "
          f"{states.index('tracking')}, {states.count('init')} frames in init, {len(syncs)} "
          f"synchronising calls over {MONO_FRAMES} frames (set_sync_debug_mode warn), by line "
          f"{sync_sites} [{card}]")
    init = [f for f, r in zip(per_frame, vo.results) if r.state == "init"]
    print(f"MonocularVO init frames (bootstrap and re-init, their programs replayed): "
          f"{len(init)}, synchronising calls per init frame mean "
          f"{np.mean([n for n, _ in init]):.2f} (min {min(n for n, _ in init)}, max "
          f"{max(n for n, _ in init)}), host ms per init frame median "
          f"{np.median([ms for _, ms in init]):.3f} mean {np.mean([ms for _, ms in init]):.3f} "
          f"[{card}]")
    print(f"K1 launches during the mono run: {launches}, by call site "
          f"{dict(sorted(sites.counts.items()))}")
    n_kernels, dev_ms, wall_ms, k1_sites = prof_kf
    print(f"profiled mono keyframe frame: {n_kernels} kernels, {dev_ms:.3f} ms device time over "
          f"{wall_ms:.3f} ms wall (device busy {100 * dev_ms / wall_ms:.2f} %), K1 launches by "
          f"call site {dict(sorted(k1_sites.items()))} [{card}]")
    for name, (n, ms) in prof_calls.items():
        print(f"profiled {name} alone: {n} kernels, {ms:.3f} ms device time [{card}]")
    if not (np.isfinite(ate) and ate < MONO_ATE_LIMIT_M):
        raise AssertionError(f"mono ATE {ate:.4f} m over {MONO_ATE_LIMIT_M} m")
    if sites.counts.get("lk", 0) <= 0 or sites.counts.get("photo-BA", 0) <= 0:
        raise AssertionError(f"K1 never launched from LK or photometric BA: {sites.counts}")
    if launches != sum(sites.counts.values()):
        raise AssertionError("K1 launches not all attributed to a call site")
    return launches


def profile_keyframe(torch, vo, frame):
    """One frame under torch.profiler: (kernels, device kernel ms, wall ms,
    K1 launches by call site)."""
    from torch.profiler import ProfilerActivity, profile

    from viso_tpu_torch.geometry import extract

    torch.cuda.synchronize()
    with K1Sites(torch, extract) as sites, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        vo.process(frame)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(kernels), sum(e.device_time for e in kernels) / 1e3, wall_ms, sites.counts


def profile_call(torch, fn):
    """One call of fn under torch.profiler: (kernels, device kernel ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(kernels), sum(e.device_time for e in kernels) / 1e3


class LoopRecorder:
    """Records each loop detection of a MonoSLAM run that gives a
    candidate: its inputs on the card (query, pose, a copy of the database
    and its eligible mask) and the PnP hypotheses drawn for it, so that
    `replay` can run the detection again on any device."""

    def __init__(self, torch, slam):
        from viso_tpu_torch.slam import loop_closure

        self.slam, self.lc = slam, loop_closure
        self.calls = []
        self.real_draw = loop_closure.pnp.draw_hypotheses
        db, real_detect, drawn = slam.loop_db, slam.loop_db.detect_fused_sim3, []

        def draw(*a, **k):
            drawn.append(self.real_draw(*a, **k))
            return drawn[-1]

        def detect(desc_q, kps, kp_mask, pts_q, pts_q_ok, R_cur, t_cur, intr, **kw):
            drawn.clear()
            cand = real_detect(desc_q, kps, kp_mask, pts_q, pts_q_ok, R_cur, t_cur, intr, **kw)
            if cand is not None:
                self.calls.append(dict(
                    s_rel=float(cand.s_rel), inliers=int(cand.inliers), idx=drawn[-1],
                    query=[x.clone() for x in (desc_q, kp_mask, kps, pts_q, pts_q_ok)]
                    + [torch.as_tensor(np.array(R_cur)), torch.as_tensor(np.array(t_cur))],
                    db=[x.clone() for x in (db.desc, db.desc_mask, db.points_w_dev,
                                            db.points_ok_dev)]
                    + [torch.from_numpy(db._eligible())]))
            return cand

        db.detect_fused_sim3 = detect
        loop_closure.pnp.draw_hypotheses = draw

    def close(self):
        self.lc.pnp.draw_hypotheses = self.real_draw

    def replay(self, rec, device):
        """The packed 29 floats of a recorded detection on `device`."""
        p = self.slam.loop_params
        thresh = (p.pnp_threshold_px / float(self.slam.intr.fx)) ** 2
        idx = rec["idx"].to(device)
        return self.lc._detect_fused_sim3_kernel(
            *(x.to(device) for x in rec["query"] + rec["db"]), self.slam.intr, thresh,
            p.min_matches, p.min_inliers, lambda mask: idx).cpu().numpy()

    def hold_on_cpu(self, torch, rec, packed):
        """A detection's packed result from the card, held on the CPU: the
        inlier count of its PnP pose and the Umeyama s over those inliers."""
        from viso_tpu_torch.geometry import camera, se3, sim3

        p, intr = self.slam.loop_params, self.slam.intr
        thresh = (p.pnp_threshold_px / float(intr.fx)) ** 2
        desc_q, kp_mask, kps, pts_q, pts_q_ok, R_cur, t_cur = (x.cpu() for x in rec["query"])
        idx = rec["idx"].cpu()
        _, _, _, ok, pts3d = self.lc._verify(
            desc_q, kp_mask, kps, *(x.cpu() for x in rec["db"]), intr, thresh,
            p.min_matches, p.min_inliers, lambda mask: idx)
        R = torch.from_numpy(packed[4:13].reshape(3, 3).copy())
        t = torch.from_numpy(packed[13:16].copy())
        inl = (self.lc.pnp.reprojection_residual(R, t, pts3d, camera.normalize(kps, intr))
               < thresh) & ok
        s = sim3.umeyama_masked(se3.transform(R_cur, t_cur, pts_q), se3.transform(R, t, pts3d),
                                inl & pts_q_ok)[0]
        return int(inl.sum()), float(s)


def sim3_solve_on(torch, slam, device):
    """The run's final graph solved from the raw odometry (scales 1) on
    `device`: node scales and metric camera centres."""
    from viso_tpu_torch.backend import pose_graph_sim3 as pgs

    n = len(slam.pg_raw_R)
    out, _ = pgs.solve_padded([1.0] * n, slam.pg_raw_R, slam.pg_raw_t, slam.pg_edges,
                              pgs.PGParams(iters=25), device=device)
    s, R, t = (x[:n].cpu().numpy() for x in (out.s, out.R, out.t))
    return s, -np.einsum("nji,nj->ni", R, t) / s[:, None]


def mono_slam_phase(torch, extract, frames, Rs, ts, dev, card):
    """Phase 9. MonoSLAM on the reference's mono SLAM cell (`tools/
    mono_cell.py --slam`, seed 0) over the left images of phase 6's orbit;
    returns K1's launches during the run."""
    from viso_tpu_torch.slam.mono_full import MonoSLAM
    from viso_tpu_torch.tools import diag_loops, mono_cell

    extract.launch.launches = 0
    sites = K1Sites(torch, extract)
    with sites:
        slam = MonoSLAM(mono_cell.slam_config(), mono_cell.slam_loop_params(), device=dev)
    solves = SolveTimer(slam)
    recorder = LoopRecorder(torch, slam)
    funnel = diag_loops.Funnel(slam)
    dispatch = dispatch_stream(torch, dev)
    try:
        with sites:
            nxt = slam.to_device(frames[0])
            per_frame = []
            for i in range(SLAM_FRAMES):
                if i == MONO_SLAM_WARMUP:
                    dispatch.synchronize()
                    t0 = time.perf_counter()
                tf = time.perf_counter()
                cur = nxt
                nxt = slam.to_device(frames[i + 1]) if i + 1 < SLAM_FRAMES else None
                slam.process(cur)
                if i >= MONO_SLAM_WARMUP:
                    per_frame.append(time.perf_counter() - tf)
            dispatch.synchronize()
            elapsed = time.perf_counter() - t0
            t1 = time.perf_counter()
            slam.join()
            join_s = time.perf_counter() - t1
        launches = extract.launch.launches
        R_est, t_est = slam.trajectory()
        n_kf = sum(r.is_keyframe for r in slam.results)
        nodes, reinits = len(slam.pg_s), slam.num_reinits
        loops, errors, scales = list(slam.loops), list(slam.hook_errors), list(slam.pg_s)
        counts = funnel.counts()
        ate, ate_raw = mono_cell.slam_accuracy(slam, Rs, ts)
        s_gt = mono_cell.loop_scale_truth(slam, Rs, ts)
        # The Sim(3) layer on the card against the CPU: each loop detection
        # again, and the final graph's solve.
        replays = []
        for rec in recorder.calls:
            p_dev = recorder.replay(rec, dev)
            replays.append((rec, p_dev, recorder.hold_on_cpu(torch, rec, p_dev),
                            recorder.replay(rec, "cpu")))
        (s_dev, c_dev), (s_cpu, c_cpu) = (sim3_solve_on(torch, slam, d) for d in (dev, "cpu"))
        pools = graph_pools(torch, slam)
    finally:
        recorder.close()
        slam.close()
    n_timed = SLAM_FRAMES - MONO_SLAM_WARMUP
    med = float(np.median(per_frame))
    print(f"MonoSLAM 500-frame loop cell: {n_timed / elapsed:.3f} frames/s mean, "
          f"{1.0 / med:.3f} frames/s median per frame ({1e3 * med:.3f} ms) over {n_timed} "
          f"frames after {MONO_SLAM_WARMUP} warmup; join {join_s:.2f} s [{card}]")
    print(f"MonoSLAM: {n_kf} keyframes, {nodes} pose-graph nodes, {reinits} re-inits, "
          f"{len(loops)} loops closed "
          f"{[(lp['from'], lp['to'], lp['inliers'], round(lp['s_rel'], 4)) for lp in loops]}; "
          f"node scales {min(scales):.4f}-{max(scales):.4f}")
    print(solves.line("MonoSLAM", card))
    print(f"MonoSLAM programs: {pools[0]} of {pools[1]} captured; CUDA graph pools "
          f"{pools[2]} bytes reserved, {pools[3]} allocated [{card}]")
    print(f"MonoSLAM scale-aligned keyframe ATE: {ate:.6f} m after the Sim(3) correction "
          f"(limit {MONO_SLAM_ATE_LIMIT_M} m), {ate_raw:.6f} m raw; loops' s_rel from ground "
          f"truth {[round(g, 4) for g in s_gt]}")
    s_err = [abs(float(np.log(lp["s_rel"] / g))) for lp, g in zip(loops, s_gt)]
    near = sum(e <= MONO_SLAM_TRUTH_LOG_BAND for e in s_err)
    move = float(np.abs(np.log(scales)).max())
    need = MONO_SLAM_SCALE_MOVE * float(np.median(np.abs(np.log(s_gt)))) if s_gt else 0.0
    print(f"MonoSLAM scale correction: {near} of {len(loops)} loops' s_rel within "
          f"{MONO_SLAM_TRUTH_LOG_BAND} in log of ground truth's ratio (|log| "
          f"{[round(e, 4) for e in s_err]}); node scales reach |log s| {move:.4f} "
          f"(at least {need:.4f})")
    gaps = []
    for rec, p_dev, (inl_held, s_held), p_cpu in replays:
        gaps.append(dict(
            same_as_run=bool(int(p_dev[3]) == rec["inliers"] and p_dev[16] == rec["s_rel"]),
            inliers=(int(p_dev[3]), inl_held), s=(float(p_dev[16]), s_held),
            log_gap=abs(float(np.log(p_dev[16] / s_held))),
            cpu_pnp=(int(p_cpu[3]), round(float(p_cpu[16]), 6))))
    solve_gap = (float(np.abs(np.log(s_dev / s_cpu)).max()),
                 float(np.linalg.norm(c_dev - c_cpu, axis=-1).max()))
    shown = [(g["same_as_run"], g["inliers"], tuple(round(v, 6) for v in g["s"]),
              g["log_gap"]) for g in gaps]
    print(f"MonoSLAM loop detections again on the card, and their PnP pose held on the CPU "
          f"(same as the run; inliers card, CPU; s_rel card, CPU; |log| gap): {shown}")
    print(f"MonoSLAM loop detections with the CPU's own PnP on the same inputs and hypotheses "
          f"(inliers, s_rel): {[g['cpu_pnp'] for g in gaps]}")
    print(f"MonoSLAM final graph solved from the raw odometry on the card and on the CPU: "
          f"max |log s| gap {solve_gap[0]:.3g}, max camera-centre gap {solve_gap[1]:.3g} m, "
          f"node scales {float(s_dev.min()):.4f}-{float(s_dev.max()):.4f}")
    print(f"K1 launches during the mono SLAM run: {launches}, by call site "
          f"{dict(sorted(sites.counts.items()))}")
    check_funnel("MonoSLAM", counts, loops)
    if len(R_est) != SLAM_FRAMES or not (np.isfinite(R_est).all() and np.isfinite(t_est).all()):
        raise AssertionError("mono SLAM trajectory has the wrong length or non-finite poses")
    if errors:
        raise AssertionError(f"{len(errors)} keyframe hook errors, first: {errors[0]!r}")
    if not loops:
        raise AssertionError("no mono loop closed on the 500-frame orbit")
    if not (ate < ate_raw + MONO_SLAM_OVER_RAW_M and ate < MONO_SLAM_ATE_LIMIT_M):
        raise AssertionError(f"mono SLAM ATE {ate:.4f} m over the raw ATE {ate_raw:.4f} m "
                             f"+ {MONO_SLAM_OVER_RAW_M} m or over {MONO_SLAM_ATE_LIMIT_M} m")
    if not solves.accepted:
        raise AssertionError(f"no pose-graph solve accepted ({len(solves.times)} run)")
    if move < need:
        raise AssertionError(f"node scales reach |log s| {move:.4f}, below {need:.4f}")
    if near < MONO_SLAM_TRUTH_SHARE * len(loops):
        raise AssertionError(f"only {near} of {len(loops)} loops' s_rel within "
                             f"{MONO_SLAM_TRUTH_LOG_BAND} in log of ground truth's ratio")
    if len(replays) != len(loops) or not all(
            g["same_as_run"] and abs(g["inliers"][0] - g["inliers"][1]) <= 1
            and g["log_gap"] <= MONO_SLAM_HOLD_LOG_TOL for g in gaps):
        raise AssertionError(f"loop detections not reproduced on the card or not held on the "
                             f"CPU: {gaps}")
    if max(solve_gap) > MONO_SLAM_SOLVE_TOL:
        raise AssertionError(f"Sim(3) solve differs between the card and the CPU: {solve_gap}")
    if min(sites.counts.get(k, 0) for k in ("digest", "lk", "photo-BA")) <= 0:
        raise AssertionError(f"K1 never launched from the digest, LK or photometric BA: "
                             f"{sites.counts}")
    if launches != sum(sites.counts.values()):
        raise AssertionError("K1 launches not all attributed to a call site")
    return launches


def cli_phase(torch, extract, card):
    """Phase 8. `python -m viso_tpu_torch.run` on the card (its default
    device), 30 synthetic frames in each of stereo, slam, mono and
    mono-slam mode (the SLAM modes with a checkpoint every 8 frames);
    returns K1's launches."""
    import tempfile

    from viso_tpu_torch import run
    from viso_tpu_torch.data import native

    print(f"native decoder available: {native.available()}")
    launches = 0
    with tempfile.TemporaryDirectory(prefix="viso_cli_") as tmp:
        for mode in CLI_ATE_LIMITS:
            out = os.path.join(tmp, mode)
            argv = ["--dataset", "synthetic", "--mode", mode, "--max-frames", str(CLI_FRAMES),
                    "--out-dir", out]
            slam_mode = mode.endswith("slam")
            if slam_mode:
                argv += ["--checkpoint-every", "8"]
            extract.launch.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                summary = run.main(argv)
            launches += extract.launch.launches
            with open(os.path.join(out, "frames.jsonl")) as f:
                n_lines = sum(1 for _ in f)
            files = sorted(os.listdir(out))
            print(f"CLI --mode {mode}: ATE {summary['ate_rmse_m']:.6f} m (limit "
                  f"{CLI_ATE_LIMITS[mode]}), {summary['keyframes']} keyframes, device "
                  f"{summary['device']}, {n_lines} log lines, K1 launches "
                  f"{extract.launch.launches}, {time.perf_counter() - t0:.1f} s, files {files}, "
                  f"plots_skipped {summary.get('plots_skipped')!r} [{card}]")
            need = {"trajectory.txt", "frames.jsonl", "summary.json"} | (
                {"slam.npz"} if slam_mode else set())
            if not need <= set(files) or n_lines != CLI_FRAMES:
                raise AssertionError(f"--mode {mode}: files {files}, {n_lines} log lines")
            if not (summary["device"].startswith("cuda") and np.isfinite(summary["ate_rmse_m"])
                    and summary["ate_rmse_m"] < CLI_ATE_LIMITS[mode]):
                raise AssertionError(f"--mode {mode}: summary {summary}")
    return launches


def tool_json(module, argv):
    """A tool's `main(argv)` with its output captured: the JSON object of
    its last line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    if rc != 0:
        raise AssertionError(f"{module.__name__} {argv} returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def stress_frames(n):
    """tests/test_torch_stats_stress.py's corridor: n stereo pairs and
    ground truth (a prefix of a longer run's)."""
    from viso_tpu_torch.data import synthetic
    from viso_tpu_torch.geometry import camera

    h, w = STRESS_HW
    scene = synthetic.corridor_scene(np.random.default_rng(7), tex_size=512)
    Rs, ts = synthetic.forward_trajectory(n, step=0.2, yaw_rate=0.004)
    cam = camera.Intrinsics.create(**STRESS_INTR)
    pairs = [synthetic.make_stereo_pair(scene, cam, R, t, h, w, baseline=0.3)[:2]
             for R, t in zip(Rs, ts)]
    return pairs, Rs, ts


def stats_stress(dev, rng, max_delay, pairs, Rs, ts, hard_lag):
    """Phase 11 (a): StereoVO over the stress corridor on the card with
    every stats sample delayed (`utils/debug.delay_stats`), through the
    real pinned copies and events; `hard_lag` 0 is the engine's default.
    Returns (keyframe gaps, ATE, lost count, the engine's hard lag, the
    largest stats age seen at a decision)."""
    from viso_tpu_torch.slam.engine import StereoVO, VOConfig
    from viso_tpu_torch.utils import debug, metrics

    h, w = STRESS_HW
    cfg = VOConfig(height=h, width=w, max_keyframes=6, max_landmarks=384, num_features=192,
                   detect_grid=(4, 6), fast_threshold=15.0, baseline=0.3, max_disparity=48,
                   kf_min_gap=2, kf_max_gap=8, stats_max_lag=4, stats_hard_lag=hard_lag,
                   **STRESS_INTR)
    vo = debug.delay_stats(StereoVO(cfg, device=dev), rng, max_delay)
    age = 0
    try:
        for il, ir in pairs:
            vo.process(il, ir)
            if hasattr(vo, "_stats_frame"):
                age = max(age, vo.frame_idx - vo._stats_frame)
        R_est, t_est = vo.trajectory()
        gaps = np.diff([i for i, r in enumerate(vo.results) if r.is_keyframe])
        lost, hard = getattr(vo, "_lost_count", 0), vo._stats_hard_lag()
    finally:
        vo.close()
    if not (np.isfinite(R_est).all() and np.isfinite(t_est).all()):
        raise AssertionError("stats stress: non-finite poses")
    n = len(pairs)
    ate = metrics.ate_rmse(metrics.camera_centers(R_est, t_est),
                           metrics.camera_centers(Rs[:n], ts[:n]), align=True, with_scale=False)
    return gaps, float(ate), lost, hard, age


def tools_phase(torch, extract, orbit, Rs, ts, headline, dev, card):
    """Phase 11. The stats-delay scenario and the diagnostic and profiling
    tools on the card (`diag_drift` on the first frames of phase 6's
    orbit, `profile_frame` on those of phase 4's headline sequence);
    returns K1's launches during the phase."""
    from viso_tpu_torch.tools import (diag_drift, diag_mono_seam, diag_track_bias,
                                      profile_direct, profile_frame, profile_track)

    extract.launch.launches = 0
    # (a) keyframe cadence under random stats delays (0-10 frames, rng 3)
    # and under a fixed 10-frame delay. The random run is held at the
    # CPU's hard lag 4: at the card's default (`max(8, 2 *
    # stats_max_lag)`, 8 here) the delay it lets decisions see breaks the
    # test's 0.08 m in the JAX package too, given the same delays
    # (tests/stats_lag_parity.py, ROADMAP Queue 3). The fixed delay runs
    # at the default.
    class Fixed:
        def integers(self, lo, hi):
            return 10

    t0 = time.perf_counter()
    pairs, Rs_s, ts_s = stress_frames(60)
    for label, rng, frames, hard_lag in (
            ("random 0-10", np.random.default_rng(3), 60, STRESS_HARD_LAG),
            ("fixed 10", Fixed(), 40, 0)):
        gaps, ate, lost, hard, age = stats_stress(dev, rng, 10, pairs[:frames], Rs_s, ts_s,
                                                  hard_lag)
        held = hard_lag == STRESS_HARD_LAG
        print(f"stats delayed {label} frames over {frames} frames, hard lag {hard} "
              f"({'pinned' if hard_lag else 'default'}): keyframe gaps {gaps.tolist()}, ATE "
              f"{ate:.6f} m ({'held below' if held else 'not held;'} {STRESS_ATE_M} m), lost "
              f"count {lost}, oldest sample at a decision {age} frames [{card}]")
        if not (gaps.min() >= 2 and gaps.max() <= 8 and lost == 0
                and (not held or ate < STRESS_ATE_M)):
            raise AssertionError(f"stats stress {label}: gaps {gaps}, ATE {ate}, lost {lost}")
    print(f"phase 11a wall {time.perf_counter() - t0:.1f} s")

    # (b) per-frame drift of pure StereoVO on the loop orbit (phase 6's
    # frames), at the tool's defaults.
    t0 = time.perf_counter()
    on = ["--device", str(dev)]
    d = diag_drift.run(orbit[:DRIFT_FRAMES], Rs[:DRIFT_FRAMES], ts[:DRIFT_FRAMES],
                       diag_drift.config(), dev)
    print(f"diag_drift {d['frames']} frames: {d['keyframes']} keyframes, yaw bias per frame "
          f"tracked {d['tracked_yaw_bias_rad_per_frame']:.3e} rad, keyframe "
          f"{d['keyframe_yaw_bias_rad_per_frame']:.3e} rad; translation error per frame "
          f"tracked {d['tracked_trans_err_mean_m']:.6f} m, keyframe "
          f"{d['keyframe_trans_err_mean_m']:.6f} m; end rotation drift "
          f"{d['total_rot_drift_rad']:.6f} rad; n_tracked mean {d['mean_n_tracked']:.1f} min "
          f"{d['min_n_tracked']}; ATE {d['ate_rmse_m']:.6f} m; {d['seconds']:.1f} s [{card}]")
    if not d["ate_rmse_m"] < SLAM_ATE_LIMIT_M:
        raise AssertionError(f"diag_drift ATE {d['ate_rmse_m']} over {SLAM_ATE_LIMIT_M} m")
    print(f"phase 11b wall {time.perf_counter() - t0:.1f} s")

    # (c) the tracking chain's step bias from a perfect map, held on the
    # CPU over its first frames.
    t0 = time.perf_counter()
    b = tool_json(diag_track_bias, on)
    cpu_rows, _ = diag_track_bias.run("corridor", TRACK_BIAS_CPU_FRAMES, 0.15, 6, "cpu")
    gap = max(abs(r[k] - c[k]) for r, c in zip(b["rows"], cpu_rows)
              for k in ("direct_step_m", "refined_step_m"))
    for r in b["rows"]:
        print(f"diag_track_bias frame {r['frame']}: |t| gt {r['gt_step_m']:.4f} direct "
              f"{r['direct_step_m']:.4f} (err {r['direct_err_m']:.4f}) refined "
              f"{r['refined_step_m']:.4f} (err {r['refined_err_m']:.4f}) m, rot err "
              f"{r['rot_err_deg']:.3f} deg, {r['aligned']} aligned [{b['device']}]")
    print(f"diag_track_bias: {b['landmarks']} landmarks; card against the CPU over "
          f"{len(cpu_rows)} frames: max step gap {gap:.3g} m (tolerance {TRACK_BIAS_TOL_M})")
    if gap > TRACK_BIAS_TOL_M or max(r["refined_err_m"] for r in b["rows"]) > 0.05:
        raise AssertionError(f"diag_track_bias: gap {gap}, rows {b['rows']}")
    print(f"phase 11c wall {time.perf_counter() - t0:.1f} s")

    # (d) the mono scale seam (tests/test_slam.py's scenario).
    t0 = time.perf_counter()
    m = tool_json(diag_mono_seam, on)
    print(f"diag_mono_seam: {m['reinits']} re-inits, {m['hook_errors']} hook errors, loops "
          f"(cur, cand, s_rel, expected from the nodes' realized scales) "
          f"{[(lo['cur'], lo['cand'], round(lo['s_rel'], 4), round(lo['expected'], 4)) for lo in m['loops']]}, "
          f"node scales {m['s_min']:.4f}-{m['s_max']:.4f} [{m['device']}]")
    if m["hook_errors"] or m["reinits"] < 1:
        raise AssertionError(f"diag_mono_seam: {m}")
    print(f"phase 11d wall {time.perf_counter() - t0:.1f} s")

    # (e) the profiles at the headline's shapes. profile_frame's sequence
    # is the first 16 frames of phase 4's (the same corridor and path):
    # its first frame is rendered again and held equal.
    t0 = time.perf_counter()
    reps = ["--reps", str(PROFILE_REPS)] + on
    cfg = profile_frame.config()
    first = profile_frame.render(cfg, 1)[0]
    if not all(np.array_equal(a, b) for a, b in zip(first, headline[0])):
        raise AssertionError("profile_frame: its sequence is not phase 4's")
    f = profile_frame.profile(dev, PROFILE_REPS, frames=headline[:profile_frame.FRAMES])
    walls = {"profile_frame": time.perf_counter() - t0}
    tr = tool_json(profile_track, reps)
    walls["profile_track"] = time.perf_counter() - t0 - sum(walls.values())
    di = tool_json(profile_direct, reps)
    walls["profile_direct"] = time.perf_counter() - t0 - sum(walls.values())
    print("phase 11e walls: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    for tool, rows in (("profile_frame", f["stages"]), ("profile_track", tr["stages"]),
                       ("profile_direct", [r for lv in di["levels"]
                                           for r in (lv["gn_pass"], lv["k1"], lv["sampler"])]
                        + di["level0"])):
        for r in rows:
            print(f"{tool} {r['name']}: host {r['host_ms']:.3f} ms, wall {r['wall_ms']:.3f} "
                  f"ms, stream {r['stream_ms']:.3f} ms, device {r['device_ms']:.3f} ms, "
                  f"{r['kernels']} kernels ({r['tries']} profiler windows, fence {r['fence']}), "
                  f"{r['launches']} K1 [{card}]")
            # A one-kernel stage is held by its K1 count, not by the
            # profiler: one run read 0 kernels for the single op of "tiny
            # dispatch+sync", another 1.
            if r["name"].split()[-1] in ("dispatch+sync", "upload"):
                continue
            if "K1" in r["name"].split():
                if r["launches"] != 1:
                    raise AssertionError(f"{tool} {r['name']}: {r['launches']} K1 launches")
            elif not (r["device_ms"] > 0 and r["kernels"] > 0):
                raise AssertionError(f"{tool} {r['name']}: no device time: {r}")
    print(f"profile_frame stats fetch: copy alone {f['stats_copy_ms']:.3f} ms, after the track "
          f"is enqueued {f['stats_wait_ms']:.3f} ms; process() {f['process_ms']:.3f} ms per "
          f"frame over {f['process_frames']} frames [{card}]")
    k1 = {r["name"]: r["launches"] for r in f["stages"]}
    if not (k1["track"] == k1["track_eager"] == 6 and k1["templates"] == k1["templates_eager"] > 0
            and k1["stereo_kf"] == k1["stereo_kf_eager"] > 0):
        raise AssertionError(f"profile_frame: K1 launches by stage {k1}")
    print(f"phase 11e wall {time.perf_counter() - t0:.1f} s")
    return extract.launch.launches


def dist_phase(torch, extract, dev, card):
    """Phase 10. The distributed window BA (`parallel/dist_ba.py`) on the
    card: (a) bench_dist_ba's problem over an NCCL group of one rank,
    bit-equal to `ba.solve_impl`; (c) the mesh dryrun's StereoSLAM with
    distribute_ba on that group, against the same run without; (b) 2 and
    4 gloo ranks sharing the card, each within the solver tolerances of
    the single-device solve and equal to each other; (d) `multiprocess_ba
    --engine`'s StereoVO over 2 gloo ranks. Returns K1's launches in (c)
    and (d)."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from viso_tpu_torch.backend import ba
    from viso_tpu_torch.parallel import dist_ba, mesh as mesh_mod
    from viso_tpu_torch.tools import bench_dist_ba, multiprocess_ba
    from viso_tpu_torch.utils import metrics

    C, L, iters = DIST_CAMS, DIST_LANDMARKS, DIST_ITERS
    prob = bench_dist_ba.build_problem(C, L, dev)
    params = ba.BAParams(iters=iters, num_fixed=2)
    out_1, info_1 = ba.solve_impl(prob, params)
    t0 = time.perf_counter()
    for _ in range(bench_dist_ba.REPS):
        ba.solve_impl(prob, params)
    torch.cuda.synchronize()
    single_rate = bench_dist_ba.REPS * iters / (time.perf_counter() - t0)
    print(f"phase 10 problem: C={C} L={L} {iters} LM iterations, "
          f"{int(info_1['num_obs'])} observations, cost {float(info_1['initial_cost']):.6g} -> "
          f"{float(info_1['final_cost']):.6g}; ba.solve_impl {single_rate:.3f} LM iters/s "
          f"[{card}]")

    with tempfile.TemporaryDirectory(prefix="viso_nccl_") as tmp:
        dist.init_process_group(bench_dist_ba.backend_for(1, dev),
                                init_method=f"file://{tmp}/store", rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=60))
        try:
            # (a) NCCL, world size 1.
            mesh = mesh_mod.make_mesh(device=dev)
            solver = dist_ba.make_sharded_solver(mesh, params)
            out_s, info_s = solver(prob)
            equal = all(torch.equal(getattr(out_s, k), getattr(out_1, k))
                        for k in ("R", "t", "points")) and all(
                torch.equal(info_s[k], info_1[k]) for k in info_1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(bench_dist_ba.REPS):
                solver(prob)
            torch.cuda.synchronize()
            rate = bench_dist_ba.REPS * iters / (time.perf_counter() - t0)
            calls, nbytes, ms = solver.stats.per_iter(iters)
            print(f"(a) {dist.get_backend()} world 1: bit-equal to ba.solve_impl {equal}, "
                  f"{nbytes:.0f} all-reduce bytes and {calls:.0f} calls per LM iteration "
                  f"(psum_bytes_per_iter {dist_ba.psum_bytes_per_iter(C)}), all-reduce "
                  f"{ms:.6f} ms per iteration (CUDA events), {rate:.3f} LM iters/s [{card}]")
            if not (equal and nbytes == dist_ba.psum_bytes_per_iter(C) and calls == 2):
                raise AssertionError("(a): the NCCL world-1 solve is not ba.solve_impl's")

            # (c) the mesh dryrun's StereoSLAM on the NCCL group.
            frames, Rs, ts = multiprocess_ba.dryrun_frames()
            centres = {}
            for distribute in (False, True):
                vo = multiprocess_ba.dryrun_slam(dev, distribute_ba=distribute,
                                                 stats_deterministic=True)
                ba_calls = []
                run_ba = vo._run_window_ba

                def counted(*a, _run=run_ba, _calls=ba_calls):
                    # Each window BA alone on the host clock, the card idle
                    # before it and after it: device-wide synchronises while
                    # the loop worker runs, which meet no capture (the
                    # dispatch thread makes them all).
                    torch.cuda.synchronize()
                    t_ba = time.perf_counter()
                    out = _run(*a)
                    torch.cuda.synchronize()
                    _calls.append(1e3 * (time.perf_counter() - t_ba))
                    return out

                vo._run_window_ba = counted
                extract.launch.launches = 0
                t0 = time.perf_counter()
                for il, ir in frames:
                    vo.process(il, ir)
                vo.join()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches_c = extract.launch.launches
                progs = {n: vo._kernels.get(n) for n in ("ba", "ba_prep", "ba_solve", "ba_finish")}
                replays = {n: p.replays for n, p in progs.items() if p is not None}
                listing = {n: m for n, m in vo.program_listing().items() if n.startswith("ba")}
                t_fin = vo.t.cpu().numpy()
                R_est, t_est = vo.trajectory()
                centres[distribute] = metrics.camera_centers(R_est, t_est)
                nodes, kfs, errors = len(vo.pg_raw_R), len(vo.kf_order), vo.hook_errors
                on_group = distribute and vo._ba_mesh.group is not None
                vo.close()
                ate = metrics.ate_rmse(centres[distribute], metrics.camera_centers(Rs, ts),
                                       align=True, with_scale=False)
                print(f"(c) dryrun StereoSLAM distribute_ba={distribute}: {len(frames)} frames "
                      f"in {wall:.2f} s, {nodes} nodes, {kfs} keyframes, {len(ba_calls)} window "
                      f"BAs (on the NCCL group: {on_group}), BA ms per keyframe (host clock, "
                      f"synchronised) {[round(ms, 3) for ms in ba_calls]}, ATE {ate:.6f} m, K1 "
                      f"launches {launches_c}; programs replayed {replays}, run as {listing} "
                      f"[{card}]")
                # The sharded solve: eager at its first call, captured at its second.
                n_ba = len(ba_calls)
                want = ({"ba_prep": n_ba, "ba_solve": n_ba - 1, "ba_finish": n_ba} if distribute
                        else {"ba": n_ba})
                if replays != want:
                    raise AssertionError(f"(c) distribute_ba={distribute}: window BA programs "
                                         f"replayed {replays}, expected {want}")
                # __graft_entry__.py dryrun_multichip's assertions.
                if not (nodes >= 3 and np.isfinite(t_fin).all() and ba_calls and kfs >= 3
                        and abs(float(t_fin[2])) > 0.2 and not errors):
                    raise AssertionError(f"(c) distribute_ba={distribute}: nodes {nodes}, "
                                         f"t {t_fin}, BAs {len(ba_calls)}, errors {errors}")
            gap = float(np.abs(centres[True] - centres[False]).max())
            print(f"(c) centres with and without distribute_ba: max gap {gap:.3g} m "
                  f"(limit {DIST_SLAM_GAP_M})")
            if not (on_group and gap <= DIST_SLAM_GAP_M and launches_c > 0):
                raise AssertionError(f"(c): gap {gap} m, K1 launches {launches_c}")
        finally:
            dist.destroy_process_group()

    # (b) gloo ranks sharing the card.
    host = {k: getattr(out_1, k).cpu().numpy() for k in ("R", "t", "points")}
    tol = {"R": DIST_R_TOL, "t": DIST_T_TOL, "points": DIST_P_TOL}
    for world in (2, 4):
        t0 = time.perf_counter()
        rec, ranks = bench_dist_ba.run_world(world, dev, C, L, iters,
                                             timeout=DIST_SPAWN_TIMEOUT_S)
        gaps = {k: max(float(np.abs(r[k] - host[k]).max()) for r in ranks) for k in tol}
        same = all(np.array_equal(r[k], ranks[0][k]) for r in ranks for k in tol)
        cost_gap = max(abs(r["final_cost"] - float(info_1["final_cost"])) for r in ranks)
        print(f"(b) {rec['backend']} world {world}, ranks sharing one card: "
              f"{rec['allreduce_bytes_per_iter']:.0f} all-reduce bytes and "
              f"{rec['allreduce_calls_per_iter']:.0f} calls per LM iteration, all-reduce "
              f"{rec['allreduce_ms_per_iter']:.6f} ms per iteration (CUDA events), "
              f"{rec['lm_iters_per_s']:.3f} LM iters/s, {rec['landmarks_per_rank']} landmarks "
              f"per rank; gaps to the single solve R {gaps['R']:.3g} t {gaps['t']:.3g} points "
              f"{gaps['points']:.3g} cost {cost_gap:.3g} (final {rec['final_cost']:.6g}); "
              f"ranks equal {same}; {time.perf_counter() - t0:.1f} s [{card}]")
        if not (same and rec["ranks_share_one_card"]
                and rec["allreduce_bytes_per_iter"] == dist_ba.psum_bytes_per_iter(C)
                and all(gaps[k] <= tol[k] for k in tol)
                and cost_gap <= DIST_COST_RTOL * abs(float(info_1["final_cost"])) + DIST_COST_ATOL):
            raise AssertionError(f"(b) world {world}: {rec}, gaps {gaps}, cost {cost_gap}")

    # (d) multiprocess_ba --engine over 2 gloo ranks on the card.
    t0 = time.perf_counter()
    ranks = multiprocess_ba.launch(multiprocess_ba.engine_rank, 2, device=dev,
                                   timeout=DIST_SPAWN_TIMEOUT_S)
    launches_d = sum(r["k1_launches"] for r in ranks)
    same = all(np.array_equal(r["c_dist"], ranks[0]["c_dist"]) for r in ranks)
    for r in ranks:
        print(f"(d) engine rank {r['rank']} of {r['world']} (gloo, one card): ATE single "
              f"{r['ate_single']:.6f} m, distributed {r['ate_dist']:.6f} m, max centre gap "
              f"{r['max_diff']:.6f} m, K1 launches {r['k1_launches']}, the solve run as "
              f"{r['ba_solve']!r} [{card}]")
    print(f"(d) ranks equal {same}; {time.perf_counter() - t0:.1f} s")
    if not (same and all(multiprocess_ba.engine_ok(r) for r in ranks)
            and all(r["k1_launches"] > 0 and r["ba_solve"] == "eager (gloo)" for r in ranks)):
        raise AssertionError(f"(d): {ranks}")
    return launches_c + launches_d


def bit_equal(torch, a, b):
    """Equal shapes, dtypes and bits (a NaN equals itself)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.contiguous().view(ints), b.contiguous().view(ints)
    return torch.equal(a, b)


class ReplayCheck:
    """Phase 12. Wraps an engine's programs as it runs them: calls 2 to
    1 + REPLAY_CHECKS of each (replays of its captured graph) are each
    preceded by an eager call of the bare function on the same inputs.
    The replay's outputs are held against the eager call's bit for bit
    (no program accumulates with atomics), K1's counted launches against
    the eager call's, and the outputs against the previous checked call's
    (new inputs give new outputs: they are re-read, not baked into the
    graph). Keeps each program's last arguments for the timings."""

    def __init__(self, torch, vo, extract):
        from viso_tpu_torch.slam import programs

        self.torch, self.extract, self.flatten = torch, extract, programs.flatten
        self.real = vo._program
        self.calls = collections.Counter()
        self.rows, self.prev, self.args = [], {}, {}
        vo._program = self.program

    def done(self, names):
        return all(self.calls[n] >= 1 + REPLAY_CHECKS for n in names)

    def program(self, name):
        torch, launch = self.torch, self.extract.launch
        prog = self.real(name)

        def call(*args):
            self.calls[name] += 1
            self.args[name] = args
            if not 2 <= self.calls[name] <= 1 + REPLAY_CHECKS:
                return prog(*args)
            n0 = launch.launches
            ref = [x.clone() for x in self.flatten(prog.fn(*args))[0]]
            n_eager, n0 = launch.launches - n0, launch.launches
            out = prog(*args)
            n_replay = launch.launches - n0
            got = self.flatten(out)[0]
            prev = self.prev.get(name)
            self.rows.append(dict(
                name=name, call=self.calls[name], graphed=prog.graph is not None,
                replays=prog.replays, k1_eager=n_eager, k1_replay=n_replay,
                equal=len(got) == len(ref) and all(bit_equal(torch, a, b)
                                                   for a, b in zip(got, ref)),
                new=prev is None or not all(bit_equal(torch, a, b) for a, b in zip(got, prev))))
            self.prev[name] = [x.clone() for x in got]
            return out

        return call


def sync_error_frames(torch, vo, checker, tracked, keyframe):
    """A tracked frame, then a keyframe frame (the decision forced) with
    its window BA, under `set_sync_debug_mode("error")`: any call that
    synchronises the host with the card raises. The frames are on the
    card already (the upload may sync)."""
    ba = checker.calls["ba"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = vo.process(*tracked)
        vo._should_insert_keyframe = lambda n_tracked: True
        second = vo.process(*keyframe)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        vo.__dict__.pop("_should_insert_keyframe", None)
    torch.cuda.synchronize()
    if first.is_keyframe or not second.is_keyframe or checker.calls["ba"] != ba + 1:
        raise AssertionError(f"sync check frames: keyframe {first.is_keyframe} then "
                             f"{second.is_keyframe}, {checker.calls['ba'] - ba} BAs")


def program_times(torch, checker, names, card, label):
    """Each program as the engine runs it (replay) and its bare function
    (eager) on the program's last inputs: host enqueue, device ms and
    kernels (`utils/profiling.profile_stage`), K1's launches."""
    from viso_tpu_torch.geometry import extract
    from viso_tpu_torch.utils import profiling

    def k1():
        return extract.launch.launches

    rows = []
    for name in names:
        prog, args = checker.real(name), checker.args[name]
        for kind, fn in (("replay", lambda: prog(*args)), ("eager", lambda: prog.fn(*args))):
            r = profiling.profile_stage(f"{name} {kind}", fn, reps=PROGRAM_TIME_REPS, counter=k1)
            rows.append(r)
            print(f"{label} program {r['name']}: host {r['host_ms']:.3f} ms, device "
                  f"{r['device_ms']:.3f} ms, {r['kernels']} kernels ({r['tries']} profiler "
                  f"windows), stream {r['stream_ms']:.3f} ms, {r['launches']} K1 [{card}]")
            if not (r["device_ms"] > 0 and r["kernels"] > 0):
                raise AssertionError(f"{label} {r['name']}: no device time: {r}")
        if rows[-1]["launches"] != rows[-2]["launches"]:
            raise AssertionError(f"{label} {name}: K1 launches replay {rows[-2]['launches']} "
                                 f"!= eager {rows[-1]['launches']}")
    return rows


def check_replays(checker, names, label, card):
    rows = [r for r in checker.rows if r["name"] in names]
    for r in rows:
        print(f"{label} {r['name']} call {r['call']} (replay {r['replays']}): bit-equal to the "
              f"eager call {r['equal']}, K1 {r['k1_replay']} replayed / {r['k1_eager']} eager, "
              f"new outputs {r['new']} [{card}]")
    short = [n for n in names if sum(r["name"] == n for r in rows) != REPLAY_CHECKS]
    bad = [r for r in rows if not (r["graphed"] and r["equal"] and r["new"]
                                   and r["k1_replay"] == r["k1_eager"])]
    if short or bad:
        raise AssertionError(f"{label}: programs without {REPLAY_CHECKS} checked replays "
                             f"{short}, failing {bad}")


def programs_phase(torch, extract, headline, mono_frames, dev, card):
    """Phase 12. The engines' captured programs: at the headline's shape
    (StereoVO: track, templates, stereo keyframe, reprojection BA) and at
    the mono cell's (MonocularVO: track, templates, mono keyframe,
    photometric BA), REPLAY_CHECKS replays of each held against eager
    calls (`ReplayCheck`); a tracked frame and a keyframe frame with its
    BA under `set_sync_debug_mode("error")`; then each program's host,
    device ms and kernels, replayed and eager."""
    from viso_tpu_torch.slam.engine import MonocularVO, StereoVO, VOConfig
    from viso_tpu_torch.tools import mono_cell

    for label, vo, frames, names in (
            ("headline", StereoVO(headline_config(VOConfig), device=dev), headline,
             ("track", "templates", "stereo_kf", "ba")),
            ("mono cell", MonocularVO(mono_cell.config(), device=dev),
             [(img,) for img in mono_frames[:PROGRAM_MONO_FRAMES]],
             ("track", "templates", "mono_kf", "ba"))):
        t0 = time.perf_counter()
        checker = ReplayCheck(torch, vo, extract)
        try:
            staged = []
            for f in frames:
                up = vo.to_device(*f)
                staged.append(up if isinstance(up, tuple) else (up,))
            torch.cuda.synchronize()
            i = 0
            while i < len(staged) - 2 and not (checker.done(names) and vo.state == "tracking"):
                vo.process(*staged[i])
                i += 1
            check_replays(checker, names, label, card)
            sync_error_frames(torch, vo, checker, staged[i], staged[i + 1])
            print(f"{label}: {i} frames, then a tracked frame and a keyframe frame with its "
                  f"window BA under set_sync_debug_mode('error'): no synchronising call "
                  f"[{card}]")
            program_times(torch, checker, names, card, label)
        finally:
            vo.close()
        print(f"phase 12 {label} wall {time.perf_counter() - t0:.1f} s")


class LoopReplayCheck:
    """Phase 13. Wraps the programs a SLAM engine's loop layer makes
    (`slam/programs.Cache`, on whichever thread calls them): the first
    REPLAY_CHECKS calls of each that replay its captured graph (a cached
    program runs eagerly at its first call and captures at its second on
    the dispatch thread; the worker's run eagerly until a drain made
    their capture), of a solve once `check_solves` is set, are each preceded by an eager call of its bare function on
    the same staged inputs. The digest and the detection's segments are held
    against it bit for bit (neither accumulates with atomics); a solve
    within LOOP_SOLVE_TOL, since its scatter-adds (`index_add_`) use
    atomics, whose order differs from call to call. The digest's K1
    launches are held against the eager call's, the outputs against the previous checked
    call's (new inputs give new outputs). Keeps each program's last staged
    arguments for the timings."""

    def __init__(self, torch, slam, extract):
        from viso_tpu_torch.slam import programs

        self.torch, self.extract, self.programs = torch, extract, programs
        self.cache = slam._loop_programs
        self.real_get = self.cache.get
        self.rows, self.prev, self.args, self.eager_gaps = [], {}, {}, {}
        self.check_solves = False
        self.cache.get = self.get

    @staticmethod
    def gap(a, b):
        return max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b)
                   if x.is_floating_point())

    @staticmethod
    def label(key):
        return f"{key[0]} {key[1]}x{key[2]}" if key[0].startswith("pose_graph") else key[0]

    def checked(self, name):
        return sum(r["name"] == name for r in self.rows)

    def get(self, key, fn, **kw):
        prog = self.real_get(key, fn, **kw)
        torch, launch, name = self.torch, self.extract.launch, self.label(key)

        def call(*args):
            self.args[name] = (prog, args)
            # The first REPLAY_CHECKS calls that replay (the worker's
            # programs replay once a drain made their capture); of a solve,
            # those driven after the run (`drive_solves`).
            check = (prog.graph is not None and self.checked(name) < REPLAY_CHECKS
                     and (self.check_solves or not key[0].startswith("pose_graph")))
            if not check:
                return prog(*args)
            prog._stage(args)
            n0 = launch.launches
            ref = [x.clone() for x in self.programs.flatten(
                prog.fn(*self.programs.unflatten(prog.spec, prog.inputs)))[0]]
            n_eager, n0 = launch.launches - n0, launch.launches
            out = prog(*args)
            n_replay = launch.launches - n0
            if not prog.counted:
                # A worker's program holds no K1, and the dispatch thread's
                # launches move the counter meanwhile.
                n_eager = n_replay = None
            got = self.programs.flatten(out)[0]
            if key[0].startswith("pose_graph"):
                gap = self.gap(got, ref)
                equal = gap <= LOOP_SOLVE_TOL
                if name not in self.eager_gaps:
                    # Two eager solves on the same inputs, for scale.
                    again = self.programs.flatten(
                        prog.fn(*self.programs.unflatten(prog.spec, prog.inputs)))[0]
                    self.eager_gaps[name] = self.gap(again, ref)
            else:
                gap = None
                equal = len(got) == len(ref) and all(bit_equal(torch, a, b)
                                                     for a, b in zip(got, ref))
            prev = self.prev.get(name)
            self.rows.append(dict(
                name=name, call=prog.calls, graphed=prog.graph is not None,
                stream=torch.cuda.current_stream(prog.device),
                worker=threading.current_thread() is not threading.main_thread(),
                replays=prog.replays, k1_eager=n_eager, k1_replay=n_replay, equal=equal,
                gap=gap, new=prev is None or not all(bit_equal(torch, a, b)
                                                     for a, b in zip(got, prev))))
            self.prev[name] = [x.clone() for x in got]
            return out

        return call


def drive_solves(torch, slam, mono, n):
    """n solves of the run's last graph through the loop layer's program of
    its bucket, on the worker's thread and stream, each from the node
    estimates moved by seeded noise (0.01 rad, 0.01 m), then one more
    under `set_sync_debug_mode("error")`; `join()` after each, which makes
    a capture the worker asked for. Returns the final costs."""
    from viso_tpu_torch.backend import pose_graph, pose_graph_sim3
    from viso_tpu_torch.data.synthetic import so3_exp

    rng = np.random.default_rng(0)

    def task(R, t, check):
        with torch.cuda.stream(slam._loop_stream):
            if check:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                if mono:
                    _, info = pose_graph_sim3.solve_padded(
                        slam.pg_s, R, t, slam.pg_edges, pose_graph_sim3.PGParams(iters=25),
                        device=slam.device, programs=slam._loop_programs)
                else:
                    _, info = pose_graph.solve_padded(
                        R, t, slam.pg_edges, pose_graph.PGParams(iters=25),
                        device=slam.device, programs=slam._loop_programs)
            finally:
                if check:
                    torch.cuda.set_sync_debug_mode(0)
            return float(info["final_cost"])

    costs = []
    for k in range(n + 1):
        R = [so3_exp(rng.normal(0, 0.01, 3)).astype(np.float32) @ r for r in slam.pg_R]
        t = [v + rng.normal(0, 0.01, 3).astype(np.float32) for v in slam.pg_t]
        costs.append(slam._hook_pool.submit(task, R, t, k == n).result())
        slam.join()
    return costs


def sync_error_digest(torch, slam):
    """The dispatch side of a keyframe hook (the digest program, its
    copies, the copies to the host) under `set_sync_debug_mode("error")`
    on the dispatch thread; the hook itself is not enqueued."""
    pool, hooks = slam._hook_pool, []
    slam._hook_pool = type("Pool", (), {"submit": lambda self, fn, *a: hooks.append(a)})()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        slam._post_keyframe(slam.kf_order[-1], slam.last_pyr)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        slam._hook_pool = pool
    torch.cuda.synchronize()
    if len(hooks) != 1:
        raise AssertionError("the keyframe hook's dispatch side enqueued no hook")


def loop_programs_phase(torch, extract, orbit, dev, card):
    """Phase 13. The SLAM loop layer's programs: StereoSLAM on phase 6's
    cell and MonoSLAM on phase 9's, each until every detection segment has
    had REPLAY_CHECKS checked replays (`LoopReplayCheck`), then 2 +
    REPLAY_CHECKS solves of the run's last graph through the program of
    its bucket on the worker; a keyframe hook's digest on the dispatch thread and a
    solve on the worker under `set_sync_debug_mode("error")`; then each
    program's host, device ms and kernels, replayed and eager."""
    from viso_tpu_torch.geometry import extract as k1
    from viso_tpu_torch.slam.full import StereoSLAM
    from viso_tpu_torch.slam.loop_closure import LoopParams
    from viso_tpu_torch.slam.mono_full import MonoSLAM
    from viso_tpu_torch.tools import diag_loops, mono_cell
    from viso_tpu_torch.utils import profiling

    for label, make, frames, detect, solve in (
            ("StereoSLAM", lambda: StereoSLAM(diag_loops.stereo_config(),
                                              LoopParams(min_inliers=40, max_correction_m=4.0),
                                              device=dev),
             orbit, ("detect_match", "detect_dlt", "detect_dlt_sign", "detect_pnp"),
             "pose_graph"),
            ("MonoSLAM", lambda: MonoSLAM(mono_cell.slam_config(), mono_cell.slam_loop_params(),
                                          device=dev),
             [(il,) for il, _ in orbit],
             ("detect_match", "detect_dlt", "detect_dlt_sign", "detect_pnp_sim3",
              "detect_umeyama"), "pose_graph_sim3")):
        t0 = time.perf_counter()
        slam = make()
        checker = LoopReplayCheck(torch, slam, extract)
        try:
            n = 0
            for f in frames:
                slam.process(*f)
                n += 1
                if n % 16 == 0 and slam._hook_last is not None:
                    slam._hook_last.result()    # the worker, caught up
                    if min(checker.checked(d) for d in detect) >= REPLAY_CHECKS:
                        break
            slam.join()
            if slam.hook_errors:
                raise AssertionError(f"{label}: hook errors {slam.hook_errors}")
            checker.check_solves = True
            costs = drive_solves(torch, slam, label == "MonoSLAM", 2 + REPLAY_CHECKS)
            sync_error_digest(torch, slam)
            rows = checker.rows
            for r in rows:
                gap = "" if r["gap"] is None else f" (max gap {r['gap']:.3g})"
                print(f"{label} {r['name']} call {r['call']} (replay {r['replays']}): equal to "
                      f"the eager call {r['equal']}{gap}, K1 {r['k1_replay']} replayed / "
                      f"{r['k1_eager']} eager, new outputs {r['new']} [{card}]")
            print(f"{label} solves: largest gap between two eager solves on the same "
                  f"inputs {checker.eager_gaps} [{card}]")
            names = list(detect) + ["digest"]
            solved = sorted({r["name"] for r in rows if r["name"].startswith(solve + " ")})
            short = [x for x in names + solved
                     if sum(r["name"] == x for r in rows) != REPLAY_CHECKS]
            # A program replays on its caller's stream: the worker's own on
            # the worker, the default one on the dispatch thread (the digest,
            # and join()'s last solve); each thread's captures ran on a
            # stream of their own, which no eager work uses.
            bad = [r for r in rows if not (
                r["graphed"] and r["equal"] and r["new"] and r["k1_replay"] == r["k1_eager"]
                and r["stream"] == (slam._loop_stream if r["worker"]
                                    else torch.cuda.current_stream(dev)))]
            capture_streams = set(slam._loop_programs._streams.values())
            if (len(capture_streams) != 2 or slam._loop_stream in capture_streams
                    or torch.cuda.current_stream(dev) in capture_streams):
                bad.append(dict(capture_streams=capture_streams))
            if short or bad or not solved or not all(np.isfinite(costs)):
                raise AssertionError(f"{label}: programs without {REPLAY_CHECKS} checked "
                                     f"replays {short}, failing {bad}, solves {solved}, "
                                     f"costs {costs}")
            print(f"{label}: {n} frames; a keyframe hook's digest on the dispatch thread and "
                  f"a solve on the worker ({solved[-1]}) under set_sync_debug_mode('error'): "
                  f"no synchronising call [{card}]")
            for name in names + solved[-1:]:
                prog, args = checker.args[name]

                def staged(prog=prog):
                    return prog.fn(*checker.programs.unflatten(prog.spec, prog.inputs))

                reps = 1 if name.startswith("pose_graph") else PROGRAM_TIME_REPS
                for kind, fn in (("replay", lambda: prog(*args)), ("eager", staged)):
                    r = profiling.profile_stage(f"{name} {kind}", fn, reps=reps,
                                                counter=lambda: k1.launch.launches)
                    print(f"{label} program {r['name']}: host {r['host_ms']:.3f} ms, device "
                          f"{r['device_ms']:.3f} ms, {r['kernels']} kernels ({r['tries']} "
                          f"profiler windows), stream {r['stream_ms']:.3f} ms, {r['launches']} "
                          f"K1 [{card}]")
                    if not (r["device_ms"] > 0 and r["kernels"] > 0):
                        raise AssertionError(f"{label} {r['name']}: no device time: {r}")
            pools = graph_pools(torch, slam)
            print(f"{label} programs: {pools[0]} of {pools[1]} captured; CUDA graph pools "
                  f"{pools[2]} bytes reserved, {pools[3]} allocated [{card}]")
        finally:
            slam.close()
        print(f"phase 13 {label} wall {time.perf_counter() - t0:.1f} s")


class SyncSites:
    """Synchronising calls while it is entered (`set_sync_debug_mode
    ("warn")`): their count, and each call's innermost three frames in the
    repository as "file:line <- file:line <- file:line"."""

    def __init__(self, torch):
        self.torch, self.sites, self.count = torch, collections.Counter(), 0

    def __enter__(self):
        import traceback

        def show(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" not in str(message).lower():
                return
            self.count += 1
            stack = [f for f in traceback.extract_stack()[:-1]
                     if f.filename.startswith(str(REPO)) and "chip_smoke" not in f.filename]
            self.sites[" <- ".join(f"{os.path.relpath(f.filename, REPO)}:{f.lineno}"
                                   for f in stack[::-1][:3])] += 1

        self.warnings = warnings.catch_warnings()
        self.warnings.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = show
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode(0)
        self.warnings.__exit__(*exc)


class InitReplayCheck:
    """Phase 14. Wraps the programs a MonocularVO's bootstrap makes (its
    `programs.Cache`): calls 3 to 2 + REPLAY_CHECKS of each (replays: a
    cached program runs eagerly at its first call and captures at its
    second) are each preceded by an eager call of its bare function on the
    same staged inputs, held against it bit for bit with its K1 launches
    (the init chain's LK). The eager calls' launches are taken back from
    K1's counter: they compare, they are not the path's."""

    def __init__(self, torch, vo, extract):
        from viso_tpu_torch.slam import programs

        self.torch, self.extract, self.programs = torch, extract, programs
        self.cache, self.real_get, self.rows = vo._cache, vo._cache.get, []
        self.cache.get = self.get

    def done(self, programs: int) -> bool:
        """Whether each of `programs` programs has had its checked replays."""
        keys = collections.Counter(r["key"] for r in self.rows)
        return len(keys) == programs and min(keys.values()) >= REPLAY_CHECKS

    def get(self, key, fn, **kw):
        prog = self.real_get(key, fn, **kw)
        torch, launch, flatten = self.torch, self.extract.launch, self.programs.flatten

        def call(*args):
            if not 2 <= prog.calls <= 1 + REPLAY_CHECKS:
                return prog(*args)
            prog._stage(args)
            n0 = launch.launches
            ref = [x.clone() for x in flatten(prog.fn(*self.programs.unflatten(
                prog.spec, prog.inputs)))[0] if isinstance(x, torch.Tensor)]
            n_eager = launch.launches - n0
            launch.launches = n0
            out = prog(*args)
            n_replay = launch.launches - n0
            got = [x for x in flatten(out)[0] if isinstance(x, torch.Tensor)]
            self.rows.append(dict(
                key=key, name=key[0], call=prog.calls, replays=prog.replays, k1_eager=n_eager,
                k1_replay=n_replay, equal=prog.graph is not None and len(got) == len(ref)
                and all(bit_equal(torch, a, b) for a, b in zip(got, ref))))
            return out

        return call


@contextlib.contextmanager
def error_except_solvers(torch, vo, ran):
    """`set_sync_debug_mode("error")` around the bootstrap's programs as the
    engine calls them: the init chain's LK (`init_track`) and
    `twoview.initialize` (its draws and segments), but for the two-view
    solvers (BOOT_SOLVERS, which read their status on the host), run in
    mode 0. `ran` collects what ran under it."""
    from viso_tpu_torch.ops import twoview

    real_run, real_init = vo._cache.run, twoview.initialize
    real_solvers = {n: getattr(torch.linalg, n) for n in BOOT_SOLVERS}

    def strict(name, fn):
        def call(*args, **kw):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            ran.append(name)
            return out
        return call

    def solver(name):
        def call(*args, **kw):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return real_solvers[name](*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return call

    def run(name, fn, statics, *args, **kw):
        call = real_run if name != "init_track" else strict(name, real_run)
        return call(name, fn, statics, *args, **kw)

    vo._cache.run = run
    twoview.initialize = strict("twoview.initialize", real_init)
    for n in BOOT_SOLVERS:
        setattr(torch.linalg, n, solver(n))
    try:
        yield
    finally:
        del vo._cache.run
        twoview.initialize = real_init
        for n, f in real_solvers.items():
            setattr(torch.linalg, n, f)


def bootstrap_run(torch, extract, frames, dev, mode):
    """MonocularVO on the mono cell's first BOOT_FRAMES frames, re-inits
    forced at BOOT_REINITS, its bootstrap eager ("eager") or through its
    programs ("programs"), each frame's synchronising calls counted
    (`SyncSites`) on the host clock; or through its programs checked by
    `InitReplayCheck`, and then a chained init frame under
    `error_except_solvers` ("checked"). Returns (engine, per-frame (syncs,
    host ms), sync sites of the init frames, the checker, what ran under the
    error mode, K1's launches)."""
    from viso_tpu_torch.ops import ransac
    from viso_tpu_torch.slam.engine import MonocularVO
    from viso_tpu_torch.tools import mono_cell

    vo = MonocularVO(mono_cell.config(), device=dev)
    lost = vo._update_lost
    vo._update_lost = lambda n: vo.frame_idx in BOOT_REINITS or lost(n)
    checker, strict_ran = None, []
    if mode == "checked":
        checker = InitReplayCheck(torch, vo, extract)
    elif mode == "eager":
        vo._cache.run = lambda name, fn, statics, *args, counted=False: ransac.eager(
            name, fn, statics, *args)
    staged = [vo.to_device(f) for f in frames[:BOOT_FRAMES]]
    torch.cuda.synchronize()
    per_frame, sites = [], collections.Counter()
    extract.launch.launches = 0
    try:
        for img in staged:
            if mode != "checked":
                torch.cuda.synchronize()
                with SyncSites(torch) as sync:
                    t0 = time.perf_counter()
                    vo.process(img)
                    per_frame.append((sync.count, 1e3 * (time.perf_counter() - t0)))
                if vo.results[-1].state == "init":
                    sites.update(sync.sites)
            elif (strict_ran != STRICT_RAN and vo.state == "init" and vo.init_ref is not None
                  and checker.done(BOOT_PROGRAMS)):
                # Replays only (the checks are done); a reseed frame runs
                # no two-view step, and the next frame tries again.
                strict_ran.clear()
                with error_except_solvers(torch, vo, strict_ran):
                    vo.process(img)
            else:
                vo.process(img)
        torch.cuda.synchronize()
        launches = extract.launch.launches
    finally:
        vo.close()
    return vo, per_frame, sites, checker, strict_ran, launches


def bootstrap_phase(torch, extract, mono_frames, dev, card):
    """Phase 14. (a) The monocular bootstrap's programs: MonocularVO on the
    mono cell's first frames with forced re-inits, the bootstrap eager and
    through its programs (synchronising calls and host ms per init frame,
    the calls' sites, the poses against each other), then through its
    programs with each replay held bit-equal to an eager call and a
    chained init frame under `error_except_solvers`. (b) Phase 10's
    problem over an NCCL group of one rank as the `ba_solve` program:
    eager, captured, replayed, each bit-equal to `ba.solve_impl`; LM
    iters/s replayed and eager. Returns K1's launches in (a)'s run through
    the programs."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from viso_tpu_torch.backend import ba
    from viso_tpu_torch.parallel import dist_ba, mesh as mesh_mod
    from viso_tpu_torch.slam import programs
    from viso_tpu_torch.tools import bench_dist_ba

    t0 = time.perf_counter()
    runs = {mode: bootstrap_run(torch, extract, mono_frames, dev, mode)
            for mode in ("eager", "programs", "checked")}
    for label in ("eager", "programs"):
        vo, per_frame, sites, _, _, _ = runs[label]
        states = [r.state for r in vo.results]
        init = [f for f, st in zip(per_frame, states) if st == "init"]
        print(f"(a) MonocularVO bootstrap {label}: {len(init)} init frames of {len(states)} "
              f"(re-inits forced at {BOOT_REINITS}: {vo.num_reinits}), synchronising calls per "
              f"init frame mean {np.mean([n for n, _ in init]):.2f} (min "
              f"{min(n for n, _ in init)}, max {max(n for n, _ in init)}), host ms per init "
              f"frame median {np.median([ms for _, ms in init]):.3f} mean "
              f"{np.mean([ms for _, ms in init]):.3f} [{card}]")
        print(f"(a) {label}: synchronising calls in the init frames by site: "
              f"{dict(sites.most_common())}")
        if not (vo.num_reinits == len(BOOT_REINITS) and states[-1] == "tracking"
                and "init" in states[BOOT_REINITS[-1] + 1:]):
            raise AssertionError(f"(a) {label}: no bootstrap after a forced re-init: {states}")
    vo, _, _, checker, strict_ran, _ = runs["checked"]
    for r in checker.rows:
        print(f"(a) {r['name']} call {r['call']} (replay {r['replays']}): bit-equal to the eager "
              f"call {r['equal']}, K1 {r['k1_replay']} replayed / {r['k1_eager']} eager [{card}]")
    names = {key[0] for key in vo._cache.programs}
    bad = [r for r in checker.rows if not (r["equal"] and r["k1_replay"] == r["k1_eager"])]
    poses = {label: runs[label][0].trajectory() for label in runs}
    gaps = {label: max(float(np.abs(a - b).max()) for a, b in zip(poses[label], poses["eager"]))
            for label in ("programs", "checked")}
    launches = runs["programs"][5]
    print(f"(a) {len(vo._cache.programs)} bootstrap programs {sorted(names)}; largest pose gap "
          f"to the eager run {gaps}; a chained init frame under set_sync_debug_mode('error') "
          f"but for {BOOT_SOLVERS}: {strict_ran}; K1 launches through the programs {launches}; "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    if (bad or not checker.done(BOOT_PROGRAMS) or len(vo._cache.programs) != BOOT_PROGRAMS
            or launches <= 0
            or strict_ran != STRICT_RAN):
        raise AssertionError(f"(a): checked {len(checker.rows)} replays, failing {bad}, "
                             f"strict {strict_ran}, launches {launches}")

    # (b) phase 10's solve as the ba_solve program over NCCL, world 1.
    t0 = time.perf_counter()
    C, L, iters = DIST_CAMS, DIST_LANDMARKS, DIST_ITERS
    prob = bench_dist_ba.build_problem(C, L, dev)
    params = ba.BAParams(iters=iters, num_fixed=2)
    out_1, info_1 = ba.solve_impl(prob, params)
    with tempfile.TemporaryDirectory(prefix="viso_nccl_") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=60))
        try:
            solver = dist_ba.ShardedSolver(mesh_mod.make_mesh(device=dev), params)
            program = solver.program(programs.Cache(dev))
            equal = []
            for _ in range(2 + REPLAY_CHECKS):
                out, info = program(prob)
                equal.append(all(bit_equal(torch, getattr(out, k), getattr(out_1, k))
                                 for k in ("R", "t", "points"))
                             and all(bit_equal(torch, info[k], info_1[k]) for k in info_1))
            calls, nbytes, _ = solver.stats.per_iter(iters)
            replays = program.replays
            rates = {}
            for kind, fn in (("replayed", lambda: program(prob)), ("eager", lambda: solver(prob)),
                             ("eager", lambda: solver(prob)), ("replayed", lambda: program(prob))):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for _ in range(bench_dist_ba.REPS):
                    fn()
                torch.cuda.synchronize()
                rates.setdefault(kind, []).append(
                    bench_dist_ba.REPS * iters / (time.perf_counter() - t1))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            program(prob)
            end.record()
            end.synchronize()
            replay_ms = start.elapsed_time(end)
        finally:
            dist.destroy_process_group()
    print(f"(b) ba_solve over NCCL world 1 (C={C} L={L}, {iters} LM iterations): calls 1-"
          f"{2 + REPLAY_CHECKS} (eager, capture, replays) bit-equal to ba.solve_impl {equal}; "
          f"replays {replays}; all-reduce {nbytes:.0f} bytes in {calls:.0f} calls per LM "
          f"iteration (restored after a replay); LM iters/s replayed {rates['replayed']} eager "
          f"{rates['eager']} (host clock, {bench_dist_ba.REPS} solves a turn, in turns replay, "
          f"eager, eager, replay); one "
          f"replayed solve {replay_ms:.3f} ms (CUDA events); {time.perf_counter() - t0:.1f} s "
          f"[{card}]")
    if not (all(equal) and program.graph is not None and replays == 1 + REPLAY_CHECKS
            and (calls, nbytes) == (2, dist_ba.psum_bytes_per_iter(C))):
        raise AssertionError(f"(b): equal {equal}, replays {replays}, "
                             f"calls {calls} bytes {nbytes}")
    return launches


def dist_slam_phase(torch, orbit, Rs, ts, dev, card):
    """Phase 10(e). The 500-frame loop SLAM cell's configuration
    (`diag_loops.stereo_config()`, `LoopParams(min_inliers=40,
    max_correction_m=4.0)`) with distribute_ba and stats_deterministic on
    phase 6's orbit: at world size 1 in this process, then over
    DIST_CELL_RANKS spawned gloo ranks sharing the card
    (`multiprocess_ba.slam_rank`), rank 0 synchronising the whole device
    after every `process()` call while its loop worker runs. Returns K1's
    launches (every run)."""
    import dataclasses

    from viso_tpu_torch.slam.loop_closure import LoopParams
    from viso_tpu_torch.tools import diag_loops, multiprocess_ba
    from viso_tpu_torch.utils import metrics

    cfg = dataclasses.replace(diag_loops.stereo_config(), distribute_ba=True,
                              stats_deterministic=True)
    lp = LoopParams(min_inliers=40, max_correction_m=4.0)
    frames = np.stack([np.stack(pair) for pair in orbit])
    c_gt = metrics.camera_centers(Rs, ts)
    t0 = time.perf_counter()
    world1 = multiprocess_ba.slam_rank(dev, frames, cfg, lp)
    t1 = time.perf_counter()
    ranks = multiprocess_ba.launch(multiprocess_ba.slam_rank, DIST_CELL_RANKS,
                                   args=(frames, cfg, lp, True), device=dev, backend="gloo",
                                   timeout=DIST_CELL_TIMEOUT_S)
    t2 = time.perf_counter()
    raw_equal, rank_gap = multiprocess_ba.slam_ranks_gap(ranks)
    bad = []
    for r in [world1] + ranks:
        pf = np.asarray(r["per_frame_s"])
        ate = metrics.ate_rmse(r["c"], c_gt, align=True, with_scale=False)
        band = (float(np.abs(r["c"] - world1["c"]).max()),
                float(np.abs(r["c_raw"] - world1["c_raw"]).max()))
        apart = np.flatnonzero(np.abs(r["c_raw"] - world1["c_raw"]).max(axis=-1) > 1e-3)
        sync = " (whole device synchronised after every frame)" if r["world"] > 1 and \
            r["rank"] == 0 else ""
        print(f"(e) loop SLAM cell, rank {r['rank']} of {r['world']}{sync}: "
              f"{len(pf) / pf.sum():.3f} frames/s mean, {1.0 / float(np.median(pf)):.3f} median "
              f"(host clock per process() call), {r['keyframes']} keyframes in the window, "
              f"{r['nodes']} nodes, {r['window_bas']} window BAs (solve {r['ba_solve']}), "
              f"{len(r['loops'])} loops {r['loops']}, ATE {ate:.6f} m (limit "
              f"{SLAM_ATE_LIMIT_M}), corrected / raw centres {band[0]:.3g} / {band[1]:.3g} m "
              f"from world 1 (limit {DIST_CELL_BAND_M}; raw first 1 mm apart at frame "
              f"{apart[0] if apart.size else None}), K1 launches {r['k1_launches']}, "
              f"{len(r['drained'])} drained captures, hook errors {r['hook_errors']} [{card}]")
        if not (len(r["c"]) == SLAM_FRAMES and np.isfinite(r["c"]).all() and r["loops"]
                and not r["hook_errors"] and ate < SLAM_ATE_LIMIT_M and r["k1_launches"] > 0
                and max(band) <= DIST_CELL_BAND_M):
            bad.append(r["rank"] if r["world"] > 1 else "world 1")
    print(f"(e) {DIST_CELL_RANKS} gloo ranks sharing one card: raw trajectories equal "
          f"{raw_equal}, corrected centres within {rank_gap:.3g} m of rank 0's (limit "
          f"{DIST_CELL_RANK_GAP_M}); world 1 {t1 - t0:.1f} s, the ranks {t2 - t1:.1f} s "
          f"[{card}]")
    if bad or not raw_equal or rank_gap > DIST_CELL_RANK_GAP_M or not all(
            r["ba_solve"] == "eager (gloo)" for r in ranks):
        raise AssertionError(f"(e): failing runs {bad}, raw equal {raw_equal}, rank gap "
                             f"{rank_gap} m")
    return world1["k1_launches"] + sum(r["k1_launches"] for r in ranks)


def dist_cli_phase(dev, card):
    """Phase 10(f). `run.main(["--distribute", "--mode", "mono-slam", ...])`
    on the CLI's synthetic run (240x320, CLI_FRAMES frames) over 2 spawned
    gloo ranks sharing the card (`multiprocess_ba.cli_rank`): mono reaches
    tracking on both, the ranks' trajectories equal, each run within the
    CLI's bound, no hook error. Returns K1's launches."""
    import tempfile

    from viso_tpu_torch.tools import multiprocess_ba

    with tempfile.TemporaryDirectory(prefix="viso_dist_cli_") as tmp:
        argv = ["--distribute", "--dataset", "synthetic", "--mode", "mono-slam",
                "--max-frames", str(CLI_FRAMES), "--out-dir", tmp]
        t0 = time.perf_counter()
        ranks = multiprocess_ba.launch(multiprocess_ba.cli_rank, 2, args=(argv,), device=dev,
                                       backend="gloo", timeout=DIST_SPAWN_TIMEOUT_S)
        wall = time.perf_counter() - t0
        dirs = [tmp, os.path.join(tmp, "rank1")]
        trajs = [np.loadtxt(os.path.join(d, "trajectory.txt")) for d in dirs]
        states = []
        for d in dirs:
            with open(os.path.join(d, "frames.jsonl")) as f:
                states.append([json.loads(line)["state"] for line in f])
    limit = CLI_ATE_LIMITS["mono-slam"]
    for rank, (r, st) in enumerate(zip(ranks, states)):
        s = r["summary"]
        print(f"(f) CLI --distribute --mode mono-slam, rank {rank} of 2: ATE "
              f"{s['ate_rmse_m']:.6f} m (limit {limit}), {s['keyframes']} keyframes, first "
              f"tracking frame {st.index('tracking') if 'tracking' in st else None}, hook errors "
              f"{s['hook_errors']}, device {s['device']}, K1 launches {r['k1_launches']} "
              f"[{card}]")
    equal = np.array_equal(trajs[0], trajs[1]) and states[0] == states[1]
    print(f"(f) ranks' trajectories and states equal {equal}; {wall:.1f} s [{card}]")
    if not (equal and all(st[-1] == "tracking" and len(st) == CLI_FRAMES for st in states)
            and all(np.isfinite(r["summary"]["ate_rmse_m"])
                    and r["summary"]["ate_rmse_m"] < limit and r["summary"]["hook_errors"] == 0
                    and r["k1_launches"] > 0 for r in ranks)):
        raise AssertionError(f"(f): equal {equal}, states {states}, "
                             f"summaries {[r['summary'] for r in ranks]}")
    return sum(r["k1_launches"] for r in ranks)


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
    from viso_tpu_torch.tools import bench_extract, bench_k1
    from viso_tpu_torch.utils import metrics
    t_start = time.perf_counter()

    # Phase 1: the card.
    if torch.cuda.device_count() != 1:
        raise AssertionError(f"expected one visible card, got {torch.cuda.device_count()}")
    card = bench_extract.card_line()
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
    cases, max_err = kernel_cases(torch, extract, bench_k1.MAIN_PATH_CASES, dev, card)
    k1_frame = {key: sum(cases[n][key] for n in bench_k1.TRACK_CASES) for key in FRAME_KEYS}
    print("K1 per tracked frame (6 calls): "
          + " ".join(f"{key}={k1_frame[key]:.6f}" for key in FRAME_KEYS) + f" [{card}]")
    mono_kf = [n for n in cases if n.startswith("mono")]
    print(f"K1 per mono keyframe's LK and photo-BA ({len(mono_kf)} calls): "
          + " ".join(f"{key}={sum(cases[n][key] for n in mono_kf):.6f}" for key in FRAME_KEYS)
          + f" [{card}]")
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

    # 4b: one more tracked frame under torch.profiler (the last frame
    # again): no copy of the keyframe stack (8 images at level 1 or more).
    stack_bytes = 8 * (H // 2) * (W // 2) * 4
    dev_ms, n_kernels, n_k1, copies = profile_frame(torch, vo, timed[-1], stack_bytes)
    vo.close()
    print(f"profiled tracked frame: {n_kernels} kernels, {dev_ms:.3f} ms device time, "
          f"{n_k1} K1 launches, {len(copies)} copies of the keyframe stack [{card}]")
    if copies or n_k1 <= 0:
        raise AssertionError(f"tracked frame copies the keyframe stack {copies} "
                             f"or never launches K1 ({n_k1})")

    # 4c: the main path, clean: counts reset just before, read just after.
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
    orbit, orbit_Rs, orbit_ts = render_orbit(synthetic)
    slam_k1 = slam_phase(torch, extract, extract_aligned, orbit, orbit_Rs, orbit_ts, metrics,
                         dev, card)
    print(f"phase 6 wall {time.perf_counter() - t0:.1f} s")

    # Phase 7: MonocularVO on the 500-frame mono cell.
    t0 = time.perf_counter()
    mono_frames, mono_Rs, mono_ts = render_mono()
    mono_k1 = mono_phase(torch, extract, mono_frames, mono_Rs, mono_ts, dev, card)
    print(f"phase 7 wall {time.perf_counter() - t0:.1f} s")

    # Phase 8: the CLI on the card.
    t0 = time.perf_counter()
    cli_k1 = cli_phase(torch, extract, card)
    print(f"phase 8 wall {time.perf_counter() - t0:.1f} s")

    # Phase 9: MonoSLAM on the left images of phase 6's orbit.
    t0 = time.perf_counter()
    mono_slam_k1 = mono_slam_phase(torch, extract, [il for il, _ in orbit], orbit_Rs, orbit_ts,
                                   dev, card)
    print(f"phase 9 wall {time.perf_counter() - t0:.1f} s")

    # Phase 10: the distributed window BA, then SLAM over ranks.
    t0 = time.perf_counter()
    dist_k1 = dist_phase(torch, extract, dev, card)
    t1 = time.perf_counter()
    dist_k1 += dist_slam_phase(torch, orbit, orbit_Rs, orbit_ts, dev, card)
    t2 = time.perf_counter()
    dist_k1 += dist_cli_phase(dev, card)
    print(f"phase 10 wall {time.perf_counter() - t0:.1f} s ((a)-(d) {t1 - t0:.1f} s, (e) "
          f"{t2 - t1:.1f} s, (f) {time.perf_counter() - t2:.1f} s)")

    # Phase 11: the stats-delay scenario and the diagnostic and profiling tools.
    t0 = time.perf_counter()
    tools_k1 = tools_phase(torch, extract, orbit, orbit_Rs, orbit_ts, frames, dev, card)
    print(f"phase 11 wall {time.perf_counter() - t0:.1f} s")

    # Phase 12: the captured programs.
    t0 = time.perf_counter()
    programs_phase(torch, extract, frames, mono_frames, dev, card)
    print(f"phase 12 wall {time.perf_counter() - t0:.1f} s")

    # Phase 13: the SLAM loop layer's captured programs.
    t0 = time.perf_counter()
    loop_programs_phase(torch, extract, orbit, dev, card)
    print(f"phase 13 wall {time.perf_counter() - t0:.1f} s")

    # Phase 14: the monocular bootstrap's programs and the captured sharded solve.
    t0 = time.perf_counter()
    boot_k1 = bootstrap_phase(torch, extract, mono_frames, dev, card)
    print(f"phase 14 wall {time.perf_counter() - t0:.1f} s")

    # Phase 15: results.
    print(f"total wall {time.perf_counter() - t_start:.1f} s")
    # ms, plain_ms, bound_ms, library_ms: device times (CUDA graph replay),
    # K1 summed over a tracked frame's 6 calls, K2 over the tool's 12 calls.
    def record(name, source, replaces, launches, err, t):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err,
            "ms": t["device_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t["library_ms"],
            "device_ms": t["device_ms"], "host_ms": t["host_ms"], "floor_ms": t["floor_ms"],
            "entry_ms": t["entry_ms"],
        }

    print(json.dumps({"kernels": [
        record("extract_windows", "viso_tpu_torch/csrc/extract_windows.cu",
               "viso_tpu/geometry/extract_pallas.py:64",
               launches + slam_k1 + mono_k1 + cli_k1 + mono_slam_k1 + dist_k1 + tools_k1
               + boot_k1,
               max_err, k1_frame),
        record("extract_aligned", "viso_tpu_torch/csrc/extract_aligned.cu",
               "tools/bench_extract.py:37", k2["launches"], k2["max_abs_err"], k2),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
