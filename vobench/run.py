"""The benchmark of `viso_tpu_torch`, the PyTorch and CUDA visual
odometry engines, on one NVIDIA GPU.

    python3 -m vobench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. A cell of `BENCHMARK.json` names a
configuration (`vobench/configs/<name>.json`: the engine, its settings
and the checks' limits) and a traffic mix (`vobench/traffic/<name>.json`:
the drive, and the feed `vobench/feeds/<feed>.py` that hands its frames
to the engine). One run, in one process on one card:

  1. builds the port's CUDA kernels (`viso_tpu_torch._cuda.build_all`,
     into `build/viso_tpu_torch/`; the native decoder into `native/`),
     reused by every later run of the checkout;
  2. renders one period of the drive through the traffic's corridor on
     the card (`vobench/scenes.py`);
  3. warms the engine up on the drive's first frames, until every
     program of the cell is captured;
  4. hands frames to `process()` back to back for `--seconds` (a closed
     loop: a logged drive processed as fast as the card allows), each
     frame's pose copied to pinned host memory without blocking and
     stamped on the host clock by a waiting thread when it lands;
  5. checks a sample of the window's steps against the plain reference
     (`vobench/check.py`) and prints one JSON line.

With `--trace 0` the line's metrics are the cell's end-to-end metrics
(frames/s, the 95th percentile of frame latency, KITTI's translational
drift, set-up seconds); with `--trace 1` its per-layer metrics, each read
by `vobench/metrics/<name>.py` from the run's host times, CUDA events
around the engine's programs and a profiled slice of the window
(`vobench/trace.py`). Without a card, or with fewer than the cell asks
for, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that may not be loaded in a run (compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "viso_tpu")
FORBIDDEN_FILES = ("bench", "chip_smoke")
# Frames a window can take per second of its length, at most: sizes the
# pose buffer and a feed's cycled path list.
MAX_FPS = 500
# Build and kernel caches of the run, at fixed paths inside the checkout.
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/vobench/torch_extensions",
              "TRITON_CACHE_DIR": "build/vobench/triton"}
# Blocks of consecutive window frames whose steps the check compares.
CHECK_BLOCKS = 3
# Frames profiled after the window in a traced run.
TRACE_FRAMES = 20
# The rig's keys of a configuration file and the engine settings they give.
RIG_KEYS = {"image_rows": "height", "image_cols": "width", "fx": "fx", "fy": "fy", "cx": "cx",
            "cy": "cy", "baseline_m": "baseline"}


def load_json(path):
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def cell_of(name: str, bench: dict | None = None, root: Path = HERE) -> Cell:
    """The cell `name` of `BENCHMARK.json` with its configuration and
    traffic files, found by name under `root`."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    return Cell(name=name, chips=w["chips"],
                config=load_json(root / "configs" / f"{w['config']}.json"),
                traffic=load_json(root / "traffic" / f"{w['traffic']}.json"),
                end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if applies(m, name)])


def engine_settings(config: dict) -> dict:
    """The engine's `VOConfig` settings: the configuration's `engine`
    block with the rig (image size, intrinsics, baseline) from the file's
    top-level keys, which state it once."""
    rig = {RIG_KEYS[k]: v for k, v in config.items() if k in RIG_KEYS}
    return dict(config["engine"], **rig)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden in a run."""
    tops = {m.split(".")[0] for m in sys.modules}
    return sorted(t for t in tops if t in FORBIDDEN or t in FORBIDDEN_FILES)


@dataclass
class Context:
    """What a feed is given."""

    traffic: dict
    stereo: bool
    frames_host: np.ndarray      # (P, 2, H, W) or (P, H, W) uint8; frame i is image i mod P
    engine: object
    max_frames: int


class PoseSink:
    """Each frame's pose (R, t) copied into a row of pinned host memory
    after `process()` returns, without blocking, with an event recorded
    after the copy; a thread waits on the events in order and stamps each
    on the host clock when it completes. On the CPU the copy is done at
    once and stamped at once."""

    def __init__(self, n: int, device):
        import queue

        import torch

        self.torch = torch
        self.cuda = device.type == "cuda"
        self.host = torch.zeros((n, 12), dtype=torch.float32, pin_memory=self.cuda)
        self.landed = np.zeros(n)
        self.queue = queue.SimpleQueue()
        self.thread = threading.Thread(target=self._wait, daemon=True) if self.cuda else None
        if self.thread is not None:
            self.thread.start()

    def put(self, i: int, R, t):
        self.host[i, :9].copy_(R.reshape(9), non_blocking=True)
        self.host[i, 9:].copy_(t, non_blocking=True)
        if self.cuda:
            ev = self.torch.cuda.Event(blocking=True)
            ev.record()
            self.queue.put((i, ev))
        else:
            self.landed[i] = time.perf_counter()

    def _wait(self):
        while True:
            item = self.queue.get()
            if item is None:
                return
            i, ev = item
            ev.synchronize()
            self.landed[i] = time.perf_counter()

    def close(self):
        if self.thread is not None:
            self.queue.put(None)
            self.thread.join()
            self.thread = None

    def poses(self, n: int):
        a = self.host[:n].numpy().astype(np.float64)
        return a[:, :9].reshape(n, 3, 3), a[:, 9:]


class Snapshots:
    """Copies of an engine's state (map, pose, velocity twist) into
    buffers allocated before the window, on the engine's stream: a copy
    taken before `process()` holds the state the frame starts from."""

    def __init__(self, vo, n: int):
        self.bufs = [self._alloc(vo) for _ in range(n)]
        self.used = 0

    @staticmethod
    def _state(vo):
        return {"map": vo.map, "R": vo.R, "t": vo.t, "vel": vo.vel_xi}

    @staticmethod
    def _alloc(vo):
        import torch
        from torch.utils._pytree import tree_map

        return tree_map(lambda x: torch.empty_like(x) if isinstance(x, torch.Tensor) else x,
                        Snapshots._state(vo))

    def take(self, vo) -> dict:
        import torch
        from torch.utils._pytree import tree_leaves

        buf = self.bufs[self.used]
        self.used += 1
        for d, s in zip(tree_leaves(buf), tree_leaves(self._state(vo))):
            if isinstance(d, torch.Tensor):
                d.copy_(s)
        return buf


@dataclass
class Trace:
    """What the traced run hands the per-layer readers."""

    cell: Cell
    host_ms: list = field(default_factory=list)          # per window frame, around process()
    keyframes: list = field(default_factory=list)        # per window frame
    program_ms: dict = field(default_factory=dict)       # name -> [(frame, ms)]
    ring_waits: list | None = None                       # seconds per frame
    slice: object = None                                 # trace.Slice
    power_limit: str = "not read"


def card_power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def check_plan(seed: int, check: dict) -> list:
    """The window frames whose steps are checked, drawn from the seed:
    `CHECK_BLOCKS` blocks of `block_frames` consecutive frames, their
    starts among the first `within_frames` frames of the window."""
    rng = np.random.default_rng(seed % 2**64)
    k = check["block_frames"]
    starts = sorted(rng.choice(check["within_frames"] // k, CHECK_BLOCKS, replace=False) * k)
    return [int(s) + j for s in starts for j in range(k)]


def instrument(vo, trace: Trace, frame_ref: list, slice_on: list):
    """Wrap each engine program as the engine calls it (the replay of its
    CUDA graph) with CUDA events and a host range, and, inside the
    profiled slice, the track program with marker kernels
    (`chip_smoke.instrument`'s pattern)."""
    import torch

    from vobench import trace as trace_mod

    real = vo._program
    events = []
    cuda = vo.device.type == "cuda"

    def program(name):
        prog = real(name)

        def timed(*a):
            mark = slice_on[0] and name == "track"
            with torch.profiler.record_function(f"vobench.program.{name}"):
                if mark:
                    trace_mod.marker()
                s = torch.cuda.Event(enable_timing=True) if cuda else None
                e = torch.cuda.Event(enable_timing=True) if cuda else None
                if cuda:
                    s.record()
                out = prog(*a)
                if cuda:
                    e.record()
                if mark:
                    trace_mod.marker()
            events.append((name, frame_ref[0], s, e))
            return out

        return timed

    vo._program = program
    return events


class BootstrapRecorder:
    """Records each two-view initialization a monocular engine runs (the
    port's `ops.twoview.initialize`, called by `MonocularVO`): the state of
    the generator its RANSAC draws come from, its inputs, and copies of
    its result. Installed for the warm-up, where the bootstrap runs."""

    def __init__(self):
        from viso_tpu_torch.ops import twoview

        self.module = twoview
        self.real = twoview.initialize
        self.calls = []

        def initialize(generator, x1, x2, mask, params, *, run):
            state = generator.get_state()
            res = self.real(generator, x1, x2, mask, params, run=run)
            self.calls.append({
                "inputs": (state, x1.clone(), x2.clone(), mask.clone(), tuple(params)),
                "post": {k: getattr(res, k).clone() for k in ("R", "t", "points", "inliers")}})
            return res

        twoview.initialize = initialize

    def close(self):
        self.module.initialize = self.real


@contextlib.contextmanager
def matmul_precision(level: str):
    import torch

    old = torch.get_float32_matmul_precision()
    old_cudnn = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision(level)
    torch.backends.cudnn.allow_tf32 = level != "highest"
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)
        torch.backends.cudnn.allow_tf32 = old_cudnn


def reference_posts(cell: Cell, steps, frames, device, precision="highest"):
    """The reference's state after each checked step, from the state
    before it (`vobench/reference/steps.py`), at a float32 matmul
    precision ("highest": IEEE float32; "high": TF32, the control)."""
    import torch

    from vobench.reference import steps as ref_steps
    from vobench.reference.mapping import map_state as ref_map

    cfg = ref_steps.Config.of(engine_settings(cell.config), cell.config["ba_backend"])
    stereo = cell.config["rig"] == "stereo"
    posts = []
    with matmul_precision(precision), torch.no_grad():
        for st in steps:
            imgs = frames[st["frame"] % len(frames)]
            frame = (imgs[0], imgs[1]) if stereo else (imgs,)
            if "inputs" in st:   # a monocular bootstrap's two-view initialization
                post = ref_steps.twoview_init(device, *st["inputs"])
            elif st["pre"] is None:   # the run's first frame: built from nothing
                post = ref_steps.first(cfg, stereo, frame, device)
            else:
                pre = dict(st["pre"], map=ref_map.MapState(*st["pre"]["map"]))
                post = ref_steps.step(cfg, stereo, pre, frame, st["decision"])
            posts.append(post)
    return posts


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             control: bool = False) -> dict:
    """One run of `cell`; returns the result line's object (with
    `control`: also the control's numbers, under "control")."""
    import torch

    from viso_tpu_torch.slam import engine as eng
    from vobench import check, scenes
    from vobench import trace as trace_mod

    dev = torch.device(device)
    cfg = cell.config
    tr = cell.traffic
    stereo = cfg["rig"] == "stereo"
    if dev.type == "cuda":
        from viso_tpu_torch import _cuda

        _cuda.build_all()
        torch.cuda.reset_peak_memory_stats(dev)
    # The inputs: one period of the drive through the traffic's corridor,
    # rendered on the device. Every seed drives the same corridor from its
    # start: a corridor or a start of its own moves KITTI's drift by far
    # more than two runs of one corridor differ. The seed draws the steps
    # to check (`vobench.control` reads the check's limits on corridors
    # drawn from the seed).
    e = engine_settings(cfg)
    drive = scenes.Drive(tr["step_m"], tr["period_frames"], tr["weave_m"], tr["tex_size"],
                         tr["tex_scale"])
    plan = set(check_plan(seed, cfg["check"]))
    tex = scenes.textures(tr["texture_seed"], len(scenes.CORRIDOR), drive.tex_size, dev)
    intr = (e["fx"], e["fy"], e["cx"], e["cy"])
    frames = scenes.render_period(drive, tex, intr, e["height"], e["width"],
                                  e["baseline"] if stereo else None)
    del tex
    frames_host = frames.cpu().numpy()
    vo_cfg = eng.VOConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in e.items()})
    vo = getattr(eng, cfg["engine_class"])(vo_cfg, device=dev)
    warm = cfg["warmup_frames"]
    max_frames = warm + math.ceil(seconds * MAX_FPS) + 8
    feed = importlib.import_module(f"vobench.feeds.{tr['feed']}").Feed(
        Context(traffic=tr, stereo=stereo, frames_host=frames_host, engine=vo,
                max_frames=max_frames))
    # A stereo engine's first frame is checked from nothing it made; a
    # monocular engine's start is its bootstrap's two-view initialization.
    steps = []
    boot = None if stereo else BootstrapRecorder()
    try:
        for i in range(warm):
            vo.process(*feed.next())
            if i == 0 and stereo:
                steps.append({"frame": 0, "pre": None, "decision": None,
                              "post": Snapshots(vo, 1).take(vo)})
    finally:
        if boot is not None:
            boot.close()
    if boot is not None and boot.calls:
        steps.append(dict(boot.calls[-1], frame=0, pre=None, decision=None))
    print(f"warm-up: {warm} frames, engine {vo.state}, keyframes {len(vo.kf_order)}, "
          f"programs {sorted(vo.program_listing())}", file=sys.stderr)
    captured = set(vo.program_listing())
    reinits_before = getattr(vo, "num_reinits", 0)
    snaps = Snapshots(vo, len(plan) + CHECK_BLOCKS)
    frame_ref, slice_on = [0], [False]
    tr_data = Trace(cell) if trace else None
    prog_events = instrument(vo, tr_data, frame_ref, slice_on) if trace else None
    prof = None
    sink = PoseSink(max_frames, dev)
    handed = np.zeros(max_frames)
    keyframes = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    n = 0
    pre = None
    n_window = None
    # A traced run profiles a slice of frames once the window has closed.
    while n < max_frames - warm:
        if n_window is None and time.perf_counter() - t0 >= seconds:
            n_window = n
            if not (trace and dev.type == "cuda"):
                break
            from torch.profiler import ProfilerActivity, profile

            t_prof = time.perf_counter()
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
            trace_mod.fence(dev)
            slice_on[0] = True
            slice_t0 = time.perf_counter()
            print(f"profiler started in {slice_t0 - t_prof:.3f} s", file=sys.stderr)
        frame_ref[0] = n
        with torch.profiler.record_function("vobench.feed") if trace else contextlib.nullcontext():
            args = feed.next()
        checked = n in plan
        if checked:
            pre = pre if pre is not None else snaps.take(vo)
            decision = {"frame_id": vo.frame_idx + 1, "kf_before": list(vo.kf_order),
                        "state": vo.state}
        th = time.perf_counter()
        handed[n] = th
        if trace:
            with torch.profiler.record_function("vobench.process"):
                res = vo.process(*args)
            tr_data.host_ms.append((time.perf_counter() - th) * 1e3)
        else:
            res = vo.process(*args)
        sink.put(n, res.R, res.t)
        keyframes.append(bool(res.is_keyframe))
        if checked:
            decision.update(kf_after=list(vo.kf_order), state_after=vo.state)
            post = snaps.take(vo)
            steps.append({"frame": warm + n, "pre": pre, "decision": decision, "post": post})
            pre = post if (n + 1) in plan else None
        n += 1
        if slice_on[0] and n == n_window + TRACE_FRAMES:
            trace_mod.fence(dev)
            prof.stop()
            slice_on[0] = False
            print(f"profiled slice: {TRACE_FRAMES} frames in "
                  f"{time.perf_counter() - slice_t0:.3f} s", file=sys.stderr)
            break
    sink.close()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    n_all, n = n, (n if n_window is None else n_window)   # frames handed; in the window
    window_s = sink.landed[n - 1] - t0
    new_programs = sorted(set(vo.program_listing()) - captured)
    reinits = getattr(vo, "num_reinits", 0) - reinits_before
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    R_est, t_est = sink.poses(n)
    lat_ms = (sink.landed[:n] - handed[:n]) * 1e3
    failed = int(np.sum(~(np.isfinite(R_est).all(axis=(1, 2)) & np.isfinite(t_est).all(axis=1))))
    per_s = np.bincount(((sink.landed[:n] - t0)).astype(int))
    print(f"window: from {time.time() - (time.perf_counter() - t0):.3f} (epoch s), "
          f"{n} frames in {window_s:.3f} s, keyframes {sum(keyframes[:n])}, latency "
          f"p50 {np.median(lat_ms):.3f} ms, frames landed per second {per_s.tolist()}",
          file=sys.stderr)
    result = {"correct": None, "attempted": n, "failed": failed, "metrics": {}}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": memory_peak}
    if trace:
        tr_data.host_ms = tr_data.host_ms[:n]
        tr_data.keyframes = keyframes[:n]
        tr_data.ring_waits = feed.waits[warm + 1:warm + 1 + n] if feed.waits is not None else None
        for name, frame, s, e_ in prog_events:
            if frame < n:
                tr_data.program_ms.setdefault(name, []).append(
                    (frame, s.elapsed_time(e_) if dev.type == "cuda" else float("nan")))
        if prof is not None:
            t_ev = time.perf_counter()
            events = prof.events()
            print(f"profiler events read in {time.perf_counter() - t_ev:.3f} s: {len(events)}",
                  file=sys.stderr)
            tr_data.slice = trace_mod.Slice(
                events, n_all - n, sum(1 for name, f, *_ in prog_events
                                       if name == "track" and f >= n),
                cfg["k1_track_calls"])
            print(f"slice: {n_all - n} frames, {tr_data.slice.markers} markers, "
                  f"{len(tr_data.slice.work)} device operations, busy "
                  f"{tr_data.slice.busy_s:.6f} s of {tr_data.slice.window_s:.6f} s; the window's "
                  f"{window_s / n * 1e3:.3f} ms a frame untraced", file=sys.stderr)
            tr_data.power_limit = card_power_limit()
            device_info.update(busy_s=tr_data.slice.busy_s, window_s=tr_data.slice.window_s)
            result["breakdown"] = {"device_ops": tr_data.slice.device_ops(),
                                   "idle_gaps": tr_data.slice.idle_gaps()}
        for m in cell.per_layer:
            v = importlib.import_module(f"vobench.metrics.{m['name']}").read(tr_data)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        gt = drive.poses(range(warm, warm + n))
        values = {"fps": n / window_s, "frame_p95_ms": float(np.percentile(lat_ms, 95)),
                  "setup_s": setup_s}
        if stereo:
            from vobench import drift

            values["trans_err_pct"] = drift.trans_err_pct(R_est, t_est, *gt)
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result["device"] = device_info
    # The check, once the window has closed and the engine is freed.
    feed.close()
    vo.close()
    del vo, feed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # The reference follows a tracking frame; a monocular re-initialization
    # (the map dropped, a new bootstrap) it does not, and its steps are
    # counted and left out.
    held = [s for s in steps if s["decision"] is None
            or (s["decision"]["state"] == "tracking" and s["decision"]["state_after"] == "tracking")]
    print(f"steps left out (not tracking): {len(steps) - len(held)}; re-initializations in the "
          f"window: {reinits}", file=sys.stderr)
    steps = held
    posts = reference_posts(cell, steps, frames, dev)
    numbers = check.worst([check.gaps(s["post"], p) for s, p in zip(steps, posts)])
    if not stereo and not any("inputs" in s for s in steps):
        numbers["mask_diff"] = float("inf")   # no bootstrap to check
    ok, table = check.verdict(numbers, cfg["check"]["limits"])
    if new_programs:
        print(f"programs first run inside the window: {new_programs}", file=sys.stderr)
    enough = len(steps) >= CHECK_BLOCKS
    result["correct"] = bool(ok and failed == 0 and enough and not new_programs)
    table["failed_frames"] = {"value": failed, "limit": 0}
    print(f"steps checked: {len(steps)} ({len(plan)} planned in the window)", file=sys.stderr)
    if control:
        cposts = reference_posts(cell, steps, frames, dev, precision="high")
        result["control"] = check.worst([check.gaps(c, p) for c, p in zip(cposts, posts)])
    result["check"] = table
    return result


def setup_environment():
    for key, rel in CACHE_DIRS.items():
        path = ROOT / rel
        path.mkdir(parents=True, exist_ok=True)
        os.environ[key] = str(path)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    setup_environment()
    cell = cell_of(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for name, v in result["check"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
