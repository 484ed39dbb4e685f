"""Numeric sanitizer analogues and state audits (port of
`viso_tpu/utils/debug.py`).

  * `enable_nan_checks()`: torch's anomaly mode (also via env
    VISO_DEBUG_NANS=1).
  * `check_finite_state(engine)`: sweeps every tensor of the live engine
    state (map, pose, pose graph, loop database) and names each field that
    went non-finite. The map is all fixed-capacity masked tensors, so one
    sweep covers the whole SLAM state.
  * `snapshot_versions` / `assert_no_donation`: the reference pins that no
    engine kernel donates a buffer, because the loop layer's digest and
    keyframe snapshots read map arrays after their successors exist. The
    port's map, pose and templates live in storage written in place every
    frame (the captured programs read fixed addresses), so its form of
    that invariant is about what the engine keeps of the past: no program
    writes into a tensor the engine holds as a record of an earlier frame
    (each frame's pose in `results`, a monocular segment's base pose).
    Every in-place write bumps a tensor's `_version`, so the check
    compares the counters.
  * `delay_stats(engine, rng, max_delay)`: stats that land late. Replaces
    the engine's `_host_fetch` with fetches whose `done()` stays false
    until the engine has advanced a drawn number of frames (a slow
    device-to-host readback), the delayed executor of the reference's
    tests/test_stats_stress.py.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def enable_nan_checks(enabled: bool = True):
    """Turn torch's anomaly mode on or off: a backward pass that produces
    NaN raises at the forward op that led to it, with its traceback.

    What it does not catch: NaN in forward-only code. The engines run no
    backward pass, so their NaN shows only in results; the production
    programs also carry branchless `isfinite` guards (ops/direct.py,
    backend/ba.py) that replace NaN, which JAX's debug-NaN mode would
    stop at. Use `check_finite_state` for the engine state."""
    torch.autograd.set_detect_anomaly(enabled)


if os.environ.get("VISO_DEBUG_NANS") == "1":
    enable_nan_checks(True)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)) and x:
        return np.stack([_host(v) for v in x])
    return np.asarray(x)


def check_finite_state(engine) -> list[str]:
    """Audit every tensor of a VO/SLAM engine for non-finite values.

    Returns the offending field names (empty = healthy). Pulls the whole
    state to the host: a debugging and checkpoint-time tool, not a
    per-frame check.
    """
    bad: list[str] = []

    def scan(name, arr):
        a = _host(arr)
        if a.dtype.kind == "f" and not np.all(np.isfinite(a)):
            bad.append(name)

    m = engine.map
    for name in m._fields:
        v = getattr(m, name)
        if isinstance(v, tuple):
            for lvl, x in enumerate(v):
                scan(f"map.{name}[{lvl}]", x)
        else:
            scan(f"map.{name}", v)
    scan("R", engine.R)
    scan("t", engine.t)
    for attr in ("pg_raw_R", "pg_raw_t", "pg_R", "pg_t", "pg_s"):
        v = getattr(engine, attr, None)
        if v:
            scan(attr, v)
    db = getattr(engine, "loop_db", None)
    if db is not None:
        for attr in ("points_w", "points_w_dev", "R", "t", "path_len", "rot_len"):
            v = getattr(db, attr, None)
            if v is not None:
                scan(f"loop_db.{attr}", v)
    return bad


def snapshot_versions(engine) -> list:
    """(name, tensor, version) for every tensor the engine keeps as a
    record of an earlier frame: each frame's pose in `results` and, for a
    monocular engine, its segment's base pose."""
    out = []
    for k, r in enumerate(engine.results):
        out += [(f"results[{k}].R", r.R, r.R._version), (f"results[{k}].t", r.t, r.t._version)]
    for name, x in zip(("init_base.R", "init_base.t"), getattr(engine, "init_base", ())):
        out.append((name, x, x._version))
    return out


def assert_no_donation(snapshot):
    """Raise AssertionError if any tensor of `snapshot_versions(...)` was
    written in place since: a record of an earlier frame that aliases the
    engine's state reads the state's later values."""
    written = [name for name, x, version in snapshot if x._version != version]
    assert not written, (
        f"in-place writes into snapshot tensors {written}: what the engine "
        "keeps of an earlier frame must be a copy of its state, not the state"
    )


class DelayedFetch:
    """A stats fetch (`slam.engine.HostFetch`) that reports done() only
    once `engine.frame_idx` has reached `release_frame`; its result() is
    the fetch's own."""

    def __init__(self, fetch, engine, release_frame: int):
        self._fetch = fetch
        self._engine = engine
        self._release = release_frame

    def done(self) -> bool:
        return self._engine.frame_idx >= self._release and self._fetch.done()

    def result(self):
        return self._fetch.result()


def delay_stats(engine, rng, max_delay: int):
    """Delay each of `engine`'s stats samples by `rng.integers(0,
    max_delay + 1)` frames, drawn at submission. Returns the engine."""
    from viso_tpu_torch.slam.engine import HostFetch

    def fetch(stats):
        delay = int(rng.integers(0, max_delay + 1))
        return DelayedFetch(HostFetch(stats), engine, engine.frame_idx + delay)

    engine._host_fetch = fetch
    return engine
