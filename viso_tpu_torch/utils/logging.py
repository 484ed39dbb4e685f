"""Structured per-frame logging (port of `viso_tpu/utils/logging.py`):
one JSON-able record per frame (tracks, landmarks, keyframes, state, wall
time), streamed as JSONL to a file or a stream.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field


@dataclass
class FrameLog:
    frame: int
    wall_ms: float
    num_tracked: int = 0
    num_landmarks: int = 0
    num_keyframes: int = 0
    is_keyframe: bool = False
    state: str = ""
    extra: dict = field(default_factory=dict)

    def to_json(self):
        d = {
            "frame": self.frame,
            "wall_ms": round(self.wall_ms, 3),
            "tracked": self.num_tracked,
            "landmarks": self.num_landmarks,
            "keyframes": self.num_keyframes,
            "kf": self.is_keyframe,
            "state": self.state,
        }
        d.update(self.extra)
        return json.dumps(d)


class RunLogger:
    """Collects FrameLogs; optionally streams JSONL to a file/stderr."""

    def __init__(self, stream=None, path: str | None = None):
        self.records: list[FrameLog] = []
        self.stream = stream
        self._file = open(path, "w") if path else None
        self._t_last = time.perf_counter()

    def tick(self):
        self._t_last = time.perf_counter()

    def log_frame(self, frame: int, **kw) -> FrameLog:
        now = time.perf_counter()
        rec = FrameLog(frame=frame, wall_ms=(now - self._t_last) * 1e3, **kw)
        self._t_last = now
        self.records.append(rec)
        line = rec.to_json()
        if self.stream is not None:
            print(line, file=self.stream, flush=True)
        if self._file is not None:
            self._file.write(line + "\n")
        return rec

    def fps(self, skip: int = 0):
        recs = self.records[skip:]
        if not recs:
            return 0.0
        total = sum(r.wall_ms for r in recs) / 1e3
        return len(recs) / max(total, 1e-9)

    def summary(self):
        return {
            "frames": len(self.records),
            "fps": round(self.fps(skip=min(5, len(self.records) // 2)), 3),
            "keyframes": sum(r.is_keyframe for r in self.records),
            "mean_tracked": (
                sum(r.num_tracked for r in self.records) / max(len(self.records), 1)
            ),
        }

    def close(self):
        if self._file:
            self._file.close()
            self._file = None


def eprint(*args):
    print(*args, file=sys.stderr, flush=True)
