"""`frame_gap_share` (device layer): the stream time from the end of a
window frame's last enqueue to the start of the next frame's first,
summed over the window's timed frames, as a share of their stream time
(each frame's first enqueue to its last, plus its gap), in percent: how
long the card's stream waited on the host between frames. Read from the
CUDA events that the port's frame recorder records at `process()`'s first
and last enqueue on one frame in `EVENT_EVERY`
(`viso_tpu_torch.utils.profiling.RECORDER`), with no profiler. Nothing
without them."""


def read(run):
    try:
        from viso_tpu_torch.utils.profiling import RECORDER
    except ImportError:   # a port without the recorder
        return None
    frames = RECORDER.frames(run.cell.config["warmup_frames"], len(run.host_ms))
    # Gaps inside the window: the last frame's runs into what follows it
    # (a traced run's profiler start).
    timed = [f for f in frames[:-1] if f.device_ms is not None and f.gap_ms is not None]
    if not timed:
        return None
    gaps = sum(f.gap_ms for f in timed)
    return 100.0 * gaps / (gaps + sum(f.device_ms for f in timed))
