"""`device_ms_per_frame` (device layer): the seconds in which an operation
ran on the card (the union of the device operations' intervals) over the
profiled slice's frames, in ms a frame. The profiler stretches the gaps
between a CUDA graph's kernels (it records each kernel), so the slice's
idle share (`device_idle`) reads higher than an untraced run's; the busy
time a frame is what the window's untraced frame time is to be set
against."""


def read(run):
    s = run.slice
    if s is None or not s.complete or not s.frames:
        return None
    return 1e3 * s.busy_s / s.frames
