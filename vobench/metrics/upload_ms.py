"""`upload_ms` (ingestion layer, `BaseVO._upload` and `engine.FrameStaging`):
the host ms of the window's `upload` spans over the window's frames, a
mean per frame (a feed that stages a frame ahead uploads it in the
frame before), from the port's frame recorder
(`viso_tpu_torch.utils.profiling.RECORDER`). Nothing without it."""


def read(run):
    try:
        from viso_tpu_torch.utils.profiling import RECORDER
    except ImportError:   # a port without the recorder
        return None
    frames = RECORDER.frames(run.cell.config["warmup_frames"], len(run.host_ms))
    return sum(f.span_ms("upload") for f in frames) / len(frames) if frames else None
