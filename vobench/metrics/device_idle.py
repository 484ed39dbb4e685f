"""`device_idle` (device layer): the share of the profiled slice with no
operation running on the card (the complement of the union of the device
operations' intervals), in percent."""


def read(run):
    s = run.slice
    if s is None or not s.complete or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
