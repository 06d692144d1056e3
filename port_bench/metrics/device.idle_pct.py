"""device.idle_pct: the share of the traced window in which no operation
runs on the card, from the profiler's timeline; across ranks the
largest."""

COMBINE = "max"


def read(trace):
    if trace.window_s <= 0 or not trace.ops:
        return None
    return 100.0 * max(0.0, 1.0 - trace.busy_s / trace.window_s)
