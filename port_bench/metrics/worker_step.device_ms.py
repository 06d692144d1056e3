"""worker_step.device_ms: device time of the kernels a global step of the
worker-stacked ADAG step (the window's merge included, spread over its
steps), from the traced window."""

COMBINE = "rank0"


def read(trace):
    if not trace.count(lambda k: k != "memory"):
        return None
    return trace.seconds(lambda k: k != "memory") / trace.steps * 1e3
