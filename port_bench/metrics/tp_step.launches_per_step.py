"""tp_step.launches_per_step: the device operations (kernels, copies,
fills) that one TP step enqueues, counted in the traced window.  Each is
a launch the host dispatches, so fewer of them shorten the host's share
of the step; the count does not depend on the profiler's pace."""

COMBINE = "rank0"


def read(trace):
    if not trace.ops:
        return None
    return len(trace.ops) / trace.steps
