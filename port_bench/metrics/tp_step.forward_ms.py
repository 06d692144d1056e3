"""tp_step.forward_ms: the TP step's forward on the card — the median
device time of its ``tp.forward`` phase (the casts, the forward, the
log-softmax and NLL) over the untraced window's steps, from the
program's phase records (``port_bench/phases.py``)."""

from port_bench import phases

COMBINE = "rank0"


def read(trace):
    return phases.tp_phase_ms(trace, "tp.forward")
