"""tp_step.backward_ms: the TP step's backward on the card — the median
device time of its ``tp.backward`` phase (``torch.autograd.grad``) over
the untraced window's steps, from the program's phase records
(``port_bench/phases.py``)."""

from port_bench import phases

COMBINE = "rank0"


def read(trace):
    return phases.tp_phase_ms(trace, "tp.backward")
