"""tp_step.optimizer_ms: the TP step's optimizer on the card — the median
device time of its ``tp.optimizer`` phase (adam's update and its
application to the params) over the untraced window's steps, from the
program's phase records (``port_bench/phases.py``).  Where the host
paces the step this is the time the card spends on the phase's
dispatch."""

from port_bench import phases

COMBINE = "rank0"


def read(trace):
    return phases.tp_phase_ms(trace, "tp.optimizer")
