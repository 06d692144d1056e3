"""tp_step.host_lead_ms: how far the host runs ahead of the card — the
median time each untraced window step's entry (``tp.step``'s entry
event) waited in the launch queue (``queue_s``), from the program's
phase records (``port_bench/phases.py``).  Near 0 the card ran dry and
waited for the host at every step (host-paced); large, the launch queue
holds a backlog (card-paced)."""

from port_bench import phases

COMBINE = "rank0"


def read(trace):
    steps = phases.window_steps(trace, phases.records())
    return phases.median_ms(r["queue_s"] for r in steps) if steps else None
