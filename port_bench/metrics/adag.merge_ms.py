"""adag.merge_ms: ADAG's window merge on the card — the median device
time of the ``merge`` phases (the commit, the worker-summed delta, the
center's update and the pull) of the untraced ``train`` call, from the
program's phase records (``port_bench/phases.py``)."""

from port_bench import phases

COMBINE = "rank0"


def read(trace):
    call = phases.untraced_call(phases.records())
    if call is None:
        return None
    return phases.median_ms(r["device_s"] for r in call[2]
                            if r["name"] == "merge")
