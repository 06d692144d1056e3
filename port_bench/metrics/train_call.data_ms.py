"""train_call.data_ms: a ``train`` call's data on the host's clock — the
host seconds (in ms) of the untraced call's ``shard`` (the rows sharded
over the workers and cut to windows) and ``layout`` (the resident
transpose, the copy to the card and its drain) phases, from the
program's phase records (``port_bench/phases.py``).  Every call pays it
before its first step: three times in set-up, and once inside the
window, which is one call."""

from port_bench import phases

COMBINE = "rank0"


def read(trace):
    call = phases.untraced_call(phases.records())
    if call is None or call[0] is None:
        return None
    shard, layout, _ = call
    return (shard["host_s"] + layout["host_s"]) * 1e3
