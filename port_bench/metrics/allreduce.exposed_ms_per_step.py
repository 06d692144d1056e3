"""allreduce.exposed_ms_per_step: the packed all-reduce's device time a
step on rank 0, ``collectives.reduce_stats(op="all_reduce")``'s
``device_seconds`` over the untraced window, not under the profiler.
Under NCCL it holds the wait for the slowest rank, so it is exposed
time, not transfer time."""

COMBINE = "rank0"


def read(trace):
    stats = trace.facts.get("allreduce")
    if not stats or not stats.get("calls"):
        return None
    return stats["device_seconds"] / trace.facts["window_steps"] * 1e3
