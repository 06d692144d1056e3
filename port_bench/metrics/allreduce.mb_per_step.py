"""allreduce.mb_per_step: megabytes (1e6) the packed all-reduce moves a
step, from ``collectives.reduce_stats(op="all_reduce")`` over the
untraced window."""

COMBINE = "rank0"


def read(trace):
    stats = trace.facts.get("allreduce")
    if not stats or not stats.get("calls"):
        return None
    return stats["bytes"] / trace.facts["window_steps"] / 1e6
