"""attn_kernels.roofline_pct: the attention kernels' share of their
roofline, sum of the launches' least times over the sum of their kernel
times.  A launch's least time is the larger of its FLOPs over 989 TFLOP/s
and its bytes over 3.35 TB/s, from the launch's shape
(``reference/flops.py``); the shape of every launch of the step is the
cell's (batch a rank, tokens, heads, head size)."""

from port_bench.reference.flops import attention_launch, bound_s

COMBINE = "rank0"


def read(trace):
    shape = trace.facts.get("attention_shape")
    ops = [(k[5:], s) for _, k, s in trace.ops if k.startswith("attn:")]
    if not shape or not ops:
        return None
    bound = sum(bound_s(*attention_launch(launch, *shape))
                for launch, _ in ops)
    return 100.0 * bound / sum(s for _, s in ops)
