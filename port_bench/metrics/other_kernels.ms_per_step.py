"""other_kernels.ms_per_step: device time a step of every kernel that is
neither a product, nor one of the attention kernels K1-K3, nor a
collective: LayerNorm, GELU, softmax-xent, casts, adam's elementwise
updates."""

COMBINE = "rank0"


def read(trace):
    if not trace.count(lambda k: k == "other"):
        return None
    return trace.seconds(lambda k: k == "other") / trace.steps * 1e3
