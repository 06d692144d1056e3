"""gemm.ms_per_step: device time of the product kernels (cuBLAS, CUTLASS,
cuDNN's implicit GEMMs) a step, from the traced window."""

COMBINE = "rank0"


def read(trace):
    if not trace.count(lambda k: k == "gemm"):
        return None
    return trace.seconds(lambda k: k == "gemm") / trace.steps * 1e3
