"""attn_kernels.ms_per_step: device time a step of the attention kernels
(K1 ``flash_fwd``, K2 ``flash_bwd_dq``, K3 ``flash_bwd_dkv``, and K4
``flash_bwd_fused`` where it runs), by kernel name."""

COMBINE = "rank0"


def read(trace):
    if not trace.count(lambda k: k.startswith("attn:")):
        return None
    return trace.seconds(lambda k: k.startswith("attn:")) / trace.steps * 1e3
