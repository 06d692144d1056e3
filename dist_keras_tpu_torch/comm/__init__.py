"""Process-group layer — counterpart of ``comm/`` (``backend.py``): the
``torch.distributed`` bring-up, the contiguous deal, the deadline
barrier and the cross-process gather."""

from dist_keras_tpu_torch.comm.backend import (
    barrier,
    fetch_global,
    global_devices,
    group_info,
    initialize,
    is_multi_host,
    local_data_slice,
    local_devices,
    num_processes,
    process_index,
    select_backend,
    shutdown,
)

__all__ = [
    "initialize", "shutdown", "select_backend", "group_info",
    "num_processes", "process_index", "is_multi_host", "local_devices",
    "global_devices", "local_data_slice", "barrier", "fetch_global",
]
