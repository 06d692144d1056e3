"""Process-group layer — counterpart of ``comm/``, its single-process
half (``backend.py``)."""

from dist_keras_tpu_torch.comm.backend import (
    barrier,
    fetch_global,
    initialize,
    is_multi_host,
    local_data_slice,
    num_processes,
    process_index,
)

__all__ = [
    "initialize", "num_processes", "process_index", "is_multi_host",
    "local_data_slice", "barrier", "fetch_global",
]
