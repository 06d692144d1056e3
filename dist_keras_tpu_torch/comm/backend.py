"""Communication backend — counterpart of ``comm/backend.py``, its
single-process half.

The JAX package brings up a multi-host process group from the
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``
environment (what ``launch.Job`` exports per host) and fetches sharded
arrays across hosts.  The port runs one process on one card: asking for
more — through those variables, a ``torchrun``-style ``WORLD_SIZE``
above 1, or :func:`initialize`'s arguments — raises
``NotImplementedError`` instead of training a lone replica silently.
Workers across cards and hosts through ``torch.distributed`` are
ROADMAP queue 1, item 12b.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dist_keras_tpu_torch.utils.pytree import tree_map

_MULTI_HOST_ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                   "JAX_PROCESS_ID")


def _refuse(what):
    raise NotImplementedError(
        f"{what}: training across processes, hosts or cards is not ported "
        "yet (ROADMAP queue 1, item 12b: workers across cards through "
        "torch.distributed); the port runs W workers stacked on one card")


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Single-process bring-up: a no-op, unless a multi-process group is
    asked for (arguments or environment), which raises."""
    if coordinator_address is not None or (
            num_processes is not None and int(num_processes) > 1):
        _refuse("comm.initialize(coordinator_address / num_processes > 1)")
    env = [name for name in _MULTI_HOST_ENV if os.environ.get(name)]
    if env:
        _refuse(f"the multi-host environment ({', '.join(env)})")
    if int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
        _refuse(f"WORLD_SIZE={os.environ['WORLD_SIZE']}")


def num_processes():
    return 1


def process_index():
    return 0


def is_multi_host():
    return False


def local_data_slice(n_rows, process=None, count=None):
    """Row range [start, stop) a process loads from a global dataset of
    ``n_rows`` (contiguous split, the dealing order of
    ``Dataset.worker_shards``); the whole range for the one process."""
    process = process_index() if process is None else process
    count = num_processes() if count is None else count
    per = n_rows // count
    start = process * per
    stop = n_rows if process == count - 1 else start + per
    return start, stop


def barrier(tag="dist_keras_tpu_barrier", timeout_s=None):
    """Block until this process's queued card work is done (there is no
    other process to wait for); -> the number of participating
    processes, 1."""
    del tag, timeout_s
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return 1


def fetch_global(tree):
    """Device tree -> the same tree of host numpy arrays (the full value:
    one process holds every worker)."""
    return tree_map(lambda x: x.detach().cpu().numpy()
                    if isinstance(x, torch.Tensor) else np.asarray(x), tree)
