"""Worker layout — counterpart of ``parallel/mesh.py``, its one-card half.

The JAX package places one dist-keras worker (a full model replica
running the hot loop, workers.py:~30) on each device of a 1-D
``workers`` mesh.  On one card the port stacks the W workers instead:
every per-worker tensor (local replicas, optimizer state, pulled
snapshots) carries a leading dimension of size W on the trainer's
device, and the cross-worker collectives of ``parallel/collectives.py``
reduce over that dimension.  :func:`worker_mesh` describes that layout;
it needs no device count, so W is not bounded by the number of cards.

Across processes (a ``torch.distributed`` group, ``comm/backend.py``)
each rank stacks a contiguous range ``[lo, hi)`` of the W global worker
slots, ``comm.local_data_slice(W)`` (the last rank takes the
remainder), which is the JAX package's process-ordered device layout
when W divides evenly; the collectives then reduce over the local
dimension and all-reduce across the ranks.

The axis names are the JAX package's.  The tensor- and sequence-parallel
meshes (``grid_mesh``, ``replicated``, ``batch_sharded``) wait for
ROADMAP queue 1, item 17.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

WORKER_AXIS = "workers"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


@dataclass(frozen=True)
class WorkerMesh:
    """W worker slots over ``world`` processes: this process (``rank``)
    stacks slots ``[lo, hi)`` on dimension 0 of tensors on ``device``."""

    num_workers: int
    device: torch.device
    axis_names: tuple = (WORKER_AXIS,)
    rank: int = 0
    world: int = 1
    lo: int = 0
    hi: int = None

    def __post_init__(self):
        if self.hi is None:
            object.__setattr__(self, "hi", self.num_workers)

    @property
    def num_local(self):
        """The worker slots this process stacks, ``hi - lo``."""
        return self.hi - self.lo

    @property
    def shape(self):
        return {WORKER_AXIS: self.num_workers}

    @property
    def size(self):
        return self.num_workers


def worker_mesh(num_workers, device, rank=None, world=None):
    """-> the :class:`WorkerMesh` of ``num_workers`` slots on ``device``
    (a ``torch.device`` or its name), dealt over ``world`` processes as
    ``comm.local_data_slice`` deals rows; ``rank`` / ``world`` default
    to the process group's (0 / 1 single-process).  A process left with
    no slot raises ``ValueError``."""
    from dist_keras_tpu_torch.comm import backend as comm

    num_workers = int(num_workers)
    if num_workers < 1:
        raise ValueError(f"num_workers={num_workers} must be >= 1")
    rank = comm.process_index() if rank is None else int(rank)
    world = comm.num_processes() if world is None else int(world)
    lo, hi = comm.local_data_slice(num_workers, process=rank, count=world)
    if hi <= lo:
        raise ValueError(
            f"num_workers={num_workers} over {world} processes leaves "
            f"rank {rank} no worker (the contiguous deal gives each of "
            f"the first {world - 1} ranks {num_workers // world}); pass "
            f"num_workers >= {world}")
    return WorkerMesh(num_workers, torch.device(device), rank=rank,
                      world=world, lo=lo, hi=hi)
