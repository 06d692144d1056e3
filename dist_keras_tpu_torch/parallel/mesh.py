"""Worker layout — counterpart of ``parallel/mesh.py``, its one-card half.

The JAX package places one dist-keras worker (a full model replica
running the hot loop, workers.py:~30) on each device of a 1-D
``workers`` mesh.  On one card the port stacks the W workers instead:
every per-worker tensor (local replicas, optimizer state, pulled
snapshots) carries a leading dimension of size W on the trainer's
device, and the cross-worker collectives of ``parallel/collectives.py``
reduce over that dimension.  :func:`worker_mesh` describes that layout;
it needs no device count, so W is not bounded by the number of cards.

The axis names are the JAX package's.  The tensor- and sequence-parallel
meshes (``grid_mesh``, ``replicated``, ``batch_sharded``) and workers
spread over several cards wait for ROADMAP queue 1, items 17 and 12b.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

WORKER_AXIS = "workers"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


@dataclass(frozen=True)
class WorkerMesh:
    """W worker slots stacked on dimension 0 of tensors on ``device``."""

    num_workers: int
    device: torch.device
    axis_names: tuple = (WORKER_AXIS,)

    @property
    def shape(self):
        return {WORKER_AXIS: self.num_workers}

    @property
    def size(self):
        return self.num_workers


def worker_mesh(num_workers, device):
    """-> the :class:`WorkerMesh` of ``num_workers`` stacked slots on
    ``device`` (a ``torch.device`` or its name)."""
    num_workers = int(num_workers)
    if num_workers < 1:
        raise ValueError(f"num_workers={num_workers} must be >= 1")
    return WorkerMesh(num_workers, torch.device(device))
