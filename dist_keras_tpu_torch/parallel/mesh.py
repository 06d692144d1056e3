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

The axis names are the JAX package's.  A mesh axis laid over the ranks
of the process group is a :class:`RankAxis` (its size, this rank's
index on it, the ``torch.distributed`` group): the ``experts`` axis of
``parallel/moe.py`` and the ``seq`` axis of :func:`make_tp_mesh`, whose
collectives (``parallel/collectives.py``) run between those ranks.  The
tensor-parallel and data x sequence meshes (``make_tp_mesh`` with
``tp > 1`` or ``dp > 1``, ``grid_mesh``, ``replicated``,
``batch_sharded``) wait for ROADMAP queue 1, item 17.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

WORKER_AXIS = "workers"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "experts"


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


@dataclass(frozen=True)
class RankAxis:
    """A mesh axis of ``size`` ranks; this process is ``index`` on it.
    ``group`` is the ``torch.distributed`` group of those ranks (None:
    the default group, rank ``index``).  Size 1 runs no collective."""

    name: str
    size: int = 1
    index: int = 0
    group: object = None


def rank_axis(name, group=None):
    """-> the :class:`RankAxis` ``name`` over ``group``'s ranks (None:
    every rank of the process group; size 1 single-process)."""
    from dist_keras_tpu_torch.comm import backend as comm

    if group is None:
        return RankAxis(name, comm.num_processes(), comm.process_index())
    import torch.distributed as dist

    return RankAxis(name, dist.get_world_size(group),
                    dist.get_rank(group), group)


@dataclass(frozen=True)
class TPMesh:
    """The transformer step's ``(workers, model, seq)`` mesh over the
    ranks: ``seq`` is a :class:`RankAxis`; ``workers`` and ``model``
    are 1 (item 17)."""

    seq: RankAxis

    @property
    def shape(self):
        return {WORKER_AXIS: 1, MODEL_AXIS: 1, SEQ_AXIS: self.seq.size}


def make_tp_mesh(dp=1, tp=1, sp=None):
    """The ``(workers, model, seq)`` mesh of ``make_tp_train_step``
    over the process group: ``sp`` (default: every rank) is the
    ``seq`` axis, one rank per sequence block.  ``dp > 1`` or
    ``tp > 1`` raise ``NotImplementedError`` (ROADMAP queue 1, item
    17); an ``sp`` other than the group's size raises ``ValueError``."""
    if int(dp) != 1 or int(tp) != 1:
        raise NotImplementedError(
            f"make_tp_mesh(dp={dp}, tp={tp}): data and tensor parallelism "
            "across ranks are not ported yet (ROADMAP queue 1, item 17); "
            "the port's mesh is dp=1, tp=1, sp=<ranks>")
    seq = rank_axis(SEQ_AXIS)
    if sp is not None and int(sp) != seq.size:
        raise ValueError(
            f"make_tp_mesh(sp={sp}) over a process group of {seq.size} "
            "rank(s): sp must be the group's size")
    return TPMesh(seq)
