"""Worker layout and the mesh axes over ranks — counterpart of
``parallel/mesh.py``.

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
index on it, the ``torch.distributed`` group of its ranks).
:func:`grid_mesh` lays an N-D grid of such axes over the group in the
JAX package's device layout: the ranks are reshaped in the axes' dict
order, so on ``(workers, model, seq)`` rank ``r = (w * tp + m) * sp +
s`` holds the block JAX device ``r`` holds.  :func:`make_tp_mesh` is
the transformer step's ``(workers, model, seq)`` grid, the pipeline's
``(workers, stages)`` grid comes from ``parallel/pipeline.py``'s
``make_pp_mesh`` and FSDP's ``workers`` axis from ``grid_mesh``; the
``experts`` axis of ``parallel/moe.py`` is :func:`rank_axis` over the
whole group.  Every collective of ``parallel/collectives.py`` runs
between the ranks of one axis.

A leaf's split over the axes is a :class:`PartitionSpec`, the JAX
package's descriptor: one entry per dimension, the axis name that
dimension is split over or None (``P()``: replicated).
:func:`replicated` and :func:`batch_sharded` are its two common specs;
:func:`tree_map_specs` walks a tree beside its spec tree.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

WORKER_AXIS = "workers"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "experts"
PIPE_AXIS = "stages"


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
    the default group, rank ``index``).  Size 1 runs no collective.
    ``links`` (the ``stages`` axis of more than one rank, made with it by
    :func:`grid_mesh`): ``{(i, j): group}``, a two-rank group for each
    direction i -> j between neighbouring indices, the ring's wrap from
    the last to the first included; the pipeline's messages travel on
    them."""

    name: str
    size: int = 1
    index: int = 0
    group: object = None
    links: dict = field(default=None, compare=False, repr=False)


def rank_axis(name, group=None):
    """-> the :class:`RankAxis` ``name`` over ``group``'s ranks (None:
    every rank of the process group, :func:`grid_mesh`'s one axis; size
    1 single-process)."""
    from dist_keras_tpu_torch.comm import backend as comm

    if group is None:
        return grid_mesh({name: comm.num_processes()}).axis(name)
    import torch.distributed as dist

    return RankAxis(name, dist.get_world_size(group),
                    dist.get_rank(group), group)


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per dimension of a leaf,
    the mesh axis name it is split over or None; ``P()`` replicates.  A
    tuple, so two specs compare equal to each other and to JAX's."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return "P" + tuple.__repr__(self)

    def dim(self, axis):
        """The dimension split over ``axis``, or None."""
        return self.index(axis) if axis in self else None


P = PartitionSpec


def tree_map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree``'s leaves beside the spec tree
    ``specs`` (dict entries matched by key, so the two trees' key orders
    may differ; a spec is a :class:`PartitionSpec` or None) -> a tree
    shaped like ``tree``."""
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(specs,
                                                          PartitionSpec):
        return type(tree)(tree_map_specs(fn, v, s)
                          for v, s in zip(tree, specs))
    return fn(tree, specs)


def replicated(mesh=None):
    """The spec of a leaf every rank holds whole."""
    return P()


def batch_sharded(mesh=None, axis=WORKER_AXIS, ndim=1):
    """The spec that splits a leaf's leading dim over ``axis``."""
    return P(axis, *([None] * (ndim - 1)))


def num_available_devices():
    """The cards this process sees (0 on a host without one)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


@dataclass(frozen=True)
class GridMesh:
    """An N-D grid of :class:`RankAxis` over the process group, in the
    axes' order (the last varies fastest over the ranks).  An axis the
    grid does not name reads as size 1 (:meth:`axis`)."""

    axes: tuple

    @property
    def axis_names(self):
        return tuple(a.name for a in self.axes)

    @property
    def shape(self):
        return {a.name: a.size for a in self.axes}

    @property
    def size(self):
        n = 1
        for a in self.axes:
            n *= a.size
        return n

    def axis(self, name):
        """The :class:`RankAxis` ``name`` (size 1 when not in the grid)."""
        for a in self.axes:
            if a.name == name:
                return a
        return RankAxis(name)

    @property
    def workers(self):
        return self.axis(WORKER_AXIS)

    @property
    def model(self):
        return self.axis(MODEL_AXIS)

    @property
    def seq(self):
        return self.axis(SEQ_AXIS)

    @property
    def stages(self):
        return self.axis("stages")


_MESH_CACHE = {}


def grid_mesh(axis_sizes):
    """The grid ``{name: size, ...}`` over every rank of the process
    group (the sizes' product must be its size; ``ValueError``
    otherwise), e.g. ``{"workers": 2, "model": 2, "seq": 2}`` over 8
    ranks.  Each axis of more than one rank gets a ``torch.distributed``
    group per line of the grid; every rank creates every group, in one
    fixed order, the first time a grid is asked for (``new_group`` must
    be called by every rank of the default group), and the grid is
    cached, so asking again creates none.  An axis spanning every rank
    uses the default group.  The ``stages`` axis also gets its
    per-direction links (:class:`RankAxis`), created the same way."""
    from dist_keras_tpu_torch.comm import backend as comm

    names = tuple(axis_sizes)
    sizes = tuple(int(s) for s in axis_sizes.values())
    world, rank = comm.num_processes(), comm.process_index()
    need = 1
    for s in sizes:
        if s < 1:
            raise ValueError(f"mesh {dict(axis_sizes)}: sizes must be >= 1")
        need *= s
    if need != world:
        raise ValueError(
            f"mesh {dict(axis_sizes)} needs {need} ranks, the process "
            f"group has {world}")
    key = (names, sizes, comm.group_info())
    if key in _MESH_CACHE:
        return _MESH_CACHE[key]
    import numpy as np

    grid = np.arange(world).reshape(sizes)
    where = [int(i) for i in np.unravel_index(rank, sizes)]
    axes = []
    for d, (name, size) in enumerate(zip(names, sizes)):
        group = links = None
        lines = np.moveaxis(grid, d, -1).reshape(-1, size)
        if 1 < size < world:
            import torch.distributed as dist

            for line in lines:       # every rank creates every group
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    group = g
        if name == PIPE_AXIS and size > 1:
            links = _direction_links(lines, rank)
        axes.append(RankAxis(name, size, where[d], group, links))
    mesh = GridMesh(tuple(axes))
    _MESH_CACHE[key] = mesh
    return mesh


def _direction_links(lines, rank):
    """A two-rank group for each direction i -> j between neighbouring
    indices of each line of ranks (j = i +- 1 around the ring), created
    on every rank in one order -> ``{(i, j): group}`` of ``rank``'s
    line.  Under NCCL the sends and receives between two ranks of one
    group share one stream in posting order, so a group a direction
    lets two neighbouring stages send to each other at once."""
    import torch.distributed as dist

    links = {}
    for line in lines:
        p = len(line)
        for i in range(p):
            for j in sorted({(i + 1) % p, (i - 1) % p} - {i}):
                g = dist.new_group([int(line[i]), int(line[j])])
                if rank in line:
                    links[(i, j)] = g
    return links


def make_tp_mesh(dp=1, tp=1, sp=None):
    """The ``(workers, model, seq)`` mesh of ``make_tp_train_step`` over
    the process group: ``dp`` data-parallel replicas, ``tp`` ranks
    splitting the heads and the FFN, ``sp`` ranks splitting the
    sequence (default: the group's size over ``dp * tp``).  A product
    other than the group's size raises ``ValueError``."""
    from dist_keras_tpu_torch.comm import backend as comm

    dp, tp = int(dp), int(tp)
    if sp is None:
        world = comm.num_processes()
        if dp < 1 or tp < 1 or world % (dp * tp):
            raise ValueError(
                f"make_tp_mesh(dp={dp}, tp={tp}): dp * tp must divide the "
                f"process group's {world} rank(s)")
        sp = world // (dp * tp)
    try:
        return grid_mesh({WORKER_AXIS: dp, MODEL_AXIS: tp, SEQ_AXIS: int(sp)})
    except ValueError as e:
        raise ValueError(f"make_tp_mesh(dp={dp}, tp={tp}, sp={sp}): {e}")
