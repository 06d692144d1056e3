"""Collective helpers over worker-stacked trees — counterpart of
``parallel/collectives.py``.

The JAX package calls these inside ``shard_map`` with the ``workers``
axis bound, one worker per device.  Here the W workers are stacked on
dimension 0 of every per-worker leaf (``parallel/mesh.py``), so a
collective is a reduction over that dimension and runs as one eager op
per leaf on the card:

- ``tree_psum``: sum over dim 0 — the 'everybody commits a delta'
  aggregate (parameter_servers.py:~240);
- ``tree_pmean``: mean over dim 0 — AveragingTrainer's merge;
- ``tree_pmean_sync``: the mean for floating leaves, the max for the
  rest (lockstep integer counters);
- ``tree_all_gather``: every worker's view of the whole stack, which is
  the stacked tree itself;
- ``tree_ppermute``: ``lax.ppermute``'s (source, destination) pairs over
  dim 0; a slot that no pair writes gets zeros.

The reductions return unstacked trees (the center's layout); a result
every worker holds its own copy of is made with
``utils.pytree.tree_stack``.

Across processes (``comm/backend.py``'s group, each rank stacking its
own range of the workers) a reduction first reduces the local dim 0,
then all-reduces across the ranks (SUM; MAX for ``tree_pmean_sync``'s
integer leaves), one collective per dtype: the leaves are packed into
one flat buffer each.  ``tree_pmean`` and ``tree_pmean_sync`` divide
by the global worker count their caller passes (``total``).
``tree_psum(tree, async_op=True)`` returns a :class:`PendingReduce`
whose :meth:`~PendingReduce.wait` waits the collective's ``Work``;
:class:`AsyncMerge` holds one in flight.  A
blocking cross-rank all-reduce's wall lands in
``perf.phase.comm_blocked``; :func:`reduce_stats` counts the calls,
bytes and seconds.  With one process nothing of this runs: the code
path is the stacked reduction alone.  ``tree_pvary`` has no counterpart: with
explicit stacking there is no implicit replicated-to-varying promotion
to guard against, as long as per-worker copies are real copies, never
``expand`` views.
"""

from __future__ import annotations

import time

import torch

from dist_keras_tpu_torch.observability import perf
from dist_keras_tpu_torch.resilience.faults import fault_point

from dist_keras_tpu_torch.utils.pytree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)

_stats = {"calls": 0, "bytes": 0, "seconds": 0.0}


def reduce_stats(reset=False):
    """-> ``{"calls", "bytes", "seconds"}`` of the cross-rank
    all-reduces so far (bytes of the packed buffers; seconds of the
    blocking ones, enqueue to done); ``reset`` zeroes them."""
    out = dict(_stats)
    if reset:
        _stats.update(calls=0, bytes=0, seconds=0.0)
    return out


def _group():
    """The process group's facts when it spans several processes."""
    from dist_keras_tpu_torch.comm import backend as comm

    g = comm.group_info()
    return g if g is not None and g.world > 1 else None


class PendingReduce:
    """A cross-rank all-reduce in flight: ``wait()`` waits each packed
    bucket's ``Work`` and returns the reduced tree (views into the
    buckets).  With nothing in flight ``wait()`` returns the tree."""

    def __init__(self, tree, leaves, jobs):
        self._tree, self._leaves, self._jobs = tree, leaves, jobs

    @property
    def tree(self):
        return self._tree

    def wait(self):
        for work, flat, idx in self._jobs:
            work.wait()
            parts = flat.split([self._leaves[i].numel() for i in idx])
            for i, part in zip(idx, parts):
                self._leaves[i] = part.view(self._leaves[i].shape)
        if self._jobs:
            self._jobs = []
            self._tree = tree_unflatten(self._tree, self._leaves)
        return self._tree


def _cross(tree, ops, async_op=False):
    """All-reduce every leaf of ``tree`` across the ranks with its op in
    ``ops`` (one per leaf), packed per (dtype, device, op); -> the
    reduced tree, or its :class:`PendingReduce` with ``async_op``."""
    import torch.distributed as dist

    leaves = tree_leaves(tree)
    buckets = {}
    for i, (x, op) in enumerate(zip(leaves, ops)):
        buckets.setdefault((x.dtype, x.device, op), []).append(i)
    t0 = time.perf_counter()
    jobs = []
    for (_, _, op), idx in buckets.items():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        _stats["calls"] += 1
        _stats["bytes"] += flat.numel() * flat.element_size()
        jobs.append((dist.all_reduce(flat, op=op, async_op=True), flat,
                     idx))
    pending = PendingReduce(tree, list(leaves), jobs)
    if async_op:
        return pending
    with perf.phase("comm_blocked"):
        out = pending.wait()
    _stats["seconds"] += time.perf_counter() - t0
    return out


def _total(total):
    """The global worker count a cross-rank mean divides by."""
    if total is None:
        raise ValueError(
            "a mean across processes needs the global worker count: "
            "pass total= (the trainer's num_workers)")
    return int(total)


def tree_psum(tree, async_op=False):
    """Sum a worker-stacked tree over its workers, in each leaf's dtype
    (as ``lax.psum``; torch would widen integer sums to int64), and
    across the ranks of a process group.  ``async_op`` -> a
    :class:`PendingReduce`."""
    local = tree_map(lambda x: x.sum(0, dtype=x.dtype), tree)
    if _group() is None:
        return PendingReduce(local, [], []) if async_op else local
    import torch.distributed as dist

    return _cross(local, [dist.ReduceOp.SUM] * len(tree_leaves(local)),
                  async_op)


def tree_pmean(tree, total=None):
    """Average a worker-stacked tree over its workers (every rank's:
    ``total`` is their global count, needed across processes)."""
    if _group() is None:
        return tree_map(lambda x: x.mean(0), tree)
    total = _total(total)
    summed = tree_psum(tree)
    return tree_map(lambda x: x / total, summed)


def tree_pmean_sync(tree, total=None):
    """Average floating leaves over the workers; the max of the rest.

    Integer leaves (seed counters riding in a model's params) advance in
    lockstep on every worker, so the max is their common value.
    ``total`` is the global worker count, needed across processes."""
    if _group() is None:
        return tree_map(lambda x: x.mean(0) if torch.is_floating_point(x)
                        else x.amax(0), tree)
    import torch.distributed as dist

    total = _total(total)
    local = tree_map(lambda x: x.sum(0, dtype=x.dtype)
                     if torch.is_floating_point(x) else x.amax(0), tree)
    ops = [dist.ReduceOp.SUM if torch.is_floating_point(x)
           else dist.ReduceOp.MAX for x in tree_leaves(local)]
    return tree_map(lambda x: x / total if torch.is_floating_point(x)
                    else x, _cross(local, ops))


def tree_all_gather(tree):
    """Every worker's gathered view: the (W, ...) stack itself."""
    return tree


def tree_ppermute(tree, perm):
    """``lax.ppermute`` over dim 0: for each ``(src, dst)`` in ``perm``
    slot ``dst`` receives slot ``src``; slots no pair writes are zeros."""
    perm = [(int(s), int(d)) for s, d in perm]
    dsts = [d for _, d in perm]
    if len(set(dsts)) != len(dsts) or len({s for s, _ in perm}) != len(perm):
        raise ValueError(f"perm {perm} repeats a source or a destination")
    src_of = {d: s for s, d in perm}

    def shift(x):
        n = x.shape[0]
        if any(not 0 <= i < n for pair in perm for i in pair):
            raise ValueError(f"perm {perm} names a slot outside 0..{n - 1}")
        return torch.stack([x[src_of[d]] if d in src_of
                            else torch.zeros_like(x[0]) for d in range(n)])

    return tree_map(shift, tree)


def axis_size(tree):
    """The number of workers a stacked tree holds (its leaves' dim 0)."""
    return int(tree_leaves(tree)[0].shape[0])


def _card_event(tree):
    """A CUDA event recorded behind ``tree``'s card work, or None when
    its leaves are on the CPU."""
    cards = {x.device for x in tree_leaves(tree)
             if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    if not cards:
        return None
    (card,) = cards
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(card))
    return event


class AsyncMerge:
    """Host-level async tree merge with at most one merge in flight
    (``DK_COMM_OVERLAP``'s flush).

    :meth:`submit` enqueues ``merge_fn(*args)`` — eager CUDA ops return
    as soon as they are queued — and records a CUDA event behind it;
    :meth:`wait` synchronizes that event and returns the result.  A
    second :meth:`submit` first waits out the previous merge, which
    bounds device memory at two result buffers.  On the CPU the ops
    have finished when they return, so :meth:`wait` only hands the
    result back.  ``submits`` and ``waits`` count the calls.

    When ``merge_fn`` returns a :class:`PendingReduce` (``tree_psum(...,
    async_op=True)`` across ranks) the all-reduce is in flight from
    ``submit`` and :meth:`wait` is its ``Work.wait()`` alone: that orders
    the current stream behind the collective (NCCL's stream, gloo's copy
    back to the card) without draining the work queued after it.

    The ``comm.merge`` fault point fires at each submit, so a chaos
    schedule can kill or delay the Nth merge.  The submit's (enqueue)
    wall lands in ``perf.phase.comm_overlap`` and the wait's (blocking)
    wall in ``perf.phase.comm_blocked``: a blocked merge pays its whole
    wall in ``comm_blocked``, an overlapped one only what did not hide
    under the work enqueued after it."""

    def __init__(self, merge_fn):
        self._fn = merge_fn
        self._inflight = None     # result tree of the enqueued merge
        self._event = None
        self._result = None
        self.submits = 0
        self.waits = 0

    @property
    def pending(self):
        """True while a submitted merge has not been waited yet."""
        return self._inflight is not None

    def submit(self, *args):
        """Enqueue ``merge_fn(*args)``; -> self.  Waits out a previous
        merge first."""
        if self._inflight is not None:
            self.wait()
        fault_point("comm.merge")
        with perf.phase("comm_overlap"):
            result = self._fn(*args)
            self._event = (None if isinstance(result, PendingReduce)
                           else _card_event(result))
        self._inflight = result
        self.submits += 1
        return self

    def wait(self):
        """Block until the in-flight merge is done; -> its result (the
        last result again when nothing is in flight)."""
        if self._inflight is None:
            return self._result
        with perf.phase("comm_blocked"):
            result = self._inflight
            if isinstance(result, PendingReduce):
                result = result.wait()
            elif self._event is not None:
                self._event.synchronize()
        self._result, self._inflight, self._event = result, None, None
        self.waits += 1
        return self._result
