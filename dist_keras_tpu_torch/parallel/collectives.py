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
``utils.pytree.tree_stack``.  ``tree_pvary`` has no counterpart: with
explicit stacking there is no implicit replicated-to-varying promotion
to guard against, as long as per-worker copies are real copies, never
``expand`` views.
"""

from __future__ import annotations

import torch

from dist_keras_tpu_torch.observability import perf
from dist_keras_tpu_torch.resilience.faults import fault_point

from dist_keras_tpu_torch.utils.pytree import tree_leaves, tree_map


def tree_psum(tree):
    """Sum a worker-stacked tree over its workers, in each leaf's dtype
    (as ``lax.psum``; torch would widen integer sums to int64)."""
    return tree_map(lambda x: x.sum(0, dtype=x.dtype), tree)


def tree_pmean(tree):
    """Average a worker-stacked tree over its workers."""
    return tree_map(lambda x: x.mean(0), tree)


def tree_pmean_sync(tree):
    """Average floating leaves over the workers; the max of the rest.

    Integer leaves (seed counters riding in a model's params) advance in
    lockstep on every worker, so the max is their common value."""
    return tree_map(lambda x: x.mean(0) if torch.is_floating_point(x)
                    else x.amax(0), tree)


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
            cards = {x.device for x in tree_leaves(result)
                     if isinstance(x, torch.Tensor)
                     and x.device.type == "cuda"}
            self._event = None
            if cards:
                (card,) = cards
                self._event = torch.cuda.Event()
                self._event.record(torch.cuda.current_stream(card))
        self._inflight = result
        self.submits += 1
        return self

    def wait(self):
        """Block until the in-flight merge is done; -> its result (the
        last result again when nothing is in flight)."""
        if self._inflight is None:
            return self._result
        with perf.phase("comm_blocked"):
            if self._event is not None:
                self._event.synchronize()
        self._result, self._inflight, self._event = self._inflight, None, None
        self.waits += 1
        return self._result
