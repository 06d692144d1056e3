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

Between the ranks of a mesh axis (a ``mesh.RankAxis``: the
``experts`` axis of ``parallel/moe.py``, the ``workers`` / ``model`` /
``seq`` axes of ``make_tp_mesh``, FSDP's ``workers`` axis, the
pipeline's ``stages`` axis) run the collectives that are not the
stacked workers' merge, each an identity that touches no
``torch.distributed`` at size 1:

- :func:`all_to_all`: ``lax.all_to_all(split_axis=0, concat_axis=0)``,
  dim 0 indexed by destination rank before and by source rank after;
  its backward is the same exchange of the cotangents;
- :func:`ring_shift`: ``lax.ppermute`` by ``offset`` along the ring
  (rank i sends to i + offset, receives from i - offset) in one
  ``batch_isend_irecv``; its backward shifts by ``-offset``;
- :func:`sum_across`: ``lax.psum`` of a value every rank then holds
  whole; its backward is the identity (the cotangent is the same on
  every rank), so a loss computed from it on every rank does not scale
  the gradients by the axis size.  It is Megatron's *g*;
- :func:`copy_to`: Megatron's *f*, the conjugate of :func:`sum_across`:
  the identity forward, the sum of every rank's cotangent backward.  A
  replicated activation entering rank-local compute (the column-split
  products of the ``model`` axis) goes through it, so the grads of
  what came before are whole on every rank — JAX's vma-aware transpose
  inserts that psum by itself;
- :func:`cross_rank_sum`: the packed all-reduce (SUM) of a tree, the
  replicated leaves' gradients after a backward;
- :func:`all_gather` / :func:`reduce_scatter` (SUM) along a dimension
  (FSDP's gather before the forward and its gradient scatter);
- :func:`broadcast` from one rank of the axis;
- :func:`isend` / :func:`recv`: one point-to-point message to or from
  a rank of the axis (the pipeline's activations and cotangents).  The
  send is posted and returns its :class:`SendWork` (waited later), the
  receive blocks; each message carries a ``tag`` (gloo matches by
  source and tag, in posting order).

Under gloo (ranks sharing a card) gloo reduces and broadcasts CUDA
tensors itself, but its all-gather, reduce-scatter, all-to-all and
point-to-point read host memory: those stage a CUDA tensor through a
pinned host buffer (:func:`_staged` decides, from the backend and the
tensor's device).  That staging is the transport, not a fallback.
``reduce_stats(op=...)`` counts each kind apart (``"all_reduce"``,
``"all_to_all"``, ``"ring"``, ``"all_gather"``, ``"reduce_scatter"``,
``"broadcast"``, ``"p2p"``).
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

_STATS = {op: {"calls": 0, "bytes": 0, "seconds": 0.0}
          for op in ("all_reduce", "all_to_all", "ring", "all_gather",
                     "reduce_scatter", "broadcast", "p2p")}


def reduce_stats(reset=False, op="all_reduce"):
    """-> ``{"calls", "bytes", "seconds"}`` of the cross-rank
    collectives of kind ``op`` so far: ``"all_reduce"`` (bytes of the
    packed buffers; seconds of the blocking ones, enqueue to done),
    ``"all_to_all"``, ``"ring"``, ``"all_gather"``, ``"reduce_scatter"``,
    ``"broadcast"`` (bytes sent; seconds blocked, the host staging
    included) or ``"p2p"`` (bytes sent; seconds blocked in the
    receives, their staging included); ``reset`` zeroes them."""
    stats = _STATS[op]
    out = dict(stats)
    if reset:
        stats.update(calls=0, bytes=0, seconds=0.0)
    return out


def _count(op, nbytes, t0):
    stats = _STATS[op]
    stats["calls"] += 1
    stats["bytes"] += nbytes
    stats["seconds"] += time.perf_counter() - t0


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


def _cross(tree, ops, async_op=False, group=None):
    """All-reduce every leaf of ``tree`` across the ranks of ``group``
    (None: all of them) with its op in ``ops`` (one per leaf), packed
    per (dtype, device, op); -> the reduced tree, or its
    :class:`PendingReduce` with ``async_op``."""
    import torch.distributed as dist

    stats = _STATS["all_reduce"]
    leaves = tree_leaves(tree)
    buckets = {}
    for i, (x, op) in enumerate(zip(leaves, ops)):
        buckets.setdefault((x.dtype, x.device, op), []).append(i)
    t0 = time.perf_counter()
    jobs = []
    for (_, _, op), idx in buckets.items():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        stats["calls"] += 1
        stats["bytes"] += flat.numel() * flat.element_size()
        jobs.append((dist.all_reduce(flat, op=op, group=group,
                                     async_op=True), flat, idx))
    pending = PendingReduce(tree, list(leaves), jobs)
    if async_op:
        return pending
    with perf.phase("comm_blocked"):
        out = pending.wait()
    stats["seconds"] += time.perf_counter() - t0
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


# -- collectives between the ranks of a mesh axis ---------------------------
def _staged(x):
    """True when ``x`` (a tensor or a device) must cross the host: a CUDA
    tensor under gloo."""
    from dist_keras_tpu_torch.comm import backend as comm

    g = comm.group_info()
    cuda = (x.is_cuda if isinstance(x, torch.Tensor)
            else torch.device(x).type == "cuda")
    return cuda and g is not None and g.backend == "gloo"


def _to_host(x):
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


def _peer(axis, i):
    """The global rank of ``axis``'s rank ``i``."""
    if axis.group is None:
        return i
    import torch.distributed as dist

    return dist.get_global_rank(axis.group, i)


def _exchange(x, axis):
    import torch.distributed as dist

    t0 = time.perf_counter()
    x = x.contiguous()
    staged = _staged(x)
    src = _to_host(x) if staged else x
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=axis.group)
    if staged:
        out = out.to(x.device, non_blocking=True)
    _count("all_to_all", src.numel() * src.element_size(), t0)
    return out


def _shift(x, axis, offset):
    import torch.distributed as dist

    t0 = time.perf_counter()
    n, i = axis.size, axis.index
    x = x.contiguous()
    staged = _staged(x)
    send = _to_host(x) if staged else x
    recv = torch.empty_like(send)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, _peer(axis, (i + offset) % n),
                   axis.group),
        dist.P2POp(dist.irecv, recv, _peer(axis, (i - offset) % n),
                   axis.group)])
    for work in works:
        work.wait()
    if staged:
        recv = recv.to(x.device, non_blocking=True)
    _count("ring", send.numel() * send.element_size(), t0)
    return recv


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _exchange(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.axis), None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, offset):
        ctx.axis, ctx.offset = axis, offset
        return _shift(x, axis, offset)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.axis, -ctx.offset), None, None


def _all_reduce(x, axis):
    import torch.distributed as dist

    t0 = time.perf_counter()
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=axis.group)
    _count("all_reduce", out.numel() * out.element_size(), t0)
    return out


class _SumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


def all_to_all(x, axis):
    """``x`` (axis.size, ...) with dim 0 indexed by destination rank ->
    the same shape with dim 0 indexed by source rank.  Differentiable."""
    if axis.size == 1:
        return x
    if x.shape[0] != axis.size:
        raise ValueError(f"all_to_all over {axis.size} ranks needs dim 0 "
                         f"of {axis.size}, got {tuple(x.shape)}")
    return _AllToAll.apply(x, axis)


def ring_shift(x, axis, offset=1):
    """Rank i's ``x`` lands on rank (i + offset) mod n; -> what rank
    (i - offset) mod n sent.  Differentiable."""
    if axis.size == 1:
        return x
    return _RingShift.apply(x, axis, int(offset))


def sum_across(x, axis):
    """The sum of every rank's ``x``; the backward passes the cotangent
    through unchanged (every rank holds the same one)."""
    if axis.size == 1:
        return x
    return _SumAcross.apply(x, axis)


def cross_rank_sum(tree, axis):
    """Sum every leaf of ``tree`` across ``axis``'s ranks through the
    packed all-reduce (one collective per dtype); the tree itself at
    size 1."""
    if axis.size == 1:
        return tree
    import torch.distributed as dist

    return _cross(tree, [dist.ReduceOp.SUM] * len(tree_leaves(tree)),
                  group=axis.group)


def copy_to(x, axis):
    """``x`` itself; the backward sums every rank's cotangent (Megatron's
    *f*, the conjugate of :func:`sum_across`)."""
    if axis.size == 1:
        return x
    return _CopyTo.apply(x, axis)


def all_gather(x, axis, dim=0):
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the
    tiled all-gather); ``x`` itself at size 1.  Not differentiable."""
    if axis.size == 1:
        return x
    import torch.distributed as dist

    t0 = time.perf_counter()
    xt = x.movedim(dim, 0).contiguous()
    staged = _staged(xt)
    src = _to_host(xt) if staged else xt
    out = src.new_empty((axis.size * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=axis.group)
    if staged:
        out = out.to(x.device, non_blocking=True)
    _count("all_gather", src.numel() * src.element_size(), t0)
    return out.movedim(0, dim)


def reduce_scatter(x, axis, dim=0):
    """The sum of every rank's ``x``, split along ``dim`` into
    ``axis.size`` equal blocks; -> this rank's block (``x`` itself at
    size 1).  Not differentiable."""
    if axis.size == 1:
        return x
    import torch.distributed as dist

    n = axis.size
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter over {n} ranks: dim {dim} of "
                         f"{tuple(x.shape)} does not divide")
    t0 = time.perf_counter()
    xt = x.movedim(dim, 0).contiguous()
    staged = _staged(xt)
    src = _to_host(xt) if staged else xt
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                               group=axis.group)
    if staged:
        out = out.to(x.device, non_blocking=True)
    _count("reduce_scatter", src.numel() * src.element_size(), t0)
    return out.movedim(0, dim)


def broadcast(x, axis, src):
    """Rank ``src`` (its index on ``axis``)'s ``x`` on every rank of the
    axis (every rank passes a tensor of the same shape and dtype); ``x``
    itself at size 1.  Not differentiable."""
    if axis.size == 1:
        return x
    import torch.distributed as dist

    t0 = time.perf_counter()
    out = x.contiguous().clone()
    dist.broadcast(out, _peer(axis, src), group=axis.group)
    _count("broadcast", out.numel() * out.element_size(), t0)
    return out


class SendWork:
    """A posted :func:`isend`: ``wait()`` blocks until the receiver has
    taken it; it keeps the (staged) buffer alive until then."""

    def __init__(self, work, buf):
        self._work, self._buf = work, buf

    def done(self):
        return self._work.is_completed()

    def wait(self):
        self._work.wait()
        self._buf = None


def isend(x, axis, to, tag=0):
    """Post ``x`` to rank ``to`` (its index on ``axis``) with ``tag``;
    -> its :class:`SendWork`.  A CUDA tensor under gloo is copied to a
    pinned host buffer first."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    x = x.contiguous()
    buf = _to_host(x) if _staged(x) else x
    work = dist.isend(buf, _peer(axis, to), group=axis.group, tag=int(tag))
    stats = _STATS["p2p"]
    stats["calls"] += 1
    stats["bytes"] += buf.numel() * buf.element_size()
    stats["seconds"] += time.perf_counter() - t0
    return SendWork(work, buf)


def recv(shape, dtype, device, axis, frm, tag=0):
    """-> the tensor rank ``frm`` (its index on ``axis``) sent with
    ``tag``, on ``device``; blocks until it arrives."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    device = torch.device(device)
    staged = _staged(device)
    buf = torch.empty(tuple(shape), dtype=dtype,
                      device="cpu" if staged else device,
                      pin_memory=staged)
    dist.irecv(buf, _peer(axis, frm), group=axis.group, tag=int(tag)).wait()
    if staged:
        buf = buf.to(device, non_blocking=True)
    _STATS["p2p"]["seconds"] += time.perf_counter() - t0
    return buf
