"""Windowed-commit machinery and the async optimizer family —
counterpart of ``trainers/windowed.py``.

The reference's asynchronous parameter-server optimizers (workers.py:~230-600
+ parameter_servers.py:~200-330) share one skeleton: train locally for
``communication_window`` batches, then exchange an update with the center
variable.  With the workers stacked on one card the exchange is one
reduction over the worker dimension (``parallel/collectives.py``):

- DOWNPOUR  (workers.py:~230): commit the accumulated weight delta; pull.
  -> center += psum(local - center); local = center.
- ADAG      (workers.py:~300): DOWNPOUR with the delta divided by the
  configured window length before the commit.
  -> center += psum((local - center) / communication_window).
- AEASGD    (workers.py:~370): elastic averaging; every window the worker
  moves toward the center by E = alpha*(theta_i - center) and commits E.
  -> E_i = alpha*(local - center); local -= E_i; center += psum(E_i).
- EAMSGD    (workers.py:~450): AEASGD + Nesterov momentum on the local
  update (the worker optimizer chained with a Nesterov ``trace``).

As in the JAX package all workers commit at the same window boundary:
the communication pattern and the update algebra of the reference, with
zero staleness (DynSGD, whose point is staleness, staggers its commits:
``dynsgd.py``).

A run is a Python loop over windows, each W worker-stacked steps
(``trainers/step.py``'s ``make_worker_step``) and then one merge, on data
resident on the device; window ``g`` reads the epoch's window
``g % windows_per_epoch``, as the JAX scan does.  Nothing in the loop
reads a value back to the host: the losses are fetched once per chunk
(``trainers/chunking.py``).

Randomness: one ``torch.Generator`` on the device, seeded with ``seed``,
feeds every worker's dropout (each worker draws its own mask through
``vmap``'s ``randomness="different"``) and runs on across epochs.  It
cannot reproduce the JAX package's ``fold_in(fold_in(key, epoch),
worker)`` threefry streams, only their distribution.

Not ported yet, each raising: ``checkpoint_every_windows`` (ROADMAP queue
1, item 19) and ``stream_chunk_windows`` / ``max_resident_bytes`` (item
20).
"""

from __future__ import annotations

import warnings

import torch

from dist_keras_tpu_torch.ops.optimizers import chain, trace
from dist_keras_tpu_torch.parallel.collectives import (
    AsyncMerge,
    axis_size,
    tree_psum,
)
from dist_keras_tpu_torch.trainers.base import DistributedTrainer
from dist_keras_tpu_torch.trainers.chunking import (
    init_streaming,
    run_chunked,
    units_first,
)
from dist_keras_tpu_torch.utils import knobs
from dist_keras_tpu_torch.utils.pytree import (
    tree_add,
    tree_merge_floats,
    tree_scale,
    tree_stack,
    tree_sub,
    tree_zeros_like,
)


class AsynchronousDistributedTrainer(DistributedTrainer):
    """Base of the windowed family (trainers.py:~420).

    ``parallelism_factor`` (trainers.py:~310) is accepted for parity and
    is a no-op, as in the JAX package: the reference oversubscribes Spark
    partitions so a straggling executor can be load-balanced, and the
    stacked workers step in lockstep."""

    def __init__(self, keras_model, num_workers=2, communication_window=5,
                 parallelism_factor=1, checkpoint_every_windows=None,
                 stream_chunk_windows=None, max_resident_bytes=None,
                 comm_overlap=None, **kw):
        if checkpoint_every_windows is not None:
            raise NotImplementedError(
                "checkpoint_every_windows: checkpoints, resume and "
                "preemption are not ported yet (ROADMAP queue 1, item 19)")
        init_streaming(self, stream_chunk_windows, max_resident_bytes)
        super().__init__(keras_model, num_workers=num_workers, **kw)
        self.communication_window = int(communication_window)
        self.parallelism_factor = int(parallelism_factor)
        # overlapped window merges: None defers to the DK_COMM_OVERLAP
        # knob at train() time, an explicit bool pins it per trainer
        self.comm_overlap = comm_overlap
        self._overlap = False  # resolved per train() call

    # --- strategy hooks -------------------------------------------------
    def wrap_optimizer(self, tx):
        return tx

    def merge(self, center, local):
        """(center, stacked local) -> (center', stacked local'), once per
        window: the blocked merge."""
        raise NotImplementedError

    # --- overlap decomposition (DK_COMM_OVERLAP) ------------------------
    # The blocked ``merge`` is  commit -> psum -> apply -> absorb  with
    # the apply consumed at once.  The overlapped path applies each
    # window's summed commit one window late (the one-window-stale
    # center of the paper's async model, where a worker's commit is in
    # flight while it trains on), and the final commit is flushed
    # through ``AsyncMerge`` at the end of train().  On one card eager
    # torch has nothing to overlap; the algebra changes the results, so
    # it is kept for parity with the JAX package.
    def commit(self, center, local):
        """The workers' window commit deltas (stacked, before the psum),
        against the center their window started from."""
        raise NotImplementedError(
            f"{type(self).__name__} defines no commit/absorb overlap "
            "decomposition — DK_COMM_OVERLAP needs both (or run this "
            "trainer with the blocked merge: comm_overlap=False)")

    def absorb(self, center, local, delta):
        """The worker-local update after a commit: ``center`` is the
        one-window-stale merged center, ``delta`` each worker's own
        just-committed delta (before the psum)."""
        raise NotImplementedError(
            f"{type(self).__name__} defines no commit/absorb overlap "
            "decomposition — DK_COMM_OVERLAP needs both (or run this "
            "trainer with the blocked merge: comm_overlap=False)")

    # --- shared training loop ------------------------------------------
    def train(self, dataset, shuffle=False):
        """Train over ``num_epoch`` epochs of whole communication windows;
        -> the model holding the final center."""
        model, loss_fn, tx = self._resolve()
        tx = self.wrap_optimizer(tx)
        overlap = self._overlap = bool(
            self.comm_overlap if self.comm_overlap is not None
            else knobs.get("DK_COMM_OVERLAP"))
        if shuffle:
            dataset = dataset.shuffle(seed=self.seed)
        xs, ys = self._shards(dataset)  # (workers, steps, batch, ...)

        W = min(self.communication_window, xs.shape[1])
        wpe = xs.shape[1] // W  # windows per epoch
        # whole windows only, cut per epoch (the remainder is dropped
        # every epoch, like the reference's fixed mini-batching)
        if W < self.communication_window:
            warnings.warn(
                f"communication_window={self.communication_window} > "
                f"{xs.shape[1]} steps per worker per epoch; effective "
                f"window shrunk to {W}", stacklevel=2)
        dropped = xs.shape[1] - wpe * W
        if dropped:
            warnings.warn(
                f"dropping {dropped} trailing step(s) per worker per epoch "
                f"(not a whole communication window)", stacklevel=2)
        n = xs.shape[0]
        xs = xs[:, :wpe * W].reshape(n, wpe, W, *xs.shape[2:])
        ys = ys[:, :wpe * W].reshape(n, wpe, W, *ys.shape[2:])
        # resident as (wpe, W, workers, batch, ...)
        xs, ys = units_first(xs, 2), units_first(ys, 2)
        total_w = self.num_epoch * wpe

        step, opt_init = self._make_worker_step(model, loss_fn, tx)
        center = self._device_params(model.params)
        local = self._stack_workers(center)
        opt_state = self._stack_workers(opt_init(center))
        # the overlap carry: the previous window's summed commit, not yet
        # applied (zeros before the first boundary)
        pending = tree_zeros_like(center) if overlap else None
        generator = torch.Generator(device=self.device).manual_seed(
            self.seed)

        def window(xw, yw):
            nonlocal center, pending, local, opt_state
            carry, losses = (local, opt_state, generator), []
            for j in range(W):
                carry, loss = step(carry, (xw[j], yw[j]))
                losses.append(loss)
            local, opt_state, _ = carry
            # integer leaves are RNG state, not weights: exempt from the
            # merge algebra (tree_merge_floats), as in the JAX package
            if overlap:
                delta = self.commit(center, local)
                center = tree_merge_floats(tree_add(center, pending), center)
                local = tree_merge_floats(
                    self.absorb(center, local, delta), local)
                pending = tree_merge_floats(tree_psum(delta), pending)
            else:
                new_center, new_local = self.merge(center, local)
                center = tree_merge_floats(new_center, center)
                local = tree_merge_floats(new_local, local)
            return losses

        def dispatch(i, K, windows_done, data):
            xs_d, ys_d = data
            losses = []
            for g in range(windows_done, windows_done + K):
                losses += window(xs_d[g % wpe], ys_d[g % wpe])
            # (K*W) x (workers,) -> (workers, K, W)
            return torch.stack(losses, 1).reshape(n, K, W)

        history = run_chunked(
            self, xs, ys, total=total_w, per_epoch=wpe,
            samples_per_unit=n * W * self.batch_size, dispatch=dispatch,
            sync_ref=lambda: center,
            carry_leaves=(center, pending, local, opt_state),
            worker_axis=True)
        if overlap:
            # flush the last window's in-flight commit, so the returned
            # center holds every worker's final delta
            flush = AsyncMerge(
                lambda c, p: tree_merge_floats(tree_add(c, p), c))
            center = flush.submit(center, pending).wait()
        return self._finalize(center, history)


def _pull(center, local):
    """Every worker pulls the center: real per-worker copies of it."""
    return tree_stack(center, axis_size(local))


class DOWNPOUR(AsynchronousDistributedTrainer):
    """trainers.py:~470 / workers.py:~230."""

    def __init__(self, keras_model, communication_window=5, **kw):
        super().__init__(keras_model,
                         communication_window=communication_window, **kw)

    def merge(self, center, local):
        center = tree_add(center, tree_psum(tree_sub(local, center)))
        return center, _pull(center, local)

    def commit(self, center, local):
        return tree_sub(local, center)

    def absorb(self, center, local, delta):
        # DOWNPOUR pulls the center after its commit; overlapped, the
        # pulled center is one window stale (the commit is in flight)
        return _pull(center, local)


class ADAG(AsynchronousDistributedTrainer):
    """Accumulated-gradient normalisation (trainers.py:~530,
    workers.py:~300): the window's accumulated delta is divided by the
    configured window length — not the effective one after a shrink
    warning, as in the JAX package — before the commit."""

    def __init__(self, keras_model, communication_window=12, **kw):
        super().__init__(keras_model,
                         communication_window=communication_window, **kw)

    def merge(self, center, local):
        delta = tree_scale(tree_sub(local, center),
                           1.0 / self.communication_window)
        center = tree_add(center, tree_psum(delta))
        return center, _pull(center, local)

    def commit(self, center, local):
        return tree_scale(tree_sub(local, center),
                          1.0 / self.communication_window)

    def absorb(self, center, local, delta):
        return _pull(center, local)


class AEASGD(AsynchronousDistributedTrainer):
    """Asynchronous elastic averaging SGD (trainers.py:~590,
    workers.py:~370). alpha = learning_rate * rho."""

    def __init__(self, keras_model, communication_window=32, rho=5.0,
                 learning_rate=0.1, **kw):
        super().__init__(keras_model,
                         communication_window=communication_window, **kw)
        self.rho = float(rho)
        self.learning_rate = float(learning_rate)

    def merge(self, center, local):
        alpha = self.learning_rate * self.rho
        elastic = tree_scale(tree_sub(local, center), alpha)
        local = tree_sub(local, elastic)
        center = tree_add(center, tree_psum(elastic))
        return center, local

    def commit(self, center, local):
        alpha = self.learning_rate * self.rho
        return tree_scale(tree_sub(local, center), alpha)

    def absorb(self, center, local, delta):
        # the elastic force moves the worker toward the center it
        # measured against (one window stale under overlap); the worker
        # keeps its own replica, unlike the pull-based family
        return tree_sub(local, delta)


class EAMSGD(AEASGD):
    """AEASGD + Nesterov momentum on the local update (trainers.py:~650,
    workers.py:~450): the worker optimizer's updates go through a Nesterov
    momentum trace."""

    def __init__(self, keras_model, momentum=0.9, **kw):
        super().__init__(keras_model, **kw)
        self.momentum = float(momentum)

    def wrap_optimizer(self, tx):
        return chain(tx, trace(self.momentum, nesterov=True))
