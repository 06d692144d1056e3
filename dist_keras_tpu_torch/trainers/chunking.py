"""Chunked dispatch for the trainers — counterpart of
``trainers/chunking.py``.

A run of N units (steps for ``SingleTrainer``, ``AveragingTrainer``,
``EnsembleTrainer`` and ``DynSGD``, communication windows for the
windowed family) is cut into dispatch chunks at the union of epoch
boundaries (when callbacks are registered), checkpoint-cadence points
counted from the resume point and, when streaming, data-chunk
boundaries, and driven through :class:`ChunkRunner`.  A chunk's steps
run as a Python loop that never waits for the card, so the host
enqueues ahead of the device.  At a boundary (an epoch's end, a due
checkpoint, the last chunk) the runner waits for the card and fetches
the pending chunks' losses to the host, where the reference fetches its
scan's losses; that fetch is where the NaN policy is applied, per-epoch
metrics are recorded, a due checkpoint is saved (before user callbacks)
and callbacks fire.

Data is resident or streamed.  Resident: the epoch's batches are copied
to the card once, before the clock starts, laid out units first
(:func:`_layout`), and a step reads its batch by its epoch-relative
index.  Streamed (``stream_chunk_steps`` / ``stream_chunk_windows``, or
a ``max_resident_bytes`` budget the epoch exceeds): the epoch stays on
the host and a ``data.feed.ChunkFeed`` ships each chunk through the
trainer's pinned staging ring and copy stream (``Trainer._chunk_put``).
The runner retires chunk i-1 (its one loss fetch, which waits for its
compute) before it prefetches chunk i+1, so at most two chunks are ever
on the card and chunk i+1's copy runs under chunk i.  That retire stays
inside the clock: it is the backpressure a streamed run pays.  Both
paths give the same bits: a streamed chunk is indexed like the resident
epoch (:class:`_Shifted`).

Preemption (``handle_preemption``): the SIGTERM/SIGINT handler only sets
a flag; each chunk boundary reads it, puts it to a cluster vote
(``coordination.any_flag``; free on one process) and, when set, dumps
the flight recorder (``preempt``, when the event log is on), saves the
boundary checkpoint, verifies it and raises ``Preempted`` (128+signum)
carrying the verified ``saved_step``.

Losses come to the host through ``fetch_global``: the identity copy for
``SingleTrainer`` (each rank's loss is its own), the cross-rank gather
(``comm.fetch_global``) for the distributed trainers, whose history is
then every rank's workers on every rank.

Telemetry, as the JAX runner's: ``perf.phase`` histograms for ``data``
(the feed's get and prefetch, the host's staging copy included),
``step`` (the dispatch's enqueue, the boundary's wait and each loss
fetch), ``comm`` (the votes) and ``ckpt``, and before the runner starts
``layout`` (the resident epoch's transpose, its copy to the card and the
drain; streamed, chunk 0's get and drain), timed on the trainer's card
too; ``perf.d2h`` per fetch,
``perf.count_dispatch`` per chunk; the ``step.loss`` fault point over
each fetched loss array; a ``train.run`` span rooting the run; and a
``chunk`` event per chunk with ``streamed``.
"""

from __future__ import annotations

import signal
import time

import numpy as np
import torch

from dist_keras_tpu_torch.observability import events as obs_events
from dist_keras_tpu_torch.observability import flight
from dist_keras_tpu_torch.observability import perf
from dist_keras_tpu_torch.observability import spans as obs_spans
from dist_keras_tpu_torch.resilience import coordination, preemption
from dist_keras_tpu_torch.resilience.faults import fault_point
from dist_keras_tpu_torch.resilience.guards import check_losses
from dist_keras_tpu_torch.resilience.preemption import Preempted
from dist_keras_tpu_torch.utils.sync import drain


def to_host(losses):
    """The identity fetch: this process's losses copied to the host as
    numpy."""
    if isinstance(losses, torch.Tensor):
        return losses.detach().cpu().numpy()
    return np.asarray(losses)


def init_streaming(trainer, chunk, budget, name="stream_chunk_windows"):
    """Validate and install the streaming kwargs every trainer shares."""
    # None = off; anything else must be a positive int (0 raises like
    # every other out-of-range value rather than silently meaning "off")
    value = None if chunk is None else int(chunk)
    if value is not None and value < 1:
        raise ValueError(f"{name}={chunk} must be >= 1")
    setattr(trainer, name, value)
    trainer.max_resident_bytes = None if budget is None else int(budget)
    if trainer.max_resident_bytes is not None \
            and trainer.max_resident_bytes < 1:
        raise ValueError(f"max_resident_bytes={budget} must be >= 1")
    trainer._streamed = False  # set by train(); introspectable by tests


def _layout(unit_dims):
    """Host ``(workers, *units, batch, ...)`` -> the resident layout as a
    view: ``(*units, workers, batch, ...)``, so each step reads one
    contiguous ``(workers, batch, ...)`` slab; ``unit_dims=None`` (one
    worker, no worker dim on the card) drops the leading dummy axis."""
    if unit_dims is None:
        return lambda a: a[0]
    return lambda a: a.transpose(
        (*range(1, 1 + unit_dims), 0, *range(1 + unit_dims, a.ndim)))


def reject_stale_checkpoint(restored, required_key, trainer, detail):
    """Raise the shared actionable error for a checkpoint written by a
    pre-step-granular version of ``trainer``: the missing key is the
    only tell (a pickle-format checkpoint restores without a template
    match)."""
    if restored is not None and required_key not in restored:
        raise ValueError(
            f"checkpoint predates step-granular {trainer} state "
            f"({detail}) — restart training or point checkpoint_dir at "
            "a fresh directory")


def chunk_plan(start, total, per_epoch, *, epoch_bounds=False,
               cadence=None, data_chunk=None):
    """Chunk sizes (in units) for the dispatch loop, from ``start`` (the
    resume point) to ``total``:

    - ``epoch_bounds``: cut at every epoch boundary (callbacks need
      on_epoch_end at real epoch ends);
    - ``cadence=N``: cut every N units counted from ``start`` — the
      checkpoint grid;
    - ``data_chunk=C``: streaming — cut at every epoch boundary AND every
      C-th unit within each epoch, aligned to the epoch start (not the
      resume point, so a resumed run reuses the same chunk grid); each
      chunk's data is then one contiguous epoch-relative slice of <= C
      units, the feed's transfer unit.

    No cuts = one chunk."""
    remaining = total - start
    if remaining <= 0:
        return []
    bounds = {total}
    if epoch_bounds:
        first = (start // per_epoch + 1) * per_epoch
        bounds |= set(range(first, total, per_epoch))
    if cadence:
        bounds |= set(range(start + cadence, total, cadence))
    if data_chunk:
        # k=0 of the grid lands on every epoch boundary too
        for e in range(start // per_epoch, -(-total // per_epoch)):
            bounds |= {e * per_epoch + k
                       for k in range(0, per_epoch, data_chunk)
                       if start < e * per_epoch + k}
    cuts = sorted(b for b in bounds if start < b <= total)
    out, prev = [], start
    for b in cuts:
        out.append(b - prev)
        prev = b
    return out


def resolve_stream_chunk(requested, budget, per_device_epoch_bytes,
                         per_epoch):
    """-> the streaming chunk size in units, or None.

    ``requested`` wins when set; otherwise ``budget`` (bytes of data
    residency on the device) sizes a chunk so TWO chunks (running and
    prefetched) fit inside it — only when the epoch exceeds the
    budget."""
    C = requested
    if C is None and budget and per_device_epoch_bytes > budget:
        per_unit = max(1, per_device_epoch_bytes // per_epoch)
        C = max(1, budget // (2 * per_unit))
    if C:
        C = max(1, min(int(C), per_epoch))
    return C


def epoch_spans(plan, start, per_epoch):
    """Epoch-relative (offset, length) data slices, one per chunk."""
    u, spans = start, []
    for K in plan:
        spans.append((u % per_epoch, K))
        u += K
    return spans


class _Shifted:
    """A streamed chunk indexed like the resident epoch: epoch unit
    ``u`` is the chunk's row ``u - offset``."""

    __slots__ = ("rows", "offset")

    def __init__(self, rows, offset):
        self.rows, self.offset = rows, offset

    def __getitem__(self, u):
        return self.rows[u - self.offset]


def run_chunked(trainer, xs, ys, *, total, per_epoch, samples_per_unit,
                dispatch, sync_ref, carry_leaves, start=0, cadence=None,
                state_fn=None, stream_units=None, unit_dims=None,
                fetch_global=None):
    """Streaming decision -> chunk plan -> resident data or a feed ->
    :class:`ChunkRunner` -> the history.

    ``xs`` / ``ys`` are the epoch's host arrays ``(workers, *units,
    batch, ...)`` with ``unit_dims`` unit dims (1: steps; 2: windows of
    steps), or ``(1, steps, batch, ...)`` with ``unit_dims=None`` for one
    worker and no worker dim on the card.  ``dispatch(i, K, units_done,
    data)`` gets ``data`` indexable by epoch-relative unit, whichever
    path.  ``stream_units`` is the trainer's requested streaming chunk
    in units; the epoch's bytes (every worker's: they share the card)
    against ``trainer.max_resident_bytes`` may turn streaming on.  The
    resident copy (or chunk 0's, streamed) and the carry state land
    before the clock starts.  ``start`` is the resume point in units,
    ``cadence`` the checkpoint grid and ``state_fn() -> dict`` the
    checkpoint payload (evaluated only when a save is due).
    ``fetch_global`` brings a chunk's device losses to the host
    (default :func:`to_host`, this process's own).

    One worker: each chunk's losses are ``(K,)`` and the history is the
    run's losses, flat.  Otherwise each chunk's losses are ``(workers,
    K, ...)``, concatenated along axis 1 and reshaped to ``(workers,
    epochs, per_epoch, ...)`` when the run covered whole epochs — a run
    resumed mid-epoch keeps its losses flat, ``(workers, units, ...)``,
    as in the reference."""
    stream_C = resolve_stream_chunk(
        stream_units, trainer.max_resident_bytes, xs.nbytes + ys.nbytes,
        per_epoch)
    trainer._streamed = bool(stream_C)
    plan = chunk_plan(start, total, per_epoch,
                      epoch_bounds=bool(trainer.callbacks), cadence=cadence,
                      data_chunk=stream_C)
    layout = _layout(unit_dims)
    feed = None
    if stream_C:
        from dist_keras_tpu_torch.data.feed import ChunkFeed

        spans = epoch_spans(plan, start, per_epoch)
        feed = ChunkFeed(spans, trainer._chunk_put(
            layout, max((k for _, k in spans), default=1)), xs, ys)
        trainer._last_feed = feed  # test introspection
        # chunk 0's copy and the carry land OUTSIDE the clock, like the
        # resident path's one copy; chunks 1.. copy inside it, under the
        # running dispatch (plan may be empty: resume of a finished run)
        with perf.phase("layout", device=trainer.device):
            first = feed.get(0) if plan else ()
            drain(*carry_leaves, *first)

        def run_one(i, K, units_done, data):
            off = spans[i][0]
            return dispatch(i, K, units_done,
                            tuple(_Shifted(t, off) for t in data))
        resident = ()
    else:
        with perf.phase("layout", device=trainer.device):
            resident = tuple(
                torch.from_numpy(np.ascontiguousarray(layout(a))).to(
                    trainer.device) for a in (xs, ys))
            # data AND carry-state copies complete OUTSIDE the clock
            drain(*resident, *carry_leaves)
        run_one = dispatch
    runner = ChunkRunner(trainer, plan=plan, start=start, total=total,
                         per_epoch=per_epoch,
                         samples_per_unit=samples_per_unit, cadence=cadence,
                         feed=feed, fetch_global=fetch_global)
    all_losses = runner.run(run_one, sync_ref=sync_ref, state_fn=state_fn,
                            resident_data=resident)
    if not all_losses:
        return []
    if unit_dims is None:
        return np.concatenate(all_losses).tolist()
    flat = np.concatenate(all_losses, axis=1)
    if flat.shape[1] % per_epoch == 0:
        flat = flat.reshape(flat.shape[0], -1, per_epoch, *flat.shape[2:])
    return flat.tolist()


class ChunkRunner:
    """Drives a chunk plan: dispatch, the depth-2 retire when streamed,
    and at each boundary the wait for the card, the loss fetches, the
    NaN policy, a due checkpoint and the epoch's record.

    - ``dispatch(i, K, units_done, data) -> device losses`` (``(K,)``,
      or ``(workers, K, ...)``) — enqueue chunk i (the trainer
      reassigns its carry inside);
    - ``sync_ref() -> tree`` — what to ``drain`` at a boundary;
    - ``state_fn() -> dict`` — the checkpoint payload.

    Timing: the clock covers dispatch, the streamed retire (one blocking
    loss fetch of the previous chunk: the backpressure that keeps two
    chunks on the card, genuine training wall) and the boundary's wait;
    the boundary's loss fetches, checkpoint saves, metrics and
    callbacks run off it."""

    def __init__(self, trainer, *, plan, start, total, per_epoch,
                 samples_per_unit, cadence=None, feed=None,
                 fetch_global=None):
        self.tr = trainer
        self.plan = plan
        self.start = start
        self.total = total
        self.per_epoch = per_epoch
        self.samples_per_unit = samples_per_unit
        self.cadence = cadence
        self.feed = feed
        self._fetch = fetch_global or to_host

    # checkpoint cadence in units; trainer._last_ckpt_epoch is the unit
    # count of the last save (set by _maybe_resume on restore)
    def _ckpt_due(self, units_done):
        if self.tr._checkpointer_or_none() is None:
            return False
        last = getattr(self.tr, "_last_ckpt_epoch", None) or 0
        cadence = self.cadence or self.total
        return units_done - last >= cadence or units_done >= self.total

    def _maybe_ckpt(self, units_done, state_fn):
        if self._ckpt_due(units_done):
            # async (DK_CKPT_ASYNC, default): only the snapshot's copies
            # are enqueued here.  The handle is dropped on purpose — the
            # preempt boundary and the end-of-run drain wait through
            # wait_until_finished, which covers whatever write is in
            # flight; a PREVIOUS background failure re-raises out of
            # save() here, one cadence late
            self.tr._checkpointer_or_none().save(units_done, state_fn())
            self.tr._last_ckpt_epoch = units_done

    def _drain_saves(self, raise_errors, timeout_s=None):
        """Wait (bounded) for any in-flight async save — a run leaving
        the dispatch loop must never leave a background writer racing a
        relaunched incarnation in the same directory."""
        ckptr = self.tr._checkpointer_or_none()
        if ckptr is None:
            return
        ckptr.wait_until_finished(
            timeout_s=(coordination.default_timeout_s()
                       if timeout_s is None else timeout_s),
            raise_errors=raise_errors)

    def _preempt_save(self, units_done, state_fn, world=1):
        """Boundary checkpoint on a delivered SIGTERM/SIGINT — saved
        regardless of cadence (deduped against a save already at this
        unit; the None sentinel lets a run preempted before any save
        still write its unit-0 state), waited for under one bounded
        deadline and VERIFIED before the exit, so ``Preempted.
        saved_step`` is a checked claim (single host; on a pod the
        non-leaders return before the leader's promotion)."""
        ckptr = self.tr._checkpointer_or_none()
        if ckptr is None:
            return None
        deadline = coordination.default_timeout_s()
        if getattr(self.tr, "_last_ckpt_epoch", None) != units_done:
            handle = ckptr.save(units_done, state_fn())
            self.tr._last_ckpt_epoch = units_done
            handle.wait(timeout_s=deadline)
        else:
            # a cadence save of this exact unit may still be in flight
            ckptr.wait_until_finished(timeout_s=deadline)
        if world == 1:
            ckptr.verify(units_done)
        return units_done

    def run(self, dispatch, sync_ref, state_fn=None, resident_data=()):
        tr = self.tr
        all_losses, acc_losses = [], []
        acc_dt, acc_samples = 0.0, 0
        units_done = self.start
        self._halt = False
        pending = []   # [(chunk i, device losses, units when done)]

        def _retire_one():
            # the fetch blocks until chunk j is done: the streamed path's
            # backpressure.  Its wall is the host-side "step" phase and
            # its bytes the d2h row; the step.loss fault stays inside the
            # phase, so an injected delay reads as a slow step
            j, lj, units_after = pending.pop(0)
            with perf.phase("step"):
                t_fetch = time.perf_counter()
                arr = self._fetch(lj)
                perf.d2h(arr.nbytes, time.perf_counter() - t_fetch)
                # a NaN injection rides the fetched host array (the
                # device math untouched) — the nan_policy hook
                arr = fault_point("step.loss", value=arr)
            if self.feed is not None:
                self.feed.release(j)
            all_losses.append(arr)
            acc_losses.append(arr)
            if check_losses(tr, arr, units_done=units_after):
                self._halt = True

        # graceful preemption window: the handler only sets a flag,
        # noticed at the next chunk boundary; off the main thread there
        # is none (strict=False), and the run proceeds uninstalled
        installed = (tr.handle_preemption
                     and preemption.install(strict=False))
        # resolved whatever handle_preemption says: the halt verdict
        # below must be cluster-wide on any multi-host run
        coord = coordination.get_coordinator()
        tr.record_training_start()
        t_mark = time.time()
        # the run's root span: every chunk breadcrumb, vote and
        # checkpoint event below stamps its trace identity (and the
        # async writer's ckpt.save span resumes it); entered by hand so
        # the try/except/finally below stays the unwind structure
        run_span = obs_spans.span("train.run", start=self.start)
        run_span.__enter__()
        try:
            for i, K in enumerate(self.plan):
                sig = (preemption.requested()
                       if tr.handle_preemption else None)
                signalled = sig is not None
                if tr.handle_preemption:
                    # boundary vote: did ANY host see the signal?  A host
                    # whose own flag is clear adopts SIGTERM
                    with perf.phase("comm"):
                        voted = coord.any_flag(sig is not None)
                    if voted:
                        sig = signal.SIGTERM if sig is None else sig
                    if sig is not None and coord.world > 1:
                        with perf.phase("comm"):
                            agreed = coord.agree_min(units_done)
                        if agreed != units_done:  # pragma: no cover
                            raise RuntimeError(
                                f"coordinated save step disagreement: "
                                f"this host at {units_done}, cluster "
                                f"min {agreed} — hosts ran different "
                                "chunk plans")
                if sig is not None:
                    obs_events.emit("preempt", signum=int(sig),
                                    units_done=units_done,
                                    adopted=not signalled)
                    # the post-mortem: the ring holds the run's last
                    # events up to the agreed boundary
                    if obs_events.enabled():
                        flight.dump("preempt", signum=int(sig),
                                    units_done=units_done)
                    while pending:
                        _retire_one()
                    if coord.world > 1:
                        self._halt = coord.any_flag(self._halt)
                    with perf.phase("ckpt"):
                        saved = (None if self._halt
                                 else self._preempt_save(
                                     units_done, state_fn,
                                     world=coord.world))
                    if coord.world > 1:
                        with perf.phase("comm"):
                            coord.barrier("preempt_exit")
                    obs_events.emit("preempt_exit", signum=int(sig),
                                    saved_step=saved)
                    tr.record_training_end()
                    raise Preempted(sig, saved_step=saved)
                with perf.phase("data"):
                    data = (self.feed.get(i) if self.feed is not None
                            else resident_data)
                with perf.phase("step"):
                    losses = dispatch(i, K, units_done, data)
                perf.count_dispatch()
                units_done += K
                obs_events.emit("chunk", i=i, units=K,
                                units_done=units_done,
                                streamed=self.feed is not None)
                pending.append((i, losses, units_done))
                if self.feed is not None:
                    # retire the previous chunk BEFORE prefetching the
                    # next: at most two chunks are ever on the card, and
                    # the i+1 copy still runs under chunk i
                    while len(pending) > 1:
                        _retire_one()
                    with perf.phase("data"):
                        self.feed.prefetch(i + 1)
                multi = coord.world > 1
                # multi-host: a locally tripped halt waits for the next
                # NATURAL boundary, where every host votes on it
                boundary = (units_done % self.per_epoch == 0
                            or i == len(self.plan) - 1
                            or self._ckpt_due(units_done)
                            or (self._halt and not multi))
                acc_samples += self.samples_per_unit * K
                if not boundary:
                    continue
                with perf.phase("step"):
                    drain(sync_ref())
                acc_dt += time.time() - t_mark
                # host-side work below stays outside the clock
                while pending:
                    _retire_one()
                if multi:
                    with perf.phase("comm"):
                        self._halt = coord.any_flag(self._halt)
                # save BEFORE user callbacks run (a callback that dies
                # must not lose the chunk), never a halted run's state
                if not self._halt:
                    with perf.phase("ckpt"):
                        self._maybe_ckpt(units_done, state_fn)
                axis = 0 if all_losses[-1].ndim == 1 else 1
                if units_done % self.per_epoch == 0:
                    tr._emit_epoch_end(
                        units_done // self.per_epoch,
                        np.concatenate(acc_losses, axis=axis),
                        acc_dt, acc_samples)
                    acc_losses, acc_dt, acc_samples = [], 0.0, 0
                if self._halt:
                    obs_events.emit("nan_halt", units_done=units_done)
                    if acc_losses:
                        # the partial epoch too, so the nonfinite ledger
                        # reaches trainer.metrics
                        tr._emit_epoch_end(
                            units_done // self.per_epoch + 1,
                            np.concatenate(acc_losses, axis=axis),
                            acc_dt, acc_samples)
                    break
                t_mark = time.time()
        # dklint: ignore[broad-except] re-raised at once: only drains the
        # async writer on the unwind path (bounded, no-raise)
        except BaseException as e:
            self._drain_saves(
                raise_errors=False,
                timeout_s=0 if isinstance(e, TimeoutError) else None)
            raise
        finally:
            run_span.__exit__(None, None, None)
            # a raising callback must not leave the feed pinning the
            # host epoch arrays
            if self.feed is not None:
                self.feed.close()
            if installed:
                preemption.restore()
        tr.record_training_end()
        # the clean path's error surface: record_training_end drained
        # (no-raise); this zero-timeout probe raises a deferred
        # background-save error, or TimeoutError for a wedged writer
        ckptr = tr._checkpointer_or_none()
        if ckptr is not None:
            ckptr.wait_until_finished(timeout_s=0, raise_errors=True)
        return all_losses
