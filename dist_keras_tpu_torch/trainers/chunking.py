"""Chunked dispatch for the trainers — counterpart of
``trainers/chunking.py``, its resident-data path.

A run of N units (steps for ``SingleTrainer``, ``AveragingTrainer``,
``EnsembleTrainer`` and ``DynSGD``, communication windows for the
windowed family) is cut into dispatch chunks at the union of epoch
boundaries (when callbacks are registered) and checkpoint-cadence points
counted from the resume point, and driven through :class:`ChunkRunner`.
At each chunk's end the runner waits for the card and fetches the
chunk's losses to the host once, where the reference fetches its scan's
losses; that one fetch is where the NaN policy is applied, per-epoch
metrics are recorded, a due checkpoint is saved (before user callbacks)
and callbacks fire.  A chunk's steps run as a Python loop that never
waits for the card, so the host enqueues ahead of the device until the
boundary.  A boundary adds no host sync beyond that fetch unless a save
is due, and an async save (``DK_CKPT_ASYNC``) only enqueues its copies.

Preemption (``handle_preemption``): the SIGTERM/SIGINT handler only sets
a flag; each chunk boundary reads it, puts it to a cluster vote
(``coordination.any_flag``; free on one process) and, when set, saves
the boundary checkpoint, verifies it and raises ``Preempted``
(128+signum) carrying the verified ``saved_step``.

Not ported yet, each raising where the reference would use it:
streaming through a ``ChunkFeed`` with its data-chunk cuts and
``epoch_spans`` (ROADMAP queue 1, item 20), and the runner's perf
phases, spans and the ``step.loss`` fault point (item 22).
"""

from __future__ import annotations

import signal
import time

import numpy as np
import torch

from dist_keras_tpu_torch.comm.backend import fetch_global
from dist_keras_tpu_torch.observability import events as obs_events
from dist_keras_tpu_torch.resilience import coordination, preemption
from dist_keras_tpu_torch.resilience.guards import check_losses
from dist_keras_tpu_torch.resilience.preemption import Preempted
from dist_keras_tpu_torch.utils.sync import drain


def init_streaming(trainer, chunk, budget, name="stream_chunk_windows"):
    """Install the streaming kwargs: only "off" (``None``) is ported."""
    if chunk is not None or budget is not None:
        raise NotImplementedError(
            f"{name} / max_resident_bytes (streaming through a ChunkFeed) "
            "are not ported yet (ROADMAP queue 1, item 20)")
    setattr(trainer, name, None)
    trainer.max_resident_bytes = None


def units_first(a, unit_dims):
    """Host ``(workers, *units, batch, ...)`` -> ``(*units, workers,
    batch, ...)``, contiguous: each step then reads one contiguous
    ``(workers, batch, ...)`` slab of the resident data."""
    order = (*range(1, 1 + unit_dims), 0, *range(1 + unit_dims, a.ndim))
    return np.ascontiguousarray(a.transpose(order))


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
               cadence=None):
    """Chunk sizes (in units) for the dispatch loop, from ``start`` (the
    resume point) to ``total``:

    - ``epoch_bounds``: cut at every epoch boundary (callbacks need
      on_epoch_end at real epoch ends);
    - ``cadence=N``: cut every N units counted from ``start`` — the
      checkpoint grid.

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
    cuts = sorted(b for b in bounds if start < b <= total)
    out, prev = [], start
    for b in cuts:
        out.append(b - prev)
        prev = b
    return out


def run_chunked(trainer, xs, ys, *, total, per_epoch, samples_per_unit,
                dispatch, sync_ref, carry_leaves, start=0, cadence=None,
                state_fn=None, worker_axis=False):
    """Chunk plan -> resident data on the device -> :class:`ChunkRunner`
    -> the history.

    ``xs`` / ``ys`` are host arrays of the epoch's batches, copied to
    ``trainer.device`` once; that copy and the carry state's land before
    the clock starts.  ``dispatch`` gets them as ``data``.  ``start`` is
    the resume point in units, ``cadence`` the checkpoint grid and
    ``state_fn() -> dict`` the checkpoint payload (evaluated only when a
    save is due).

    One worker (``SingleTrainer``): each chunk's losses are ``(K,)`` and
    the history is the run's losses, flat.  With ``worker_axis`` each
    chunk's losses are ``(workers, K, ...)``, concatenated along axis 1
    and reshaped to ``(workers, epochs, per_epoch, ...)`` when the run
    covered whole epochs — a run resumed mid-epoch keeps its losses
    flat, ``(workers, units, ...)``, as in the reference."""
    plan = chunk_plan(start, total, per_epoch,
                      epoch_bounds=bool(trainer.callbacks), cadence=cadence)
    data = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(trainer.device)
                 for a in (xs, ys))
    drain(*data, *carry_leaves)
    runner = ChunkRunner(trainer, plan=plan, start=start, total=total,
                         per_epoch=per_epoch,
                         samples_per_unit=samples_per_unit, cadence=cadence)
    all_losses = runner.run(dispatch, sync_ref=sync_ref, state_fn=state_fn,
                            resident_data=data)
    if not all_losses:
        return []
    if not worker_axis:
        return np.concatenate(all_losses).tolist()
    flat = np.concatenate(all_losses, axis=1)
    if flat.shape[1] % per_epoch == 0:
        flat = flat.reshape(flat.shape[0], -1, per_epoch, *flat.shape[2:])
    return flat.tolist()


class ChunkRunner:
    """Drives a chunk plan: dispatch, then at each chunk's end wait for
    the card, fetch the losses, apply the NaN policy, save a due
    checkpoint, record the epoch.

    - ``dispatch(i, K, units_done, data) -> device losses`` (``(K,)``,
      or ``(workers, K, ...)``) — enqueue chunk i (the trainer
      reassigns its carry inside);
    - ``sync_ref() -> tree`` — what to ``drain`` at a boundary;
    - ``state_fn() -> dict`` — the checkpoint payload.

    Timing: the clock covers dispatch and the boundary's wait; the loss
    fetch, checkpoint saves, metrics and callbacks run off it."""

    def __init__(self, trainer, *, plan, start, total, per_epoch,
                 samples_per_unit, cadence=None):
        self.tr = trainer
        self.plan = plan
        self.start = start
        self.total = total
        self.per_epoch = per_epoch
        self.samples_per_unit = samples_per_unit
        self.cadence = cadence

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
        try:
            for i, K in enumerate(self.plan):
                sig = (preemption.requested()
                       if tr.handle_preemption else None)
                signalled = sig is not None
                if tr.handle_preemption:
                    # boundary vote: did ANY host see the signal?  A host
                    # whose own flag is clear adopts SIGTERM
                    if coord.any_flag(sig is not None):
                        sig = signal.SIGTERM if sig is None else sig
                    if sig is not None and coord.world > 1:
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
                    if coord.world > 1:
                        self._halt = coord.any_flag(self._halt)
                    saved = (None if self._halt
                             else self._preempt_save(units_done, state_fn,
                                                     world=coord.world))
                    if coord.world > 1:
                        coord.barrier("preempt_exit")
                    obs_events.emit("preempt_exit", signum=int(sig),
                                    saved_step=saved)
                    tr.record_training_end()
                    raise Preempted(sig, saved_step=saved)
                losses = dispatch(i, K, units_done, resident_data)
                units_done += K
                obs_events.emit("chunk", i=i, units=K,
                                units_done=units_done, streamed=False)
                drain(sync_ref())
                acc_dt += time.time() - t_mark
                acc_samples += self.samples_per_unit * K
                # host-side work below stays outside the clock
                arr = fetch_global(losses)   # the chunk's one fetch
                all_losses.append(arr)
                acc_losses.append(arr)
                if check_losses(tr, arr, units_done=units_done):
                    self._halt = True
                if coord.world > 1:
                    self._halt = coord.any_flag(self._halt)
                # save BEFORE user callbacks run (a callback that dies
                # must not lose the chunk), never a halted run's state
                if not self._halt:
                    self._maybe_ckpt(units_done, state_fn)
                axis = 0 if arr.ndim == 1 else 1
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
