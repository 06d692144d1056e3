"""Chunked dispatch for the trainers — counterpart of
``trainers/chunking.py``, its single-process path.

A run of N units (steps for ``SingleTrainer``) is cut into dispatch
chunks at epoch boundaries when callbacks are registered (one chunk for
the whole run otherwise) and driven through :class:`ChunkRunner`, which
fetches each chunk's losses to the host once, at the chunk's end, where
the reference fetches its scan's losses.  That one fetch is where the
NaN policy is applied, per-epoch metrics are recorded and callbacks
fire.  A chunk's steps run as a Python loop that never waits for the
card, so the host enqueues ahead of the device until the boundary.

Not ported yet, each raising where the reference would use it:
streaming through a ``ChunkFeed`` with its data-chunk cuts and
``epoch_spans`` (ROADMAP queue 1, item 20), checkpoint cadence, resume
and preemption (item 19), and the runner's perf phases, spans and fault
points (item 22); the loop keeps the reference's phase structure so
they slot in later.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from dist_keras_tpu_torch.observability import events as obs_events
from dist_keras_tpu_torch.resilience.guards import check_losses
from dist_keras_tpu_torch.utils.sync import drain


def init_streaming(trainer, chunk, budget, name="stream_chunk_windows"):
    """Install the streaming kwargs: only "off" (``None``) is ported."""
    if chunk is not None or budget is not None:
        raise NotImplementedError(
            f"{name} / max_resident_bytes (streaming through a ChunkFeed) "
            "are not ported yet (ROADMAP queue 1, item 20)")
    setattr(trainer, name, None)
    trainer.max_resident_bytes = None


def chunk_plan(start, total, per_epoch, *, epoch_bounds=False):
    """Chunk sizes (in units) for the dispatch loop: cut at every epoch
    boundary (``epoch_bounds``); no cuts = one chunk."""
    if total <= start:
        return []
    bounds = {total}
    if epoch_bounds:
        first = (start // per_epoch + 1) * per_epoch
        bounds |= set(range(first, total, per_epoch))
    cuts = sorted(bounds)
    return [b - a for a, b in zip([start] + cuts[:-1], cuts)]


def run_chunked(trainer, xs, ys, *, total, per_epoch, samples_per_unit,
                dispatch, sync_ref, carry_leaves):
    """Chunk plan -> resident data on the device -> :class:`ChunkRunner`
    -> the history: the per-unit losses of the run, flat.

    ``xs`` / ``ys`` are host arrays of the epoch's batches, copied to
    ``trainer.device`` once; that copy and the carry state's land before
    the clock starts.  ``dispatch`` gets them as ``data``."""
    plan = chunk_plan(0, total, per_epoch,
                      epoch_bounds=bool(trainer.callbacks))
    data = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(trainer.device)
                 for a in (xs, ys))
    drain(*data, *carry_leaves)
    runner = ChunkRunner(trainer, plan=plan, per_epoch=per_epoch,
                         samples_per_unit=samples_per_unit)
    all_losses = runner.run(dispatch, sync_ref=sync_ref, resident_data=data)
    return np.concatenate(all_losses).tolist() if all_losses else []


class ChunkRunner:
    """Drives a chunk plan: dispatch, then at each chunk's end wait for
    the card, fetch the losses, apply the NaN policy, record the epoch.

    - ``dispatch(i, K, units_done, data) -> device losses (K,)`` —
      enqueue chunk i (the trainer reassigns its carry inside);
    - ``sync_ref() -> tree`` — what to ``drain`` at a boundary.

    Every chunk ends at an epoch boundary (the run's end is one), so
    each is fetched, and its epoch recorded, as soon as it is
    dispatched.  Timing: the clock covers dispatch and the boundary's
    wait; the loss fetch, metrics and callbacks run off it."""

    def __init__(self, trainer, *, plan, per_epoch, samples_per_unit):
        self.tr = trainer
        self.plan = plan
        self.per_epoch = per_epoch
        self.samples_per_unit = samples_per_unit

    def run(self, dispatch, sync_ref, resident_data=()):
        tr = self.tr
        all_losses = []
        units_done = 0
        tr.record_training_start()
        for i, K in enumerate(self.plan):
            t_mark = time.time()
            losses = dispatch(i, K, units_done, resident_data)
            units_done += K
            obs_events.emit("chunk", i=i, units=K, units_done=units_done,
                            streamed=False)
            drain(sync_ref())
            seconds = time.time() - t_mark
            # host-side work below stays outside the clock
            arr = losses.cpu().numpy()   # the chunk's one fetch
            all_losses.append(arr)
            halt = check_losses(tr, arr, units_done=units_done)
            tr._emit_epoch_end(units_done // self.per_epoch, arr, seconds,
                               self.samples_per_unit * K)
            if halt:
                obs_events.emit("nan_halt", units_done=units_done)
                break
        tr.record_training_end()
        return all_losses
