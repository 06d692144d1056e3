"""NaN/Inf sentinels for the training loop — a copy of the JAX package's
``resilience/guards.py``, on the port's ``events`` and ``metrics``.

A single NaN loss silently poisons every later step (and, worse, the next
checkpoint) unless someone looks.  The trainers' ``ChunkRunner`` passes
every fetched host loss array through :func:`check_losses`, which counts
non-finite entries into ``trainer.nonfinite_steps`` (surfaced per epoch
in ``trainer.metrics[...]["nonfinite_steps"]``) and applies the
per-trainer ``nan_policy``:

- ``"raise"`` (default): abort with :class:`NonFiniteLossError` BEFORE
  the boundary's checkpoint save runs, so the last checkpoint on disk is
  always pre-divergence and ``resume=True`` restarts from healthy state.
- ``"halt"``: stop dispatching at the boundary, skip the poisoned save,
  return what trained so far (the counters tell how much was lost).
- ``"skip"``: device-side guard — ``trainers.step`` builds the update
  with a finite-check on (loss, grads) and keeps the previous
  params/optimizer state on a bad step, so one exploding batch costs one
  skipped update instead of the run.  Host-side we only count.
- ``None`` / ``"off"``: count only.

Detection is HOST-side on values that are fetched anyway (the per-chunk
loss retire), so the sentinel costs zero device work and zero extra
transfers for every policy except ``"skip"``'s in-trace check.
"""

from __future__ import annotations

import numpy as np

POLICIES = ("raise", "skip", "halt")


class NonFiniteLossError(FloatingPointError):
    """A training chunk produced NaN/Inf losses under nan_policy='raise'."""

    def __init__(self, message, nonfinite=0, units_done=None):
        super().__init__(message)
        self.nonfinite = int(nonfinite)
        self.units_done = units_done


def normalize_policy(policy):
    """-> canonical policy value; raises on an unknown name."""
    if policy in (None, "off", False):
        return None
    if policy not in POLICIES:
        raise ValueError(
            f"nan_policy={policy!r} must be one of {POLICIES} or None")
    return policy


def count_nonfinite(arr):
    arr = np.asarray(arr)
    if not np.issubdtype(arr.dtype, np.floating):
        return 0
    return int(arr.size - np.count_nonzero(np.isfinite(arr)))


def check_losses(trainer, arr, units_done=None):
    """Count non-finite entries of a fetched loss array into
    ``trainer.nonfinite_steps``; apply the trainer's ``nan_policy``.
    Returns True when the runner should halt at the next boundary."""
    bad = count_nonfinite(arr)
    if not bad:
        return False
    trainer.nonfinite_steps += bad
    policy = getattr(trainer, "nan_policy", None)
    from dist_keras_tpu_torch.observability import events, metrics

    metrics.counter("train.nonfinite_steps").inc(bad)
    events.emit("nonfinite", count=bad, units_done=units_done,
                policy=policy)
    if policy == "raise":
        hint = ""
        if getattr(trainer, "checkpoint_dir", None):
            hint = (" — the last checkpoint predates the divergence; "
                    "restart with resume=True (and a lower lr / "
                    "nan_policy='skip')")
        raise NonFiniteLossError(
            f"{bad} non-finite loss value(s) at unit {units_done}"
            f"{hint}", nonfinite=bad, units_done=units_done)
    return policy == "halt"
