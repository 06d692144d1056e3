"""Profiling / tracing hooks — the JAX package's ``utils/profiling.py``
on ``torch.profiler``.

- ``trace(logdir)``: context manager around ``torch.profiler.profile``
  recording the host's operators, and the card's kernels and copies once
  the process has initialised CUDA.  On exit it writes a Chrome trace
  (``<host>_<pid>.<ns>.pt.trace.json``, TensorBoard's and Perfetto's
  format) into ``logdir``.  While it (or any other ``torch.profiler``)
  records, ``observability.span`` regions and ``perf.phase`` phases
  forward their names into the trace as ``record_function`` ranges.
- ``annotate(name)``: named region that shows up inside the trace (a
  ``record_function`` range, and an NVTX range where CUDA is available).
- ``StepTimer``: cheap host-side per-call timer with summary stats, for
  loops the profiler would be too heavy for — a thin wrapper over
  ``observability.metrics.Histogram``, the process-wide registry every
  subsystem shares.
"""

from __future__ import annotations

import contextlib
import time

import torch

from dist_keras_tpu_torch.observability import metrics as _metrics


def _activities():
    """CPU always; CUDA once this process has initialised it — and then
    it must be recordable: a CPU-only trace of a card's work would hide
    the device."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        cuda = torch.profiler.ProfilerActivity.CUDA
        if cuda not in torch.profiler.supported_activities():
            raise RuntimeError(
                "torch.profiler cannot record CUDA activity in this "
                "process (no CUPTI): refusing a CPU-only trace of a run "
                "on the card")
        acts.append(cuda)
    return acts


@contextlib.contextmanager
def trace(logdir):
    """Capture a trace into ``logdir`` (view with TensorBoard or
    Perfetto).

    Every ``observability.span(...)`` and ``perf.phase(...)`` opened
    inside shows up as a ``record_function`` range in the captured
    timeline (they detect the running profiler); the profiler stops,
    and the trace is written, even when the body raises."""
    prof = torch.profiler.profile(
        activities=_activities(),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(
            str(logdir)))
    prof.start()
    try:
        yield
    finally:
        prof.stop()


class annotate:
    """Named region inside a trace: ``torch.profiler.record_function``,
    plus an NVTX range where CUDA is available (none on a CPU-only
    build).  Re-enterable: ``with annotate("x"):`` may run many times."""

    def __init__(self, name):
        self.name = str(name)
        self._rf = []

    def __enter__(self):
        rf = torch.profiler.record_function(self.name)
        rf.__enter__()
        self._rf.append(rf)
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_pop()
        self._rf.pop().__exit__(*exc)
        return False


class StepTimer:
    """Per-call wall-clock timer: ``with timer: ...`` per step.

    A named timer (``StepTimer(name="train.step")``) registers its
    histogram in the process-wide metrics registry, so its samples ride
    the epoch-boundary snapshots into the event stream; an anonymous
    one keeps a private histogram.
    """

    def __init__(self, name=None):
        # dklint: ignore[metric-dynamic] caller-chosen instrument
        # name: a named StepTimer registers under whatever vocabulary
        # its owner uses (the registry cannot enumerate user names)
        self._hist = (_metrics.histogram(name) if name
                      else _metrics.Histogram())
        self._t0 = None

    @property
    def times(self):
        """The recorded durations (seconds) — historical list API."""
        return self._hist.samples

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0)
        return False

    def observe(self, seconds):
        """Record an externally-measured duration."""
        self._hist.observe(seconds)

    def reset(self):
        """Drop every recorded sample (windowed use: reset per epoch)."""
        self._hist.reset()

    def summary(self):
        """-> {count, mean_s, p50_s, p95_s, p99_s, max_s, total_s}.

        A zero-length window returns ``count: 0`` with ``None`` stats
        (``total_s: 0.0``) instead of raising from the percentile
        math."""
        s = self._hist.summary()
        return {
            "count": s["count"],
            "mean_s": s["mean"],
            "p50_s": s["p50"],
            "p95_s": s["p95"],
            "p99_s": s["p99"],
            "max_s": s["max"],
            "total_s": s["total"],
        }
