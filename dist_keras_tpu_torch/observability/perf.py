"""Perf attribution — CPU-measurable proxies for device-side perf claims.

A copy of the JAX package's ``observability/perf.py`` on the port's
``metrics`` and ``spans``, without its retrace listener.  What the HOST
can always measure, cheaply enough to stay on in production:

- **Retraces** — the JAX package counts every XLA executable build
  through a ``jax.monitoring`` listener.  Eager PyTorch builds no
  executables, so there is nothing to listen to: :func:`install`
  returns False and ``perf.retraces`` stays zero.  The "no unbounded
  retraces" contract is kept by the serving engines themselves instead:
  each counts the distinct shapes it dispatches (``ServingEngine``'s
  batch rungs, ``DecodeEngine``'s prefill and decode rungs) and reports
  ``retrace_count`` against its ladder's ``retrace_bound`` in
  ``stats()``.
- **Dispatches** — model launches enqueued by the framework's own hot
  loops (:func:`count_dispatch` at each serving replica batch and each
  decode prefill / step).  A deliberate seam count: it measures the
  dispatch *granularity the framework chose*, which is exactly the knob
  batch ladders turn.
- **H2D / D2H bytes + walls** — :func:`h2d` / :func:`d2h` record bytes
  shipped and the host wall of a transfer (the serving engine's batch
  upload and its one fetch per batch).
- **Per-phase step-time breakdown** — :func:`phase` wraps host-side
  phases into always-on ``perf.phase.<name>`` registry histograms; while
  a device trace is open the region also goes through ``spans.span``.
  Wiring phases into the trainers' runner is ROADMAP queue 1, item 22.

Everything lands in the process metrics registry, so it rides the
snapshots with no extra plumbing.  No device profiler is ever required.
"""

from __future__ import annotations

import contextlib
import time

from dist_keras_tpu_torch.observability import metrics, spans

# comm_overlap / comm_blocked are the round-19 split of the boundary
# collective wall: AsyncMerge (parallel/collectives.py) charges the
# async enqueue to comm_overlap and the deferred block_until_ready to
# comm_blocked, so "how much of the collective hid under compute" is a
# first-class histogram instead of a guess inside "comm"
PHASES = ("data", "step", "comm", "comm_overlap", "comm_blocked", "ckpt")


def install():
    """The JAX package registers its retrace listener here.  Eager
    PyTorch compiles no executables, so there is no listener to
    register: -> False, and ``perf.retraces`` stays zero (callers never
    gate on the result; the engines count their dispatched shapes
    instead)."""
    return False


def installed():
    return False


def count_dispatch(n=1):
    """Count ``n`` compiled-program launches enqueued by a framework
    hot loop (per chunk / per serving batch — NOT per compiled step,
    which lives inside the dispatch and cannot host a Python hook)."""
    metrics.counter("perf.dispatches").inc(n)


def h2d(nbytes, seconds):
    """Record one host->device transfer: bytes shipped + the enqueue
    wall (a non-blocking copy from pinned memory is async — the DMA
    overlaps compute, so the enqueue wall is the host-side cost that
    exists)."""
    metrics.counter("perf.h2d_bytes").inc(int(nbytes))
    metrics.histogram("perf.h2d_s").observe(seconds)


def d2h(nbytes, seconds):
    """Record one device->host fetch: bytes + the BLOCKING wall.  On
    the streamed training path this wall doubles as the depth-2
    backpressure barrier (see ``ChunkRunner``), so it includes the wait
    for the dispatched compute — which is precisely the "host overlap
    wall" a device-only claim needs a CPU-measurable proxy for."""
    metrics.counter("perf.d2h_bytes").inc(int(nbytes))
    metrics.histogram("perf.d2h_s").observe(seconds)


@contextlib.contextmanager
def phase(name, **fields):
    """Always-on timed phase: observes ``perf.phase.<name>`` (registry
    histogram — a clock read + deque append, no I/O, per-chunk-cadence
    safe).  Only while a device trace is open does the region also run
    through ``spans.span`` (-> ``TraceAnnotation`` + span events), so
    XProf and the histograms share a vocabulary without per-chunk JSON
    emission on production runs."""
    # dklint: spans=perf.*
    cm = (spans.span(f"perf.{name}", **fields)
          if spans.device_trace_active() else contextlib.nullcontext())
    with cm:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            # dklint: metrics=perf.phase.*
            metrics.histogram(f"perf.phase.{name}").observe(
                time.perf_counter() - t0)


def snapshot(snap=None):
    """Compact JSON-ready perf-attribution snapshot — the
    ``perf_sample`` event payload and the report's per-rank row.
    Percentile-free (totals only): this runs on every sampler tick,
    which passes its already-taken registry ``snap`` in so one tick
    walks the registry once, not twice."""
    if snap is None:
        snap = metrics.snapshot(percentiles=False)
    counters, hists = snap["counters"], snap["histograms"]
    phases = {}
    for name, h in hists.items():
        if name.startswith("perf.phase."):
            phases[name[len("perf.phase."):]] = {
                "count": h["count"],
                "total_s": round(h["total"], 6),
                "mean_s": (round(h["total"] / h["count"], 6)
                           if h["count"] else None),
            }
    out = {
        "retraces": counters.get("perf.retraces", 0),
        "traces": counters.get("perf.traces", 0),
        "dispatches": counters.get("perf.dispatches", 0),
        "h2d_bytes": counters.get("perf.h2d_bytes", 0),
        "d2h_bytes": counters.get("perf.d2h_bytes", 0),
        "phases": phases,
    }
    compile_h = hists.get("perf.compile_s")
    if compile_h and compile_h["count"]:
        out["compile_s_total"] = round(compile_h["total"], 4)
    return out
