"""Process-wide metrics registry — named counters, gauges, histograms; a
copy of the JAX package's ``observability/metrics.py`` on the port's
``events`` and ``knobs``.

``utils/profiling.StepTimer`` sketched this in miniature (a list of
per-call durations with summary stats); this module grows it into the
registry every subsystem shares: trainers, ``comm.backend``,
``checkpoint``, ``resilience.retry`` and ``data.streaming`` register
named instruments here, and the whole registry snapshots to JSON at
epoch boundaries into the event stream (``events.py``), so a post-hoc
report can say "this run retried rsync 7 times and spent 12 s in
checkpoint saves" without anyone having threaded those numbers through
return values.

Design points:

- **Get-or-create by name** (:func:`counter` / :func:`gauge` /
  :func:`histogram`): call sites never coordinate registration order,
  and the same name from two modules is the same instrument.
- **Cheap always-on**: incrementing a counter is a lock + int add —
  safe on warm host-side paths (per-chunk, per-retry; NOT the compiled
  per-step device loop, which cannot host Python hooks).  File I/O only
  happens at explicit :func:`emit_snapshot` points, and only when
  ``DK_OBS_DIR`` is set.
- **Zero-length windows are guarded**: an empty histogram summarizes to
  ``count: 0`` with ``None`` stats instead of a numpy warning or a
  raise — the same convention ``StepTimer.summary`` now follows.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from dist_keras_tpu_torch.observability import events

# Exemplar capture: when the SLO plane is armed
# (``DK_SLO``), every histogram observation made under an open span
# records that span's ``(trace_id, span_id)`` in a small per-histogram
# ring, so a scrape's bad percentile links straight to a retained
# trace.  ``spans.py`` registers the provider at import (it already
# imports this module, so the hook avoids a metrics->spans cycle the
# same way ``events._set_context_provider`` does); the knob is read
# once and cached, keeping the disarmed observe path at two global
# loads.
_exemplar_provider = None   # () -> (trace_id, span_id) | None
_exemplars_on = None        # cached DK_SLO (tri-state: None = unknown)


def _set_exemplar_provider(fn):
    global _exemplar_provider
    _exemplar_provider = fn


def _exemplars_enabled():
    global _exemplars_on
    if _exemplars_on is None:
        from dist_keras_tpu_torch.utils import knobs

        _exemplars_on = bool(knobs.get("DK_SLO"))
    return _exemplars_on


class Counter:
    """Monotonic named count (retry attempts, nonfinite steps, ...)."""

    def __init__(self, name):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class Gauge:
    """Last-write-wins named value (resident bytes, world size, ...)."""

    def __init__(self, name):
        self.name = name
        self._value = None
        self._lock = threading.Lock()

    def set(self, value):
        with self._lock:
            self._value = value

    @property
    def value(self):
        return self._value


class Histogram:
    """Sample distribution with percentile summaries (durations).

    ``count`` / ``mean`` / ``total`` / ``max`` are EXACT over the whole
    lifetime (until :meth:`reset`); percentiles are computed over a
    bounded window of the most recent :data:`Histogram.WINDOW` samples,
    so a week-long run's memory stays flat and the epoch-boundary
    snapshot cost stays O(window) instead of growing quadratically with
    run length.  A recent window is also the operationally useful
    percentile — "what do saves cost *now*", not diluted by hour-one.
    """

    WINDOW = 4096
    EXEMPLARS = 8

    def __init__(self, name=None):
        import collections

        self.name = name
        self._window = collections.deque(maxlen=self.WINDOW)
        self._exemplars = collections.deque(maxlen=self.EXEMPLARS)
        self._count = 0
        self._total = 0.0
        self._max = None
        self._over = {}  # threshold -> cumulative count(value > thr)
        self._lock = threading.Lock()

    def observe(self, value, exemplar=None):
        """Record one sample.  ``exemplar``: optional ``(trace_id,
        span_id)`` linking this observation to a trace; when omitted
        and the SLO plane is armed, the current span's ids are
        captured automatically (provider registered by ``spans.py``).
        """
        value = float(value)
        if exemplar is None and _exemplar_provider is not None \
                and _exemplars_enabled():
            exemplar = _exemplar_provider()
        with self._lock:
            self._window.append(value)
            self._count += 1
            self._total += value
            if self._max is None or value > self._max:
                self._max = value
            for thr in self._over:
                if value > thr:
                    self._over[thr] += 1
            if exemplar is not None:
                self._exemplars.append(
                    (str(exemplar[0]), str(exemplar[1]), value,
                     time.time()))

    def track_over(self, threshold):
        """Start counting observations ABOVE ``threshold`` exactly
        (cumulative, like ``count``) — the latency-SLO seam: one float
        compare per observe once registered, zero when not."""
        thr = float(threshold)
        with self._lock:
            self._over.setdefault(thr, 0)

    def over(self, threshold):
        """Cumulative count of observations above a tracked threshold
        (0 for a threshold never registered)."""
        with self._lock:
            return self._over.get(float(threshold), 0)

    def exemplars(self):
        """-> recent exemplars, newest last:
        ``[{trace_id, span_id, value, t}, ...]``."""
        with self._lock:
            items = list(self._exemplars)
        return [{"trace_id": tid, "span_id": sid, "value": v, "t": t}
                for tid, sid, v, t in items]

    def reset(self):
        with self._lock:
            self._window.clear()
            self._exemplars.clear()
            self._count = 0
            self._total = 0.0
            self._max = None
            self._over = {thr: 0 for thr in self._over}

    @property
    def samples(self):
        """The retained (most recent) samples — the percentile window."""
        with self._lock:
            return list(self._window)

    def totals(self):
        """-> {count, total, max} — the exact lifetime aggregates,
        WITHOUT the percentile pass (no window copy, no numpy).  The
        sampler's per-tick path: at a sub-second ``DK_OBS_SAMPLE_S``
        cadence the full :meth:`summary` per histogram per tick is
        what would break the <5% overhead contract."""
        with self._lock:
            return {"count": self._count, "total": self._total,
                    "max": self._max}

    def summary(self):
        """-> {count, mean, p50, p95, p99, max, total}; a zero-length
        window returns ``count: 0`` with ``None`` stats (``total: 0.0``)
        instead of raising from the percentile math."""
        with self._lock:
            count, total, mx = self._count, self._total, self._max
            window = list(self._window)
        if count == 0:
            return {"count": 0, "mean": None, "p50": None, "p95": None,
                    "p99": None, "max": None, "total": 0.0}
        # one percentile pass for all three points (summary() runs at
        # every epoch-boundary snapshot — it is warm-path-adjacent)
        p50, p95, p99 = np.percentile(
            np.asarray(window, dtype=np.float64), (50, 95, 99))
        return {
            "count": count,
            "mean": total / count,
            "p50": float(p50),
            "p95": float(p95),
            "p99": float(p99),
            "max": mx,
            "total": total,
        }


# The metric vocabulary — every instrument name any seam registers,
# with its kind.  Entries containing ``*`` are fnmatch patterns for
# dynamic families (the call site carries a ``# dklint: metrics=<pat>``
# annotation naming its pattern).  Adding a counter/gauge/histogram?
# Register it here AND add a row to the README metrics table, or the
# ``metric-unregistered`` / ``metric-undocumented`` lint rules fail
# the tree; exact names must also stay collision-free after Prometheus
# sanitization (``metric-collision``).
KNOWN_METRICS = {
    # training
    "train.nonfinite_steps": "counter",
    # checkpointing (checkpoint.py): what the training loop actually
    # waited vs what the (possibly background) writer spent
    "ckpt.save_stall_s": "histogram",
    "ckpt.write_s": "histogram",
    # differential saves + remote tier (checkpoint.py,
    # resilience/store.py)
    "ckpt.chunks_skipped": "counter",
    "ckpt.bytes_pushed": "counter",
    "ckpt.remote_pruned": "counter",
    # streaming data plane
    "stream.batches": "counter",
    "stream.rows": "counter",
    # retry surfaces (resilience/retry.py — per-surface families)
    "*.retries": "counter",
    "*.exhausted": "counter",
    # supervisor
    "supervisor.restarts": "counter",
    "supervisor.giveups": "counter",
    # elastic resharding restore (resilience/elastic.py)
    "reshard.restores": "counter",
    "reshard.bytes": "counter",
    # serving
    "serve.enqueued": "counter",
    "serve.completed": "counter",
    "serve.rejected": "counter",
    "serve.errors": "counter",
    "serve.reloads": "counter",
    "serve.reload.skipped_corrupt": "counter",
    "serve.reload.errors": "counter",
    "serve.pending": "gauge",
    "serve.predict_s": "histogram",
    # serving router tier (serving/router.py, serving/reload.py,
    # serving/autoscale.py)
    "route.requests": "counter",
    "route.errors": "counter",
    "route.evictions": "counter",
    "route.readmissions": "counter",
    "route.cutovers": "counter",
    "route.backends_live": "gauge",
    "route.forward_s": "histogram",
    "autoscale.resizes": "counter",
    "autoscale.replicas": "gauge",
    # parameter-server training mode (ps/server.py)
    "ps.pulls": "counter",
    "ps.commits": "counter",
    "ps.joins": "counter",
    "ps.lapses": "counter",
    "ps.stale_scaled": "counter",
    "ps.rejected_stale": "counter",
    "ps.workers": "gauge",
    "ps.clock": "gauge",
    "ps.staleness": "histogram",
    # PS commit-delta compression (ps/worker.py): payload array bytes
    # before/after the DK_PS_COMPRESS codec — equal when it is off
    "ps.commit_bytes_raw": "counter",
    "ps.commit_bytes_wire": "counter",
    # perf attribution (observability/perf.py)
    "perf.dispatches": "counter",
    "perf.h2d_bytes": "counter",
    "perf.d2h_bytes": "counter",
    "perf.h2d_s": "histogram",
    "perf.d2h_s": "histogram",
    "perf.phase.*": "histogram",
    # spans (observability/spans.py)
    "span.*": "histogram",
    # watchdog
    "watchdog.alerts": "counter",
    "watchdog.firing.*": "gauge",
    # flight recorder (observability/flight.py)
    "flight.dumps": "counter",
    # SLO plane (observability/slo.py): per-objective burn gauges —
    # slo.<objective>.burn_fast / .burn_slow / .firing
    "slo.*": "gauge",
    # tail-based trace retention (observability/flight.py)
    "trace.retained": "counter",
    "trace.dropped": "counter",
    "trace.dropped_records": "counter",
    "trace.inflight": "gauge",
    # cluster simulator (sim/)
    "sim.host_steps": "counter",
    "sim.faults": "counter",
    # continuous-batching decode engine (serving/decode.py)
    "decode.admitted": "counter",
    "decode.completed": "counter",
    "decode.rejected": "counter",
    "decode.errors": "counter",
    "decode.cancelled": "counter",
    "decode.tokens": "counter",
    "decode.ttft_s": "histogram",
    "decode.step_s": "histogram",
    "decode.active": "gauge",
    "decode.kv_used_pages": "gauge",
    # decode survivability plane (serving/decode.py): quarantine +
    # sequence recovery, deadline admission/expiry, brownout shedding
    # (shed is deliberately NOT folded into decode.rejected — the
    # generate_tokens SLO reads rejected, and a shed that burned the
    # SLO would amplify itself), and the periodic allocator self-check
    "decode.quarantines": "counter",
    "decode.recovered": "counter",
    "decode.shed": "counter",
    "decode.deadline_infeasible": "counter",
    "decode.deadline_expired": "counter",
    "decode.kv_leaked": "counter",
    # router hedging (serving/router.py): hedged /generate forwards,
    # first-wins outcomes, and budget denials
    "route.hedges": "counter",
    "route.hedge_wins": "counter",
    "route.hedge_denied": "counter",
    "route.stream_errors": "counter",
}

_lock = threading.Lock()
_registry = {}  # name -> instrument


def _get(name, cls):
    with _lock:
        inst = _registry.get(name)
        if inst is None:
            inst = _registry[name] = cls(name)
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} is already registered as "
                f"{type(inst).__name__}, not {cls.__name__}")
        return inst


def counter(name):
    return _get(str(name), Counter)


def gauge(name):
    return _get(str(name), Gauge)


def histogram(name):
    return _get(str(name), Histogram)


def snapshot(percentiles=True):
    """-> JSON-ready dict of every registered instrument's current
    value: ``{"counters": {...}, "gauges": {...}, "histograms":
    {name: summary}}``.  ``percentiles=False`` swaps each histogram's
    full summary for its cheap :meth:`Histogram.totals` (count/total/
    max only) — the sampler-tick variant, O(instruments) with no numpy
    pass, so a sub-second sampling cadence stays inside the <5%
    overhead contract."""
    with _lock:
        items = list(_registry.items())
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for name, inst in items:
        if isinstance(inst, Counter):
            out["counters"][name] = inst.value
        elif isinstance(inst, Gauge):
            out["gauges"][name] = inst.value
        else:
            h = inst.summary() if percentiles else inst.totals()
            if percentiles:
                ex = inst.exemplars()
                if ex:
                    h["exemplars"] = ex
            out["histograms"][name] = h
    return out


def emit_snapshot(**extra):
    """Write the registry snapshot into the event stream (one
    ``"metrics"`` event) — the epoch-boundary hook trainers call.
    No-op when ``DK_OBS_DIR`` is unset, and the snapshot itself is only
    computed when the emit will land."""
    if not events.enabled():
        return
    events.emit("metrics", **snapshot(), **extra)


def to_prometheus(**kw):
    """Prometheus text exposition (format 0.0.4) of the registry — the
    one scrape format the serving ``/metricsz?format=prometheus``
    endpoint and the standalone per-host exporter both serve.  Kwargs
    pass through to :func:`observability.prometheus.render` (lazy
    import keeps this module http-free)."""
    from dist_keras_tpu_torch.observability import prometheus

    return prometheus.render(**kw)


def reset():
    """Drop every registered instrument (tests)."""
    global _exemplars_on
    with _lock:
        _registry.clear()
    _exemplars_on = None
