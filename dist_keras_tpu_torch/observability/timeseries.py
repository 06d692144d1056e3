"""Live time-series metrics — bounded rings sampled by a background thread.

The metrics registry answers "what were the totals when the run ended"; this
module grows it into the live, queryable signal the anomaly watchdog and
the serving router need: every registered counter/gauge/histogram is
periodically sampled into a bounded per-metric :class:`TimeSeries` ring,
so "is step time regressing *right now*" and "is this host's queue
growing" are O(window) reads against flat memory instead of a log scan.

Design points:

- **Flat memory, lock-cheap.**  A :class:`TimeSeries` is two
  preallocated float64 arrays (timestamps, values) written round-robin;
  ``append`` is a short lock + two array stores, ``values()`` copies the
  window in chronological order.  A week-long run holds exactly
  ``window`` points per metric, forever.
- **One sampler thread per process** (:class:`MetricsSampler`), cadence
  ``DK_OBS_SAMPLE_S`` seconds.  Each tick snapshots the metrics
  registry: counters and numeric gauges record their value; histograms
  record the *cumulative* ``<name>.count`` and ``<name>.total`` pair, so
  a consumer (the watchdog's regression rule) derives interval means
  from deltas without per-sample percentile math.  The tick then runs
  the attached :class:`~dist_keras_tpu_torch.observability.watchdog.Watchdog`
  and — when the event log is enabled — emits one compact
  ``perf_sample`` event carrying the perf-attribution snapshot
  (:func:`~dist_keras_tpu_torch.observability.perf.snapshot`), so the merged
  report can plot dispatches/phase walls over time.
- **Zero-cost when off.**  :func:`maybe_start_sampler` (called from
  ``Trainer.record_training_start`` and the serving front end) is one
  env read when ``DK_OBS_SAMPLE_S`` is unset — no thread, no series, no
  registry walk.  Sampling is independent of ``DK_OBS_DIR``: an
  operator can run the watchdog + Prometheus exporter live without
  writing event files.

Env knobs: ``DK_OBS_SAMPLE_S`` (sampler cadence, seconds; unset =
sampler never auto-starts), ``DK_OBS_TS_WINDOW`` (ring size per metric,
default 512), ``DK_WATCHDOG=0`` (auto-started sampler skips the default
watchdog), ``DK_METRICS_PORT`` (:func:`maybe_start_sampler` also brings
up the standalone Prometheus exporter — independently of the sampling
cadence, so a scrape-port-only config still serves — see
``prometheus.py``).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from dist_keras_tpu_torch.observability import events, metrics
from dist_keras_tpu_torch.utils import knobs

# the registry's default is the single source of truth
DEFAULT_WINDOW = knobs.KNOBS["DK_OBS_TS_WINDOW"].default


def _default_window():
    # registry-parsed (default 512, malformed -> default); the floor
    # keeps a degenerate ring usable
    return max(2, int(knobs.get("DK_OBS_TS_WINDOW")))


class TimeSeries:
    """Bounded ``(t, value)`` ring for one metric.

    ``append`` overwrites the oldest point past ``window``; readers get
    chronological copies.  All methods are safe against a concurrent
    appender (the sampler thread) — the lock covers only index
    arithmetic and array stores, never user code.
    """

    def __init__(self, name, window=None):
        self.name = str(name)
        self.window = int(window) if window else _default_window()
        if self.window < 2:
            raise ValueError(f"window={window} must be >= 2")
        self._t = np.zeros(self.window, dtype=np.float64)
        self._v = np.zeros(self.window, dtype=np.float64)
        self._n = 0  # total points ever appended
        self._lock = threading.Lock()

    def append(self, value, t=None):
        t = time.time() if t is None else float(t)
        with self._lock:
            i = self._n % self.window
            self._t[i] = t
            self._v[i] = float(value)
            self._n += 1

    def __len__(self):
        return min(self._n, self.window)

    @property
    def total_appended(self):
        """Lifetime point count (retained points = ``len(self)``)."""
        return self._n

    @property
    def latest(self):
        """The most recent ``(t, value)``, or None when empty."""
        with self._lock:
            if self._n == 0:
                return None
            i = (self._n - 1) % self.window
            return (self._t[i], self._v[i])

    def values(self):
        """-> ``(t, v)`` float64 arrays, oldest first (copies — safe to
        hold while the sampler keeps appending)."""
        with self._lock:
            n = min(self._n, self.window)
            if n == 0:
                return (np.empty(0), np.empty(0))
            if self._n <= self.window:
                return (self._t[:n].copy(), self._v[:n].copy())
            i = self._n % self.window
            order = np.r_[i:self.window, 0:i]
            return (self._t[order].copy(), self._v[order].copy())

    def since(self, t0):
        """-> the retained ``(t, v)`` points with ``t >= t0``."""
        t, v = self.values()
        keep = t >= float(t0)
        return (t[keep], v[keep])

    def span_s(self):
        """Seconds covered by the retained window (0.0 when < 2 pts)."""
        t, _ = self.values()
        return float(t[-1] - t[0]) if len(t) >= 2 else 0.0


_lock = threading.Lock()
_series = {}  # name -> TimeSeries


def series(name, window=None):
    """Get-or-create the named series (same call-site contract as the
    metrics registry: no registration-order coordination)."""
    name = str(name)
    with _lock:
        s = _series.get(name)
        if s is None:
            s = _series[name] = TimeSeries(name, window=window)
        return s


def get(name):
    """The named series, or None — a probe that never creates (rules
    must not materialize empty series for metrics nobody records)."""
    with _lock:
        return _series.get(str(name))


def names():
    with _lock:
        return sorted(_series)


def record_snapshot(snap, t=None):
    """Fold one metrics-registry snapshot into the series registry —
    the sampler tick's core, public so tests drive it deterministically.

    Counters -> ``<name>``; numeric gauges -> ``<name>``; histograms ->
    cumulative ``<name>.count`` + ``<name>.total`` (interval means are
    deltas, derived by consumers — storing cumulative keeps each tick
    O(metrics) with no per-metric state here)."""
    t = time.time() if t is None else float(t)
    for name, v in snap.get("counters", {}).items():
        series(name).append(v, t=t)
    for name, v in snap.get("gauges", {}).items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            series(name).append(v, t=t)
    for name, h in snap.get("histograms", {}).items():
        series(f"{name}.count").append(h.get("count", 0), t=t)
        series(f"{name}.total").append(h.get("total", 0.0), t=t)


def default_sample_s():
    """The ``DK_OBS_SAMPLE_S`` cadence, or None when unset/malformed
    (malformed = sampler stays off, loudly on stderr would be noise —
    the README documents the knob as float seconds)."""
    raw = (knobs.raw("DK_OBS_SAMPLE_S") or "").strip()
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        return None
    return v if v > 0 else None


class MetricsSampler:
    """Background thread sampling the registry every ``interval_s``.

    ``start``/``stop`` are idempotent; ``tick()`` is the single sampling
    pass, public so tests (and the watchdog gate) can drive it without
    wall-clock waits.  A tick never throws — a failing rule or emit
    degrades like every other observability path.
    """

    def __init__(self, interval_s=None, watchdog=None):
        if interval_s is None:
            interval_s = default_sample_s()
        if interval_s is None:
            interval_s = 5.0
        self.interval_s = float(interval_s)
        if self.interval_s <= 0:
            raise ValueError(f"interval_s={interval_s} must be > 0")
        self.watchdog = watchdog
        self.ticks = 0
        self._stop = threading.Event()
        self._thread = None
        self._lock = threading.Lock()

    def tick(self, now=None):
        """One sampling pass: registry -> series, watchdog check, and a
        ``perf_sample`` event when the log is enabled."""
        now = time.time() if now is None else float(now)
        snap = None
        try:
            # percentiles=False: the tick must stay O(instruments)
            # with no numpy percentile pass — series only need the
            # cumulative count/total anyway (rules derive interval
            # means from deltas)
            snap = metrics.snapshot(percentiles=False)
            record_snapshot(snap, t=now)
        # dklint: ignore[broad-except] a registry snapshot failure must not kill the sampler tick
        except Exception:  # pragma: no cover - registry must not kill
            pass
        # SLO evaluation runs AFTER the rings absorb this tick's
        # snapshot (objectives read the rings) and BEFORE the watchdog
        # check (SLOBurnRate reads the evaluation, idempotent per
        # timestamp).  maybe_evaluate is a no-op unless DK_SLO is
        # armed, and never throws.
        from dist_keras_tpu_torch.observability import slo

        slo.maybe_evaluate(now)
        if self.watchdog is not None:
            try:
                self.watchdog.check(now=now)
            # dklint: ignore[broad-except] watchdog.check never throws; belt-and-braces for the tick
            except Exception:  # pragma: no cover - never throws anyway
                pass
        if events.enabled():
            try:
                from dist_keras_tpu_torch.observability import perf

                events.emit("perf_sample", **perf.snapshot(snap=snap))
            # dklint: ignore[broad-except] a failed perf_sample is a dropped sample, not a dead sampler
            except Exception:  # pragma: no cover - dropped sample
                pass
        # under the lock: tick() runs on the sampler thread AND from
        # main (tests, stop(final_tick=True)) — a torn += would lose
        # counts the idempotence tests assert on
        with self._lock:
            self.ticks += 1

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self.tick()

    @property
    def running(self):
        t = self._thread
        return t is not None and t.is_alive()

    def start(self):
        """Start the sampler thread (idempotent); -> self."""
        with self._lock:
            if self.running:
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="dk-obs-sampler")
            self._thread.start()
        return self

    def stop(self, timeout=5.0, final_tick=False):
        """Stop the thread (idempotent).  ``final_tick=True`` runs one
        last deterministic pass so the series carry the run's end."""
        with self._lock:
            t, self._thread = self._thread, None
            self._stop.set()
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=timeout)
        if final_tick:
            self.tick()


_global = {"sampler": None}


def get_sampler():
    """The process-wide sampler (None until :func:`maybe_start_sampler`
    armed one)."""
    return _global["sampler"]


def maybe_start_sampler():
    """Start the process-wide sampler iff ``DK_OBS_SAMPLE_S`` is set —
    the auto-wiring hook trainers and the serving front end call.  Two
    env reads when everything is unset.  The first start attaches the
    default watchdog (unless ``DK_WATCHDOG=0``).  The
    ``DK_METRICS_PORT`` Prometheus exporter is attempted FIRST and
    unconditionally: an operator who sets only the scrape port (the
    README's "one scrape config covers the pod" wiring) gets a live
    exporter without also having to opt into sampling.  Returns the
    running sampler or None."""
    try:
        from dist_keras_tpu_torch.observability import prometheus

        prometheus.maybe_start_exporter()
    # dklint: ignore[broad-except] exporter bring-up is best-effort; telemetry must not kill
    except Exception:  # pragma: no cover - exporter must not kill
        pass
    interval = default_sample_s()
    if interval is None:
        return None
    with _lock:
        sampler = _global["sampler"]
        if sampler is None:
            wd = None
            if knobs.get("DK_WATCHDOG"):
                from dist_keras_tpu_torch.observability import watchdog

                wd = watchdog.Watchdog()
            sampler = _global["sampler"] = MetricsSampler(
                interval_s=interval, watchdog=wd)
    return sampler.start()


def stop_sampler(final_tick=False):
    """Stop and forget the process-wide sampler (tests / clean exits)."""
    with _lock:
        sampler, _global["sampler"] = _global["sampler"], None
    if sampler is not None:
        sampler.stop(final_tick=final_tick)


def reset():
    """Drop every series and the global sampler (tests)."""
    stop_sampler()
    with _lock:
        _series.clear()
