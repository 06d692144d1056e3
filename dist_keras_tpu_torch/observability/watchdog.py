"""Anomaly watchdog — declarative rules over the live time series.

The sampler (``timeseries.MetricsSampler``) turns the metrics registry
into per-metric ``(t, value)`` rings; this module evaluates rules over
them every tick and turns transitions into typed alerts:

- rule starts firing  -> one ``watchdog_alert`` event (naming the rule,
  metric, measured value vs baseline — and, because every event carries
  ``rank``, WHICH host regressed), ``watchdog.alerts`` counter ++, the
  ``watchdog.firing.<rule>`` gauge -> 1, the pluggable ``alert_sink``
  callback, and the ``resilience.supervisor`` alert seam (registered
  sinks + ``DK_ALERT_CMD``) — one delivery per transition, never one
  per tick;
- rule stops firing for ``clear_checks`` CONSECUTIVE ticks -> one
  ``watchdog_clear`` event and the gauge -> 0.  The consecutive-clear
  hysteresis is the anti-flapping contract: a value oscillating around
  the threshold produces one alert and (eventually) one clear, not an
  alert storm.

Rules (each a small class with ``evaluate(now) -> (firing, fields)``;
compose your own or take :func:`default_rules`):

- :class:`StepTimeRegression` — the recent interval-mean of a phase
  histogram (e.g. ``perf.phase.step``) exceeds ``factor`` x the MEDIAN
  of earlier interval means.  Median baseline, deliberately: the first
  interval contains the XLA compile (seconds against millisecond
  steps), and a mean baseline would let that one outlier mask a real
  2x regression forever.
- :class:`ThroughputStall` — a counter that was advancing has not
  advanced for ``window_s`` (e.g. ``perf.dispatches``: the run is
  alive but no work is retiring — the "backend unresponsive"
  signature).
- :class:`QueueDepthGrowth` — a gauge (e.g. ``serve.pending``) rising
  monotonically across the last ``samples`` ticks above ``min_depth``:
  offered load is outrunning service rate *before* the queue bound
  starts rejecting.
- :class:`HeartbeatQuiet` — heartbeat-evidence dead peers
  (``coordination.dead_peers_at``, ``require_file=True`` so a host
  that never started is not convicted); fires naming the quiet ranks.

Rule evaluation never throws into the sampler: a broken rule degrades
to "not firing" plus one stderr warning per process.
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np

from dist_keras_tpu_torch.observability import events, metrics, timeseries
from dist_keras_tpu_torch.utils import knobs


class Rule:
    """One declarative anomaly rule.  Subclasses set ``name`` and
    implement :meth:`evaluate`; ``fields`` become the alert payload."""

    name = "rule"

    def evaluate(self, now):
        """-> ``(firing: bool, fields: dict)`` for this instant."""
        raise NotImplementedError

    def reset(self):
        """Forget accumulated state (stateful rules override; default
        no-op).  Called via :meth:`Watchdog.quiesce` when a workload
        phase ends ON PURPOSE — counters that stop advancing because
        the work completed must not be judged as a stall."""


def _aligned(count_series, total_series):
    """-> ``(t, count, total)`` arrays restricted to ticks present in
    BOTH rings.  The sampler appends ``.count`` then ``.total`` with one
    shared timestamp per tick under separate ring locks, so a reader
    landing between the two appends sees the newest count with no
    matching total; pairing by tail length would then shift every
    interval by one tick and can manufacture a regression that never
    happened.  Intersecting on the shared timestamps makes any torn
    read degrade to "newest tick not visible yet" instead."""
    tc, c = count_series.values()
    tt, tot = total_series.values()
    t, ic, it = np.intersect1d(tc, tt, return_indices=True)
    return t, c[ic], tot[it]


def _means_of(t, c, tot):
    """-> (t, mean) arrays of per-sample-interval histogram means from
    aligned cumulative arrays (only intervals where the count advanced
    produce a point)."""
    if len(t) < 2:
        return np.empty(0), np.empty(0)
    dc, dtot = np.diff(c), np.diff(tot)
    keep = dc > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        means = np.where(keep, dtot / np.maximum(dc, 1), 0.0)
    return t[1:][keep], means[keep]


def _interval_means(count_series, total_series):
    """-> (t, mean) per-interval means of a cumulative ``.count`` /
    ``.total`` ring pair (torn-read-safe via :func:`_aligned`)."""
    return _means_of(*_aligned(count_series, total_series))


class StepTimeRegression(Rule):
    """Recent mean of ``<metric>`` (a registry histogram sampled as
    ``.count``/``.total`` series) > ``factor`` x the median of earlier
    interval means, AND slower by at least ``min_abs_s`` absolute.
    The absolute floor is the anti-noise half of the contract: 2x of a
    1 ms step is scheduler jitter, 2x of a 1 s step is an incident —
    a ratio alone cannot tell them apart on fast steps."""

    def __init__(self, metric="perf.phase.step", factor=2.0,
                 recent_s=10.0, min_count=2, min_baseline=3,
                 min_abs_s=0.01):
        self.metric = str(metric)
        self.name = f"step_time_regression.{self.metric}" \
            if self.metric != "perf.phase.step" else "step_time_regression"
        self.factor = float(factor)
        self.recent_s = float(recent_s)
        self.min_count = int(min_count)
        self.min_baseline = int(min_baseline)
        self.min_abs_s = float(min_abs_s)
        self._since_t = 0.0

    def reset(self, now=None):
        """Phase boundary (quiesce): the rings outlive a workload, so
        the rule must forget them itself — judging workload B's compile
        era against workload A's millisecond baseline would page the
        operator for a normal warm-up.  Points at/before the boundary
        are ignored; the rule stays quiet until ``min_baseline`` NEW
        interval means accumulate, exactly like process start."""
        self._since_t = time.time() if now is None else float(now)

    def evaluate(self, now):
        sc = timeseries.get(f"{self.metric}.count")
        st = timeseries.get(f"{self.metric}.total")
        if sc is None or st is None:
            return False, {}
        ta, c, tot = _aligned(sc, st)
        if self._since_t:
            keep = ta > self._since_t
            ta, c, tot = ta[keep], c[keep], tot[keep]
        t, means = _means_of(ta, c, tot)
        if not len(means):
            return False, {}
        cut = float(now) - self.recent_s
        recent, baseline = means[t > cut], means[t <= cut]
        if len(baseline) < self.min_baseline or not len(recent):
            return False, {}
        # recent WEIGHTED mean from the cumulative deltas across the
        # cut, on the same aligned post-boundary view
        i = int(np.searchsorted(ta, cut, side="right")) - 1
        if i < 0 or c[-1] - c[i] < self.min_count:
            return False, {}
        recent_mean = (tot[-1] - tot[i]) / (c[-1] - c[i])
        base = float(np.median(baseline))
        firing = (base > 0 and recent_mean > self.factor * base
                  and recent_mean - base > self.min_abs_s)
        phase = self.metric.rsplit(".", 1)[-1]
        return firing, {"metric": self.metric, "phase": phase,
                        "recent_mean_s": round(float(recent_mean), 6),
                        "baseline_median_s": round(base, 6),
                        "factor": self.factor,
                        "min_abs_s": self.min_abs_s}


class ThroughputStall(Rule):
    """A previously-advancing counter has not advanced in ``window_s``.

    Stateful across ticks by design: judging the stall from the ring's
    retained span alone would (a) blind the rule whenever the ring
    covers less than ``window_s`` (512 points at a 0.1 s cadence retain
    51 s — a 60 s stall could never fire) and (b) falsely CLEAR a
    still-ongoing stall once the flat period scrolls the last advance
    out of the ring.  Tracking the last-advance instant in the rule —
    evaluated every sampler tick, like all rules — has neither failure
    mode.  A counter that never advanced stays quiet (idle != stalled).

    ``pending_metric``: optional gauge naming the outstanding work
    (e.g. ``serve.pending``).  While that gauge exists and reads <= 0
    the stall clock is HELD — a serving host with no offered load is
    idle, not wedged, and must not page the operator after every quiet
    hour.  A process where the gauge was never recorded (pure
    training: no serving engine) is unaffected.
    """

    def __init__(self, metric="perf.dispatches", window_s=60.0,
                 pending_metric=None):
        self.metric = str(metric)
        self.name = f"throughput_stall.{self.metric}"
        self.window_s = float(window_s)
        self.pending_metric = str(pending_metric) if pending_metric \
            else None
        self.reset()

    def reset(self):
        """Disarm: post-reset quiet is idle, not a stall — the
        quiesce() hook for deliberate completions (train end, drain)."""
        self._last = None            # last observed value
        self._last_advance_t = None  # when it last grew
        self._advanced = False       # grew at least once since armed

    def evaluate(self, now):
        s = timeseries.get(self.metric)
        if s is None:
            return False, {}
        latest = s.latest
        if latest is None:
            return False, {}
        t, v = latest
        if self._last is None:
            self._last = v           # arm on first sight — not growth
            return False, {}
        if v > self._last:
            self._advanced = True
            self._last_advance_t = t
        self._last = v
        if not self._advanced:
            return False, {}
        if self.pending_metric is not None:
            p = timeseries.get(self.pending_metric)
            pl = p.latest if p is not None else None
            if pl is not None and pl[1] <= 0:
                # nothing outstanding: quiet is idle — hold the stall
                # clock so only time spent with work pending counts
                self._last_advance_t = now
                return False, {}
        stalled_s = float(now) - float(self._last_advance_t)
        return stalled_s >= self.window_s, {
            "metric": self.metric,
            "stalled_s": round(stalled_s, 3),
            "last_value": float(v)}


class QueueDepthGrowth(Rule):
    """A gauge rising monotonically over the last ``samples`` ticks,
    ending at/above ``min_depth``."""

    def __init__(self, metric="serve.pending", samples=5, min_depth=16):
        self.metric = str(metric)
        self.name = f"queue_depth_growth.{self.metric}"
        self.samples = int(samples)
        self.min_depth = float(min_depth)

    def evaluate(self, now):
        s = timeseries.get(self.metric)
        if s is None:
            return False, {}
        _, v = s.values()
        if len(v) < self.samples:
            return False, {}
        w = v[-self.samples:]
        firing = bool(np.all(np.diff(w) >= 0) and w[-1] > w[0]
                      and w[-1] >= self.min_depth)
        return firing, {"metric": self.metric, "depth": float(w[-1]),
                        "grew_from": float(w[0]),
                        "samples": self.samples}


class HeartbeatQuiet(Rule):
    """Heartbeat-evidence dead peers under ``DK_COORD_DIR`` — the
    watchdog-plane mirror of the coordination layer's typed
    ``PeerLost``, but continuous (an alert while the run still limps)
    instead of terminal."""

    name = "heartbeat_quiet"

    def evaluate(self, now):
        d = knobs.raw("DK_COORD_DIR")
        if not d:
            return False, {}
        try:
            world = int(knobs.raw("DK_COORD_WORLD") or 0)
        except ValueError:
            return False, {}
        if world < 2:
            return False, {}
        from dist_keras_tpu_torch.resilience import coordination

        dead = coordination.dead_peers_at(d, world, require_file=True)
        return bool(dead), {"ranks": sorted(dead), "world": world}


def default_rules():
    """The standard production set — step-time regression, dispatch
    stall, serving completion stall, serving queue growth, quiet
    hosts.  Both stall rules gate on ``serve.pending`` so an idle
    serving host reads as idle, never as a stall; in a pure training
    process that gauge is never recorded and the gate is inert (the
    narrow cost: a co-resident idle serving engine holds the dispatch
    stall clock during training — a missed page there beats paging
    every host on every quiet night).  With ``DK_SLO`` armed the set
    also carries ``slo.SLOBurnRate`` (lazy import: slo depends on this
    module for the ``Rule`` base, so the reach-back stays inside the
    function body)."""
    rules = [
        StepTimeRegression(),
        ThroughputStall("perf.dispatches", pending_metric="serve.pending"),
        ThroughputStall("serve.completed", pending_metric="serve.pending"),
        QueueDepthGrowth("serve.pending"),
        HeartbeatQuiet(),
    ]
    try:
        from dist_keras_tpu_torch.observability import slo

        rules.extend(slo.burn_rules())
    # dklint: ignore[broad-except] a broken SLO plane degrades to the classic rule set
    except Exception:  # pragma: no cover - slo plane optional
        pass
    return rules


class Watchdog:
    """Evaluate rules; emit typed alerts on transitions only.

    ``alert_sink``: optional callable receiving each alert dict — the
    pluggable alert seam; alerts ALSO route through
    ``resilience.supervisor.alert`` (registered sinks + the
    ``DK_ALERT_CMD`` webhook-command), so one operator hook covers
    supervisor giveups and watchdog alerts alike.
    """

    def __init__(self, rules=None, alert_sink=None, clear_checks=2):
        self.rules = list(rules) if rules is not None else default_rules()
        self.alert_sink = alert_sink
        self.clear_checks = max(1, int(clear_checks))
        self.alerts = []   # every alert ever fired (introspection)
        self._state = {}   # rule -> {"firing": bool, "clears": int}
        self._warned = set()
        self._lock = threading.Lock()

    def firing(self):
        """Names of the rules currently in the firing state."""
        with self._lock:
            return sorted(r.name for r, st in self._state.items()
                          if st["firing"])

    def quiesce(self):
        """A workload phase ended DELIBERATELY (train end, serving
        drain): reset every rule's accumulated state so the quiet that
        follows completion is idle, not anomaly.  Without this, a
        completed run's dispatch counter stops advancing forever and
        ``ThroughputStall`` would page the operator for every run that
        succeeded.  Already-firing alerts clear through the normal
        hysteresis as the reset rules report not-firing."""
        for rule in self.rules:
            try:
                rule.reset()
            # dklint: ignore[broad-except] a broken rule reset degrades to a one-time warning
            except Exception as e:
                self._warn_once(rule, e)

    def _warn_once(self, rule, e):
        if rule.name in self._warned:
            return
        self._warned.add(rule.name)
        print(f"[dk.watchdog] WARNING: rule {rule.name!r} raised "
              f"{e!r} — treated as not-firing", file=sys.stderr,
              flush=True)

    def _deliver(self, alert):
        # the ONE alert seam: supervisor sinks + DK_ALERT_CMD, then the
        # watchdog-local callback; all best-effort — alerting must
        # never be the thing that kills the run it watches
        try:
            from dist_keras_tpu_torch.resilience import supervisor

            supervisor.alert("watchdog_alert", **alert)
        # dklint: ignore[broad-except] the alert seam never raises into the sampler thread
        except Exception:  # pragma: no cover - alert seam never raises
            pass
        if self.alert_sink is not None:
            try:
                self.alert_sink(alert)
            # dklint: ignore[broad-except] a broken alert_sink warns; alerting must not kill the run
            except Exception as e:
                print(f"[dk.watchdog] WARNING: alert_sink raised {e!r}",
                      file=sys.stderr, flush=True)

    def check(self, now=None):
        """Evaluate every rule once; -> the alerts fired THIS check
        (transitions only)."""
        now = time.time() if now is None else float(now)
        fired = []
        for rule in self.rules:
            try:
                firing, fields = rule.evaluate(now)
            # dklint: ignore[broad-except] a broken rule degrades to not-firing + one warning
            except Exception as e:
                self._warn_once(rule, e)
                firing, fields = False, {}
            with self._lock:
                st = self._state.setdefault(
                    rule, {"firing": False, "clears": 0})
                if firing:
                    st["clears"] = 0
                    transition = not st["firing"]
                    st["firing"] = True
                else:
                    transition = False
                    if st["firing"]:
                        st["clears"] += 1
                        if st["clears"] >= self.clear_checks:
                            st["firing"] = False
                            st["clears"] = 0
                            events.emit("watchdog_clear", rule=rule.name)
                            # dklint: metrics=watchdog.firing.*
                            metrics.gauge(
                                f"watchdog.firing.{rule.name}").set(0)
            if transition:
                alert = {"rule": rule.name, "t": now, **fields}
                # dump the flight recorder FIRST and stamp the path
                # into the alert payload: the DK_ALERT_CMD webhook line
                # then names the artifact to open, not just the
                # symptom — an alert is actionable without shell
                # archaeology.  Transition-only cadence bounds the I/O.
                try:
                    from dist_keras_tpu_torch.observability import flight

                    dump_path = flight.dump("watchdog_alert",
                                            rule=rule.name)
                # dklint: ignore[broad-except] a failed dump must not block the alert delivery
                except Exception:  # pragma: no cover - dump optional
                    dump_path = None
                if dump_path is not None:
                    alert["dump_path"] = dump_path
                self.alerts.append(alert)
                fired.append(alert)
                events.emit("watchdog_alert", **alert)
                metrics.counter("watchdog.alerts").inc()
                # dklint: metrics=watchdog.firing.*
                metrics.gauge(f"watchdog.firing.{rule.name}").set(1)
                self._deliver(alert)
        return fired
