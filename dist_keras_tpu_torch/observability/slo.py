"""Request-level SLO engine — declarative objectives, burn-rate math.

Round 21 shipped the serving fabric with one stitched trace per
request, but nothing *consumed* the ``serve.*`` / ``route.*`` rings at
production scale: no objective said what "good" means, and no alert
translated a bad p99 sample into "you are burning error budget".  This
module closes that loop:

- **Objectives** are declarative good/total ratios over existing
  telemetry: :func:`availability` objectives read cumulative counters
  from the per-metric ``TimeSeries`` rings (``serve.completed`` vs
  ``serve.errors``, ``route.requests`` vs ``route.errors``);
  :func:`latency` objectives count requests over a threshold via
  :meth:`metrics.Histogram.track_over` (``span.serve.request``
  durations vs ``DK_SLO_LATENCY_S``).  The closed vocabulary lives in
  :data:`KNOWN_SLOS` (lint-checked against the README table, like
  events).
- **Multi-window / multi-burn-rate** evaluation, the standard SRE
  recipe: the *fast* page needs BOTH the 5 m and 1 h windows burning
  at >= 14.4x the sustainable rate (budget gone in under ~6 h); the
  *slow* page needs both 1 h and 6 h burning at >= 6x.  Requiring the
  short AND the long window makes a page mean "still happening AND
  significant"; the short window alone would page on blips, the long
  alone would page an hour after the incident ended.  Windows are
  measured in *ring time* (every entry point takes an explicit
  ``now``), so the sim's ``World`` clock drives the math
  deterministically and a wall-clock process just passes
  ``time.time()``.
- **Surfaces**: ``slo.<objective>.*`` gauges (→ ``dk_slo_*`` after
  Prometheus sanitization), the :class:`SLOBurnRate` watchdog rule
  (transition-only + hysteresis via the existing ``Watchdog``
  machinery), the ``/slz`` section of ``statusz``, and
  :func:`breaching` — the signal ``ReplicaAutoscaler`` consumes
  alongside ``QueueDepthGrowth``.

Everything here is never-throws toward the sampler thread and inert
unless ``DK_SLO`` is armed (one cached knob read).
"""

from __future__ import annotations

import bisect
import sys
import threading
import time

from dist_keras_tpu_torch.observability import events, metrics, timeseries
# one-way dependency: watchdog never imports slo at module level (its
# default_rules() reaches back only inside the function body)
from dist_keras_tpu_torch.observability.watchdog import Rule
from dist_keras_tpu_torch.utils import knobs


# The objective vocabulary — every SLO name any registry may register,
# with what it means.  Adding an objective?  Register it here AND add a
# row to the README SLO table, or the ``slo-undocumented`` /
# ``slo-doc-drift`` lint rules fail the tree (the same both-ways
# contract events and metrics follow).
KNOWN_SLOS = {
    "serve_availability": ("serving requests answered without error or "
                           "rejection (good = serve.completed, bad = "
                           "serve.errors + serve.rejected)"),
    "serve_latency": ("serve.request spans completing under the "
                      "DK_SLO_LATENCY_S threshold"),
    "route_availability": ("router forwards that returned a backend "
                           "answer (bad = route.errors over "
                           "route.requests)"),
    "generate_ttft": ("decode requests whose first generated token "
                      "lands under the DK_SLO_TTFT_S threshold "
                      "(histogram = decode.ttft_s)"),
    "generate_tokens": ("decode sequences that ran to completion "
                        "(good = decode.completed, bad = "
                        "decode.errors + decode.rejected)"),
}

# (label, window seconds) — shared by burn math, gauges, and the
# report renderer.  Ring time, not wall time.
WINDOWS = (("5m", 300.0), ("1h", 3600.0), ("6h", 21600.0))
FAST_BURN = 14.4   # 5m AND 1h both over => budget gone in < ~6h
SLOW_BURN = 6.0    # 1h AND 6h both over => sustained significant burn
_PRUNE_S = 27000.0  # keep a bit more than the slowest window

_warned = set()
_warn_lock = threading.Lock()


def _warn_once(key, msg):
    with _warn_lock:
        if key in _warned:
            return
        _warned.add(key)
    print(f"[dk.slo] WARNING: {msg}", file=sys.stderr, flush=True)


class Objective:
    """One good/total objective with its own cumulative sample ring.

    ``source()`` returns the CUMULATIVE ``(good, total)`` pair at call
    time; :meth:`evaluate` appends ``(now, good, total)`` and computes
    per-window burn rates from interval deltas, so the math needs no
    per-request hook — one cheap sample per sampler tick.  A window
    the ring does not fully cover yet degrades to the covered span
    (deltas against the oldest retained point): a fresh process
    failing hard fires FAST instead of waiting an hour for data.
    """

    def __init__(self, name, target, source, description="",
                 threshold_s=None):
        if name not in KNOWN_SLOS:
            raise ValueError(
                f"unknown SLO objective {name!r} — add it to "
                f"slo.KNOWN_SLOS (and the README table) first")
        self.name = str(name)
        self.target = float(target)
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"SLO target must be in (0, 1), "
                             f"got {self.target}")
        self.source = source
        self.description = str(description) or KNOWN_SLOS[name]
        self.threshold_s = (None if threshold_s is None
                            else float(threshold_s))
        self._t, self._good, self._total = [], [], []
        self._lock = threading.Lock()

    def _burn(self, window_s, now):
        """Burn rate over the trailing window: (bad fraction of the
        interval) / (allowed bad fraction).  1.0 = burning exactly the
        budget; 14.4 = the whole 30-day budget in ~2 days."""
        t = self._t
        if len(t) < 2:
            return 0.0
        # baseline = the sample at/just before the window start (the
        # standard cumulative-counter approximation); if the ring is
        # younger than the window, the oldest point (partial window)
        i = bisect.bisect_left(t, float(now) - float(window_s))
        b = max(i - 1, 0) if i else 0
        if b >= len(t) - 1:
            b = len(t) - 2
        d_total = self._total[-1] - self._total[b]
        if d_total <= 0:
            return 0.0
        d_good = self._good[-1] - self._good[b]
        bad_frac = min(1.0, max(0.0, (d_total - d_good) / d_total))
        return bad_frac / max(1e-9, 1.0 - self.target)

    def evaluate(self, now):
        """Sample the source, append to the ring, -> the result doc
        (burn per window + firing flags) for this instant."""
        now = float(now)
        good, total = self.source()
        good, total = float(good), float(total)
        with self._lock:
            # idempotent per timestamp: the sampler and a standalone
            # SLOBurnRate rule may both evaluate the same tick
            if not self._t or now > self._t[-1]:
                self._t.append(now)
                self._good.append(good)
                self._total.append(total)
                cut = now - _PRUNE_S
                k = bisect.bisect_left(self._t, cut)
                if k:
                    del self._t[:k], self._good[:k], self._total[:k]
            burn = {label: self._burn(w, now) for label, w in WINDOWS}
            covered = self._t[-1] - self._t[0] if self._t else 0.0
        fast = burn["5m"] >= FAST_BURN and burn["1h"] >= FAST_BURN
        slow = burn["1h"] >= SLOW_BURN and burn["6h"] >= SLOW_BURN
        doc = {
            "objective": self.name,
            "target": self.target,
            "good": good,
            "total": total,
            "burn": {k: round(v, 4) for k, v in burn.items()},
            "fast_firing": fast,
            "slow_firing": slow,
            "firing": fast or slow,
            "covered_s": round(covered, 3),
        }
        if self.threshold_s is not None:
            doc["threshold_s"] = self.threshold_s
        return doc

    def reset(self):
        with self._lock:
            self._t, self._good, self._total = [], [], []


def availability(name, bad, good=None, total=None, target=0.999):
    """Availability objective over cumulative COUNTER rings.

    Either ``good=(names,)`` (total = good + bad) or
    ``total=(names,)`` (good = total - bad).  Counters are read from
    the per-metric ``TimeSeries`` rings the sampler populates, so the
    objective sees exactly what the watchdog sees; a ring that does
    not exist yet reads 0 and the objective stays quiet.
    """
    if (good is None) == (total is None):
        raise ValueError("availability() needs exactly one of "
                         "good= or total=")
    bad, base = tuple(bad), tuple(good if good is not None else total)

    def _ring(metric):
        s = timeseries.get(metric)
        latest = s.latest if s is not None else None
        return float(latest[1]) if latest is not None else 0.0

    def source():
        b = sum(_ring(m) for m in bad)
        if good is not None:
            g = sum(_ring(m) for m in base)
            return g, g + b
        n = sum(_ring(m) for m in base)
        return max(0.0, n - b), n

    return Objective(name, target, source)


def latency(name, histogram="span.serve.request", threshold_s=None,
            target=0.99):
    """Latency-threshold objective over a registry histogram: good =
    observations at/under ``threshold_s`` (default
    ``DK_SLO_LATENCY_S``), counted exactly via
    :meth:`Histogram.track_over` — one float compare per observe, no
    ring scan."""
    thr = (knobs.get("DK_SLO_LATENCY_S") if threshold_s is None
           else float(threshold_s))
    # dklint: metrics=span.*
    h = metrics.histogram(histogram)
    h.track_over(thr)

    def source():
        count = float(h.totals()["count"])
        return count - float(h.over(thr)), count

    return Objective(name, target, source, threshold_s=thr)


class Registry:
    """A set of objectives evaluated together.  The module-level
    default registry feeds the gauges / watchdog / statusz surfaces;
    the sim builds private registries so scenario math never touches
    process globals."""

    def __init__(self, gauges=False):
        self._objectives = []
        self._results = []
        self._last_now = None
        self._firing = frozenset()
        self._gauges = bool(gauges)
        self._lock = threading.Lock()

    def register(self, objective):
        with self._lock:
            if any(o.name == objective.name for o in self._objectives):
                raise ValueError(
                    f"SLO objective {objective.name!r} already "
                    f"registered")
            self._objectives.append(objective)
        return objective

    def objectives(self):
        with self._lock:
            return list(self._objectives)

    def results(self):
        """Last evaluation's result docs (empty before the first)."""
        with self._lock:
            return list(self._results)

    def breaching(self):
        """Names of objectives firing as of the last evaluation — the
        autoscaler's scale-up evidence."""
        with self._lock:
            return sorted(self._firing)

    def evaluate(self, now=None):
        """Evaluate every objective at ``now`` (ring time) -> result
        docs.  Idempotent per timestamp; a broken objective degrades
        to absent-with-one-warning, never a raise into the sampler."""
        now = time.time() if now is None else float(now)
        with self._lock:
            if self._last_now is not None and now <= self._last_now:
                return list(self._results)
            objectives = list(self._objectives)
            was_firing = self._firing
        results = []
        for obj in objectives:
            try:
                results.append(obj.evaluate(now))
            # dklint: ignore[broad-except] a broken objective degrades to one warning, never a sampler raise
            except Exception as e:
                _warn_once(("objective", obj.name),
                           f"objective {obj.name!r} raised {e!r} — "
                           f"skipped")
        firing = frozenset(r["objective"] for r in results if r["firing"])
        if self._gauges:
            for r in results:
                n = r["objective"]
                # dklint: metrics=slo.*
                metrics.gauge(f"slo.{n}.burn_fast").set(r["burn"]["5m"])
                # dklint: metrics=slo.*
                metrics.gauge(f"slo.{n}.burn_slow").set(r["burn"]["1h"])
                # dklint: metrics=slo.*
                metrics.gauge(f"slo.{n}.firing").set(
                    1 if r["firing"] else 0)
        with self._lock:
            self._results = results
            self._last_now = now
            self._firing = firing
        if firing != was_firing and events.enabled():
            events.emit("slo_transition",
                        firing=sorted(firing),
                        cleared=sorted(was_firing - firing),
                        t_eval=now)
        return list(results)

    def clear(self):
        with self._lock:
            self._objectives = []
            self._results = []
            self._last_now = None
            self._firing = frozenset()


class SLOBurnRate(Rule):
    """Watchdog rule: any registered objective is burning error budget
    past the multi-window thresholds.  The alert names the WORST
    objective (and every firing one), its burn per window, and which
    page class (fast/slow) tripped; transitions and hysteresis come
    from the surrounding ``Watchdog``, like every other rule.

    Evaluates the registry itself (idempotent per timestamp), so the
    rule works under a bare ``Watchdog.check`` with no sampler.
    """

    name = "slo_burn_rate"

    def __init__(self, registry=None):
        self._registry = registry

    def evaluate(self, now):
        reg = self._registry if self._registry is not None else _default
        if not reg.objectives():
            return False, {}
        results = reg.evaluate(now)
        firing = [r for r in results if r["firing"]]
        if not firing:
            return False, {}
        worst = max(firing,
                    key=lambda r: max(r["burn"]["5m"], r["burn"]["1h"]))
        return True, {
            "objective": worst["objective"],
            "target": worst["target"],
            "burn_5m": worst["burn"]["5m"],
            "burn_1h": worst["burn"]["1h"],
            "burn_6h": worst["burn"]["6h"],
            "page": "fast" if worst["fast_firing"] else "slow",
            "objectives": sorted(r["objective"] for r in firing),
        }


_default = Registry(gauges=True)
_enabled = None


def enabled():
    """One cached ``DK_SLO`` read — the zero-cost gate every surface
    checks first."""
    global _enabled
    if _enabled is None:
        _enabled = bool(knobs.get("DK_SLO"))
    return _enabled


def register(objective):
    """Register an objective with the process-default registry."""
    return _default.register(objective)


def objectives():
    return _default.objectives()


def results():
    return _default.results()


def breaching():
    """Firing objective names from the default registry's last
    evaluation — empty when ``DK_SLO`` is off or all is well."""
    if not enabled():
        return []
    return _default.breaching()


def install_defaults():
    """Register the standard serving objectives (idempotent): serving
    availability + latency, router availability, decode TTFT +
    sequence completion.  A process that never
    records the underlying metrics keeps the objectives quiet (a
    source reading (0, 0) produces zero burn)."""
    if _default.objectives():
        return
    _default.register(availability(
        "serve_availability", good=("serve.completed",),
        bad=("serve.errors", "serve.rejected"), target=0.999))
    _default.register(latency("serve_latency", target=0.99))
    _default.register(availability(
        "route_availability", total=("route.requests",),
        bad=("route.errors",), target=0.999))
    _default.register(latency(
        "generate_ttft", histogram="decode.ttft_s",
        threshold_s=float(knobs.get("DK_SLO_TTFT_S")), target=0.99))
    _default.register(availability(
        "generate_tokens", good=("decode.completed",),
        bad=("decode.errors", "decode.rejected"), target=0.999))


def maybe_evaluate(now=None):
    """The sampler-tick hook: no-op unless ``DK_SLO`` is armed;
    otherwise install the default objectives once and evaluate.
    Never throws."""
    if not enabled():
        return
    try:
        install_defaults()
        _default.evaluate(now)
    # dklint: ignore[broad-except] SLO evaluation must never kill the sampler tick
    except Exception as e:
        _warn_once("evaluate", f"evaluation raised {e!r}")


def burn_rules():
    """The rules :func:`watchdog.default_rules` appends when ``DK_SLO``
    is armed (installing the default objectives so the rule has
    something to evaluate)."""
    if not enabled():
        return []
    try:
        install_defaults()
    # dklint: ignore[broad-except] objective install failure degrades to no SLO rule + warning
    except Exception as e:
        _warn_once("install", f"default objectives raised {e!r}")
        return []
    return [SLOBurnRate()]


def status_doc():
    """The ``/slz`` section of statusz: armed-or-not, each objective's
    last result (burn per window, firing flags)."""
    return {
        "enabled": enabled(),
        "windows": {label: w for label, w in WINDOWS},
        "fast_burn": FAST_BURN,
        "slow_burn": SLOW_BURN,
        "objectives": _default.results(),
    }


def reset():
    """Forget objectives, results, and the cached knob (tests)."""
    global _enabled
    _default.clear()
    _enabled = None
    with _warn_lock:
        _warned.clear()
