"""Closed-loop replica autoscaling — actuate what the watchdog alerts.

The ``QueueDepthGrowth`` watchdog rule already recognizes a
serving host falling behind: the ``serve.pending`` gauge rising
monotonically across sampler ticks, ending at depth.  This module
closes the loop: the SAME ramp signature (plus an optional latency-p99
breach) actuates :meth:`ServingEngine.resize` between a floor and a
ceiling, with the watchdog's ``clear_checks``-style hysteresis so
noise never oscillates the replica set.

Decision rule per :meth:`ReplicaAutoscaler.tick`:

- **Scale up** (by ``step``, bounded by ``ceiling``) when the last
  ``samples`` points of the ``serve.pending`` time-series ring are
  non-decreasing, strictly grew, and end at/above ``depth_high`` —
  exactly :class:`~dist_keras_tpu_torch.observability.watchdog.
  QueueDepthGrowth`'s firing condition — OR when the engine's
  ``serve.predict_s`` windowed p99 exceeds ``p99_high_s`` (when set).
- **Scale down** (by ``step``, bounded by ``floor``) only after
  ``clear_checks`` CONSECUTIVE calm ticks (queue at/below
  ``depth_low`` and no ramp) — one quiet tick proves nothing, the
  same reasoning as the watchdog's consecutive-clear hysteresis.
- **Cooldown**: after ANY resize, ``cooldown_checks`` ticks must pass
  before the next one — the new replica set gets to absorb the
  backlog before being judged.

Every actuation emits ``autoscale_resize`` (direction, from, to,
evidence) + the ``autoscale.resizes`` counter; the ``autoscale.
replicas`` gauge tracks the current target.  The decision core is
:meth:`tick` — the background loop is just a cadence around it, so
tests and the simulator drive single deterministic ticks directly.

The scaler needs the time-series sampler to be feeding the
``serve.pending`` ring (``DK_OBS_SAMPLE_S`` — ``ServingServer.start``
wires it); without samples it holds still, which is the safe failure
mode for an actuator.
"""

from __future__ import annotations

import threading

import numpy as np

from dist_keras_tpu_torch.observability import events, metrics, timeseries


class ReplicaAutoscaler:
    """Drive ``engine.resize`` from the ``serve.*`` telemetry rings.

    Args:
      engine: anything with ``resize(n)`` and ``stats()`` returning a
        ``"replicas"`` count (:class:`ServingEngine`, or
        :class:`~.reload.BlueGreenEngine` which fans resize to both
        colors).
      floor / ceiling: replica-count bounds (inclusive).
      interval_s: background-loop tick cadence.
      depth_high: ramp must END at/above this queue depth to scale up
        (the ``QueueDepthGrowth`` ``min_depth`` twin).
      depth_low: queue at/below this counts as a calm tick (default
        ``depth_high // 4``).
      p99_high_s: optional latency SLO — a ``serve.predict_s`` p99
        above it scales up even without a ramp.
      slo_signal: consume the SLO plane: any objective the
        default ``slo`` registry reports as burning past the
        multi-window thresholds counts as scale-up evidence alongside
        the ramp — inert unless ``DK_SLO`` is armed (``slo.breaching``
        returns ``[]`` when off).  Default True.
      samples: ring points the ramp test inspects.
      clear_checks: consecutive calm ticks before a scale-down.
      cooldown_checks: ticks held still after any resize.
      step: replicas added/removed per actuation.
    """

    def __init__(self, engine, floor=1, ceiling=8, interval_s=1.0,
                 depth_high=16, depth_low=None, p99_high_s=None,
                 slo_signal=True, samples=5, clear_checks=3,
                 cooldown_checks=2, step=1):
        if not 1 <= int(floor) <= int(ceiling):
            raise ValueError(
                f"need 1 <= floor ({floor}) <= ceiling ({ceiling})")
        self.engine = engine
        self.floor = int(floor)
        self.ceiling = int(ceiling)
        self.interval_s = float(interval_s)
        self.depth_high = float(depth_high)
        self.depth_low = (float(depth_low) if depth_low is not None
                          else self.depth_high / 4.0)
        self.p99_high_s = (None if p99_high_s is None
                           else float(p99_high_s))
        self.slo_signal = bool(slo_signal)
        self.samples = int(samples)
        self.clear_checks = int(clear_checks)
        self.cooldown_checks = int(cooldown_checks)
        self.step = int(step)
        self.resizes = 0
        self._calm_streak = 0
        self._cooldown = 0
        self._stop = threading.Event()
        self._thread = None
        self._gauge = metrics.gauge("autoscale.replicas")
        self._gauge.set(self._replicas())

    def _replicas(self):
        return int(self.engine.stats()["replicas"])

    def _ramp(self):
        """-> (firing, last_depth) over the serve.pending ring — the
        QueueDepthGrowth signature, evaluated here so sim ticks need
        no watchdog instance."""
        s = timeseries.get("serve.pending")
        if s is None:
            return False, None
        _, v = s.values()
        if len(v) == 0:
            return False, None
        if len(v) < self.samples:
            return False, float(v[-1])
        w = v[-self.samples:]
        firing = bool(np.all(np.diff(w) >= 0) and w[-1] > w[0]
                      and w[-1] >= self.depth_high)
        return firing, float(w[-1])

    def _slo_burning(self):
        """Firing objective names from the SLO plane's last evaluation
        — ``[]`` when ``slo_signal`` is off, ``DK_SLO`` is unarmed, or
        no objective burns.  Best-effort: the scaler must keep working
        on a process without the SLO plane."""
        if not self.slo_signal:
            return []
        try:
            from dist_keras_tpu_torch.observability import slo

            return slo.breaching()
        # dklint: ignore[broad-except] a broken SLO plane degrades to ramp/p99 evidence only
        except Exception:  # pragma: no cover - slo plane optional
            return []

    def tick(self):
        """One decision: inspect the rings, maybe resize.  -> the
        action taken: ``"up"`` / ``"down"`` / ``None`` (held)."""
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        ramp, depth = self._ramp()
        p99 = metrics.histogram("serve.predict_s").summary()["p99"]
        slo_breach = (self.p99_high_s is not None and p99 is not None
                      and p99 > self.p99_high_s)
        burning = self._slo_burning()
        cur = self._replicas()
        if (ramp or slo_breach or burning) and cur < self.ceiling:
            self._calm_streak = 0
            return self._resize(min(self.ceiling, cur + self.step),
                                "up", depth=depth, p99=p99,
                                ramp=ramp, slo_breach=slo_breach,
                                slo_objectives=burning or None)
        if ramp or slo_breach or burning:
            self._calm_streak = 0  # pinned at the ceiling: no churn
            return None
        calm = depth is None or depth <= self.depth_low
        if not calm:
            self._calm_streak = 0
            return None
        self._calm_streak += 1
        if self._calm_streak >= self.clear_checks and cur > self.floor:
            self._calm_streak = 0
            return self._resize(max(self.floor, cur - self.step),
                                "down", depth=depth, p99=p99,
                                ramp=False, slo_breach=False)
        return None

    def _resize(self, target, direction, **evidence):
        before = self._replicas()
        self.engine.resize(target)
        self.resizes += 1
        self._cooldown = self.cooldown_checks
        self._gauge.set(target)
        metrics.counter("autoscale.resizes").inc()
        events.emit("autoscale_resize", direction=direction,
                    replicas_from=before, replicas_to=target,
                    **{k: v for k, v in evidence.items()
                       if v is not None})
        return direction

    # -- background loop ------------------------------------------------
    def _loop(self):
        while not self._stop.is_set():
            try:
                self.tick()
            # dklint: ignore[broad-except] a failed actuation (engine draining mid-tick) must not kill the scaler
            except Exception as e:
                events.emit("autoscale_resize", direction="error",
                            error=type(e).__name__,
                            detail=str(e)[:200])
            self._stop.wait(self.interval_s)

    def start(self):
        """Start the background decision loop (daemon); -> self."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="dk-serve-autoscale")
        self._thread.start()
        return self

    def stop(self, timeout_s=5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
