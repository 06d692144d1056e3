"""Generic retry with exponential backoff — the transient-fault absorber,
a copy of the JAX package's ``resilience/retry.py`` (it is framework
free) on the port's ``world`` seam, ``events`` and ``metrics``.

The reference got retries for free from Spark task re-execution; here
every rsync/ssh hop (``launch.Job``), manifest poll
(``launch.Punchcard``), checkpoint write (``checkpoint.Checkpointer``)
and stream fetch (``data.streaming``) goes through one shared policy so
"what is retried" is a single auditable surface (README "Failure
semantics").

Design points:

- **Deterministic jitter.** ``jitter`` is a +/- fraction of each delay,
  drawn from a policy-local seeded PRNG — runs de-synchronize (no
  thundering herd on a shared head node) yet every test replays the
  identical schedule.
- **Overall deadline, not per-attempt.** ``timeout`` bounds the whole
  retry loop from the first attempt; a sleep is clipped to the remaining
  budget and a retry never *starts* past the deadline.
- **The last error is re-raised as itself.** Callers keep matching on the
  original exception type; the attempt count rides on the exception as
  ``_retry_attempts`` for diagnostics.
- **Injectable clock/sleep** so tests assert the schedule without
  sleeping.  Defaults route through the :mod:`~dist_keras_tpu_torch
  .resilience.world` seam (resolved per call), so backoff sleeps under
  the cluster simulator advance simulated time instead of stalling.
"""

from __future__ import annotations

import random

from dist_keras_tpu_torch.resilience import world as _world


class RetryPolicy:
    """attempts = total tries (1 = no retry).  Delay before retry ``i``
    (1-based) is ``min(backoff * multiplier**(i-1), max_delay)``, jittered
    by ``+/- jitter`` fraction."""

    def __init__(self, attempts=3, backoff=0.1, multiplier=2.0,
                 max_delay=30.0, jitter=0.0, timeout=None,
                 retryable=(OSError,), sleep=None,
                 clock=None, on_retry=None, seed=None,
                 name=None):
        if int(attempts) < 1:
            raise ValueError(f"attempts={attempts} must be >= 1")
        if float(backoff) < 0 or float(max_delay) < 0:
            raise ValueError("backoff/max_delay must be >= 0")
        if not 0.0 <= float(jitter) < 1.0:
            raise ValueError(f"jitter={jitter} must be in [0, 1)")
        self.attempts = int(attempts)
        self.backoff = float(backoff)
        self.multiplier = float(multiplier)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self.timeout = None if timeout is None else float(timeout)
        self.retryable = tuple(retryable)
        # None -> the world-seam module functions, which resolve the
        # CURRENT world at call time: a SimWorld installed after this
        # policy was built still governs its sleeps and deadlines
        self.sleep = _world.sleep if sleep is None else sleep
        self.clock = _world.monotonic if clock is None else clock
        self.on_retry = on_retry
        # name: which retry surface this is ("checkpoint.save",
        # "job.rsync", ...) — stamped on the observability events and
        # the per-surface metrics counters below; None = anonymous
        # (events still fire, counters aggregate under "retry")
        self.name = name
        # seed=None derives from the pid so concurrent processes
        # genuinely de-synchronize (the anti-thundering-herd property);
        # an explicit seed replays the identical schedule for tests
        import os

        self._rng = random.Random(os.getpid() if seed is None else seed)
        self._deadline = None  # armed by call()/start_deadline()

    def start_deadline(self):
        """Arm the overall ``timeout`` deadline from NOW.  :meth:`call`
        does this itself; a caller driving its OWN loop (the auto-resume
        supervisor) arms it once and then consults
        :meth:`remaining_deadline` so every nested retry surface shares
        one budget.  -> the remaining seconds (None = unbounded)."""
        self._deadline = (None if self.timeout is None
                          else self.clock() + self.timeout)
        return self.timeout

    def remaining_deadline(self):
        """Seconds left in the overall ``timeout`` budget of the current
        (or most recent) :meth:`call` / :meth:`start_deadline`, clipped
        at 0.0; None when the policy has no timeout.  Before any call
        the FULL budget is reported — a nested surface asking early must
        not read "already expired".  This is how an outer budget (the
        supervisor's) bounds inner retries (a checkpoint save's) instead
        of the two silently stacking."""
        if self.timeout is None:
            return None
        if self._deadline is None:
            return self.timeout
        return max(0.0, self._deadline - self.clock())

    def delay(self, attempt):
        """Backoff before retry ``attempt`` (1-based), jitter applied."""
        d = min(self.backoff * self.multiplier ** (attempt - 1),
                self.max_delay)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return d

    def call(self, fn, *args, **kwargs):
        """Run ``fn`` under this policy; re-raises the last error after
        the attempts/deadline budget is spent."""
        # lazy: events/metrics must never be an import cycle hazard for
        # the low-level retry primitive (and emit() is a no-op boolean
        # check when DK_OBS_DIR is unset)
        from dist_keras_tpu_torch.observability import events, metrics

        surface = self.name or "retry"
        self.start_deadline()
        deadline = self._deadline
        last = None
        for attempt in range(1, self.attempts + 1):
            try:
                return fn(*args, **kwargs)
            except self.retryable as e:
                last = e
                if attempt >= self.attempts:
                    break
                d = self.delay(attempt)
                if deadline is not None:
                    remaining = deadline - self.clock()
                    if remaining <= 0:
                        break  # out of time: don't start another attempt
                    d = min(d, remaining)
                # dklint: metrics=*.retries
                metrics.counter(f"{surface}.retries").inc()
                events.emit("retry", name=surface, attempt=attempt,
                            error=type(e).__name__, delay_s=d)
                if self.on_retry is not None:
                    self.on_retry(attempt, e, d)
                if d > 0:
                    self.sleep(d)
        # dklint: metrics=*.exhausted
        metrics.counter(f"{surface}.exhausted").inc()
        events.emit("retry_exhausted", name=surface, attempts=attempt,
                    error=type(last).__name__)
        try:
            last._retry_attempts = attempt
        except AttributeError:  # pragma: no cover - __slots__ exceptions
            pass
        raise last


def retry_call(fn, *args, policy=None, **kwargs):
    """``(policy or RetryPolicy()).call(fn, *args, **kwargs)``."""
    return (policy or RetryPolicy()).call(fn, *args, **kwargs)


def retry(fn=None, *, attempts=3, backoff=0.1, multiplier=2.0,
          max_delay=30.0, jitter=0.0, timeout=None, retryable=(OSError,),
          sleep=None, on_retry=None, seed=0, name=None):
    """Decorator form: ``@retry`` or ``@retry(attempts=5, ...)``.

    The policy is built once at decoration time; its jitter PRNG is
    shared across calls, so a long-lived decorated function still walks a
    deterministic jitter sequence.
    """
    policy = RetryPolicy(attempts=attempts, backoff=backoff,
                         multiplier=multiplier, max_delay=max_delay,
                         jitter=jitter, timeout=timeout,
                         retryable=retryable, sleep=sleep,
                         on_retry=on_retry, seed=seed, name=name)

    def deco(f):
        import functools

        @functools.wraps(f)
        def wrapped(*args, **kwargs):
            return policy.call(f, *args, **kwargs)

        wrapped.retry_policy = policy
        return wrapped

    return deco if fn is None else deco(fn)
