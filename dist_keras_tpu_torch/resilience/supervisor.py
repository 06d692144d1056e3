"""Auto-resume supervisor — "typed exit" becomes "resumed run"; a copy
of the JAX package's ``resilience/supervisor.py`` (it is framework
free) on the port's ``world``, ``retry``, ``knobs`` and ``events``.

The resilience stack below this module guarantees a crash or preemption
leaves a fully-committed, integrity-manifested checkpoint; what it did
NOT do is relaunch anything — the operator had to notice the 143 and
restart by hand.  :func:`supervise` closes that loop in the
torchelastic style: run a training callable under a restart budget,
restore from the latest *verified* step
(``Checkpointer.latest_verified_step`` — a corrupt latest step is
skipped, the run resumes one cadence earlier instead of crash-looping
against unreadable bytes), and give up TYPED when restarting stops
being a plan:

- **Fatal errors are never retried.**  Config mistakes (``ValueError``
  / ``TypeError``) and a poisoned coordinator
  (:class:`~dist_keras_tpu_torch.resilience.coordination.CoordinatorPoisoned`
  — the collective stream desynced; only a fresh incarnation helps)
  propagate immediately.  Restarting a run that cannot ever succeed
  just burns the cluster.
- **A crash loop is a typed verdict, not an infinite loop.**  More than
  ``max_restarts`` restarts inside a rolling ``budget_window_s`` raises
  :class:`CrashLoop` carrying the evidence (timestamp + error of every
  restart in the window) — the post-mortem is in the exception, not
  scattered across N logs.
- **One deadline bounds everything.**  ``deadline_s`` arms the
  supervisor's :class:`~dist_keras_tpu_torch.resilience.retry.RetryPolicy`
  deadline; backoff sleeps are clipped to
  ``policy.remaining_deadline()`` and nested retry surfaces (a
  checkpoint save's own policy) can consult the same number, so inner
  retries can't silently overrun the outer budget.

``Preempted`` (SIGTERM → boundary checkpoint → ``SystemExit``) counts
as restartable: the per-process preemption flag is cleared before the
relaunch, and the next attempt resumes from the very step the
coordinated exit committed.  Events: ``supervisor_restart`` per
relaunch, ``supervisor_giveup`` (reason = fatal | crash_loop |
deadline) when the supervisor stops.

Launcher-side, ``launch.Job(supervise=...)`` reuses
:class:`RestartBudget` to relaunch DEAD HOSTS (heartbeat-proven via
``dead_hosts()``) over the existing rsync/ssh retry surfaces, rotating
``DK_COORD_SESSION`` per incarnation so the FileCoordinator rendezvous
never mixes two attempts' markers.

Async checkpointing changes NOTHING here by design:
``latest_verified_step`` only ever sees PROMOTED steps, and an async
save's staging directory is invisible until the same atomic/two-phase
promote the synchronous pipeline ran — so the restart probe can never
hand a relaunch a step that is still streaming out of a dead
incarnation's background writer.  (The dispatch loop additionally
drains its writer before every exit, so an in-process relaunch never
races a zombie write in the same directory.)
"""

from __future__ import annotations

import json
import subprocess
import sys
from collections import deque

from dist_keras_tpu_torch.resilience import world as _world
from dist_keras_tpu_torch.resilience.preemption import Preempted
from dist_keras_tpu_torch.resilience.retry import RetryPolicy
from dist_keras_tpu_torch.utils import knobs

# ---------------------------------------------------------------------
# Operator alerting seam.  Emitting a supervisor_giveup EVENT records
# that the run died; it pages nobody.  This is the single seam every
# "a human should know" verdict routes through — supervise()'s giveups,
# Job.supervise_run's CrashLoop, and the observability watchdog's
# anomaly alerts all call alert(), which fans out to (a) every
# registered in-process sink and (b) the DK_ALERT_CMD webhook-command
# (a shell command receiving the alert JSON on stdin — `curl -d @-
# https://hooks...` is the canonical value).  Best-effort by contract:
# a broken sink or a dead webhook degrades to a stderr warning, because
# alerting must never be the thing that kills (or hangs) the run it
# reports on.

_alert_sinks = []
_alert_warned = set()


def add_alert_sink(sink):
    """Register a callable receiving every alert payload dict; -> the
    sink (pass it back to :func:`remove_alert_sink`)."""
    _alert_sinks.append(sink)
    return sink


def remove_alert_sink(sink):
    try:
        _alert_sinks.remove(sink)
    except ValueError:
        pass


def clear_alert_sinks():
    """Drop every registered sink (tests)."""
    del _alert_sinks[:]


def _alert_warn_once(key, msg):
    if key in _alert_warned:
        return
    _alert_warned.add(key)
    print(f"[dk.alerts] WARNING: {msg}", file=sys.stderr, flush=True)


def alert(kind, **fields):
    """Deliver one operator alert through every registered sink plus
    ``DK_ALERT_CMD``; -> the payload dict.  NEVER raises.

    The payload always names this host's ``rank``: the webhook line is
    the one delivery a fleet operator sees live, and an unattributable
    page from an 8-host pod is half an alert (the event log gets rank
    from its writer; this seam must carry it itself)."""
    payload = {"kind": str(kind), "t": _world.time(), **fields}
    if "rank" not in payload:
        try:
            from dist_keras_tpu_torch.observability import events

            # rank() is None with the event log off; the env-derived
            # identity must reach the webhook regardless
            r = events.rank()
            payload["rank"] = events._default_rank() if r is None else r
        # dklint: ignore[broad-except] best-effort rank attribution for the webhook payload
        except Exception:  # pragma: no cover - attribution best-effort
            pass
    for sink in list(_alert_sinks):
        try:
            sink(payload)
        # dklint: ignore[broad-except] alert sinks are best-effort; a broken sink never kills the run
        except Exception as e:
            _alert_warn_once(("sink", sink), f"alert sink {sink!r} "
                                             f"raised {e!r}")
    cmd = knobs.raw("DK_ALERT_CMD")
    if cmd:
        timeout = knobs.get("DK_ALERT_CMD_TIMEOUT_S")
        try:
            subprocess.run(
                cmd, shell=True,
                input=(json.dumps(payload, default=str) + "\n").encode(),
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                timeout=timeout)
        # dklint: ignore[broad-except] DK_ALERT_CMD webhook delivery is best-effort
        except Exception as e:
            _alert_warn_once(("cmd", cmd),
                             f"DK_ALERT_CMD failed: {e!r}")
    return payload


class CrashLoop(RuntimeError):
    """The restart budget died: ``len(evidence)`` failures inside the
    rolling window (or the overall deadline expired).  ``evidence`` is
    ``[(t_monotonic, exc_type_name, detail), ...]`` for every failure
    still inside the window — the give-up carries its own post-mortem.
    """

    def __init__(self, msg, evidence=(), reason="crash_loop"):
        self.evidence = list(evidence)
        self.reason = reason
        super().__init__(msg)


class RestartBudget:
    """N restarts per rolling window — the shared budget arithmetic of
    :func:`supervise` (in-process restarts) and ``Job.supervise_run``
    (dead-host relaunches).  :meth:`record` returns True while the
    budget lives; the first recording that overflows the window returns
    False and :attr:`evidence` holds the window's failures."""

    def __init__(self, max_restarts, window_s, clock=None):
        if int(max_restarts) < 0:
            raise ValueError(
                f"max_restarts={max_restarts} must be >= 0")
        if float(window_s) <= 0:
            raise ValueError(f"budget window {window_s}s must be > 0")
        self.max_restarts = int(max_restarts)
        self.window_s = float(window_s)
        # None -> the world seam (sim clocks govern the rolling window)
        self.clock = _world.monotonic if clock is None else clock
        self._events = deque()

    def record(self, error_name, detail=""):
        """Record one failure; -> True if a restart is still in budget."""
        now = self.clock()
        self._events.append((now, str(error_name), str(detail)[:200]))
        while self._events and now - self._events[0][0] > self.window_s:
            self._events.popleft()
        return len(self._events) <= self.max_restarts

    @property
    def evidence(self):
        return list(self._events)


# Never retried: a restart cannot fix a bad config or a desynced
# collective stream.  (CoordinatorPoisoned is resolved lazily to keep
# this module import-light; it subclasses RuntimeError, so it must be
# tested BEFORE the generic handler.)
def _default_fatal():
    from dist_keras_tpu_torch.resilience.coordination import CoordinatorPoisoned

    return (ValueError, TypeError, CoordinatorPoisoned, CrashLoop)


def supervise(fn, checkpointer=None, *, max_restarts=3,
              budget_window_s=300.0, backoff=0.5, multiplier=2.0,
              max_delay=30.0, deadline_s=None, fatal=None,
              sleep=None, clock=None, on_restart=None):
    """Run ``fn`` under the auto-resume restart loop; -> ``fn``'s
    return value from the attempt that completed.

    ``fn(attempt, resume_step)`` is the training callable: ``attempt``
    is 0 for the first run and counts restarts; ``resume_step`` is the
    latest VERIFIED checkpoint step (None without a ``checkpointer`` or
    before any save) — pass it into the trainer's ``resume=`` so the
    relaunch continues from the agreed chunk instead of epoch 0
    (``Trainer(resume=resume_step if resume_step is not None else
    False)`` accepts the explicit step).

    Restarted: :class:`Preempted` (the flag is cleared first — a
    restart in the same process must not instantly re-preempt) and any
    ``Exception`` outside ``fatal``.  ``fatal`` defaults to
    ``(ValueError, TypeError, CoordinatorPoisoned, CrashLoop)``.
    Budget: ``max_restarts`` per rolling ``budget_window_s`` —
    exceeded, a typed :class:`CrashLoop` (with the window's evidence)
    chains from the last error.  ``deadline_s`` additionally bounds the
    WHOLE supervised run (sleeps clipped, no restart starts past it);
    the supervisor's policy deadline is shared with nested surfaces via
    ``RetryPolicy.remaining_deadline``.
    """
    from dist_keras_tpu_torch.observability import events, metrics
    from dist_keras_tpu_torch.resilience import preemption

    fatal = _default_fatal() if fatal is None else tuple(fatal)
    # None -> the world seam; a SimWorld installed around this call
    # drives the budget window, backoff sleeps and the deadline alike
    sleep = _world.sleep if sleep is None else sleep
    clock = _world.monotonic if clock is None else clock
    budget = RestartBudget(max_restarts, budget_window_s, clock=clock)
    policy = RetryPolicy(attempts=max_restarts + 1, backoff=backoff,
                         multiplier=multiplier, max_delay=max_delay,
                         timeout=deadline_s, jitter=0.0,
                         sleep=sleep, clock=clock, name="supervisor")
    policy.start_deadline()
    attempt = 0
    while True:
        try:
            # the probe lives INSIDE the try: a transient OSError from
            # a flaky checkpoint dir (all_steps' listdir) is exactly
            # the class this loop absorbs — raised here it is budgeted
            # and retried like the same error out of fn itself
            resume_step = (checkpointer.latest_verified_step()
                           if checkpointer is not None else None)
            return fn(attempt, resume_step)
        except fatal as e:
            events.emit("supervisor_giveup", reason="fatal",
                        attempt=attempt, error=type(e).__name__,
                        detail=str(e)[:200])
            alert("supervisor_giveup", reason="fatal", attempt=attempt,
                  error=type(e).__name__, detail=str(e)[:200])
            raise
        # dklint: ignore[broad-except] the supervisor's whole job:
        # classify ANY non-fatal failure into the restart budget
        # (fatal types re-raised by the handler above)
        except (Exception, Preempted) as e:
            if isinstance(e, Preempted):
                # the per-process flag survives the exception; left
                # set, the relaunched trainer would vote preempt at
                # its FIRST boundary and exit again — a fake crash loop
                preemption.clear()
            in_budget = budget.record(type(e).__name__, str(e))
            remaining = policy.remaining_deadline()
            if not in_budget or (remaining is not None
                                 and remaining <= 0):
                reason = "crash_loop" if not in_budget else "deadline"
                events.emit("supervisor_giveup", reason=reason,
                            attempt=attempt, error=type(e).__name__,
                            restarts_in_window=len(budget.evidence),
                            window_s=budget.window_s)
                metrics.counter("supervisor.giveups").inc()
                alert("supervisor_giveup", reason=reason,
                      attempt=attempt, error=type(e).__name__,
                      restarts_in_window=len(budget.evidence),
                      window_s=budget.window_s)
                lines = "; ".join(
                    f"+{t - budget.evidence[0][0]:.1f}s {name}: {detail}"
                    for t, name, detail in budget.evidence)
                raise CrashLoop(
                    f"supervisor giving up ({reason}): "
                    f"{len(budget.evidence)} failure(s) in the last "
                    f"{budget.window_s:.0f}s (budget: {max_restarts} "
                    f"restarts"
                    + (f", deadline {deadline_s:.0f}s"
                       if deadline_s is not None else "")
                    + f") — {lines}",
                    evidence=budget.evidence, reason=reason) from e
            attempt += 1
            d = policy.delay(attempt)
            if remaining is not None:
                d = min(d, remaining)
            events.emit("supervisor_restart", attempt=attempt,
                        error=type(e).__name__, detail=str(e)[:200],
                        delay_s=d,
                        preempted=isinstance(e, Preempted))
            metrics.counter("supervisor.restarts").inc()
            if on_restart is not None:
                on_restart(attempt, e, d)
            if d > 0:
                sleep(d)
