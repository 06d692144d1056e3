"""Preemption-safe shutdown: catch SIGTERM/SIGINT, checkpoint, exit 128+N.

A copy of the JAX package's ``resilience/preemption.py`` (it is
framework free).  In the port its one user so far is the serving
server's signal drain (``ServingServer.install_signal_drain``); the
trainers' ``handle_preemption`` waits for checkpoints (ROADMAP queue 1,
items 15 and 19), and :func:`on_request` dumps no flight record before
its callback, because the flight recorder is not ported (item 18).

TPU pods are preemptible: the scheduler sends SIGTERM and gives the
process a grace window.  A trainer with ``handle_preemption=True``
installs these handlers around its dispatch loop; the handler only sets a
flag (async-signal-safe), the loop notices it at the next chunk boundary,
saves a checkpoint of the full training state at that exact step, and
raises :class:`Preempted` — a ``SystemExit`` subclass carrying the
conventional ``128 + signum`` code, so an UNCAUGHT preemption exits the
process with 143 (SIGTERM) / 130 (SIGINT) and an external scheduler can
distinguish "preempted, restart with ``resume=True``" from success (0)
or a real crash (1).  The companion bench driver exits ``128+signum`` the
same way (``bench.py``), so the convention is uniform across the repo.

Displaced handlers ESCALATE rather than chain: the first delivery only
sets the flag (a previous handler that exits — bench.py's does — would
otherwise kill the process before the boundary checkpoint); a second
delivery hands the signal to the displaced disposition — a previous
handler runs, SIG_DFL is reinstalled and the signal re-delivered — so
"kill -TERM twice" still hard-exits even when the trainer is wedged in
a blocking device fetch.  Flush-style
handlers also fire on the graceful path because an uncaught
:class:`Preempted` is a ``SystemExit`` — atexit hooks run on the way
out.

Multi-host scope: the flag set here is PER-PROCESS; the dispatch loop
(``trainers/chunking.py``) turns it into a CLUSTER decision by voting
``coordination.any_flag`` at every chunk boundary, agreeing on one save
step (``agree_min``), committing it two-phase (``checkpoint.py``), and
barriering before any host raises :class:`Preempted` — so the scheduler
restarts the whole pod against one fully-committed checkpoint.

Async checkpointing (``DK_CKPT_ASYNC``, default on) does not stretch
the SIGTERM→exit window's durability contract: the boundary save the
loop makes on a delivered signal WAITS on its
``checkpoint.AsyncSaveHandle`` (and any in-flight cadence save it
coalesced behind) with a deadline bounded by ``DK_COORD_TIMEOUT_S``
before :class:`Preempted` is raised — ``saved_step`` keeps naming a
step that is promoted (and, single-host, verified) on disk, never one
still streaming out of the background writer.
"""

from __future__ import annotations

import signal
import threading


class Preempted(SystemExit):
    """Training was interrupted by a signal after a boundary checkpoint.

    Subclasses ``SystemExit`` with ``code = 128 + signum``: uncaught, the
    process exits with the scheduler-conventional code; tests catch it
    like any exception.
    """

    def __init__(self, signum, saved_step=None):
        self.signum = int(signum)
        self.saved_step = saved_step  # units_done of the boundary save
        super().__init__(128 + int(signum))

    @property
    def exit_code(self):
        return self.code


_lock = threading.Lock()  # guards install/restore bookkeeping ONLY —
# the handler itself must stay lock-free: CPython dispatches handlers
# re-entrantly in the main thread at bytecode boundaries, so a handler
# blocking on a lock the interrupted code (or a nested handler) holds
# would deadlock the process.  Plain reads/assignments are atomic under
# the GIL, which is all the handler needs.
_requested = None       # first delivered signum, or None
_prev = {}              # signum -> previous handler (install/restore)


def _handler(signum, frame):
    # NO event emission here: the handler runs re-entrantly on the main
    # thread, and the observability writer takes plain (non-reentrant)
    # locks — interrupting an in-progress emit and then emitting from
    # the handler would deadlock the process.  The dispatch loop emits
    # the "preempt" event when it notices the flag at its next boundary
    # (chunking.py), which also stamps WHERE the run was.
    global _requested
    first = _requested is None
    if first:
        _requested = signum
        # Escalation, not chaining: the FIRST delivery only sets the
        # flag — a displaced handler that exits (bench.py's _on_signal
        # calls os._exit(128+signum)) would otherwise kill the process
        # before the loop reaches its boundary checkpoint, silently
        # disabling the graceful window.  Flush-style handlers still
        # fire on the graceful path: the uncaught Preempted is a
        # SystemExit, so atexit hooks run on the way out.
        return
    # SECOND delivery: the grace period is over — escalate through the
    # displaced disposition (a stuck run must stay killable by SIGTERM).
    prev = _prev.get(signum)
    if prev is signal.SIG_IGN:
        return
    if callable(prev) and prev is not signal.SIG_DFL:
        prev(signum, frame)
        return
    # SIG_DFL (or unknown): reinstall the default and re-deliver so the
    # OS-default action (terminate) actually happens
    signal.signal(signum, signal.SIG_DFL)
    import os

    os.kill(os.getpid(), signum)


def install(signals=(signal.SIGTERM, signal.SIGINT), strict=True):
    """Install the graceful handlers.  Returns True when installed.

    Signal handlers are MAIN-THREAD-ONLY (a CPython runtime rule —
    ``signal.signal`` raises off it).  That used to surface as an
    obscure ``ValueError: signal only works in main thread of the main
    interpreter`` — or worse, as a silent False that also swallowed the
    unrelated ValueError of an invalid signal number.  Now the thread is
    detected EXPLICITLY: off the main thread, ``strict=True`` (the
    default) raises a clear, actionable error, while ``strict=False``
    (what the dispatch loop passes) returns False and the caller runs
    without a graceful window.  Any other ``signal.signal`` error (bad
    signal number, unsupported platform signal) propagates untouched.

    A request already pending is PRESERVED, not reset: a SIGTERM that
    landed between two trainer runs (after A's last boundary check,
    before B installed) still preempts B at its first boundary — the
    scheduler's grace clock is ticking regardless.  Code that
    deliberately continues after catching :class:`Preempted` must call
    :func:`clear` first."""
    if threading.current_thread() is not threading.main_thread():
        if strict:
            # dklint: ignore[untyped-raise] actionable usage error at
            # install time, before any training state exists
            raise RuntimeError(
                "preemption.install() must run on the MAIN thread: "
                "Python only allows signal handlers there "
                "(signal.signal raises from any other thread).  Run "
                "the trainer on the main thread, or pass strict=False "
                "to proceed without a graceful preemption window.")
        return False
    for s in signals:
        prev = signal.signal(s, _handler)
        if prev is not _handler:  # re-install keeps the ORIGINAL prev
            _prev[s] = prev
    return True


def restore():
    """Re-install the handlers that :func:`install` displaced."""
    with _lock:
        saved = dict(_prev)
        _prev.clear()
    for s, h in saved.items():
        try:
            # dklint: thread-root=preempt.restore
            signal.signal(s, h)
        except (ValueError, TypeError):  # pragma: no cover
            pass


def requested():
    """The first signal delivered since :func:`install`, or None."""
    return _requested


def request(signum=signal.SIGTERM):
    """Simulate a delivery (tests / cooperative schedulers)."""
    global _requested
    if _requested is None:
        _requested = int(signum)
        # unlike the real handler this runs in ordinary thread context,
        # so recording the signal directly is safe
        from dist_keras_tpu_torch.observability import events

        events.emit("preempt_signal", signum=int(signum))


def clear():
    global _requested
    _requested = None


def on_request(callback, poll_s=0.05):
    """Invoke ``callback(signum)`` ONCE when a preemption signal lands.

    The signal handler itself must stay lock-free and emit-free (see
    :func:`_handler`), so consumers that need to *react* — the serving
    server's graceful drain, a monitor flushing buffers — watch the
    flag from this daemon thread instead of hooking the handler.  The
    callback runs on the watcher thread in ordinary thread context
    (locks, I/O, event emission all fine).  A request already pending
    fires immediately.  Returns a ``stop()`` callable that cancels the
    watch (idempotent; a fired watcher stops itself)."""
    stop = threading.Event()

    def _watch():
        while not stop.is_set():
            sig = _requested
            if sig is not None:
                try:
                    callback(sig)
                finally:
                    stop.set()
                return
            stop.wait(poll_s)

    t = threading.Thread(target=_watch, daemon=True,
                         name="dk-preempt-watch")
    t.start()
    return stop.set
