"""The injectable *World* seam — a copy of the JAX package's
``resilience/world.py`` (it is framework free), which the port's
``faults.py`` reads its clocks through.

Every place the runtime touches its environment — wall clock, monotonic
clock, sleeping — used to call ``time.time`` / ``time.monotonic`` /
``time.sleep`` directly.  That hard-wires real time into components
whose *semantics* (heartbeat staleness, retry backoff, chaos horizons,
supervisor budgets) are pure functions of time, and makes a
thousand-host chaos scenario cost a thousand hosts.

This module is the seam: a tiny :class:`World` interface plus a
process-global *current world* slot.  Components never import ``time``
for behavior-bearing reads; they call :func:`time`, :func:`monotonic`
and :func:`sleep` from here (or accept ``clock=``/``sleep=`` kwargs that
default to these).  The default :class:`RealWorld` delegates straight to
the stdlib, so production behavior is bit-identical.  A simulation
(the JAX package's ``sim.SimWorld``; the simulator is not ported)
installs itself and the same
components run at the speed of arithmetic, deterministically.

Design notes
------------
* The slot is a plain module global, **not** a thread-local.  The
  simulator is single-threaded by construction (determinism demands
  it), and real-mode background threads hitting :class:`RealWorld`
  through the global is exactly the behavior they had before the seam
  existed.
* Resolution is *per call*: components that captured the module
  functions at import (or constructed a ``RetryPolicy`` before the sim
  was installed) still route through whatever world is current when the
  call happens.  Installing a world mid-flight therefore never strands
  already-built objects in the old world.
* :func:`use` is the polite API — a context manager restoring the
  previous world even when the scenario inside explodes.
"""

import contextlib
import time as _time

__all__ = [
    "World", "RealWorld", "current", "install", "use",
    "time", "monotonic", "sleep",
]


class World:
    """Environment interface: two clocks and a way to wait.

    Subclasses override all three.  ``monotonic`` carries the
    behavior-bearing load (deadlines, staleness windows, backoff);
    ``time`` exists for human-facing stamps (heartbeat files, epoch
    logs) and must move in lockstep with ``monotonic`` under
    simulation or staleness judgments diverge from the stamps they
    judge.
    """

    def time(self):
        raise NotImplementedError

    def monotonic(self):
        raise NotImplementedError

    def sleep(self, seconds):
        raise NotImplementedError


class RealWorld(World):
    """The stdlib, verbatim.  Installed by default at import."""

    def time(self):
        return _time.time()

    def monotonic(self):
        return _time.monotonic()

    def sleep(self, seconds):
        _time.sleep(seconds)


_current = RealWorld()


def current():
    """The currently installed :class:`World`."""
    return _current


def install(world):
    """Install ``world`` as current; returns the previous one.

    Prefer :func:`use` — it restores on exit.  ``install`` exists for
    harnesses (the sim CLI) that own the whole process lifetime.
    """
    global _current
    prev = _current
    _current = world
    return prev


@contextlib.contextmanager
def use(world):
    """Run a block under ``world``, restoring the previous on exit."""
    prev = install(world)
    try:
        yield world
    finally:
        install(prev)


# -- module-level delegates -------------------------------------------
# These are what components import.  They resolve the current world at
# CALL time, so a world installed after a component was constructed
# still governs that component's clocks.

def time():
    """Wall-clock seconds through the current world."""
    return _current.time()


def monotonic():
    """Monotonic seconds through the current world."""
    return _current.monotonic()


def sleep(seconds):
    """Wait through the current world (advances sim time instantly
    under simulation)."""
    _current.sleep(seconds)
