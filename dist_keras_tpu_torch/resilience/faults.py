"""Deterministic fault injection — named fault points on real failure paths.

A copy of the JAX package's ``resilience/faults.py`` (it is framework
free) on the port's ``world``, ``knobs`` and ``events``.  The registry
(:data:`KNOWN_POINTS`) is the reference's, point for point and in its
order, so one seed draws one chaos schedule in both packages.  The
port raises at only the points whose subsystems it has ported (the
checkpoint, coordination, remote-store, ``serve.*`` and ``decode.*``
seams so far); the rest stay registered and never fire.
``exc=PeerLost`` / ``exc=BarrierTimeout`` resolve through the port's
``resilience/coordination.py``, as in the reference.

The reference tolerated worker loss for free because Spark re-ran failed
partitions; this TPU-native port has to *prove* its failure story instead
of hoping, and proof needs faults that reproduce exactly.  Every
recoverable I/O seam in the framework passes through a named
:func:`fault_point`:

- ``"checkpoint.save"``  — between a checkpoint's tmp-dir write and its
  atomic rename (``checkpoint.Checkpointer``): raising here IS the
  mid-write kill.
- ``"job.rsync"`` / ``"job.ssh"`` — around each per-host command in
  ``launch.Job`` (the value is the return code, so a replace-fault
  simulates a flaky transport without a cluster).
- ``"punchcard.read_manifest"`` — before each manifest read (a torn
  concurrent write is a truncated-JSON ValueError).
- ``"stream.fetch"`` — before each ``StreamSource.get`` in
  ``StreamingPredictor``.
- ``"step.loss"`` — over each fetched host loss array in the trainers'
  ``ChunkRunner`` (a corrupt-fault plants a NaN to exercise the
  ``nan_policy`` sentinel without poisoning device math).
- ``"coord.flag"`` / ``"coord.agree"`` / ``"coord.barrier"`` — the
  cluster-consensus primitives (``resilience.coordination``): the
  boundary preemption vote, the save-step agreement and the pre-exit
  barrier each fail at an exact call count.
- ``"coord.commit"`` — between the last ``host-{i}.ok`` marker landing
  and the leader's promotion rename in a multi-host checkpoint
  (``checkpoint.Checkpointer``): raising here IS the torn two-phase
  commit.
- ``"job.heartbeat"`` — each liveness-file beat
  (``coordination.Heartbeat``): a raise silences the thread, so a host
  "dies" at a deterministic beat count and its peers' next deadline
  raises a typed ``PeerLost`` naming it.
- ``"serve.enqueue"`` / ``"serve.predict"`` / ``"serve.reload"`` — the
  serving subsystem's seams (``serving/``): admission of one request,
  one replica batch dispatch (the error lands TYPED on every future in
  the batch — never a hang), and one hot-reload attempt (the engine
  keeps serving the old params).
- ``"ckpt.gc"`` — between the chunk GC's durable deletion journal and
  its first unlink (``checkpoint.Checkpointer.gc_chunks``): raising
  here IS the mid-GC kill, and every retained step must stay
  restorable through it.
- ``"ckpt.push"`` / ``"ckpt.pull"`` — per object transfer of the
  remote checkpoint tier (``resilience/store.py``), inside the named
  retry surfaces, so chaos exercises both the absorbed-transient and
  the typed-kill path of the mirror protocol.

Faults are scheduled on the point's CALL COUNT (0-based), so a test kills
exactly the Nth save or fails exactly the first two rsyncs — no timing, no
flakes.  Arm programmatically with :func:`inject` (or the ``armed``
context manager), or via the ``DK_FAULTS`` environment variable so
subprocess tests inherit the schedule:

    DK_FAULTS="checkpoint.save@1;job.rsync@0x2:action=replace,value=30"

Grammar per semicolon-separated entry: ``point[@at][xN][:k=v,...]`` with
keys ``action`` (raise|corrupt|replace|delay), ``exc`` (FaultInjected,
OSError, IOError, ValueError, RuntimeError, ConnectionError,
TimeoutError) and ``value`` (float: the replacement for ``replace``,
the sleep seconds for ``delay`` — a slow-not-dead seam, what the
``gates.py --watchdog-only`` slow-step injection arms).

CHAOS MODE (this PR): ``DK_FAULTS_SEED=<int>`` arms every registered
fault point (:data:`KNOWN_POINTS`) with a SEEDED random schedule —
each point independently fires (probability ``DK_FAULTS_RATE``, default
0.25) at a random call index within ``DK_FAULTS_HORIZON`` (default 20)
with a seeded choice between a permanent :class:`FaultInjected` and a
retryable ``OSError``.  The schedule is a pure function of the seed
(one PRNG, every draw taken whether or not the point arms), so a chaos
run that breaks replays EXACTLY from its seed — randomized coverage
with deterministic reproduction.  ``DK_FAULTS_POINTS=a,b`` restricts
the armed set; explicit ``DK_FAULTS`` entries compose on top.
``gates.py --chaos-only`` drives K seeded 2-process runs and asserts
the single self-healing invariant: completed or typed error, with the
latest promoted checkpoint verifying and restoring bit-equal.
"""

from __future__ import annotations

import os
import re
import threading

from dist_keras_tpu_torch.resilience import world as _world
from dist_keras_tpu_torch.utils import knobs


class FaultInjected(Exception):
    """Raised by an armed fault point.

    Deliberately NOT an ``OSError`` subclass: default retry policies
    treat it as permanent, so a fault that simulates a process kill is
    not silently retried away.  Arm with ``exc=OSError`` to exercise a
    retry path instead.
    """


_MISSING = object()
_EXC_NAMES = {
    "FaultInjected": FaultInjected,
    "OSError": OSError,
    "IOError": IOError,
    "ValueError": ValueError,
    "RuntimeError": RuntimeError,
    "ConnectionError": ConnectionError,
    "TimeoutError": TimeoutError,
}

_lock = threading.RLock()
_specs = {}       # point name -> [FaultSpec]
_counts = {}      # point name -> calls so far
_env_loaded = False

# Every named fault point in the framework — the registry chaos mode
# arms.  Adding a fault_point call site?  List it here or the chaos
# gate can never exercise it — and since round 12 the static analyzer
# enforces BOTH directions (the JAX package's ``analysis``:
# fault-point-unknown / fault-point-unused; dynamic-name sites carry a
# `# dklint: fault-points=...` annotation).  (Grouped by seam; names
# are the ones passed to fault_point at each call site.)
KNOWN_POINTS = (
    "checkpoint.save", "checkpoint.commit", "coord.commit",
    "ckpt.snapshot", "ckpt.write",
    "ckpt.gc", "ckpt.push", "ckpt.pull",
    "coord.flag", "coord.agree", "coord.barrier",
    "job.rsync", "job.ssh", "job.heartbeat",
    "punchcard.read_manifest", "stream.fetch", "step.loss",
    "serve.enqueue", "serve.predict", "serve.reload",
    "reshard.load", "reshard.scatter",
    "ps.pull", "ps.commit", "ps.join", "ps.encode",
    "comm.merge",
    # serving router (serving/router.py) — appended last: seeded chaos
    # schedules index into this tuple, order is part of the replay
    # contract
    "route.forward", "route.health",
    # continuous-batching decode engine (serving/decode.py,
    # serving/kv_cache.py) — appended after the router points for the
    # same replay-contract reason
    "decode.admit", "decode.step", "decode.kv_alloc",
    # decode survivability (serving/decode.py) — appended last, same
    # replay-contract reason: fires at the head of the quarantine
    # re-admission path (a failed recovery resolves every orphan
    # typed, never a hang)
    "decode.recover",
)


class FaultSpec:
    """One armed fault: fire on calls ``at .. at+times-1`` of a point —
    or, with ``at_s`` set, on the first ``times`` calls at or past that
    TIME on the world clock (``chaos_schedule(horizon_s=...)``; under
    the cluster simulator that is simulated seconds)."""

    def __init__(self, point, at=0, times=1, action="raise", exc=None,
                 value=None, at_s=None):
        if action not in ("raise", "corrupt", "replace", "delay"):
            raise ValueError(f"unknown fault action {action!r}")
        self.point = str(point)
        self.at = int(at)
        self.times = int(times)
        self.action = action
        self.exc = exc or FaultInjected
        self.value = value
        self.at_s = None if at_s is None else float(at_s)
        # at_s is RELATIVE seconds; anchor it to the world clock at
        # arming so "fire past 3.2s" means 3.2s from now (sim seconds
        # under the cluster simulator, wall seconds in real runs)
        self._armed_mono = (None if at_s is None
                            else _world.monotonic())
        self.fired = 0  # introspection: how many times this spec fired

    def covers(self, count):
        if self.at_s is not None:
            return (self.fired < self.times
                    and _world.monotonic() - self._armed_mono
                    >= self.at_s)
        return self.at <= count < self.at + self.times

    def __repr__(self):  # pragma: no cover - debug aid
        return (f"FaultSpec({self.point!r}, at={self.at}, "
                f"times={self.times}, action={self.action!r})")


def inject(point, at=0, times=1, action="raise", exc=None, value=None):
    """Arm ``point`` to fire on its ``at``-th .. ``at+times-1``-th call
    COUNTED FROM NOW (relative to arming, so a test arms "the next save"
    regardless of how many saves ran earlier in the process; env-armed
    specs load before the first call, where relative == absolute).

    ``action``: ``"raise"`` raises ``exc`` (default :class:`FaultInjected`);
    ``"corrupt"`` returns a NaN-poisoned copy of the value passed to
    :func:`fault_point`; ``"replace"`` returns ``value`` instead of it;
    ``"delay"`` sleeps ``value`` seconds then passes the value through
    untouched (a slow seam — the watchdog-gate injection).
    Returns the :class:`FaultSpec` (pass to :func:`disarm`, or
    :func:`clear` everything).
    """
    spec = FaultSpec(point, at=at, times=times, action=action, exc=exc,
                     value=value)
    with _lock:
        spec.at += _counts.get(spec.point, 0)
        _specs.setdefault(spec.point, []).append(spec)
    return spec


def disarm(spec):
    with _lock:
        lst = _specs.get(spec.point, [])
        if spec in lst:
            lst.remove(spec)


def clear():
    """Disarm every fault and reset every call counter (also forgets any
    ``DK_FAULTS`` env schedule until the next explicit :func:`load_env`)."""
    global _env_loaded
    with _lock:
        _specs.clear()
        _counts.clear()
        _env_loaded = True  # an explicit clear overrides the env schedule


def call_count(point):
    """How many times ``point`` has been passed so far (armed or not)."""
    with _lock:
        return _counts.get(point, 0)


class armed:
    """Context manager: arm a fault for the block, disarm after.

    >>> with faults.armed("checkpoint.save", at=0):
    ...     ckptr.save(1, state)   # raises FaultInjected mid-write
    """

    def __init__(self, point, **kw):
        self._args = (point, kw)
        self.spec = None

    def __enter__(self):
        point, kw = self._args
        self.spec = inject(point, **kw)
        return self.spec

    def __exit__(self, *exc):
        disarm(self.spec)
        return False


_ENV_ENTRY_RE = re.compile(
    r"^(?P<point>.+?)(?:@(?P<at>\d+)(?:x(?P<times>\d+))?)?$")


def _parse_env_entry(entry):
    entry = entry.strip()
    if not entry:
        return None
    opts = {}
    if ":" in entry:
        entry, _, raw = entry.partition(":")
        for kv in raw.split(","):
            k, _, v = kv.partition("=")
            opts[k.strip()] = v.strip()
    m = _ENV_ENTRY_RE.match(entry)
    # fail LOUDLY at parse time, naming the entry — a malformed schedule
    # surfacing lazily from the first fault_point call deep inside
    # training would be much harder to trace back to the env var
    # '@' in the resolved point name means the @at[xN] suffix did not
    # parse (e.g. "checkpoint.save@x2") — arming it as a literal name
    # would make the schedule silently never fire; no real point name
    # contains '@'
    if m is None or not entry or "@" in m.group("point"):
        raise ValueError(
            f"malformed DK_FAULTS entry {entry!r}: expected "
            "point[@at[xN]][:k=v,...]")
    exc_name = opts.get("exc", "FaultInjected")
    if exc_name in ("PeerLost", "BarrierTimeout"):
        # lazy: coordination imports this module at its top level, so
        # the reverse import must stay inside the parse path
        from dist_keras_tpu_torch.resilience import coordination

        exc = getattr(coordination, exc_name)
    else:
        exc = _EXC_NAMES.get(exc_name, FaultInjected)
    value = opts.get("value")
    if value is not None:
        value = float(value)
    return FaultSpec(m.group("point"), at=int(m.group("at") or 0),
                     times=int(m.group("times") or 1),
                     action=opts.get("action", "raise"), exc=exc,
                     value=value)


def chaos_schedule(seed, rate=0.25, horizon=20, points=None,
                   horizon_s=None):
    """Build (without arming) the seeded chaos schedule: a list of
    :class:`FaultSpec`, one per point that drew a firing.

    A PURE function of ``(seed, rate, horizon, points, horizon_s)``:
    the PRNG draws the SAME sequence for every point whether or not it
    arms (fire/at/exc consumed unconditionally), so tightening ``rate``
    never reshuffles which call index a still-armed point fires at —
    a chaos failure reproduces from its seed alone.  Each armed point
    fires once, at a uniform call index in ``[0, horizon)``, raising
    either a permanent :class:`FaultInjected` (simulated kill) or a
    retryable ``OSError`` (transient to absorb) — seeded coin flip.

    ``horizon_s`` switches the schedule from call counts to TIME: each
    armed point instead fires on its first call at or past a uniform
    instant in ``[0, horizon_s)`` seconds on the world clock (sim
    seconds under the cluster simulator).  The extra per-point draw
    happens only in this mode, so every pre-existing
    ``(seed, rate, horizon)`` schedule is preserved verbatim.
    """
    import random as _random

    rate = float(rate)
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"chaos rate={rate} must be in [0, 1]")
    horizon = int(horizon)
    if horizon < 1:
        raise ValueError(f"chaos horizon={horizon} must be >= 1")
    if horizon_s is not None and float(horizon_s) <= 0:
        raise ValueError(f"chaos horizon_s={horizon_s} must be > 0")
    rng = _random.Random(int(seed))
    specs = []
    for point in (KNOWN_POINTS if points is None else tuple(points)):
        fire = rng.random() < rate
        at = rng.randrange(horizon)
        transient = rng.random() < 0.5
        at_s = (None if horizon_s is None
                else rng.random() * float(horizon_s))
        if fire:
            specs.append(FaultSpec(
                point, at=at, at_s=at_s,
                exc=OSError if transient else FaultInjected))
    return specs


def _load_chaos_env():
    """Arm the ``DK_FAULTS_SEED`` chaos schedule (under _lock, from
    load_env).  Malformed knobs fail LOUDLY at load time, like
    DK_FAULTS entries."""
    seed = (knobs.raw("DK_FAULTS_SEED") or "").strip()
    if not seed:
        return
    try:
        seed = int(seed)
    except ValueError:
        raise ValueError(
            f"malformed DK_FAULTS_SEED {seed!r}: expected an integer")
    rate = (knobs.raw("DK_FAULTS_RATE") or "0.25").strip() or "0.25"
    try:
        rate = float(rate)
    except ValueError:
        raise ValueError(
            f"malformed DK_FAULTS_RATE {rate!r}: expected a float")
    horizon = (knobs.raw("DK_FAULTS_HORIZON") or "20").strip() or "20"
    try:
        horizon = int(horizon)
    except ValueError:
        raise ValueError(
            f"malformed DK_FAULTS_HORIZON {horizon!r}: expected an int")
    horizon_s = (knobs.raw("DK_FAULTS_HORIZON_S") or "").strip()
    if horizon_s:
        try:
            horizon_s = float(horizon_s)
        except ValueError:
            raise ValueError(
                f"malformed DK_FAULTS_HORIZON_S {horizon_s!r}: "
                "expected a float")
    else:
        horizon_s = None
    points = None
    raw_points = (knobs.raw("DK_FAULTS_POINTS") or "").strip()
    if raw_points:
        points = tuple(p.strip() for p in raw_points.split(",")
                       if p.strip())
        unknown = sorted(set(points) - set(KNOWN_POINTS))
        if unknown:
            raise ValueError(
                f"DK_FAULTS_POINTS names unknown fault point(s) "
                f"{unknown}; known: {sorted(KNOWN_POINTS)}")
    for spec in chaos_schedule(seed, rate=rate, horizon=horizon,
                               points=points, horizon_s=horizon_s):
        _specs.setdefault(spec.point, []).append(spec)


def load_env(var="DK_FAULTS", force=False):
    """Arm the schedule in ``$DK_FAULTS`` plus the seeded chaos
    schedule in ``$DK_FAULTS_SEED`` (idempotent per process; called
    lazily by the first :func:`fault_point`; ``force=True`` re-reads
    the env after a :func:`clear`)."""
    global _env_loaded
    with _lock:
        if _env_loaded and not force:
            return
        _env_loaded = True
        # the default var resolves through the knob registry; a
        # caller-supplied custom variable name stays a plain env read
        # (knobs.raw would refuse an unregistered name)
        raw = (knobs.raw(var) if var in knobs.KNOBS
               else os.environ.get(var)) or ""
        for entry in raw.split(";"):
            spec = _parse_env_entry(entry)
            if spec is not None:
                _specs.setdefault(spec.point, []).append(spec)
        _load_chaos_env()


def _corrupt(value):
    """Deterministically poison ``value`` with NaN (first element of an
    array; the whole thing for a scalar)."""
    import numpy as np

    arr = np.array(value, copy=True)
    if arr.ndim == 0:
        return type(value)(float("nan")) if isinstance(value, float) \
            else np.asarray(float("nan"), dtype=arr.dtype)
    flat = arr.reshape(-1)
    flat[0] = float("nan")
    return arr


def fault_point(name, value=_MISSING):
    """Declare a named fault point; returns ``value`` (or None) unless an
    armed spec covers this invocation.

    Zero-overhead-by-default contract: unarmed, this is one dict lookup
    and an int increment — safe on warm paths like the per-chunk loss
    retire (NOT the per-step device loop, which is compiled and cannot
    host a Python hook).
    """
    with _lock:
        load_env()
        count = _counts.get(name, 0)
        _counts[name] = count + 1
        spec = None
        for s in _specs.get(name, ()):
            if s.covers(count):
                spec = s
                break
    if spec is None:
        return None if value is _MISSING else value
    spec.fired += 1
    # a FIRING fault is rare and interesting — record it (the unarmed
    # fast path above stays one dict lookup; lazy import keeps this
    # module import-light for subprocess workers)
    from dist_keras_tpu_torch.observability import events
    events.emit("fault", point=name, call=count, action=spec.action,
                exc=spec.exc.__name__)
    if spec.action == "raise":
        raise spec.exc(
            f"fault injected at point {name!r} (call #{count})")
    if spec.action == "delay":
        # a SLOW seam, not a dead one: stall this call for value
        # seconds, then pass the value through untouched — the
        # deterministic "this rank got slow" injection the perf
        # watchdog gate drives (a raise would end the run instead of
        # degrading it).  Routed through the world seam: under the
        # cluster simulator the delay advances SIMULATED time instead
        # of stalling the sim thread; in real runs world.sleep IS
        # time.sleep, bit-identical behavior
        _world.sleep(float(spec.value or 0.0))
        return None if value is _MISSING else value
    if spec.action == "replace":
        return spec.value
    # corrupt
    if value is _MISSING:
        raise ValueError(
            f"fault point {name!r} armed with action='corrupt' but the "
            "call site passes no value to corrupt")
    return _corrupt(value)
