"""Cluster-wide failure consensus — the pod-level half of resilience; a
copy of the JAX package's ``resilience/coordination.py`` (it is framework
free apart from its ``JaxCoordinator``) on the port's ``world``,
``faults``, ``knobs`` and ``events``.

A scheduler SIGTERM reaches hosts at *different* chunk boundaries, so
without coordination each host saves a different step and exits alone —
a torn checkpoint and a half-dead job.  This module is the small
consensus layer the chunk-boundary loop and the checkpointer share:

- :func:`any_flag` — "has ANY host seen the preemption signal?"  (bool
  OR across hosts; the boundary loop piggybacks it on every chunk cut).
- :func:`agree_min` / :func:`agree_max` — agree on a common value (the
  coordinated save step is ``agree_min(units_done)``).
- :func:`all_ok` — "did EVERY host succeed?"  (bool AND; the commit
  vote).
- :func:`barrier` — block until every host arrives, **with a deadline**:
  a dead peer surfaces as a typed :class:`PeerLost` (naming the rank)
  or :class:`BarrierTimeout`, never an infinite hang.

Two backends, selected by :func:`get_coordinator`:

- ``LocalCoordinator`` — single process: every primitive is trivial and
  free (the fast path costs one dict lookup for its fault point).
- ``FileCoordinator`` — deterministic filesystem rendezvous, selected by
  ``DK_COORD_DIR`` (+ ``DK_COORD_RANK`` / ``DK_COORD_WORLD``).  Plain
  processes sharing a directory get real consensus, real barriers and
  real dead-peer detection, with no collective library at all; it also
  works across hosts with a shared filesystem.  One coordination
  directory serves ONE job incarnation (the op log is append-ordered);
  a restart loop rotates it by exporting ``DK_COORD_SESSION=<attempt>``
  (used as a subdirectory).

The reference's third backend, ``JaxCoordinator`` (consensus through
the collectives of a multi-process ``jax.distributed`` group), is
:class:`GroupCoordinator` here: an all-gather of a float64 scalar over
the ``torch.distributed`` group's CPU side group (``comm/backend.py``),
each call under :func:`with_deadline`.  :func:`get_coordinator` picks
it for a group of more than one process when ``DK_COORD_DIR`` is
unset, and :func:`rank` / :func:`world` then read the group.

Liveness: a ``FileCoordinator`` heartbeats ``<dir>/hb/rank_{i}`` from a
background thread, so when a collective times out the survivors can
report *which* host died.  Every failure mode here is deterministically
injectable: ``"coord.flag"`` (flag/ok consensus), ``"coord.agree"``
(value consensus), ``"coord.barrier"``, ``"coord.commit"`` (checkpoint
promotion — armed in ``checkpoint.py``) and ``"job.heartbeat"`` (a
raise silences the beat thread: the host goes dark mid-run).
"""

from __future__ import annotations

import json
import os
import threading
import time

from dist_keras_tpu_torch.resilience import world as _world
from dist_keras_tpu_torch.resilience.faults import fault_point
from dist_keras_tpu_torch.utils import knobs


def default_timeout_s():
    """THE collective-deadline knob: ``DK_COORD_TIMEOUT_S`` (seconds,
    default 120) — re-read per call so a launcher-exported value wins
    regardless of import order, shared by every consensus op here, the
    checkpoint commit wait, and ``comm.barrier``'s default.  A
    malformed value falls back to 120 rather than crashing a worker
    mid-run."""
    return float(knobs.get("DK_COORD_TIMEOUT_S"))


# import-time snapshot kept for back-compat readers; new code should
# call default_timeout_s() (the per-call read)
DEFAULT_TIMEOUT_S = default_timeout_s()


class BarrierTimeout(TimeoutError):
    """A coordination call missed its deadline with no liveness verdict
    (peers absent but not provably dead — e.g. heartbeats disabled)."""


class PeerLost(RuntimeError):
    """A coordination call missed its deadline AND liveness files show
    which rank(s) went dark.  ``ranks`` names them."""

    def __init__(self, msg, ranks=()):
        super().__init__(msg)
        self.ranks = tuple(ranks)


class CoordinatorPoisoned(RuntimeError):
    """A collective was attempted on a coordinator whose op stream
    already desynced (a previous collective timed out).  TYPED and
    FATAL-by-design: the process's position in the cluster's op stream
    is unknowable, so no retry can help — the auto-resume supervisor
    (``resilience.supervisor``) classifies this as never-retried and
    the process must be restarted as a fresh incarnation (rotating
    ``DK_COORD_SESSION``).  Subclasses ``RuntimeError`` so pre-existing
    catch sites keep working."""


def with_deadline(fn, timeout_s, what, stale_probe=None):
    """Run ``fn()`` but give up after ``timeout_s`` seconds: raises
    :class:`PeerLost` (when ``stale_probe()`` names ranks with
    heartbeat EVIDENCE of death — beat once, went dark) or
    :class:`BarrierTimeout` instead of hanging forever.  ``timeout_s``
    None/0 runs ``fn`` directly.  The abandoned worker thread is daemonic
    — the process stays killable, which is the whole point.  NOTE for
    collective callers: after a timeout the op stream is desynced (the
    abandoned op may still complete on the peers) — poison the channel
    and restart rather than retrying the collective."""
    if not timeout_s:
        return fn()
    box = {}

    def run():
        try:
            box["value"] = fn()
        # dklint: ignore[broad-except] not a swallow: captured and
        # RE-RAISED on the caller thread (with_deadline's contract)
        except BaseException as e:
            box["error"] = e

    t = threading.Thread(target=run, daemon=True,
                         name=f"dk-deadline-{what}")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        dead = tuple(stale_probe()) if stale_probe else ()
        if dead:
            raise PeerLost(
                f"{what} timed out after {timeout_s}s: rank(s) "
                f"{list(dead)} stopped heartbeating", ranks=dead)
        raise BarrierTimeout(
            f"{what} timed out after {timeout_s}s (no liveness verdict "
            "on the missing peers)")
    if "error" in box:
        raise box["error"]
    return box.get("value")


def collective_with_deadline(fn, timeout_s, what, stale_probe=None):
    """:func:`with_deadline` around a ``torch.distributed`` collective:
    the group's own failure (its timeout, which equals the deadline and
    may fire first, or a peer's closed connection: a ``RuntimeError``)
    is the same verdict as the deadline — :class:`PeerLost` when
    ``stale_probe()`` names dark ranks, else :class:`BarrierTimeout`."""
    try:
        return with_deadline(fn, timeout_s, what, stale_probe)
    except (PeerLost, BarrierTimeout):
        raise
    except RuntimeError as e:
        dead = tuple(stale_probe()) if stale_probe else ()
        if dead:
            raise PeerLost(f"{what} failed ({e}): rank(s) {list(dead)} "
                           "stopped heartbeating", ranks=dead) from e
        raise BarrierTimeout(f"{what} failed in the process group: "
                             f"{e}") from e


def wait_for_peers(missing_fn, timeout_s, what, poll_s=0.02,
                   stale_fn=None):
    """THE wait-with-liveness protocol, shared by every rendezvous here
    (collective op files, checkpoint host-ok markers): poll
    ``missing_fn() -> [ranks]`` until empty.  Mid-wait (~1s cadence)
    AND at the deadline, a missing rank that once heartbeat and went
    dark (``stale_fn``) raises :class:`PeerLost` naming it.  A rank
    with NO liveness trace — never started, still importing torch,
    heartbeats disabled — is **not evidence of death**: the deadline
    stays a plain :class:`BarrierTimeout`.  PeerLost always carries
    heartbeat evidence; that invariant is what lets a supervisor act
    on ``e.ranks`` (exclude/restart the host) without misdiagnosing a
    slow start."""
    # the world seam, not time.*: under the cluster simulator these
    # deadlines and probe cadences are judged on simulated time
    deadline = _world.monotonic() + timeout_s
    next_probe = _world.monotonic() + 1.0
    while True:
        missing = missing_fn()
        if not missing:
            return
        now = _world.monotonic()
        if now >= next_probe or now > deadline:
            next_probe = now + 1.0
            stale = [r for r in (stale_fn() if stale_fn else ())
                     if r in missing]
            if stale:
                raise PeerLost(
                    f"{what}: rank(s) {stale} stopped heartbeating "
                    "before publishing", ranks=stale)
        if now > deadline:
            raise BarrierTimeout(
                f"{what} timed out waiting for rank(s) {missing} "
                f"after {timeout_s}s (no heartbeat evidence of death "
                "on the missing ranks)")
        _world.sleep(poll_s)


# ---------------------------------------------------------------------------
# liveness files
# ---------------------------------------------------------------------------
class Heartbeat:
    """Background thread refreshing ``<dir>/hb/rank_{i}`` every
    ``interval_s`` — the per-host liveness file dead-peer detection and
    ``launch.Job.dead_hosts`` read.  A raise from the ``"job.heartbeat"``
    fault point stops the thread silently: the host goes dark, exactly
    like a real death, at a deterministic beat count."""

    def __init__(self, directory, rank, interval_s=1.0):
        self.path = os.path.join(directory, "hb", f"rank_{int(rank)}")
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread = None

    def beat_once(self):
        fault_point("job.heartbeat")
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            f.write(repr(_world.time()))
        os.replace(tmp, self.path)

    def _loop(self):
        from dist_keras_tpu_torch.resilience.faults import FaultInjected

        while not self._stop.wait(self.interval_s):
            try:
                self.beat_once()
            except FaultInjected:
                # the injected death: this host goes dark for good;
                # peers' next probe names it via dead_peers
                return
            # dklint: ignore[broad-except] a transient liveness-file error must not silence a healthy host
            except Exception:
                # a TRANSIENT liveness-file error (NFS blip, EDQUOT)
                # must not silence a healthy host permanently — one
                # missed beat is invisible inside the stale window, so
                # keep beating and let the next interval retry
                continue

    def start(self):
        if self._thread is not None:
            return self
        # first beat is synchronous so liveness is visible before the
        # first collective (a fault armed at @0 therefore raises HERE)
        self.beat_once()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dk-heartbeat")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def dead_peers(directory, world, stale_after_s=10.0, ranks=None,
               require_file=False):
    """Ranks whose liveness file under ``<directory>/hb`` is missing or
    older than ``stale_after_s``.  No ``hb`` directory at all means no
    liveness information — returns ``[]`` (absence of evidence), so a
    deployment that never heartbeats degrades to plain
    :class:`BarrierTimeout`, never a false :class:`PeerLost`.

    ``require_file=True`` only counts ranks that once BEAT and went
    stale — a rank whose file is merely missing may still be starting
    up (importing torch takes seconds), so early mid-wait probes
    must not declare it dead; only the final deadline treats absence as
    death."""
    hb = os.path.join(directory, "hb")
    if not os.path.isdir(hb):
        return []
    # world seam: a sim scenario stamps hb mtimes with os.utime on the
    # SIM clock, so staleness judgments replay deterministically
    now = _world.time()
    dead = []
    for r in (range(world) if ranks is None else ranks):
        try:
            mtime = os.stat(os.path.join(hb, f"rank_{r}")).st_mtime
        except OSError:
            if not require_file:
                dead.append(r)
            continue
        if now - mtime > stale_after_s:
            dead.append(r)
    return dead


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------
class Coordinator:
    """Single-process backend AND the template every backend shares: the
    public primitives fire their fault points here, so every failure
    mode is injectable even in a 1-host run, then delegate to
    ``_allgather`` (rank-ordered list of every host's value).

    POISONING: once a collective times out, this process's position in
    the cluster's op stream is unknowable — the abandoned op may still
    complete on the peers, so issuing another collective would match
    op N's answers to op N+1's question and return wrong consensus.
    After a :class:`PeerLost`/:class:`BarrierTimeout` the coordinator
    refuses further collectives; the process should exit and let the
    scheduler restart the incarnation (rotating ``DK_COORD_SESSION``)."""

    rank = 0
    world = 1
    _poisoned = None  # message of the timeout that desynced the stream

    def _allgather(self, value, timeout_s, what):
        return [value]

    def _guarded_allgather(self, value, timeout_s, what):
        from dist_keras_tpu_torch.observability import events

        if self._poisoned:
            raise CoordinatorPoisoned(
                "coordinator is poisoned: a previous collective timed "
                f"out ({self._poisoned}) and this process's position "
                "in the cluster's op stream is unknowable — restart "
                "the process (new DK_COORD_SESSION) instead of "
                "issuing further collectives")
        t0 = time.perf_counter()
        try:
            out = self._allgather(value, timeout_s, what)
        except (PeerLost, BarrierTimeout) as e:
            self._poisoned = str(e)
            # the op that timed out is exactly what a post-mortem needs:
            # the merged report shows every OTHER host's last op too
            events.emit("coord_error", op=what, world=self.world,
                        error=type(e).__name__,
                        duration_s=time.perf_counter() - t0,
                        ranks=getattr(e, "ranks", ()))
            raise
        events.emit("coord", op=what, world=self.world,
                    duration_s=time.perf_counter() - t0)
        return out

    def _note_dead(self, ranks):
        """Emit the stale->dead transition ONCE per peer per process —
        ``stale_peers`` runs on every probe tick, and a dead host must
        not spam the event log once per poll."""
        if not ranks:
            return ranks
        known = getattr(self, "_reported_dead", None)
        if known is None:
            known = self._reported_dead = set()
        fresh = [r for r in ranks if r not in known]
        if fresh:
            from dist_keras_tpu_torch.observability import events

            known.update(fresh)
            for r in fresh:
                events.emit("peer_dead", peer=r, world=self.world)
        return ranks

    def any_flag(self, flag, timeout_s=None):
        """True iff ANY host passed a truthy flag (bool OR)."""
        fault_point("coord.flag")
        return any(self._guarded_allgather(bool(flag), timeout_s,
                                            "any_flag"))

    def all_ok(self, ok, timeout_s=None):
        """True iff EVERY host passed a truthy value (bool AND)."""
        fault_point("coord.flag")
        return all(self._guarded_allgather(bool(ok), timeout_s, "all_ok"))

    def agree_min(self, value, timeout_s=None):
        fault_point("coord.agree")
        return min(self._guarded_allgather(value, timeout_s, "agree_min"))

    def agree_max(self, value, timeout_s=None):
        fault_point("coord.agree")
        return max(self._guarded_allgather(value, timeout_s, "agree_max"))

    def barrier(self, tag="dk_coord_barrier", timeout_s=None):
        """Block until every host arrives; returns the participant
        count.  A dead peer raises :class:`PeerLost`/:class:`BarrierTimeout`
        at the deadline instead of hanging."""
        fault_point("coord.barrier")
        return len(self._guarded_allgather(None, timeout_s,
                                            f"barrier({tag})"))

    def stale_peers(self):
        """Ranks that once heartbeat and went dark — safe to act on
        MID-wait (a merely-missing file may be a peer still starting
        up; only the final deadline counts absence as death)."""
        return []

    def close(self):
        pass


LocalCoordinator = Coordinator


class GroupCoordinator(Coordinator):
    """A multi-process ``torch.distributed`` group (the reference's
    ``JaxCoordinator``): each consensus op all-gathers one float64
    scalar over the group's CPU side group under a deadline.

    Attribution: the collectives do not say WHO is absent, so a timeout
    is a :class:`BarrierTimeout` unless ``DK_COORD_DIR`` heartbeat files
    name the dark rank (only for an explicitly constructed one:
    :func:`get_coordinator` prefers the ``FileCoordinator`` there)."""

    def __init__(self):
        from dist_keras_tpu_torch.comm import backend as comm

        g = comm.group_info()
        if g is None:
            raise ValueError(
                "GroupCoordinator needs a process group: call "
                "dist_keras_tpu_torch.comm.initialize() first")
        self.rank, self.world = g.rank, g.world
        self._cpu_group = g.cpu_group

    def _allgather(self, value, timeout_s, what):
        import torch
        import torch.distributed as dist

        # None (barrier) rides as 0; bools and ints as a float64 scalar
        payload = torch.tensor(
            [0.0 if value is None else float(value)], dtype=torch.float64)
        out = [torch.empty_like(payload) for _ in range(self.world)]

        def gather():
            dist.all_gather(out, payload, group=self._cpu_group)

        collective_with_deadline(gather, timeout_s or default_timeout_s(),
                                 what, self.stale_peers)
        vals = [float(v) for v in torch.cat(out)]
        if value is None:
            return [None] * len(vals)
        if isinstance(value, bool):
            return [bool(v) for v in vals]
        if isinstance(value, int):
            return [int(v) for v in vals]
        return vals

    def stale_peers(self):
        d = knobs.raw("DK_COORD_DIR")
        if not d:
            return []
        return self._note_dead(dead_peers(_session_root(d), self.world,
                                          require_file=True))


def _coord_env(var):
    """Required companion env of ``DK_COORD_DIR`` — a missing value is
    an actionable error, never a silent default: rank defaulting to 0
    would seat two leaders, world defaulting to 1 would silently turn
    the two-phase commit OFF on the very directory the operator
    configured for it."""
    value = knobs.raw(var)
    if value is None:
        raise ValueError(
            f"DK_COORD_DIR is set but {var} is not: the coordination "
            f"layer needs this process's identity.  Export {var} per "
            "host, or pass rank=/world= explicitly.")
    return value


def _session_root(directory):
    """One coordination directory serves one job incarnation; a restart
    loop rotates via ``DK_COORD_SESSION=<attempt>`` (a subdirectory).
    ``~`` expands HERE so every consumer — worker FileCoordinator,
    launcher ``Job.dead_hosts``, ``comm.barrier``'s probe — lands on
    the same path (``launch.Job`` explicitly admits ``~`` in
    coord_dir)."""
    directory = os.path.expanduser(directory)
    session = knobs.raw("DK_COORD_SESSION") or ""
    return os.path.join(directory, session) if session else directory


class FileCoordinator(Coordinator):
    """Deterministic filesystem rendezvous — consensus for plain
    processes sharing a directory (no collectives required; this is the
    ``DK_COORD_DIR`` backend the multiprocess tests and the CPU image
    use, and it works on pods with shared storage).

    Protocol: collectives are numbered by a per-process op counter (SPMD
    discipline — every rank must issue the same collectives in the same
    order, exactly like XLA's).  Op ``n`` is the directory
    ``ops/op_{n:08d}``; each rank atomically publishes
    ``rank_{i}.json`` there and polls for the other ranks' files until
    the deadline.  At the deadline, liveness files decide the verdict:
    missing ranks that stopped heartbeating raise :class:`PeerLost`
    (naming them); otherwise :class:`BarrierTimeout`."""

    def __init__(self, directory, rank=None, world=None, poll_s=0.02,
                 heartbeat=True, heartbeat_interval_s=0.5,
                 stale_after_s=None):
        self.directory = os.path.abspath(_session_root(directory))
        # identity must be EXPLICIT (args or env) — a silent rank-0 /
        # world-1 default would let two hosts both claim the leader
        # seat, or silently disable the two-phase commit, and corrupt
        # the protocol (_coord_env raises the actionable error)
        self.rank = int(_coord_env("DK_COORD_RANK") if rank is None
                        else rank)
        self.world = int(_coord_env("DK_COORD_WORLD") if world is None
                         else world)
        self.poll_s = float(poll_s)
        # stale window: generous by default — shared filesystems cache
        # attributes (NFS acregmax) and hosts' clocks skew, and a false
        # PeerLost aborts a healthy run; tune DK_COORD_STALE_S down for
        # local-disk test rigs that want fast dead-peer verdicts
        if stale_after_s is None:
            stale_after_s = float(
                knobs.raw("DK_COORD_STALE_S")
                or max(10 * heartbeat_interval_s, 10.0))
        self.stale_after_s = float(stale_after_s)
        self._ops = os.path.join(self.directory, "ops")
        os.makedirs(self._ops, exist_ok=True)
        self._op = 0
        self._hb = None
        if heartbeat:
            self._hb = Heartbeat(self.directory, self.rank,
                                 heartbeat_interval_s).start()

    def stale_peers(self):
        return self._note_dead(
            dead_peers(self.directory, self.world,
                       stale_after_s=self.stale_after_s,
                       require_file=True))

    def _allgather(self, value, timeout_s, what):
        op, self._op = self._op, self._op + 1
        opdir = os.path.join(self._ops, f"op_{op:08d}")
        os.makedirs(opdir, exist_ok=True)
        mine = os.path.join(opdir, f"rank_{self.rank}.json")
        tmp = f"{mine}.tmp"
        with open(tmp, "w") as f:
            json.dump({"v": value}, f)
        os.replace(tmp, mine)  # atomic publish: readers never see a torn file

        got = {}

        def missing():
            for r in range(self.world):
                if r in got:
                    continue
                try:
                    with open(os.path.join(
                            opdir, f"rank_{r}.json")) as f:
                        got[r] = json.load(f)["v"]
                except (OSError, ValueError):
                    pass  # not published yet
            return sorted(set(range(self.world)) - set(got))

        wait_for_peers(
            missing, timeout_s or default_timeout_s(),
            f"{what} (op {op})", poll_s=self.poll_s,
            stale_fn=self.stale_peers)
        if self.rank == 0 and op and op % 16 == 0:
            self._gc_ops(op)
        return [got[r] for r in range(self.world)]

    def _gc_ops(self, op, keep=16):
        """Leader-side sweep of settled op dirs.  An op dir older than
        ``op - keep`` is provably drained: the leader reaching op n
        means every rank PUBLISHED op n, which it can only do after
        fully reading op n-1."""
        import shutil

        for name in os.listdir(self._ops):
            if not name.startswith("op_"):
                continue
            try:
                n = int(name[3:])
            except ValueError:
                continue
            if n <= op - keep:
                shutil.rmtree(os.path.join(self._ops, name),
                              ignore_errors=True)

    def close(self):
        if self._hb is not None:
            self._hb.stop()
            self._hb = None


# ---------------------------------------------------------------------------
# backend selection + module-level convenience API
# ---------------------------------------------------------------------------
_lock = threading.Lock()
_coordinator = None


def _process_group():
    """The ``comm`` bring-up's group facts (rank, world, ...), or None
    when no group is up — read without importing the distributed
    package when nothing imported it yet."""
    import sys

    backend = sys.modules.get("dist_keras_tpu_torch.comm.backend")
    return None if backend is None else backend.group_info()


def _process_group_world():
    """World size of the process group (1 when none is up)."""
    g = _process_group()
    return 1 if g is None else int(g.world)


def get_coordinator():
    """The process-wide coordinator: ``FileCoordinator`` when
    ``DK_COORD_DIR`` is exported, :class:`GroupCoordinator` on a
    process group of more than one process, else the trivial local one.
    Cached — the FileCoordinator's op counter must persist across
    calls."""
    global _coordinator
    with _lock:
        if _coordinator is None:
            d = knobs.raw("DK_COORD_DIR")
            if d:
                _coordinator = FileCoordinator(d)
            elif _process_group_world() > 1:
                _coordinator = GroupCoordinator()
            else:
                _coordinator = LocalCoordinator()
        return _coordinator


def reset():
    """Drop (and close) the cached coordinator — tests that flip
    ``DK_COORD_*`` env need a fresh selection."""
    global _coordinator
    with _lock:
        if _coordinator is not None:
            _coordinator.close()
            _coordinator = None


def rank():
    """This process's coordination rank: ``DK_COORD_RANK`` when
    ``DK_COORD_DIR`` is set (the companion vars are then REQUIRED, same
    rule as ``FileCoordinator`` — no silent identity defaults), else the
    process group's rank (0 without one)."""
    if knobs.raw("DK_COORD_DIR"):
        return int(_coord_env("DK_COORD_RANK"))
    g = _process_group()
    return 0 if g is None else int(g.rank)


def world():
    """The coordination world size: ``DK_COORD_WORLD`` when
    ``DK_COORD_DIR`` is set, else the process group's (1 without one)."""
    if knobs.raw("DK_COORD_DIR"):
        return int(_coord_env("DK_COORD_WORLD"))
    return _process_group_world()


def dead_peers_at(coord_dir, world, stale_after_s=None,
                  require_file=False, session=None):
    """Public launcher/monitor-side probe: dead ranks for a job's
    ``coord_dir`` as configured (session subdir and ``~`` resolved the
    same way the workers resolve them) — the stable surface for
    ``launch.Job.dead_hosts`` and ``comm.barrier``'s probe, so nothing
    outside this module touches the path layout.  The default stale
    window honors ``DK_COORD_STALE_S`` so launcher and workers judge
    liveness by the SAME clock; ``require_file=True`` restricts the
    verdict to heartbeat evidence (beat once, went dark), which is
    what PeerLost-raising callers must use.  ``session`` overrides the
    ``DK_COORD_SESSION`` env resolution: a launcher-side supervisor
    that relaunched the pod under a rotated session must judge the NEW
    incarnation's heartbeats, not its own (session-less) environment's
    view of the old ones."""
    if stale_after_s is None:
        stale_after_s = float(knobs.raw("DK_COORD_STALE_S") or "10")
    if session is None:
        root = _session_root(str(coord_dir))
    else:
        root = os.path.join(os.path.expanduser(str(coord_dir)),
                            str(session))
    return dead_peers(root, world, stale_after_s=stale_after_s,
                      require_file=require_file)


def any_flag(flag, timeout_s=None):
    return get_coordinator().any_flag(flag, timeout_s=timeout_s)


def all_ok(ok, timeout_s=None):
    return get_coordinator().all_ok(ok, timeout_s=timeout_s)


def agree_min(value, timeout_s=None):
    return get_coordinator().agree_min(value, timeout_s=timeout_s)


def agree_max(value, timeout_s=None):
    return get_coordinator().agree_max(value, timeout_s=timeout_s)


def barrier(tag="dk_coord_barrier", timeout_s=None):
    return get_coordinator().barrier(tag, timeout_s=timeout_s)
