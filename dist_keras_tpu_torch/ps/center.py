"""Center variable — the parameter server's authoritative weights, a
copy of the JAX package's ``ps/center.py`` (it is numpy and stdlib only).

The paper's central parameter server (``parameter_servers.py:~280``)
holds one "center variable" the asynchronous workers pull from and
commit deltas into; DynSGD scales each commit by ``1/(staleness+1)``
where staleness counts how many center updates landed since the
committing worker's last pull.  This module is that object, host-side
and framework-free: a pytree of numpy arrays versioned by a monotonic
**commit clock**, plus the elastic-membership ledger (worker leases).

Parity contract: :func:`dynsgd_scale` / :func:`apply_commit` mirror the
EXACT expressions of the single-host staggered-staleness scan
(``trainers/dynsgd.py`` ``_make_body.one_step``'s commit block):

    staleness = (global_count - last_seen)          # float32
    scale     = 1.0 / (staleness + 1.0)             # float32
    center    = (center + scale * (local - pulled)).astype(center.dtype)

with the committed ``delta`` being the worker-side float32
``local - pulled`` and integer leaves (Keras seed-generator counters —
RNG state, not weights) contributing nothing and never moving — the
``tree_merge_floats`` exemption policy.  ``tests/test_ps.py`` replays a
commit log through both and requires bit-equality, so the server-side
math can never drift from the trainer the accuracy floor is pinned to.

Restart semantics: a server restored from a checkpoint may hold a clock
OLDER than what a surviving worker pulled before the crash; such a
commit's raw staleness is negative and is CLAMPED to 0 (the worker is
at least as fresh as the restored center — scaling it down would
double-punish the rollback).  Staleness above ``staleness_cap`` is a
typed :class:`StaleCommit` instead of an arbitrarily-down-scaled
apply: the delta is refused, the worker re-pulls and keeps going —
bounded damage from a worker that slept through an epoch.

Thread contract: every method is safe from concurrent HTTP handler
threads; the single internal lock is held only for in-memory state
(never I/O, sleeps, or event emission — callers emit AFTER the call
returns, from their own thread).
"""

from __future__ import annotations

import threading

import numpy as np

from dist_keras_tpu_torch.resilience import world as _world
from dist_keras_tpu_torch.utils import knobs


class PSError(Exception):
    """Base of the parameter-server subsystem's typed errors."""


class StaleCommit(PSError):
    """A commit's staleness exceeded the cap — the delta was refused.

    The worker's recovery is to re-pull the center and continue; the
    work of the refused window is lost, which is the point: a cap
    bounds how much a worker that slept through many center updates can
    drag the run, where an uncapped ``1/(1+s)`` apply would still admit
    an arbitrarily old direction.
    """

    def __init__(self, staleness, cap, wid=None):
        self.staleness = int(staleness)
        self.cap = int(cap)
        self.wid = wid
        super().__init__(
            f"commit staleness {staleness} exceeds cap {cap}"
            + (f" (worker {wid})" if wid else "")
            + " — re-pull the center variable and continue")


def _is_float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def dynsgd_scale(staleness):
    """The DynSGD commit scale ``1/(staleness+1)`` as float32 — the
    same expression (same dtype, same order) the compiled scan computes
    in ``trainers/dynsgd.py``."""
    return np.float32(1.0) / (np.float32(staleness) + np.float32(1.0))


def apply_commit(center_leaf, delta_leaf, scale):
    """One leaf of the center update: ``(c + scale * d).astype(c.dtype)``.

    ``d`` is the worker's float32 ``local - pulled``; non-float leaves
    pass through untouched (the ``tree_merge_floats`` policy — integer
    leaves are RNG state, not weights).
    """
    c = np.asarray(center_leaf)
    if not _is_float(c):
        return c
    d = np.asarray(delta_leaf, dtype=np.float32)
    return (c.astype(np.float32) + np.float32(scale) * d).astype(c.dtype)


def _tree_map(fn, *trees):
    """Structure-preserving map over nested dict/list/tuple pytrees of
    arrays (stdlib-only — no jax import, so the server process stays
    light and the parity surface stays framework-free)."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees))
                for k in head}
    if isinstance(head, (list, tuple)):
        out = [_tree_map(fn, *(t[i] for t in trees))
               for i in range(len(head))]
        return type(head)(out) if isinstance(head, tuple) else out
    return fn(*trees)


def tree_copy(tree):
    """Deep host copy (every leaf materialized as an owned numpy
    array) — what crosses the wire and what readers receive, so no
    caller ever aliases the live center."""
    return _tree_map(lambda a: np.array(a, copy=True), tree)


class WorkerLease:
    """One registered worker's membership record."""

    __slots__ = ("wid", "rank", "joined_at", "expires_at", "commits",
                 "last_version", "last_commit_id", "last_commit_info")

    def __init__(self, wid, rank, now, ttl):
        self.wid = wid
        self.rank = rank            # DK_COORD_RANK of the worker, or None
        self.joined_at = now
        self.expires_at = now + ttl
        self.commits = 0
        self.last_version = None    # clock value at its last pull
        # idempotent-replay dedup: the client-minted id of the last
        # APPLIED commit and its (staleness, scale) — a retried commit
        # whose first attempt already landed (response lost to a
        # timeout) must not apply twice
        self.last_commit_id = None
        self.last_commit_info = None


class CenterVariable:
    """Versioned center weights + commit clock + worker leases.

    ``staleness_cap`` / ``lease_s`` default to the registered
    ``DK_PS_STALENESS_CAP`` / ``DK_PS_LEASE_S`` knobs when None.
    """

    def __init__(self, params, clock=0, staleness_cap=None, lease_s=None):
        self._lock = threading.Lock()
        self._center = tree_copy(params)
        self._clock = int(clock)
        self._leases = {}            # wid -> WorkerLease
        self._next_wid = 0
        self._lapsed = 0             # lifetime lapse count (stats)
        self.staleness_cap = int(
            knobs.get("DK_PS_STALENESS_CAP") if staleness_cap is None
            else staleness_cap)
        self.lease_s = float(
            knobs.get("DK_PS_LEASE_S") if lease_s is None else lease_s)

    # -- membership ----------------------------------------------------
    def join(self, wid=None, rank=None, now=None):
        """Register (or re-register) a worker lease; -> (wid, version,
        center copy, rejoined).  A late joiner pulls-and-goes: the join
        response IS its first pull.  ``wid=None`` mints a fresh id; a
        known wid renews in place (worker restart with a sticky id)."""
        now = _world.monotonic() if now is None else now
        with self._lock:
            rejoined = wid is not None and wid in self._leases
            if wid is None:
                wid = f"w{self._next_wid}"
                self._next_wid += 1
            lease = self._leases.get(wid)
            if lease is None:
                lease = self._leases[wid] = WorkerLease(
                    wid, rank, now, self.lease_s)
            else:
                lease.expires_at = now + self.lease_s
                if rank is not None:
                    lease.rank = rank
            lease.last_version = self._clock
            return wid, self._clock, tree_copy(self._center), rejoined

    def pull(self, wid=None, now=None):
        """-> (version, center copy); renews the caller's lease when its
        wid is known (an unknown wid still gets the read — pulls are
        read-only and a reader must never be refused the truth)."""
        now = _world.monotonic() if now is None else now
        with self._lock:
            lease = self._leases.get(wid) if wid else None
            if lease is not None:
                lease.expires_at = now + self.lease_s
                lease.last_version = self._clock
            return self._clock, tree_copy(self._center)

    def reap(self, now=None):
        """Drop every lapsed lease; -> [(wid, rank)] just dropped.  A
        lapsed worker leaves staleness accounting entirely — the run
        never stalls waiting for it; if it comes back, its next commit
        auto-rejoins (graceful degrade, not a stall)."""
        now = _world.monotonic() if now is None else now
        with self._lock:
            dead = [w for w in self._leases.values()
                    if w.expires_at <= now]
            for w in dead:
                del self._leases[w.wid]
            self._lapsed += len(dead)
            return [(w.wid, w.rank) for w in dead]

    def lapse(self, wid):
        """Explicitly drop one worker (host-drop evidence — the
        supervisor/heartbeat plane convicted its machine, no need to
        wait out the lease TTL).  -> True when it was registered."""
        with self._lock:
            found = self._leases.pop(wid, None)
            if found is not None:
                self._lapsed += 1
            return found is not None

    def workers_by_rank(self, ranks):
        """(wid, rank) of live workers registered from the given
        coordination ranks (the host-drop-evidence lapse path — the
        rank rides along so the lapse attribution can name WHICH
        host's death caused it)."""
        ranks = set(int(r) for r in ranks)
        with self._lock:
            return [(w.wid, int(w.rank)) for w in self._leases.values()
                    if w.rank is not None and int(w.rank) in ranks]

    # -- the DynSGD update ---------------------------------------------
    def commit(self, wid, version, delta, now=None, commit_id=None,
               rank=None):
        """Apply one worker's window delta tagged with the version it
        pulled.  -> dict(version, staleness, scale, center, rejoined,
        duplicate).

        Staleness = clock - version, clamped at 0 (server rollback);
        above ``staleness_cap`` -> typed :class:`StaleCommit`, nothing
        applied.  A commit from an unregistered wid auto-rejoins it
        (a restarted/lapsed worker degrades gracefully instead of
        corrupting the run — its staleness scaling already discounts
        whatever it missed).

        ``rank`` re-seats the worker's coordination identity when the
        commit AUTO-REJOINS a lapsed lease (without it the rejoined
        worker would silently fall out of host-drop-evidence coverage
        until its next explicit join).

        ``commit_id`` makes the call IDEMPOTENT across client retries:
        a commit whose first attempt applied but whose response was
        lost (client timeout -> retry) is recognized by the lease's
        ``last_commit_id`` and answered like a pull (current version +
        center, the recorded staleness/scale, ``duplicate=True``)
        instead of double-applying the delta.  Residual window: if the
        lease LAPSED between the two attempts the dedup memory is gone
        — the lease TTL is orders of magnitude above the retry backoff,
        so this is the deliberate bounded trade against remembering
        every dead worker forever.
        """
        now = _world.monotonic() if now is None else now
        with self._lock:
            lease = self._leases.get(wid)
            if (commit_id is not None and lease is not None
                    and lease.last_commit_id == commit_id):
                lease.expires_at = now + self.lease_s
                stal, scale = lease.last_commit_info
                return {"version": self._clock, "staleness": stal,
                        "scale": scale, "rejoined": False,
                        "duplicate": True,
                        "center": tree_copy(self._center)}
            staleness = max(0, self._clock - int(version))
            if staleness > self.staleness_cap:
                raise StaleCommit(staleness, self.staleness_cap, wid=wid)
            scale = dynsgd_scale(staleness)
            self._center = _tree_map(
                lambda c, d: apply_commit(c, d, scale),
                self._center, delta)
            self._clock += 1
            rejoined = lease is None
            if rejoined:
                lease = self._leases[wid] = WorkerLease(
                    wid, rank, now, self.lease_s)
            elif rank is not None and lease.rank is None:
                lease.rank = rank
            lease.expires_at = now + self.lease_s
            lease.commits += 1
            lease.last_version = self._clock
            lease.last_commit_id = commit_id
            lease.last_commit_info = (staleness, float(scale))
            return {"version": self._clock, "staleness": staleness,
                    "scale": float(scale), "rejoined": rejoined,
                    "duplicate": False,
                    "center": tree_copy(self._center)}

    # -- introspection -------------------------------------------------
    @property
    def clock(self):
        with self._lock:
            return self._clock

    def state(self):
        """(clock, center copy) — what the server checkpoints."""
        with self._lock:
            return self._clock, tree_copy(self._center)

    def stats(self):
        """JSON-ready snapshot for /metricsz and tests."""
        with self._lock:
            return {
                "clock": self._clock,
                "workers": len(self._leases),
                "lapsed_total": self._lapsed,
                "staleness_cap": self.staleness_cap,
                "lease_s": self.lease_s,
                "per_worker": {
                    w.wid: {"rank": w.rank, "commits": w.commits,
                            "last_version": w.last_version}
                    for w in self._leases.values()},
            }
