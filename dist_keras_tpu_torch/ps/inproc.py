"""In-process parameter-server transport — a PS swarm without sockets; a
copy of the JAX package's ``ps/inproc.py``.

The cluster simulator (the JAX package's ``sim``; the port's is ROADMAP
item 18) runs thousand-worker
chaos scenarios in SIMULATED time, which rules out the real
``PSServer``/``PSClient`` pair: an HTTP round trip blocks on kernel
sockets and OS threads, both of which tick the WALL clock the sim has
replaced.  This module is the same protocol with the wire removed:

- :class:`InProcPSServer` wraps one :class:`CenterVariable` and renders
  the EXACT verdicts the HTTP handler renders — ``PSUnavailable`` while
  draining (the 503), :class:`StaleCommit` propagated untouched (the
  409), duplicate commits answered like pulls, ``compress.decode_tree``
  applied before the center update — and emits the same ``ps.*``
  metrics and ``ps_*`` events, so a simulated run's observability
  stream is indistinguishable from a real swarm's.
- :class:`InProcPSClient` mirrors ``PSClient``'s RPC surface verb for
  verb: the same return-dict shapes, the same named ``RetryPolicy``
  surfaces (``ps.join`` / ``ps.pull`` / ``ps.commit`` with the
  ``DK_PS_COMMIT_DEADLINE_S`` overall deadline), the same fault points
  fired INSIDE the retried bodies, and the same per-call ``commit_id``
  minting — stable across retries, so the server-side idempotent-replay
  dedup is exercised by the sim exactly as over HTTP.

The seam between them is ``partitioned``: a zero-arg callable the
scenario installs to simulate a network partition.  While it returns
True every RPC raises :class:`PSUnavailable` — the same ``OSError``
subclass a refused connection raises — so the client's retry budget,
typed exhaustion, and the supervisor above it all exercise their real
code paths against a partition that heals on the sim clock.

Everything here is synchronous and single-threaded by design: the sim
scheduler owns interleaving, so the HTTP server's in-flight commit
accounting (``commit_begin``/``commit_end``) collapses to the draining
check at the door.
"""

from __future__ import annotations

import itertools
import uuid

from dist_keras_tpu_torch.observability import events
from dist_keras_tpu_torch.observability import metrics as _metrics
from dist_keras_tpu_torch.resilience import faults
from dist_keras_tpu_torch.resilience import world as _world
from dist_keras_tpu_torch.resilience.retry import RetryPolicy
from dist_keras_tpu_torch.utils import knobs
from dist_keras_tpu_torch.ps import compress
from dist_keras_tpu_torch.ps.center import CenterVariable, StaleCommit
from dist_keras_tpu_torch.ps.client import PSUnavailable


class InProcPSServer:
    """One :class:`CenterVariable` behind the HTTP handler's verdict
    logic, callable directly — no port, no threads, no pickling.

    ``window`` / ``lease_s`` / ``staleness_cap`` default to the
    registered ``DK_PS_*`` knobs, same as the socket server.
    """

    def __init__(self, params, window=None, lease_s=None,
                 staleness_cap=None):
        self.window = int(knobs.get("DK_PS_WINDOW")
                          if window is None else window)
        if self.window < 1:
            raise ValueError(
                f"communication window must be >= 1, got {self.window}")
        self.center = CenterVariable(params, lease_s=lease_s,
                                     staleness_cap=staleness_cap)
        self.draining = False

    def _door(self):
        """The admission check every RPC passes — the 503 analogue."""
        if self.draining:
            raise PSUnavailable(
                "in-process parameter server answered 503 (draining)")

    # -- the handler surface (same emissions as server._Handler) -------
    def join(self, wid=None, rank=None, now=None):
        self._door()
        now = _world.monotonic() if now is None else now
        wid, version, center, rejoined = self.center.join(
            wid=wid, rank=rank, now=now)
        st = self.center.stats()
        _metrics.counter("ps.joins").inc()
        _metrics.gauge("ps.workers").set(st["workers"])
        events.emit("ps_worker_join", wid=wid, worker_rank=rank,
                    rejoined=rejoined, version=version,
                    workers=st["workers"])
        return {"wid": wid, "version": version, "center": center,
                "rejoined": rejoined, "window": self.window,
                "lease_s": self.center.lease_s}

    def pull(self, wid=None, now=None):
        self._door()
        now = _world.monotonic() if now is None else now
        version, center = self.center.pull(wid=wid, now=now)
        _metrics.counter("ps.pulls").inc()
        events.emit("ps_pull", wid=wid, version=version)
        return {"version": version, "center": center}

    def commit(self, wid, version, delta, commit_id=None, rank=None,
               now=None):
        self._door()
        now = _world.monotonic() if now is None else now
        # same decode-before-apply ordering as the HTTP handler: the
        # center-update algebra stays codec-blind
        delta = compress.decode_tree(delta)
        try:
            info = self.center.commit(wid, int(version), delta,
                                      now=now, commit_id=commit_id,
                                      rank=rank)
        except StaleCommit as e:
            _metrics.counter("ps.rejected_stale").inc()
            events.emit("ps_stale_scaled", wid=wid,
                        staleness=e.staleness, cap=e.cap,
                        rejected=True)
            raise
        if info["duplicate"]:
            # idempotent replay: nothing applied, no commit metrics
            return {"version": info["version"],
                    "staleness": info["staleness"],
                    "scale": info["scale"], "center": info["center"],
                    "rejoined": info["rejoined"], "duplicate": True}
        _metrics.counter("ps.commits").inc()
        _metrics.gauge("ps.clock").set(info["version"])
        _metrics.histogram("ps.staleness").observe(info["staleness"])
        events.emit("ps_commit", wid=wid, version=info["version"],
                    staleness=info["staleness"], scale=info["scale"],
                    rejoined=info["rejoined"])
        if info["staleness"] > 0:
            _metrics.counter("ps.stale_scaled").inc()
            events.emit("ps_stale_scaled", wid=wid,
                        staleness=info["staleness"],
                        scale=info["scale"], rejected=False)
        return {"version": info["version"],
                "staleness": info["staleness"], "scale": info["scale"],
                "center": info["center"], "rejoined": info["rejoined"],
                "duplicate": False}

    # -- membership churn (the socket server's reaper loop, called
    # explicitly by the sim scheduler on the sim clock) ----------------
    def reap(self, now=None):
        """Drop lapsed leases; -> [(wid, rank)] dropped.  Emits the
        reaper's ``ps.lapses`` / ``ps_worker_lapse`` rows."""
        now = _world.monotonic() if now is None else now
        dead = self.center.reap(now=now)
        if dead:
            st = self.center.stats()
            _metrics.gauge("ps.workers").set(st["workers"])
            for wid, rank in dead:
                _metrics.counter("ps.lapses").inc()
                events.emit("ps_worker_lapse", wid=wid,
                            worker_rank=rank, reason="lease_ttl",
                            workers=st["workers"])
        return dead

    def drain(self):
        """Flip the admission door shut (the restart/maintenance
        window); :meth:`resume` reopens it."""
        self.draining = True

    def resume(self):
        self.draining = False


class InProcPSClient:
    """``PSClient``'s RPC surface over a direct method-call transport.

    ``partitioned`` is the scenario's network seam: a zero-arg callable
    checked inside every retried body; True -> :class:`PSUnavailable`
    (retryable ``OSError``, exactly what a refused socket raises).
    ``backoff``/``jitter`` default to the real client's so sim sleeps
    advance the sim clock by the same schedule a wall-clock worker
    would have slept.  ``seed`` pins the jitter PRNG (the real client
    lets it derive from the pid — fine for de-synchronizing live
    workers, fatal for bit-identical replay across processes).
    """

    def __init__(self, server, attempts=4, backoff=0.1, jitter=0.1,
                 commit_deadline_s=None, partitioned=None, sleep=None,
                 clock=None, seed=None):
        self.server = server
        self.partitioned = partitioned
        if commit_deadline_s is None:
            commit_deadline_s = knobs.get("DK_PS_COMMIT_DEADLINE_S")
        retryable = (OSError,)
        self._join_policy = RetryPolicy(
            attempts=attempts, backoff=backoff, jitter=jitter,
            retryable=retryable, name="ps.join", sleep=sleep,
            clock=clock, seed=seed)
        self._pull_policy = RetryPolicy(
            attempts=attempts, backoff=backoff, jitter=jitter,
            retryable=retryable, name="ps.pull", sleep=sleep,
            clock=clock, seed=seed)
        self._commit_policy = RetryPolicy(
            attempts=attempts, backoff=backoff, jitter=jitter,
            timeout=float(commit_deadline_s), retryable=retryable,
            name="ps.commit", sleep=sleep, clock=clock, seed=seed)
        # same idempotency identity scheme as PSClient: one commit_id
        # per commit() CALL, stable across its retries.  A seeded
        # client derives its nonce too (dedup is per-lease, so equal
        # nonces across DIFFERENT wids are harmless) — uuid4 in a
        # replayed trace would be the one nondeterministic byte string
        self._nonce = (uuid.uuid4().hex if seed is None
                       else f"sim{int(seed):x}")
        self._commit_seq = itertools.count()

    def _check_partition(self):
        if self.partitioned is not None and self.partitioned():
            raise PSUnavailable(
                "in-process parameter server unreachable "
                "(simulated partition)")

    # -- RPC surfaces (PSClient-shaped returns) ------------------------
    def join(self, wid=None, rank=None):
        def _do():
            faults.fault_point("ps.join")
            self._check_partition()
            return self.server.join(wid=wid, rank=rank)
        return self._join_policy.call(_do)

    def pull(self, wid=None):
        def _do():
            faults.fault_point("ps.pull")
            self._check_partition()
            return self.server.pull(wid=wid)
        return self._pull_policy.call(_do)

    def commit(self, wid, version, delta, rank=None):
        commit_id = f"{self._nonce}:{next(self._commit_seq)}"

        def _do():
            faults.fault_point("ps.commit")
            self._check_partition()
            return self.server.commit(wid, int(version), delta,
                                      commit_id=commit_id, rank=rank)
        return self._commit_policy.call(_do)
