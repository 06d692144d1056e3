"""Worker-side RPC client for the parameter server, a copy of the JAX
package's ``ps/client.py`` (stdlib only) on the port's ``retry``,
``faults``, ``knobs`` and ``serialization``.  The wire is the JAX
package's: a worker of either package talks to a server of either.

Stdlib ``http.client`` only (same dependency rule as the serving tier:
gate or stub, never install).  Every RPC runs through a NAMED
``RetryPolicy`` surface and a registered fault point, so the chaos
schedule (``DK_FAULTS_SEED``) can kill or delay exactly the Nth pull /
commit / join and the merged report attributes every absorbed retry:

- ``ps.join``   — worker registration (lease + first pull in one trip)
- ``ps.pull``   — read the center variable + version
- ``ps.commit`` — push one window's delta tagged with the pulled
  version; its retry surface carries the ``DK_PS_COMMIT_DEADLINE_S``
  overall deadline, so a wedged server turns into a typed error at a
  bounded instant instead of an unbounded worker stall

Transport failures (connection refused/reset, a 503 from a draining or
restarting server) surface as ``OSError`` inside the retried body —
absorbed by the policy, typed when the budget dies.  A **409** is the
server's typed :class:`~dist_keras_tpu_torch.ps.center.StaleCommit` verdict
and is NOT retried (retrying an over-cap commit can never succeed; the
worker's recovery is a fresh pull).

Payloads are pickled pytrees of numpy arrays
(``utils.serialization``), like every other intra-pod byte stream in
this repo (checkpoint payloads, launch transports): the trust domain
is the pod — the same machines that already ssh into each other.
"""

from __future__ import annotations

import http.client
import itertools
import json
import uuid

from dist_keras_tpu_torch.resilience import faults
from dist_keras_tpu_torch.resilience.retry import RetryPolicy
from dist_keras_tpu_torch.utils import knobs
from dist_keras_tpu_torch.utils.serialization import (pickle_object,
                                                unpickle_object)
from dist_keras_tpu_torch.ps.center import PSError, StaleCommit


class PSUnavailable(OSError, PSError):
    """The server could not be reached (or answered 503) after the
    retry budget — an ``OSError`` so outer policies (the auto-resume
    supervisor) classify it transient, typed so the operator sees WHICH
    surface died."""


def default_addr(addr=None):
    """Resolve ``host:port``: the explicit argument wins, then the
    launcher-exported ``DK_PS_ADDR``."""
    addr = addr or knobs.raw("DK_PS_ADDR")
    if not addr:
        raise ValueError(
            "no parameter-server address: pass server_addr=host:port "
            "or export DK_PS_ADDR (launch.Job(ps_addr=...) does)")
    host, _, port = str(addr).rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(
            f"malformed parameter-server address {addr!r}: expected "
            "host:port")
    return host, int(port)


class PSClient:
    """One worker's connection to the center-variable server."""

    def __init__(self, addr=None, rpc_timeout_s=30.0,
                 commit_deadline_s=None, attempts=4, backoff=0.1):
        self.host, self.port = default_addr(addr)
        self.rpc_timeout_s = float(rpc_timeout_s)
        if commit_deadline_s is None:
            commit_deadline_s = knobs.get("DK_PS_COMMIT_DEADLINE_S")
        retryable = (OSError,)
        self._pull_policy = RetryPolicy(
            attempts=attempts, backoff=backoff, jitter=0.1,
            retryable=retryable, name="ps.pull")
        self._join_policy = RetryPolicy(
            attempts=attempts, backoff=backoff, jitter=0.1,
            retryable=retryable, name="ps.join")
        self._commit_policy = RetryPolicy(
            attempts=attempts, backoff=backoff, jitter=0.1,
            timeout=float(commit_deadline_s), retryable=retryable,
            name="ps.commit")
        # idempotency identity: a per-instance nonce + a per-commit
        # sequence mint one commit_id per commit() CALL (stable across
        # its retries) — a retry whose first attempt applied but whose
        # response was lost is deduped server-side instead of
        # double-applying the delta.  The nonce keeps a RESTARTED
        # client (same sticky wid, fresh counter) from ever colliding
        # with its previous incarnation's ids.
        self._nonce = uuid.uuid4().hex
        self._commit_seq = itertools.count()

    # -- transport -----------------------------------------------------
    def _post(self, path, payload):
        """One HTTP round trip; transport failures -> OSError (the
        retryable class), server verdicts -> typed errors."""
        body = pickle_object(payload)
        try:
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.rpc_timeout_s)
            try:
                conn.request("POST", path, body=body, headers={
                    "Content-Type": "application/octet-stream",
                    "Content-Length": str(len(body))})
                resp = conn.getresponse()
                data = resp.read()
                status = resp.status
            finally:
                conn.close()
        except OSError as e:  # refused/reset/timeout: retryable as-is
            raise PSUnavailable(
                f"parameter server {self.host}:{self.port} unreachable "
                f"({type(e).__name__}: {e})") from e
        if status == 200:
            return unpickle_object(data)
        detail = {}
        try:
            detail = json.loads(data.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            pass
        if status == 409:
            raise StaleCommit(detail.get("staleness", -1),
                              detail.get("cap", -1),
                              wid=detail.get("wid"))
        if status == 503:
            # draining or restarting: transient — the retry budget
            # rides out a supervisor relaunch window
            raise PSUnavailable(
                f"parameter server {self.host}:{self.port} answered "
                f"503 ({detail.get('error', 'draining')})")
        what = detail.get("error") or repr(data[:120])
        raise PSError(
            f"parameter server answered {status} on {path}: {what}")

    # -- RPC surfaces --------------------------------------------------
    def join(self, wid=None, rank=None):
        """Register this worker; -> dict(wid, version, center, window,
        lease_s, rejoined).  The join response doubles as the first
        pull — a late joiner pulls-and-goes in one trip.  The lease
        TTL is server policy (``DK_PS_LEASE_S``), not negotiable per
        worker — staleness accounting needs ONE liveness clock."""
        def _do():
            faults.fault_point("ps.join")
            return self._post("/join", {"wid": wid, "rank": rank})
        return self._join_policy.call(_do)

    def pull(self, wid=None):
        """-> dict(version, center)."""
        def _do():
            faults.fault_point("ps.pull")
            return self._post("/pull", {"wid": wid})
        return self._pull_policy.call(_do)

    def commit(self, wid, version, delta, rank=None):
        """Push one window delta; -> dict(version, staleness, scale,
        center, rejoined, duplicate).  Bounded by the commit deadline;
        a 409 :class:`StaleCommit` surfaces untouched (not retryable);
        the commit_id makes a response-lost retry an idempotent replay
        server-side, never a double apply.  ``rank`` keeps an
        auto-rejoining commit (lapsed lease) inside host-drop-evidence
        coverage."""
        commit_id = f"{self._nonce}:{next(self._commit_seq)}"

        def _do():
            faults.fault_point("ps.commit")
            return self._post("/commit", {"wid": wid,
                                          "version": int(version),
                                          "delta": delta,
                                          "commit_id": commit_id,
                                          "rank": rank})
        return self._commit_policy.call(_do)
