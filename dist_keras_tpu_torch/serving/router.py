"""Multi-host serving router — evidence-based eviction over a pod.

Each serving host runs its own :class:`~.server.ServingServer` over its
own engine; this tier is the thin stdlib-HTTP router in front of the
pod (``serving/server.py`` / ``ps/server.py`` style — body consumed
before early replies, SIGTERM drain via ``resilience.preemption``,
``/healthz`` / ``/metricsz`` / ``/statusz`` / ``/tracez``).  A host
dying mid-load stops being a client-visible outage and becomes the
same typed, evidence-judged, bounded event the training path already
made of it.

Routing policy (:class:`BackendPool` — HTTP-free, so the cluster
simulator drives the identical code on simulated time):

- **Least-loaded by queue depth.** The health prober reads each
  backend's ``/metricsz`` engine ``outstanding`` (admitted-but-
  unresolved — the same number the engine's admission bound and the
  ``QueueDepthGrowth`` watchdog rule judge); ``pick`` routes to the
  shallowest backend, round-robin on ties.  A backend whose depth is
  UNKNOWN (malformed or missing ``/metricsz`` — a degraded host is
  exactly when its telemetry rots first) degrades the WHOLE pick to
  round-robin rather than starving the blind host or trusting a stale
  number.
- **Eviction on evidence, never on suspicion.** Three independent
  convictions: (1) consecutive connect/forward failures
  (``DK_ROUTE_FAILS``); (2) a last good ``/healthz`` older than the
  stale window (``DK_ROUTE_STALE_S``); (3) the pod's own heartbeat
  files via ``coordination.dead_peers_at(require_file=True)`` when the
  router watches the job's coord dir — the SAME liveness evidence the
  supervisor and barrier already act on, so router and trainer never
  disagree about who is dead.  Every eviction is a typed
  ``route_evict`` event naming its evidence.
- **Re-admission with hysteresis.** An evicted backend must pass
  ``DK_ROUTE_READMIT_CHECKS`` consecutive healthy probes (and not be
  heartbeat-dead) before re-entering rotation — one lucky probe never
  re-admits a flapping host (``route_readmit``).

Forward path (``POST /predict``): one attempt per backend through the
named ``"route.forward"`` retry surface (``attempts=2`` — a connect
failure or backend 503 is retried on a SIBLING exactly once, with the
failed host excluded; predict is stateless/pure so the single re-send
is idempotent by construction).  Both attempts run under the
``"route.forward"`` fault point; the prober runs under
``"route.health"``.  When no live backend exists, or the sibling
retry also fails, the client gets a typed **503 + Retry-After** —
never a hang, never a silent drop: requests a backend ADMITTED are
the backend's no-drop contract; requests the router could not place
are whole-request retries for the caller.

``POST /generate`` adds three survivability layers on top:

- **Deadline/priority propagation.**  ``x-dk-deadline-s`` and
  ``x-dk-priority`` request headers forward verbatim to the backend,
  whose admission turns an infeasible deadline into a typed 503 at
  the door instead of a burned decode slot.
- **Hedged retries under a budget.**  A non-streaming ``/generate``
  still unanswered past the observed ``route.forward_s`` tail
  (``DK_ROUTE_HEDGE_QUANTILE``) launches ONE duplicate on a sibling;
  first complete answer wins and the loser is CANCELLED (the hedge
  hop runs the backend's streaming surface, so closing the loser's
  socket makes its next token write fail and the backend reclaims
  the slot + KV pages through its own cancel path).  A token-bucket
  budget (``DK_ROUTE_HEDGE_BUDGET`` tokens earned per request) caps
  hedges to a fraction of traffic — a brownout cannot be amplified
  into a retry storm (``route.hedges`` / ``route.hedge_wins`` /
  ``route.hedge_denied``).
- **Streaming relay with typed loss.**  ``stream: true`` bodies relay
  chunk-for-chunk; a backend dying MID-STREAM ends the response with
  a final typed NDJSON record ``{"error": "backend_stream_lost",
  "retryable": true}`` instead of a truncated stream
  (``route.stream_errors`` / ``route_stream_error``), and the death
  counts as forward evidence against the backend.

Tracing: the router parses the caller's ``traceparent``, opens one
``route.forward`` span, and forwards ITS traceparent to the backend —
whose ``serve.request`` span (and the batcher/replica stage spans
under it) then parents to the router's hop: one user request is ONE
stitched trace across router -> host -> replica, and the response
echoes the router's span for client-side correlation.

4xx/5xx semantics: backend 400/500/504 pass through verbatim (the
caller's bug / the backend's typed predict failure — a sibling would
fail the same way); only connect-level failures and backend 503s
(shedding load or draining) move the request to a sibling.
"""

from __future__ import annotations

import http.client
import json
import queue as _queue
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from dist_keras_tpu_torch.observability import events, spans
from dist_keras_tpu_torch.observability import metrics as _metrics
from dist_keras_tpu_torch.resilience import coordination, preemption
from dist_keras_tpu_torch.resilience import world as _world
from dist_keras_tpu_torch.resilience.faults import fault_point
from dist_keras_tpu_torch.resilience.retry import RetryPolicy
from dist_keras_tpu_torch.utils import knobs


def default_route_port(fallback=8080):
    """The port a launched router should bind: ``DK_ROUTE_PORT``
    (exported per host by ``launch.Job(route_port=...)``), else
    ``fallback``."""
    try:
        return int(knobs.raw("DK_ROUTE_PORT") or fallback)
    except ValueError:
        return fallback


class ForwardError(OSError):
    """One failed forward attempt to one backend — connect-level
    failure, or the backend shedding load (503).  Retryable on a
    SIBLING through the ``route.forward`` surface; the failed backend
    is excluded from the retry's pick."""

    def __init__(self, addr, reason):
        self.addr = addr
        self.reason = str(reason)
        super().__init__(f"forward to {addr} failed: {self.reason}")


class NoBackends(RuntimeError):
    """Typed routing failure: no live backend to place the request on
    (all evicted, or every candidate already excluded this request).
    The front end answers 503 + Retry-After — deliberately NOT
    retryable in-process: the caller's whole-request retry is the
    bounded one."""

    def __init__(self, live=0, total=0):
        self.live = int(live)
        self.total = int(total)
        super().__init__(
            f"no live backends ({live} live of {total} known)")


class _HedgeBudget:
    """Token-bucket retry budget for hedged requests: every forwarded
    request EARNS ``ratio`` tokens (capped at ``cap``), every hedge
    SPENDS one — so hedges are bounded to roughly ``ratio`` of traffic
    no matter how bad the tail gets, and a brownout can never be
    amplified into a retry storm (the classic hedged-request guard)."""

    def __init__(self, ratio=None, cap=10.0):
        self.ratio = float(ratio if ratio is not None
                           else knobs.get("DK_ROUTE_HEDGE_BUDGET"))
        self.cap = float(cap)
        self._tokens = self.cap   # a warm start: first hedges allowed
        self._lock = threading.Lock()

    def earn(self):
        with self._lock:
            self._tokens = min(self.cap, self._tokens + self.ratio)

    def try_spend(self):
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def tokens(self):
        with self._lock:
            return self._tokens


class _Backend:
    """Router-side view of one serving host (mutated only under the
    pool lock)."""

    __slots__ = ("addr", "rank", "live", "depth", "fails",
                 "heal_streak", "last_ok", "evicted_reason")

    def __init__(self, addr, rank=None):
        self.addr = str(addr)
        self.rank = rank
        self.live = True
        self.depth = None           # last known queue depth (None: blind)
        self.fails = 0              # consecutive connect/forward failures
        self.heal_streak = 0        # consecutive healthy probes while out
        self.last_ok = _world.monotonic()  # admission grace at birth
        self.evicted_reason = None


class BackendPool:
    """The routing policy core — membership, depth, eviction,
    re-admission.  Pure bookkeeping over the ``world`` clock seam (no
    sockets), so the cluster simulator exercises the exact policy the
    live router runs; :class:`RouterServer` owns the HTTP on both
    sides of it.

    Args:
      addrs: ``host:port`` backend addresses.
      ranks: optional per-backend pod ranks, aligning each backend
        with its heartbeat file when ``coord_dir`` is set (default:
        list position).
      fail_threshold / stale_s / readmit_checks: eviction and
        re-admission policy; default to the ``DK_ROUTE_*`` knobs.
      coord_dir / world_size / session: the pod's coordination dir —
        when set, ``sweep`` folds ``coordination.dead_peers_at``
        heartbeat evidence (beat once, went dark) into eviction and
        blocks re-admission of a heartbeat-dead rank.
    """

    def __init__(self, addrs, ranks=None, fail_threshold=None,
                 stale_s=None, readmit_checks=None, coord_dir=None,
                 world_size=None, session=None):
        addrs = [str(a) for a in addrs]
        if not addrs:
            raise ValueError("BackendPool needs at least one backend")
        if ranks is None:
            ranks = list(range(len(addrs)))
        self.fail_threshold = int(fail_threshold
                                  if fail_threshold is not None
                                  else knobs.get("DK_ROUTE_FAILS"))
        self.stale_s = float(stale_s if stale_s is not None
                             else knobs.get("DK_ROUTE_STALE_S"))
        self.readmit_checks = int(
            readmit_checks if readmit_checks is not None
            else knobs.get("DK_ROUTE_READMIT_CHECKS"))
        self.coord_dir = coord_dir
        self.world_size = (int(world_size) if world_size is not None
                           else len(addrs))
        self.session = session
        self._lock = threading.Lock()
        self._backends = {a: _Backend(a, rank=r)
                          for a, r in zip(addrs, ranks)}
        self._rr = 0
        self.evictions = 0
        self.readmissions = 0
        self._gauge_live = _metrics.gauge("route.backends_live")
        self._gauge_live.set(len(addrs))

    def addrs(self):
        with self._lock:
            return list(self._backends)

    # -- evidence intake ------------------------------------------------
    def note_probe(self, addr, healthy, depth=None):
        """Record one health-probe outcome (healthy + last known queue
        depth).  Healthy probes build an evicted backend's heal streak;
        unhealthy ones reset it and count toward the fail threshold."""
        transitions = []
        with self._lock:
            b = self._backends[addr]
            if healthy:
                b.last_ok = _world.monotonic()
                b.fails = 0
                b.depth = depth
                if not b.live:
                    b.heal_streak += 1
            else:
                b.depth = None
                b.heal_streak = 0
                b.fails += 1
                if b.live and b.fails >= self.fail_threshold:
                    transitions.append(self._evict_locked(
                        b, "consecutive_failures"))
        self._emit(transitions)

    def note_forward(self, addr, ok):
        """Record one forward outcome.  ``ok=False`` (connect-level
        failure) counts toward the fail threshold and evicts at it —
        the data path notices a dead host faster than the probe
        cadence."""
        transitions = []
        with self._lock:
            b = self._backends.get(addr)
            if b is None:
                return
            if ok:
                b.fails = 0
            else:
                b.heal_streak = 0
                b.fails += 1
                if b.live and b.fails >= self.fail_threshold:
                    transitions.append(self._evict_locked(
                        b, "consecutive_failures"))
        self._emit(transitions)

    def sweep(self):
        """One policy pass: evict on stale health / dead heartbeat,
        re-admit on a full heal streak.  The prober calls this once per
        round; the simulator calls it from scripted time."""
        dead_ranks = set()
        if self.coord_dir is not None:
            try:
                dead_ranks = set(coordination.dead_peers_at(
                    self.coord_dir, self.world_size,
                    stale_after_s=self.stale_s, require_file=True,
                    session=self.session))
            except OSError:
                dead_ranks = set()  # unreadable coord dir: no evidence
        transitions = []
        now = _world.monotonic()
        with self._lock:
            for b in self._backends.values():
                hb_dead = b.rank in dead_ranks
                if b.live:
                    if hb_dead:
                        transitions.append(self._evict_locked(
                            b, "heartbeat_dead"))
                    elif now - b.last_ok > self.stale_s:
                        transitions.append(self._evict_locked(
                            b, "stale_health"))
                elif (b.heal_streak >= self.readmit_checks
                        and not hb_dead):
                    b.live = True
                    b.evicted_reason = None
                    b.fails = 0
                    b.heal_streak = 0
                    self.readmissions += 1
                    transitions.append(("route_readmit", b.addr,
                                        "healed"))
            live = sum(1 for b in self._backends.values() if b.live)
            self._gauge_live.set(live)
        self._emit(transitions)

    def _evict_locked(self, b, reason):
        b.live = False
        b.depth = None
        b.heal_streak = 0
        b.evicted_reason = reason
        self.evictions += 1
        return ("route_evict", b.addr, reason)

    def _emit(self, transitions):
        # events + counters OUTSIDE the pool lock: the event writer and
        # counter leaf locks stay strictly independent of _lock
        for kind, addr, reason in transitions:
            if kind == "route_evict":
                _metrics.counter("route.evictions").inc()
            else:
                _metrics.counter("route.readmissions").inc()
            # dklint: events=route_evict,route_readmit
            events.emit(kind, backend=addr, reason=reason)

    # -- placement ------------------------------------------------------
    def pick(self, exclude=()):
        """-> the backend address to place a request on, or None when
        no live candidate remains.  Least-loaded by last known depth
        when EVERY candidate's depth is known; any blind candidate
        degrades the pick to round-robin (fair, never starving)."""
        with self._lock:
            cands = [b for b in self._backends.values()
                     if b.live and b.addr not in exclude]
            if not cands:
                return None
            if all(b.depth is not None for b in cands):
                best = min(b.depth for b in cands)
                cands = [b for b in cands if b.depth == best]
            pick = cands[self._rr % len(cands)]
            self._rr = (self._rr + 1) % max(
                1, len(self._backends))
            return pick.addr

    def live_count(self):
        with self._lock:
            return sum(1 for b in self._backends.values() if b.live)

    def snapshot(self):
        """JSON-ready per-backend state — the ``/metricsz`` payload."""
        with self._lock:
            return [{"addr": b.addr, "rank": b.rank, "live": b.live,
                     "depth": b.depth, "fails": b.fails,
                     "heal_streak": b.heal_streak,
                     "evicted_reason": b.evicted_reason}
                    for b in self._backends.values()]


class _Handler(BaseHTTPRequestHandler):
    server_version = "dk-route/0.1"
    protocol_version = "HTTP/1.1"
    # TCP_NODELAY: a streamed reply is one small write a token, and
    # Nagle holds each behind the peer's delayed ACK of the last
    disable_nagle_algorithm = True
    _trace_header = None  # per-request traceparent echo (do_POST sets it)

    def log_message(self, fmt, *args):  # quiet: the event log is the log
        pass

    def _reply(self, code, payload, retry_after=None):
        self._reply_text(code, json.dumps(payload), "application/json",
                         retry_after=retry_after)

    def _reply_bytes(self, code, body, content_type, retry_after=None,
                     trace=None):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if retry_after is not None:
            self.send_header("Retry-After", str(retry_after))
        if trace is None:
            trace = self._trace_header
        if trace is not None:
            # response names the route.forward hop the caller's trace
            # continued into — same correlation contract as the backend
            self.send_header("traceparent", trace)
        self.end_headers()
        self.wfile.write(body)

    def _reply_text(self, code, text, content_type, retry_after=None):
        self._reply_bytes(code, text.encode("utf-8"), content_type,
                          retry_after=retry_after)

    def do_GET(self):
        srv = self.server
        self._trace_header = None  # keep-alive: no stale POST echo
        path, _, query = self.path.partition("?")
        if path == "/healthz":
            live = srv.pool.live_count()
            if srv.draining:
                self._reply(503, {"status": "draining"})
            else:
                self._reply(200, {"status": "routing",
                                  "backends_live": live,
                                  "backends": len(srv.pool.addrs())})
        elif path == "/metricsz":
            if "format=prometheus" in query:
                from dist_keras_tpu_torch.observability import prometheus

                self._reply_text(
                    200, prometheus.render(extra_gauges={
                        "route.pool.live": srv.pool.live_count()}),
                    prometheus.CONTENT_TYPE)
            else:
                self._reply(200, {"router": srv.pool.snapshot(),
                                  "registry": _metrics.snapshot()})
        elif path == "/statusz":
            from dist_keras_tpu_torch.observability import statusz

            self._reply_text(
                200,
                statusz.render(extra={"router": srv.pool.snapshot()}),
                "application/json")
        elif path == "/tracez":
            from dist_keras_tpu_torch.observability import flight

            self._reply_text(200, json.dumps(flight.tracez_doc(),
                                             default=str),
                             "application/json")
        else:
            self._reply(404, {"error": "not_found", "path": self.path})

    def do_POST(self):
        srv = self.server
        self._trace_header = None
        # body FIRST, unconditionally — replying before consuming it
        # would poison the keep-alive connection's framing
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        path = self.path.split("?")[0]
        if path not in ("/predict", "/generate"):
            self._reply(404, {"error": "not_found", "path": self.path})
            return
        if srv.draining:
            self._reply(503, {"error": "draining"}, retry_after=1)
            return
        _metrics.counter("route.requests").inc()
        # end-to-end deadline + priority ride headers across the hop
        # (the body forwards verbatim, so headers are the only channel
        # that survives without a rewrite)
        fwd_headers = {}
        for h in ("x-dk-deadline-s", "x-dk-priority"):
            v = self.headers.get(h)
            if v is not None:
                fwd_headers[h] = v
        # the forward hop runs under ONE route.forward span continuing
        # the caller's trace; the traceparent sent DOWN names this span,
        # so the backend's serve.request parents to the router's hop —
        # one stitched trace across router -> host -> replica
        ctx = spans.parse_traceparent(self.headers.get("traceparent"))
        with spans.resume(ctx):
            with spans.span("route.forward", n_bytes=len(body)):
                self._trace_header = spans.traceparent()
                if path == "/generate" and _wants_stream(body):
                    # streaming relay replies chunked from inside —
                    # including the typed final record on backend loss
                    srv.relay_stream(self, body, headers=fwd_headers)
                    return
                if path == "/generate":
                    code, payload, ctype, retry_after = \
                        srv.forward_generate(body, headers=fwd_headers)
                else:
                    code, payload, ctype, retry_after = srv.forward(
                        body, path=path, headers=fwd_headers)
        self._reply_bytes(code, payload, ctype, retry_after=retry_after)


def _wants_stream(body):
    """True when a ``/generate`` body asks for token streaming (a
    bare token list never does; unparseable bodies fall through to
    the buffered path, whose backend will 400 them typed)."""
    try:
        doc = json.loads(body.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return False
    return isinstance(doc, dict) and bool(doc.get("stream", False))


class RouterServer(ThreadingHTTPServer):
    """Threaded HTTP router over one :class:`BackendPool`.

    ``backends`` is the ``host:port`` list (or a prebuilt pool via
    ``pool=``); ``port=None`` binds :func:`default_route_port` (the
    ``DK_ROUTE_PORT`` launch export), ``port=0`` picks a free one.
    Lifecycle mirrors :class:`~.server.ServingServer`: ``start()`` /
    ``install_signal_drain()`` / ``drain()`` / ``run_forever()`` /
    ``close()``.
    """

    daemon_threads = True

    def __init__(self, backends=(), host="127.0.0.1", port=0,
                 pool=None, probe_s=None, forward_timeout_s=30.0,
                 probe_timeout_s=1.0, **pool_kw):
        self.pool = pool if pool is not None \
            else BackendPool(backends, **pool_kw)
        self.probe_s = float(probe_s if probe_s is not None
                             else knobs.get("DK_ROUTE_PROBE_S"))
        self.forward_timeout_s = float(forward_timeout_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.preempted_signum = None
        self.draining = False
        self._stop_watch = None
        self._thread = None
        self._probe_thread = None
        self._probe_stop = threading.Event()
        self._retry = RetryPolicy(
            attempts=2, backoff=0.02, jitter=0.0,
            retryable=(ForwardError,), name="route.forward")
        self._m_forward = _metrics.histogram("route.forward_s")
        self._hedge_budget = _HedgeBudget()
        # lifecycle guard: BaseServer.shutdown() BLOCKS FOREVER unless
        # serve_forever is actually running — same hazard and cure as
        # ServingServer
        self._lifecycle = threading.Lock()
        self._serving = False
        self._stopping = False
        if port is None:
            port = default_route_port(fallback=0)
        super().__init__((host, int(port)), _Handler)

    @property
    def address(self):
        """(host, bound_port) — port resolved after bind."""
        return self.server_address[:2]

    # -- forwarding -----------------------------------------------------
    def forward(self, body, path="/predict", headers=None):
        """Place one ``/predict`` or ``/generate`` body on a live
        backend; -> (status, body bytes, content type, retry_after).
        Connect failures and backend 503s burn the attempt and move to
        a SIBLING (excluded set) through the ``route.forward`` retry
        surface — at most one re-send, idempotent because an admission
        either lands whole or is typed-rejected at the backend's door
        (``/generate`` included: a 503 ``kv_exhausted`` moves the
        request to a sibling with free pages).  Exhaustion and an empty
        pool are typed 503 + Retry-After.  ``headers`` carries hop
        headers (``x-dk-deadline-s`` / ``x-dk-priority``) verbatim.
        Non-streaming ``/generate`` goes through
        :meth:`forward_generate` (hedging); ``stream: true`` bodies
        through :meth:`relay_stream` (chunk-for-chunk with a typed
        final record on backend loss)."""
        t0 = _world.monotonic()
        excluded = set()

        def attempt():
            fault_point("route.forward")
            addr = self.pool.pick(exclude=excluded)
            if addr is None:
                raise NoBackends(live=self.pool.live_count(),
                                 total=len(self.pool.addrs()))
            hdrs = {"Content-Type": "application/json"}
            hdrs.update(headers or {})
            tp = spans.traceparent()  # None with tracing off
            if tp is not None:
                hdrs["traceparent"] = tp
            req = urllib.request.Request(
                f"http://{addr}{path}", data=body, method="POST",
                headers=hdrs)
            try:
                with urllib.request.urlopen(
                        req, timeout=self.forward_timeout_s) as resp:
                    code, data = resp.status, resp.read()
                    ctype = resp.headers.get("Content-Type",
                                             "application/json")
                    retry_after = resp.headers.get("Retry-After")
            except urllib.error.HTTPError as e:
                # an HTTP status IS a backend answer, not a transport
                # failure — read it fully (keep-alive framing)
                code, data = e.code, e.read()
                ctype = e.headers.get("Content-Type",
                                      "application/json")
                retry_after = e.headers.get("Retry-After")
            except (OSError, urllib.error.URLError) as e:
                # connect-level failure: evidence against the backend,
                # sibling retry for the request
                self.pool.note_forward(addr, ok=False)
                excluded.add(addr)
                raise ForwardError(addr, e) from e
            self.pool.note_forward(addr, ok=True)
            if code == 503:
                # the backend is shedding load or draining — reachable
                # (no eviction evidence), but this REQUEST moves on
                excluded.add(addr)
                raise ForwardError(addr, "backend 503")
            return code, data, ctype, retry_after

        try:
            code, data, ctype, retry_after = self._retry.call(attempt)
        except NoBackends as e:
            _metrics.counter("route.errors").inc()
            return (503, json.dumps(
                {"error": "no_backends", "live": e.live,
                 "total": e.total}).encode("utf-8"),
                "application/json", 1)
        except ForwardError as e:
            # both attempts burned (retry_exhausted already recorded on
            # the surface): typed 503, the caller's whole-request retry
            _metrics.counter("route.errors").inc()
            return (503, json.dumps(
                {"error": "backends_unavailable",
                 "detail": str(e)[:200]}).encode("utf-8"),
                "application/json", 1)
        finally:
            self._m_forward.observe(_world.monotonic() - t0)
        return code, data, ctype, retry_after

    # -- hedged /generate -----------------------------------------------
    def _hedge_delay(self):
        """Seconds to wait before hedging, or None when hedging is
        ineligible: the knob disables it, or too few ``route.forward_s``
        samples exist to trust a tail estimate (an uninformed hedge is
        just a doubled request)."""
        q = float(knobs.get("DK_ROUTE_HEDGE_QUANTILE"))
        if q <= 0:
            return None
        s = self._m_forward.summary()
        if s["count"] < 20:
            return None
        q = min(max(q, 0.5), 0.999)
        return s["p99"] if q >= 0.99 else s["p95"]

    def forward_generate(self, body, headers=None):
        """Non-streaming ``/generate``: the hedged path when the
        tail-latency evidence, a live sibling and the retry budget all
        allow it, else the plain :meth:`forward`."""
        self._hedge_budget.earn()
        delay = self._hedge_delay()
        if delay is None or self.pool.live_count() < 2:
            return self.forward(body, path="/generate",
                                headers=headers)
        try:
            doc = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            doc = None
        if not isinstance(doc, dict) or "tokens" not in doc:
            # bare-list or malformed bodies: the buffered path's
            # backend answers them typed (200 or 400)
            return self.forward(body, path="/generate",
                                headers=headers)
        return self._hedged_generate(doc, headers, delay)

    def _hedged_generate(self, doc, headers, delay):
        """Race a primary against (at most) one budget-gated hedge.
        Both attempts run the BACKEND's streaming surface — the body is
        rewritten to ``stream: true`` and the NDJSON reassembled into
        the batched result doc — because a buffered ``/generate`` hop
        cannot be cancelled: the backend handler sits in
        ``gen.result()`` until the doc is done whether anyone is
        listening or not.  On the streaming surface, closing the
        loser's socket makes its next token write fail, and the
        backend's own disconnect path cancels the generation (slot and
        KV pages reclaim).  First complete answer wins."""
        t0 = _world.monotonic()
        sdoc = dict(doc)
        sdoc["stream"] = True
        sbody = json.dumps(sdoc).encode("utf-8")
        try:
            prompt = [int(t) for t in doc.get("tokens", [])]
        except (TypeError, ValueError):
            prompt = []
        resq = _queue.Queue()
        conns = []
        conns_lock = threading.Lock()
        settled = threading.Event()   # a winner exists: losers hush
        # read on the calling thread, inside its route.forward span: the
        # attempt threads below have no span context of their own (the
        # JAX package's copy reads it there, and its hedged hops start
        # fresh traces)
        tp = spans.traceparent()

        def run(addr, hedge):
            host, _, port = addr.rpartition(":")
            conn = http.client.HTTPConnection(
                host, int(port), timeout=self.forward_timeout_s)
            with conns_lock:
                conns.append(conn)
            try:
                hdrs = {"Content-Type": "application/json"}
                hdrs.update(headers or {})
                if tp is not None:
                    hdrs["traceparent"] = tp
                conn.request("POST", "/generate", sbody, hdrs)
                resp = conn.getresponse()
                if resp.status != 200:
                    data = resp.read()
                    if resp.status == 503:
                        # backend shedding: a failed attempt, the
                        # other arm (or the sibling retry) decides
                        resq.put(("err", ForwardError(addr,
                                                      "backend 503"),
                                  addr, hedge))
                    else:
                        # a non-503 status IS an answer: verbatim
                        resq.put(("http", (resp.status, data,
                                           resp.headers.get(
                                               "Content-Type",
                                               "application/json"),
                                           resp.headers.get(
                                               "Retry-After")),
                                  addr, hedge))
                    return
                toks = []
                final = None
                while True:
                    line = resp.readline()
                    if not line:
                        break
                    rec = json.loads(line)
                    if "token" in rec:
                        toks.append(int(rec["token"]))
                    if rec.get("done"):
                        final = rec
                        break
                if final is None:
                    raise ForwardError(addr, "stream truncated")
                self.pool.note_forward(addr, ok=True)
                if "error" in final:
                    # the backend's typed decode failure: an answer,
                    # not transport loss — map like _generate's 500
                    resq.put(("http", (500, json.dumps(
                        {"error": final["error"],
                         "detail": final.get("detail", "")}
                    ).encode("utf-8"), "application/json", None),
                        addr, hedge))
                    return
                out = {"tokens": prompt + toks, "generated": toks,
                       "prompt_len": final.get("prompt_len"),
                       "steps": final.get("steps"),
                       "ttft_s": final.get("ttft_s"),
                       "finish": final.get("finish"),
                       "recoveries": final.get("recoveries")}
                resq.put(("ok", out, addr, hedge))
            except (OSError, http.client.HTTPException,
                    ValueError) as e:
                if settled.is_set():
                    return   # cancelled loser: not evidence
                self.pool.note_forward(addr, ok=False)
                resq.put(("err", e, addr, hedge))
            except AttributeError:
                # closing a loser's connection under its blocked read
                # leaves http.client's response without a file object;
                # the JAX package's copy lets this escape the thread
                if not settled.is_set():
                    raise
            finally:
                conn.close()

        primary = self.pool.pick()
        if primary is None:
            _metrics.counter("route.errors").inc()
            return (503, json.dumps(
                {"error": "no_backends",
                 "live": self.pool.live_count(),
                 "total": len(self.pool.addrs())}).encode("utf-8"),
                "application/json", 1)
        attempted = {primary}
        threading.Thread(target=run, args=(primary, False),
                         daemon=True).start()
        inflight = 1
        got = None
        try:
            got = resq.get(timeout=delay)
        except _queue.Empty:
            hedge_addr = self.pool.pick(exclude=attempted)
            if hedge_addr is not None \
                    and self._hedge_budget.try_spend():
                _metrics.counter("route.hedges").inc()
                events.emit("route_hedge", primary=primary,
                            hedge=hedge_addr,
                            delay_s=round(delay, 6))
                attempted.add(hedge_addr)
                threading.Thread(target=run,
                                 args=(hedge_addr, True),
                                 daemon=True).start()
                inflight = 2
            elif hedge_addr is not None:
                _metrics.counter("route.hedge_denied").inc()
        win = None
        answer = None
        last_err = None
        retried = False
        deadline = t0 + self.forward_timeout_s
        while True:
            if got is not None:
                kind = got[0]
                if kind == "ok":
                    win = got
                    break
                if kind == "http":
                    answer = got
                    break
                inflight -= 1
                last_err = got[1]
                got = None
                if inflight == 0:
                    if not retried:
                        # the plain path's sibling re-send, preserved:
                        # a fast connect failure must not end the
                        # request just because hedging was armed
                        retried = True
                        sib = self.pool.pick(exclude=attempted)
                        if sib is not None:
                            attempted.add(sib)
                            threading.Thread(
                                target=run, args=(sib, False),
                                daemon=True).start()
                            inflight = 1
                            continue
                    break
                continue
            rem = deadline - _world.monotonic()
            if rem <= 0:
                break
            try:
                got = resq.get(timeout=rem)
            except _queue.Empty:
                break
        settled.set()
        with conns_lock:
            for c in conns:
                # closing a loser's socket IS its cancellation: the
                # backend's next token write fails and its disconnect
                # path frees the slot + KV pages
                c.close()
        self._m_forward.observe(_world.monotonic() - t0)
        if win is not None:
            _, out, addr, was_hedge = win
            if was_hedge:
                _metrics.counter("route.hedge_wins").inc()
            return (200, json.dumps(out).encode("utf-8"),
                    "application/json", None)
        if answer is not None:
            return answer[1]
        _metrics.counter("route.errors").inc()
        detail = (str(last_err)[:200] if last_err is not None
                  else "hedged generate timed out")
        return (503, json.dumps(
            {"error": "backends_unavailable",
             "detail": detail}).encode("utf-8"),
            "application/json", 1)

    # -- streaming relay ------------------------------------------------
    def relay_stream(self, handler, body, headers=None):
        """Relay a ``stream: true`` ``/generate`` chunk-for-chunk.
        Pre-byte failures (connect, backend 503) move to a sibling
        with the same evidence accounting as :meth:`forward`; once
        token bytes have flowed the request is pinned to its backend —
        a backend dying MID-STREAM ends the response with a final
        typed NDJSON record (``{"error": "backend_stream_lost",
        "retryable": true}``) so the client sees a typed, resumable
        loss instead of a truncated stream.  Replies directly through
        ``handler`` (chunked)."""
        t0 = _world.monotonic()
        excluded = set()
        resp = None
        addr = None
        for _ in range(2):
            try:
                fault_point("route.forward")
            # dklint: ignore[broad-except] an injected route.forward fault burns this attempt; exhaustion is a typed 503
            except Exception:
                excluded.add(f"fault-{len(excluded)}")
                continue
            addr = self.pool.pick(exclude=excluded)
            if addr is None:
                break
            hdrs = {"Content-Type": "application/json"}
            hdrs.update(headers or {})
            tp = spans.traceparent()
            if tp is not None:
                hdrs["traceparent"] = tp
            req = urllib.request.Request(
                f"http://{addr}/generate", data=body, method="POST",
                headers=hdrs)
            try:
                resp = urllib.request.urlopen(
                    req, timeout=self.forward_timeout_s)
                break
            except urllib.error.HTTPError as e:
                data = e.read()
                if e.code == 503:
                    excluded.add(addr)   # shedding: sibling retry
                    continue
                handler._reply_bytes(     # an answer: verbatim
                    e.code, data,
                    e.headers.get("Content-Type", "application/json"),
                    retry_after=e.headers.get("Retry-After"))
                self._m_forward.observe(_world.monotonic() - t0)
                return
            except (OSError, urllib.error.URLError):
                self.pool.note_forward(addr, ok=False)
                excluded.add(addr)
                continue
        if resp is None:
            _metrics.counter("route.errors").inc()
            handler._reply(503, {"error": "backends_unavailable",
                                 "live": self.pool.live_count(),
                                 "total": len(self.pool.addrs())},
                           retry_after=1)
            self._m_forward.observe(_world.monotonic() - t0)
            return
        self.pool.note_forward(addr, ok=True)
        handler.send_response(200)
        handler.send_header("Content-Type", "application/x-ndjson")
        handler.send_header("Transfer-Encoding", "chunked")
        if handler._trace_header is not None:
            handler.send_header("traceparent", handler._trace_header)
        handler.end_headers()

        def chunk(data):
            handler.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
            handler.wfile.flush()

        try:
            saw_done = False
            while True:
                try:
                    line = resp.readline()
                    if not line:
                        # chunked readline() swallows a mid-framing
                        # close as plain EOF (IncompleteRead is eaten
                        # by peek) — EOF without a ``done`` record IS
                        # the truncation signal
                        err = None if saw_done else "eof"
                except (OSError, http.client.HTTPException) as e:
                    err = type(e).__name__
                    line = b""
                if not line:
                    if err is not None:
                        # the backend died mid-stream: typed final
                        # record + forward evidence against it — never
                        # a silently truncated stream
                        self.pool.note_forward(addr, ok=False)
                        _metrics.counter("route.stream_errors").inc()
                        events.emit("route_stream_error", backend=addr,
                                    error=err)
                        chunk((json.dumps(
                            {"done": True,
                             "error": "backend_stream_lost",
                             "backend": addr, "retryable": True})
                            + "\n").encode("utf-8"))
                    break
                saw_done = saw_done or b'"done"' in line
                chunk(line)
            handler.wfile.write(b"0\r\n\r\n")
        except OSError:
            # OUR client went away mid-relay: closing the backend
            # response (finally) propagates the cancel downstream —
            # the backend's disconnect path frees the slot + pages
            pass
        finally:
            resp.close()
            self._m_forward.observe(_world.monotonic() - t0)

    # -- health probing -------------------------------------------------
    def probe_once(self):
        """One probe round over every backend + a policy sweep (the
        background loop's body; tests and the drain path call it
        directly)."""
        for addr in self.pool.addrs():
            healthy, depth = self._probe_backend(addr)
            self.pool.note_probe(addr, healthy, depth=depth)
        self.pool.sweep()

    def _probe_backend(self, addr):
        """-> (healthy, queue_depth_or_None).  A malformed or missing
        /metricsz leaves depth None — the pool degrades that backend's
        pick to round-robin rather than judging it on garbage."""
        try:
            fault_point("route.health")
            with urllib.request.urlopen(
                    f"http://{addr}/healthz",
                    timeout=self.probe_timeout_s) as resp:
                healthy = resp.status == 200
        # dklint: ignore[broad-except] probe failure (incl. injected route.health faults) IS the unhealthy verdict
        except Exception:
            return False, None
        if not healthy:
            return False, None
        try:
            with urllib.request.urlopen(
                    f"http://{addr}/metricsz",
                    timeout=self.probe_timeout_s) as resp:
                doc = json.loads(resp.read().decode("utf-8"))
            depth = doc["engine"]["outstanding"]
            if not isinstance(depth, (int, float)) \
                    or isinstance(depth, bool):
                raise ValueError("non-numeric depth")
            return True, int(depth)
        # dklint: ignore[broad-except] malformed metricsz degrades to depth-blind round-robin, never an eviction
        except Exception:
            return True, None

    def _health_loop(self):
        while not self._probe_stop.is_set():
            self.probe_once()
            self._probe_stop.wait(self.probe_s)

    # -- lifecycle ------------------------------------------------------
    def serve_forever(self, poll_interval=0.5):
        with self._lifecycle:
            if self._stopping:
                return  # a drain/close already won the race: stay down
            self._serving = True
        try:
            super().serve_forever(poll_interval)
        finally:
            with self._lifecycle:
                self._serving = False

    def _stop_listener(self):
        with self._lifecycle:
            self._stopping = True
            serving = self._serving
        if serving:
            self.shutdown()
        self.server_close()

    def start(self):
        """Serve + probe on background threads; -> (host, port)."""
        from dist_keras_tpu_torch.observability import timeseries

        timeseries.maybe_start_sampler()
        self._probe_stop.clear()
        self._probe_thread = threading.Thread(
            target=self._health_loop, daemon=True,
            name="dk-route-health")
        self._probe_thread.start()
        self._thread = threading.Thread(
            target=self.serve_forever, daemon=True, name="dk-route-http")
        self._thread.start()
        events.emit("serve_listen", host=self.address[0],
                    port=self.address[1], role="router")
        return self.address

    def install_signal_drain(self, poll_s=0.05):
        """SIGTERM/SIGINT -> graceful drain via ``resilience.
        preemption`` (flag-only handler + watcher thread), exactly like
        :meth:`ServingServer.install_signal_drain`."""
        installed = preemption.install(strict=False)
        self._stop_watch = preemption.on_request(self._drain_on_signal,
                                                 poll_s=poll_s)
        return installed

    def _drain_on_signal(self, signum):
        self.preempted_signum = signum
        events.emit("serve_drain_signal", signum=signum, role="router")
        self.drain()

    def drain(self):
        """Stop admitting (``/predict`` and ``/healthz`` answer typed
        503s), stop the prober, stop the listener.  In-flight forwards
        finish on their handler threads; the router holds no queue of
        its own, so there is nothing to flush — admitted requests live
        in the BACKENDS' no-drop contract."""
        self.draining = True
        events.emit("serve_drain_begin", role="router")
        self._stop_probe()
        self._stop_listener()
        events.emit("serve_drain", role="router")
        from dist_keras_tpu_torch.observability import flight, timeseries

        # same end-of-life telemetry contract as ServingServer.drain:
        # flush undecided retention buffers (route.forward traces) and
        # run one final sampler tick so an incident landing just
        # before the drain still fires its SLO evaluation
        flight.retain_flush()
        sampler = timeseries.get_sampler()
        if sampler is not None:
            sampler.tick()
            if sampler.watchdog is not None:
                sampler.watchdog.quiesce()

    def _stop_probe(self):
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5)

    def run_forever(self):
        """Serve on the CALLING thread until stopped; re-raises
        :class:`Preempted` after a signal drain (exit ``128+signum``,
        the scheduler convention)."""
        from dist_keras_tpu_torch.observability import timeseries

        timeseries.maybe_start_sampler()
        if self._probe_thread is None \
                or not self._probe_thread.is_alive():
            self._probe_stop.clear()
            self._probe_thread = threading.Thread(
                target=self._health_loop, daemon=True,
                name="dk-route-health")
            self._probe_thread.start()
        try:
            self.serve_forever()
        finally:
            self.server_close()
        if self.preempted_signum is not None:
            raise preemption.Preempted(self.preempted_signum)

    def close(self):
        if self._stop_watch is not None:
            self._stop_watch()
        self._stop_probe()
        self._stop_listener()


def main(argv=None):
    """CLI: ``python -m dist_keras_tpu_torch.serving.router`` — backends
    from ``DK_ROUTE_BACKENDS`` (or ``--backends host:port,...``), port
    from ``DK_ROUTE_PORT`` (or ``--port``); serves until SIGTERM, then
    drains and exits ``128+signum``.  This is the entry point
    ``launch.Job(route_port=...)`` wires per pod."""
    import argparse

    ap = argparse.ArgumentParser(prog="dist_keras_tpu_torch.serving.router")
    ap.add_argument("--backends", default=None,
                    help="comma-separated host:port list "
                         "(default: DK_ROUTE_BACKENDS)")
    ap.add_argument("--port", type=int, default=None,
                    help="bind port (default: DK_ROUTE_PORT, else 8080)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--coord-dir", default=None,
                    help="pod coordination dir for heartbeat evidence")
    ap.add_argument("--world-size", type=int, default=None)
    args = ap.parse_args(argv)
    raw = args.backends or knobs.raw("DK_ROUTE_BACKENDS") or ""
    backends = [a.strip() for a in raw.split(",") if a.strip()]
    if not backends:
        ap.error("no backends: pass --backends or set "
                 "DK_ROUTE_BACKENDS")
    srv = RouterServer(
        backends, host=args.host,
        port=args.port if args.port is not None
        else default_route_port(),
        coord_dir=args.coord_dir, world_size=args.world_size)
    srv.install_signal_drain()
    events.emit("serve_listen", host=srv.address[0],
                port=srv.address[1], role="router")
    srv.run_forever()  # starts the prober itself; foreground serve
    return 0


if __name__ == "__main__":  # pragma: no cover - CLI entry
    raise SystemExit(main())
