"""Stdlib-only HTTP front end for the serving engines.

Counterpart of ``serving/server.py``.  Endpoints:

- ``POST /predict`` — body ``{"rows": [[...], ...]}`` (or a bare JSON
  list of rows) against a :class:`~.engine.ServingEngine`; answers
  ``{"predictions": [[...], ...], "n": N}``.  Typed failure mapping:
  :class:`Overloaded` -> **503** with ``Retry-After``, a row of the
  wrong shape or a bad body -> **400**, a predict error -> **500**
  naming its type, a response outliving ``request_timeout_s`` ->
  **504**.  Rejected requests are rejected at the door; admitted ones
  are always answered.  A decode backend answers **501**.
- ``POST /generate`` — autoregressive decode against a
  :class:`~.decode.DecodeEngine`: body ``{"tokens": [...],
  "max_new_tokens": N, "eos_id": E, "stream": bool, "deadline_s": S,
  "priority": "interactive" | "batch"}`` (or a bare token list);
  ``deadline_s`` / ``priority`` may also come as the ``x-dk-deadline-s``
  / ``x-dk-priority`` headers (the body wins).  Batched replies return
  the engine's result doc; ``stream: true`` answers chunked NDJSON, one
  ``{"i", "token"}`` line per token and a final ``{"done": true, ...}``
  line as soon as the generation resolves (the JAX package's copy
  waits out a 0.05 s poll first).  The same typed mapping (503 incl. ``kv_exhausted``,
  ``shed_batch`` and ``deadline_infeasible``; 400; 500; 504 — a
  timed-out generation is cancelled so its KV pages free at once); a
  predict backend answers **501**.
- ``GET /healthz`` — **200** ``{"status": "serving"}`` while accepting;
  **503** ``{"status": "draining"}`` once drain began.
- ``GET /metricsz`` — the engine's stats plus the process metrics
  registry snapshot, JSON; ``?format=prometheus`` answers the text
  exposition (``observability/prometheus.py``) with the engine's numeric
  stats as ``dk_serve_engine_*`` gauges.
- ``GET /statusz`` — the shared build / knobs / open-span / SLO document
  (``observability/statusz.py``) plus an ``engine`` section.
- ``GET /tracez`` — the flight recorder's ring (``observability/flight.py``).

``start()`` and ``run_forever()`` arm the live-telemetry plane
(``timeseries.maybe_start_sampler``: the sampler under
``DK_OBS_SAMPLE_S``, the exporter under ``DK_METRICS_PORT``);
``drain()`` flushes trace retention and ticks the sampler one last time.

Tracing: both POST routes honour an incoming ``traceparent`` header
(W3C ``00-<trace>-<span>-01``); the request runs under one
``serve.request`` (``/predict``) or ``serve.generate`` (``/generate``)
span continuing the caller's trace, and the reply echoes a
``traceparent`` naming that span.

Graceful drain rides ``resilience.preemption``:
:meth:`ServingServer.install_signal_drain` installs the flag-only
SIGTERM/SIGINT handler, a watcher thread notices the flag and drains
the engine (every admitted request delivered, new ones 503) and stops
the listener; :meth:`ServingServer.run_forever` then re-raises
:class:`~..resilience.preemption.Preempted`, so the process exits
``128 + signum``.
"""

from __future__ import annotations

import concurrent.futures
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from dist_keras_tpu_torch.observability import events, spans
from dist_keras_tpu_torch.observability import metrics as _metrics
from dist_keras_tpu_torch.resilience import preemption
from dist_keras_tpu_torch.serving.engine import Overloaded
from dist_keras_tpu_torch.utils import knobs

def default_port(fallback=8000):
    """The port a launched serving job should bind: ``DK_SERVE_PORT``,
    else ``fallback``."""
    try:
        return int(knobs.raw("DK_SERVE_PORT") or fallback)
    except ValueError:
        return fallback


_STREAM_END = object()   # queued when a streamed generation resolves
_STREAM_POLL_S = 0.05    # a stream's deadline check between tokens


class _Handler(BaseHTTPRequestHandler):
    server_version = "dk-serve-torch/0.1"
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

    def _reply_text(self, code, text, content_type, retry_after=None):
        body = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if retry_after is not None:
            self.send_header("Retry-After", str(retry_after))
        if self._trace_header is not None:
            # the response names the span the caller's trace continued
            # into, so a client log line and a server trace correlate
            self.send_header("traceparent", self._trace_header)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        srv = self.server
        self._trace_header = None  # keep-alive: no stale POST echo
        path, _, query = self.path.partition("?")
        if path == "/healthz":
            if srv.engine.draining or not srv.engine.running:
                self._reply(503, {"status": "draining"})
            else:
                st = srv.engine.stats()
                self._reply(200, {"status": "serving",
                                  "replicas": st["replicas"],
                                  "pending": st["pending"]})
        elif path == "/metricsz":
            if "format=prometheus" in query:
                # the scrape-plane view: registry exposition + the
                # engine's numeric stats as dk_serve_engine_* gauges —
                # the same rendering the standalone exporter serves
                from dist_keras_tpu_torch.observability import prometheus

                extras = {
                    f"serve.engine.{k}": v
                    for k, v in srv.engine.stats().items()
                    if isinstance(v, (int, float))
                    and not isinstance(v, bool)}
                self._reply_text(
                    200, prometheus.render(extra_gauges=extras),
                    prometheus.CONTENT_TYPE)
            else:
                self._reply(200, {"engine": srv.engine.stats(),
                                  "registry": _metrics.snapshot()})
        elif path == "/statusz":
            from dist_keras_tpu_torch.observability import statusz

            self._reply_text(
                200, statusz.render(extra={"engine": srv.engine.stats()}),
                "application/json")
        elif path == "/tracez":
            # default=str: ring records hold the pre-serialization
            # field values (numpy scalars and friends included)
            from dist_keras_tpu_torch.observability import flight

            self._reply_text(200, json.dumps(flight.tracez_doc(),
                                             default=str),
                             "application/json")
        else:
            self._reply(404, {"error": "not_found", "path": self.path})

    def _read_json(self):
        n = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(n).decode("utf-8"))

    def do_POST(self):
        srv = self.server
        self._trace_header = None
        path = self.path.split("?")[0]
        if path == "/generate":
            self._handle_generate(srv)
            return
        if path != "/predict":
            self._reply(404, {"error": "not_found", "path": self.path})
            return
        if not hasattr(srv.engine, "submit"):
            self._reply(501, {
                "error": "not_implemented",
                "detail": "this backend serves a DecodeEngine; /predict "
                          "needs a fixed-shape ServingEngine"})
            return
        try:
            doc = self._read_json()
            rows = doc["rows"] if isinstance(doc, dict) else doc
            rows = [np.asarray(r, dtype=np.float32) for r in rows]
            if not rows:
                raise ValueError("empty rows")
        except (ValueError, KeyError, TypeError) as e:
            self._reply(400, {"error": "bad_request",
                              "detail": str(e)[:200]})
            return
        # admission, queue wait, batching, in flight and the reply all
        # run under ONE serve.request span continuing the caller's trace
        # (a malformed header degrades to a fresh root, never a 4xx)
        ctx = spans.parse_traceparent(self.headers.get("traceparent"))
        with spans.resume(ctx):
            with spans.span("serve.request", n=len(rows)):
                self._trace_header = spans.traceparent()
                code, payload, retry_after = self._predict(srv, rows)
                self._reply(code, payload, retry_after=retry_after)

    def _predict(self, srv, rows):
        """Admission + result gathering -> (status, payload,
        retry_after) with the engine's typed failure mapping."""
        try:
            futs = [srv.engine.submit(r) for r in rows]
        except Overloaded as e:
            # rows admitted before the rejection still complete inside
            # the engine (rejected-not-lost); the caller retries whole
            return 503, {"error": "overloaded", "reason": e.reason,
                         "pending": e.pending,
                         "capacity": e.capacity}, 1
        except ValueError as e:  # row shape mismatch: the CALLER's bug
            return 400, {"error": "bad_request",
                         "detail": str(e)[:200]}, None
        # dklint: ignore[broad-except] an admission error (the enqueue fault)
        # maps to a typed 500
        except Exception as e:  # noqa: BLE001
            return 500, {"error": type(e).__name__,
                         "detail": str(e)[:200]}, None
        try:
            deadline = time.monotonic() + srv.request_timeout_s
            preds = [f.result(timeout=max(0.0,
                                          deadline - time.monotonic()))
                     for f in futs]
        except (TimeoutError, concurrent.futures.TimeoutError):
            return 504, {"error": "timeout",
                         "timeout_s": srv.request_timeout_s}, None
        # dklint: ignore[broad-except] a predict error maps to a typed 500
        # naming the type
        except Exception as e:  # noqa: BLE001
            return 500, {"error": type(e).__name__,
                         "detail": str(e)[:200]}, None
        return 200, {
            "predictions": [np.asarray(p).tolist() for p in preds],
            "n": len(preds)}, None

    # -- decode serving (POST /generate) -------------------------------
    def _handle_generate(self, srv):
        if not hasattr(srv.engine, "submit_generate"):
            self._reply(501, {
                "error": "not_implemented",
                "detail": "this backend serves a fixed-shape predict "
                          "engine; /generate needs a DecodeEngine"})
            return
        try:
            doc = self._read_json()
            if isinstance(doc, list):
                doc = {"tokens": doc}
            tokens = [int(t) for t in doc["tokens"]]
            max_new = doc.get("max_new_tokens")
            eos_id = doc.get("eos_id")
            stream = bool(doc.get("stream", False))
            # end-to-end deadline: the body field wins; the
            # x-dk-deadline-s header is a router's propagation channel
            deadline_s = doc.get("deadline_s")
            if deadline_s is None:
                hdr = self.headers.get("x-dk-deadline-s")
                deadline_s = float(hdr) if hdr else None
            else:
                deadline_s = float(deadline_s)
            priority = doc.get("priority",
                               self.headers.get("x-dk-priority",
                                                "interactive"))
        except (ValueError, KeyError, TypeError) as e:
            self._reply(400, {"error": "bad_request",
                              "detail": str(e)[:200]})
            return
        ctx = spans.parse_traceparent(self.headers.get("traceparent"))
        with spans.resume(ctx):
            with spans.span("serve.generate", prompt_len=len(tokens),
                            stream=stream):
                self._trace_header = spans.traceparent()
                if stream:
                    self._generate_stream(srv, tokens, max_new, eos_id,
                                          deadline_s, priority)
                else:
                    self._reply(*self._generate(srv, tokens, max_new,
                                                eos_id, deadline_s,
                                                priority))

    def _admit_generate(self, srv, tokens, max_new, eos_id,
                        on_token=None, deadline_s=None,
                        priority="interactive"):
        """-> (generation, None) or (None, (status, payload,
        retry_after)) with the engine's typed failure mapping."""
        try:
            gen = srv.engine.submit_generate(
                tokens, max_new_tokens=max_new, eos_id=eos_id,
                on_token=on_token, deadline_s=deadline_s,
                priority=priority)
        except Overloaded as e:
            return None, (503, {"error": "overloaded",
                                "reason": e.reason,
                                "pending": e.pending,
                                "capacity": e.capacity}, 1)
        except (ValueError, TypeError) as e:  # the CALLER's bad prompt
            return None, (400, {"error": "bad_request",
                                "detail": str(e)[:200]}, None)
        # dklint: ignore[broad-except] an admission error (the admit fault,
        # ...) maps to a typed 500
        except Exception as e:  # noqa: BLE001
            return None, (500, {"error": type(e).__name__,
                                "detail": str(e)[:200]}, None)
        return gen, None

    def _generate(self, srv, tokens, max_new, eos_id,
                  deadline_s=None, priority="interactive"):
        gen, err = self._admit_generate(srv, tokens, max_new, eos_id,
                                        deadline_s=deadline_s,
                                        priority=priority)
        if err is not None:
            return err
        try:
            doc = gen.result(timeout=srv.request_timeout_s)
        except (TimeoutError, concurrent.futures.TimeoutError):
            # reclaim the slot and its KV pages NOW
            gen.cancel()
            return 504, {"error": "timeout",
                         "timeout_s": srv.request_timeout_s}, None
        # dklint: ignore[broad-except] a decode error maps to a typed 500
        # naming the type
        except Exception as e:  # noqa: BLE001
            return 500, {"error": type(e).__name__,
                         "detail": str(e)[:200]}, None
        return 200, doc, None

    def _generate_stream(self, srv, tokens, max_new, eos_id,
                         deadline_s=None, priority="interactive"):
        """Chunked NDJSON: tokens flush as the scheduler emits them (the
        engine's ``on_token`` callback feeds a local queue this handler
        drains)."""
        q = queue.Queue()
        gen, err = self._admit_generate(srv, tokens, max_new, eos_id,
                                        on_token=q.put,
                                        deadline_s=deadline_s,
                                        priority=priority)
        if err is not None:
            self._reply(*err)
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        if self._trace_header is not None:
            self.send_header("traceparent", self._trace_header)
        self.end_headers()

        def chunk(obj):
            data = (json.dumps(obj) + "\n").encode("utf-8")
            self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
            self.wfile.flush()

        # the future resolves AFTER its last on_token fired (same
        # scheduler thread), so its end marker queues behind the last
        # token and ends the loop at once; the JAX package's copy polls
        # gen.done() only after a 0.05 s get times out, which holds every
        # stream's end up to 50 ms
        gen.future.add_done_callback(lambda _f: q.put(_STREAM_END))
        deadline = time.monotonic() + srv.request_timeout_s
        i = 0
        try:
            while True:
                try:
                    tok = q.get(timeout=_STREAM_POLL_S)
                except queue.Empty:
                    if time.monotonic() > deadline:
                        gen.cancel()  # resolves as finish=cancelled
                        deadline = float("inf")
                    continue
                if tok is _STREAM_END:
                    break
                chunk({"i": i, "token": tok})
                i += 1
            # a cancel resolves the future from another thread, so a
            # token may still land behind the marker
            while not q.empty():
                chunk({"i": i, "token": q.get()})
                i += 1
            try:
                doc = gen.result(timeout=0)
                chunk({"done": True, "finish": doc["finish"],
                       "prompt_len": doc["prompt_len"],
                       "steps": doc["steps"], "ttft_s": doc["ttft_s"],
                       "recoveries": doc.get("recoveries", 0)})
            # dklint: ignore[broad-except] a failed generation ends the stream
            # with a typed error line
            except Exception as e:  # noqa: BLE001
                chunk({"done": True, "error": type(e).__name__,
                       "detail": str(e)[:200]})
            self.wfile.write(b"0\r\n\r\n")
        except OSError:
            # the client went away mid-stream: stop decoding for it NOW
            # so its slot and KV pages reclaim
            gen.cancel()


class ServingServer(ThreadingHTTPServer):
    """Threaded HTTP server wrapping one :class:`ServingEngine` or
    :class:`DecodeEngine`.  ``port=None`` binds :func:`default_port`
    (``DK_SERVE_PORT``); ``port=0`` picks a free one."""

    daemon_threads = True

    def __init__(self, engine, host="127.0.0.1", port=0,
                 request_timeout_s=30.0):
        self.engine = engine
        self.request_timeout_s = float(request_timeout_s)
        self.preempted_signum = None
        self._stop_watch = None
        self._thread = None
        # BaseServer.shutdown() blocks forever unless serve_forever is
        # running: drain()/close() on a never-started server must not
        # wedge the caller
        self._lifecycle = threading.Lock()
        self._serving = False
        self._stopping = False
        if port is None:
            port = default_port(fallback=0)
        super().__init__((host, int(port)), _Handler)

    @property
    def address(self):
        """(host, bound_port) — port resolved after bind."""
        return self.server_address[:2]

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
        """Stop the accept loop (only if it ever started) and close the
        socket — safe from any thread, any lifecycle state."""
        with self._lifecycle:
            self._stopping = True
            serving = self._serving
        if serving:
            self.shutdown()
        self.server_close()
        if (self._thread is not None
                and self._thread is not threading.current_thread()):
            self._thread.join(timeout=10)

    def start(self):
        """Serve on a background thread; -> (host, port)."""
        # live-telemetry plane: with DK_OBS_SAMPLE_S set, the sampler
        # (time series + watchdog, incl. the serve.pending queue-growth
        # rule) and the DK_METRICS_PORT exporter come up with the
        # server; one env read when unset
        from dist_keras_tpu_torch.observability import timeseries

        timeseries.maybe_start_sampler()
        self._thread = threading.Thread(
            target=self.serve_forever, daemon=True, name="dk-serve-http")
        self._thread.start()
        events.emit("serve_listen", host=self.address[0],
                    port=self.address[1])
        return self.address

    def install_signal_drain(self, poll_s=0.05):
        """Wire SIGTERM/SIGINT -> graceful drain through
        ``resilience.preemption``: the signal handler only sets a flag;
        a watcher thread notices it and runs the drain.  Off the main
        thread this degrades to watching flags set through
        ``preemption.request`` only.  -> True when the real handlers
        installed."""
        installed = preemption.install(strict=False)
        self._stop_watch = preemption.on_request(self._drain_on_signal,
                                                 poll_s=poll_s)
        return installed

    def _drain_on_signal(self, signum):
        self.preempted_signum = signum
        events.emit("serve_drain_signal", signum=signum)
        self.drain()

    def drain(self, timeout_s=None):
        """Stop admission, deliver every in-flight request, stop the
        listener.  While the backlog drains, /healthz and the POST
        routes answer typed 503s; afterwards the socket is closed, so
        late clients get connection-refused.  -> the engine's delivery
        counts."""
        out = self.engine.drain(timeout_s=timeout_s)
        self._stop_listener()  # in-flight handler threads still finish
        from dist_keras_tpu_torch.observability import flight, timeseries

        # flush in-flight retention buffers (no-op when off): a pod
        # dying right after the drain must not take undecided traces
        # with it
        flight.retain_flush()
        sampler = timeseries.get_sampler()
        if sampler is not None:
            # one final tick: the perf_sample / SLO evaluation /
            # watchdog check of an incident just before the drain must
            # not die with the pod
            sampler.tick()
            # deliberate completion: the serve.* counters stop
            # advancing now, which is not a throughput stall
            if sampler.watchdog is not None:
                sampler.watchdog.quiesce()
        return out

    def run_forever(self):
        """Serve on the CALLING thread until stopped.  After a
        signal-initiated drain, re-raises :class:`Preempted` so the
        process exits ``128 + signum``."""
        from dist_keras_tpu_torch.observability import timeseries

        timeseries.maybe_start_sampler()  # same wiring as start()
        try:
            self.serve_forever()
        finally:
            self.server_close()
        if self.preempted_signum is not None:
            raise preemption.Preempted(self.preempted_signum)

    def close(self):
        if self._stop_watch is not None:
            self._stop_watch()
        self._stop_listener()
        if self.engine.running:
            self.engine.close()
