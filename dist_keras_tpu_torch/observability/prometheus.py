"""Prometheus text exposition for the metrics registry.

One format for every scraper: the serving front end answers
``GET /metricsz?format=prometheus`` with this rendering, and the
standalone per-host :class:`Exporter` (armed by ``DK_METRICS_PORT``, or
started explicitly) serves the same text on ``/metrics`` — so the
future multi-host router, an ops Prometheus, and a curl all read one
vocabulary.  Text format 0.0.4 (the stable exposition format), stdlib
only, strictly read-only against the registry.

Mapping:

- counter ``a.b``            -> ``dk_a_b_total`` (TYPE counter)
- numeric gauge ``a.b``      -> ``dk_a_b`` (TYPE gauge; non-numeric
  gauges are skipped — exposition is numbers-only)
- histogram ``a.b``          -> ``dk_a_b`` (TYPE summary) with
  ``quantile="0.5|0.95|0.99"`` sample lines plus ``dk_a_b_sum`` /
  ``dk_a_b_count`` (exact lifetime totals; quantiles over the bounded
  recent window, matching ``Histogram.summary``)

Every sample carries a ``rank`` label (``DK_COORD_RANK`` >
``JAX_PROCESS_ID`` > 0 — the event log's identity resolution), so a
fleet scrape federates per-host series without relabeling.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from dist_keras_tpu_torch.observability import events, metrics
from dist_keras_tpu_torch.utils import knobs

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

PREFIX = "dk_"
QUANTILES = (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"))


def metric_name(name, prefix=PREFIX):
    """Registry name -> Prometheus metric name (dots and every other
    illegal character become underscores; a leading digit is guarded)."""
    n = _NAME_RE.sub("_", str(name))
    if n and n[0].isdigit():
        n = "_" + n
    return prefix + n


def _labels(extra=None, rank=None):
    lab = {}
    if rank is None:
        rank = events._default_rank()
    lab["rank"] = str(rank)
    if extra:
        lab.update({str(k): str(v) for k, v in extra.items()})
    return lab


def _escape(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _fmt_labels(lab):
    if not lab:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"'
                    for k, v in sorted(lab.items()))
    return "{" + body + "}"


def _num(v):
    return f"{v:.10g}" if isinstance(v, float) else str(v)


def render(snapshot=None, labels=None, extra_gauges=None, rank=None,
           prefix=PREFIX):
    """-> the exposition text (trailing newline included).

    ``snapshot`` defaults to the live registry; ``extra_gauges`` is a
    flat ``{name: number}`` dict rendered as additional gauges (the
    serving endpoint passes the engine's numeric stats through it)."""
    snap = metrics.snapshot() if snapshot is None else snapshot
    base = _labels(labels, rank=rank)
    lbl = _fmt_labels(base)
    lines = []
    for name in sorted(snap.get("counters", {})):
        v = snap["counters"][name]
        mn = metric_name(name, prefix) + "_total"
        lines.append(f"# TYPE {mn} counter")
        lines.append(f"{mn}{lbl} {_num(v)}")
    for name in sorted(snap.get("gauges", {})):
        v = snap["gauges"][name]
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        mn = metric_name(name, prefix)
        lines.append(f"# TYPE {mn} gauge")
        lines.append(f"{mn}{lbl} {_num(v)}")
    for name in sorted(snap.get("histograms", {})):
        h = snap["histograms"][name]
        mn = metric_name(name, prefix)
        lines.append(f"# TYPE {mn} summary")
        for q, key in QUANTILES:
            val = h.get(key)
            if val is None:
                continue
            qlbl = _fmt_labels({**base, "quantile": q})
            lines.append(f"{mn}{qlbl} {_num(float(val))}")
        lines.append(f"{mn}_sum{lbl} {_num(float(h.get('total', 0.0)))}")
        lines.append(f"{mn}_count{lbl} {_num(int(h.get('count', 0)))}")
        # OpenMetrics-style exemplar comments: a scrape's
        # bad percentile links straight to a retained trace.  Comment
        # syntax keeps the 0.0.4 text parsers happy — they skip '#'
        # lines they don't know — while the trace/span ids stay
        # machine-recoverable from the scrape body.
        for ex in h.get("exemplars", ()):
            xl = _fmt_labels({"trace_id": ex.get("trace_id", ""),
                              "span_id": ex.get("span_id", "")})
            lines.append(
                f"# {xl} {_num(float(ex.get('value', 0.0)))}")
    for name in sorted(extra_gauges or {}):
        v = (extra_gauges or {})[name]
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        mn = metric_name(name, prefix)
        lines.append(f"# TYPE {mn} gauge")
        lines.append(f"{mn}{lbl} {_num(v)}")
    return "\n".join(lines) + "\n"


CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _Handler(BaseHTTPRequestHandler):
    server_version = "dk-metrics/0.1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # the event log is the log
        pass

    def do_GET(self):
        path = self.path.split("?")[0]
        if path in ("/metrics", "/metricsz"):
            body = render().encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
        elif path == "/healthz":
            body = json.dumps({"status": "ok"}).encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        elif path == "/statusz":
            # the SAME build/config/open-span document the serving
            # front end serves — one shared renderer, one shape
            from dist_keras_tpu_torch.observability import statusz

            body = statusz.render().encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        elif path == "/tracez":
            # flight-recorder ring on demand (default=str: records
            # hold pre-serialization field values)
            from dist_keras_tpu_torch.observability import flight

            body = json.dumps(flight.tracez_doc(),
                              default=str).encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        else:
            body = json.dumps({"error": "not_found",
                               "path": self.path}).encode("utf-8")
            self.send_response(404)
            self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class Exporter(ThreadingHTTPServer):
    """Standalone per-host scrape endpoint: ``GET /metrics`` (alias
    ``/metricsz``) serves the live registry exposition; ``/healthz``
    answers 200; ``/statusz`` serves the shared build/config/open-span
    snapshot and ``/tracez`` the flight-recorder ring (same documents
    as the serving front end).  ``port=0`` binds an ephemeral port
    (tests)."""

    daemon_threads = True

    def __init__(self, port=0, host="0.0.0.0"):
        self._thread = None
        super().__init__((host, int(port)), _Handler)

    @property
    def address(self):
        return self.server_address[:2]

    def start(self):
        """Serve on a background thread; -> (host, bound_port)."""
        # dklint: thread-root=obs.exporter
        # (serve_forever is inherited from ThreadingHTTPServer, which
        # then spawns one handler thread per request — the registry's
        # ~_Handler.* row is where the off-main code actually runs)
        self._thread = threading.Thread(
            target=self.serve_forever, daemon=True,
            name="dk-metrics-exporter")
        self._thread.start()
        events.emit("metrics_exporter_listen", host=self.address[0],
                    port=self.address[1])
        return self.address

    def close(self):
        if self._thread is not None:
            self.shutdown()
            self._thread = None
        self.server_close()


_lock = threading.Lock()
_exporter = None


def get_exporter():
    return _exporter


def maybe_start_exporter():
    """Start the process-wide exporter iff ``DK_METRICS_PORT`` is set
    to a valid port (idempotent; one env read when unset).  Launch
    wiring: ``Job(metrics_port=...)`` exports the knob per host, so
    every host in a pod scrapes on the same port.  -> the exporter or
    None; a bind failure warns once and stays None (telemetry must not
    kill the run)."""
    import sys

    global _exporter
    raw = (knobs.raw("DK_METRICS_PORT") or "").strip()
    if not raw:
        return None
    with _lock:
        if _exporter is not None:
            return _exporter
        try:
            port = int(raw)
            if port < 1:
                return None
            exp = Exporter(port=port)
            exp.start()
        # dklint: ignore[broad-except] exporter bind failure warns once; telemetry must not kill the run
        except Exception as e:
            print(f"[dk.observability] WARNING: metrics exporter on "
                  f"port {raw!r} failed: {e!r}", file=sys.stderr,
                  flush=True)
            return None
        _exporter = exp
    return _exporter


def stop_exporter():
    """Close and forget the process-wide exporter (tests)."""
    global _exporter
    with _lock:
        exp, _exporter = _exporter, None
    if exp is not None:
        exp.close()
