"""Run telemetry of the port — copies of the JAX package's modules on
the same file formats: the structured event log
(:mod:`~dist_keras_tpu_torch.observability.events`, under
``DK_OBS_DIR``), the metrics registry
(:mod:`~dist_keras_tpu_torch.observability.metrics`), span tracing
(:mod:`~dist_keras_tpu_torch.observability.spans`), the perf
attribution counters (:mod:`~dist_keras_tpu_torch.observability.perf`),
the merged run report (:mod:`~dist_keras_tpu_torch.observability.report`,
CLI ``python -m dist_keras_tpu_torch.observability``), and the live
plane: the flight recorder and trace retention (``flight``), time series
and their sampler (``timeseries``), the watchdog rules (``watchdog``),
the SLO plane (``slo``), Chrome-trace export (``trace_export``), the
Prometheus exposition (``prometheus``) and ``/statusz`` (``statusz``)."""

import importlib

from dist_keras_tpu_torch.observability import (
    events,
    metrics,
    perf,
    report,
    spans,
)
from dist_keras_tpu_torch.observability.events import (
    EventWriter,
    emit,
    enabled,
    obs_dir,
)
from dist_keras_tpu_torch.observability.metrics import (
    counter,
    emit_snapshot,
    gauge,
    histogram,
    snapshot,
    to_prometheus,
)
from dist_keras_tpu_torch.observability.spans import span

# the telemetry plane (sampler thread, watchdog rules, http exposition)
# resolves lazily: every process imports `events` at startup — through
# checkpoint/faults/retry — and must not pay for numpy rule math or
# http.server unless it actually arms the sampler or an exporter
_LAZY = {
    "flight": "dist_keras_tpu_torch.observability.flight",
    "prometheus": "dist_keras_tpu_torch.observability.prometheus",
    "slo": "dist_keras_tpu_torch.observability.slo",
    "statusz": "dist_keras_tpu_torch.observability.statusz",
    "timeseries": "dist_keras_tpu_torch.observability.timeseries",
    "trace_export": "dist_keras_tpu_torch.observability.trace_export",
    "watchdog": "dist_keras_tpu_torch.observability.watchdog",
    "Exporter": ("dist_keras_tpu_torch.observability.prometheus",
                 "Exporter"),
    "MetricsSampler": ("dist_keras_tpu_torch.observability.timeseries",
                       "MetricsSampler"),
    "TimeSeries": ("dist_keras_tpu_torch.observability.timeseries",
                   "TimeSeries"),
    "Watchdog": ("dist_keras_tpu_torch.observability.watchdog",
                 "Watchdog"),
}


def __getattr__(name):
    spec = _LAZY.get(name)
    if spec is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    if isinstance(spec, tuple):
        value = getattr(importlib.import_module(spec[0]), spec[1])
    else:
        value = importlib.import_module(spec)
    globals()[name] = value  # resolve once
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))


__all__ = [
    "events", "flight", "metrics", "perf", "prometheus", "report",
    "slo", "spans", "statusz", "timeseries", "trace_export", "watchdog",
    "EventWriter", "emit", "enabled", "obs_dir",
    "counter", "gauge", "histogram", "snapshot", "emit_snapshot",
    "to_prometheus", "span",
    "TimeSeries", "MetricsSampler", "Watchdog", "Exporter",
]
