"""Run telemetry of the port — copies of the JAX package's modules on
the same file formats: the structured event log
(:mod:`~dist_keras_tpu_torch.observability.events`, under
``DK_OBS_DIR``), the metrics registry
(:mod:`~dist_keras_tpu_torch.observability.metrics`), span tracing
(:mod:`~dist_keras_tpu_torch.observability.spans`), the perf
attribution counters (:mod:`~dist_keras_tpu_torch.observability.perf`)
and the merged run report
(:mod:`~dist_keras_tpu_torch.observability.report`).
The flight recorder, time series, watchdog, SLO plane, ``/statusz`` and
the Prometheus exposition are ROADMAP queue 1, item 18."""

from dist_keras_tpu_torch.observability import events, metrics, perf, spans
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
)
from dist_keras_tpu_torch.observability.spans import span

__all__ = [
    "events", "metrics", "perf", "spans",
    "EventWriter", "emit", "enabled", "obs_dir",
    "counter", "gauge", "histogram", "snapshot", "emit_snapshot",
    "span",
]
