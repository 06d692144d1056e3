"""Run telemetry of the port: the structured event log
(:mod:`~dist_keras_tpu_torch.observability.events`), a copy of the JAX
package's, written under ``DK_OBS_DIR`` in the same format."""

from dist_keras_tpu_torch.observability import events
from dist_keras_tpu_torch.observability.events import (
    EventWriter,
    emit,
    enabled,
    obs_dir,
)

__all__ = ["events", "EventWriter", "emit", "enabled", "obs_dir"]
