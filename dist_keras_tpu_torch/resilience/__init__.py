"""Resilience — counterpart of ``resilience/``: the NaN/Inf sentinel
(:mod:`~dist_keras_tpu_torch.resilience.guards`), named fault points
(:mod:`~dist_keras_tpu_torch.resilience.faults`, on the clock seam
:mod:`~dist_keras_tpu_torch.resilience.world`) and the flag-only
SIGTERM/SIGINT handler
(:mod:`~dist_keras_tpu_torch.resilience.preemption`).  Coordination,
elastic resize, the supervisor and the checkpoint store are ROADMAP
queue 1, item 15; ``retry.py`` comes with item 27."""

from dist_keras_tpu_torch.resilience import faults, guards, preemption, world
from dist_keras_tpu_torch.resilience.faults import (
    FaultInjected,
    armed,
    fault_point,
    inject,
)
from dist_keras_tpu_torch.resilience.guards import NonFiniteLossError
from dist_keras_tpu_torch.resilience.preemption import Preempted

__all__ = [
    "faults", "guards", "preemption", "world",
    "FaultInjected", "armed", "fault_point", "inject",
    "NonFiniteLossError", "Preempted",
]
