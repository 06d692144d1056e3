"""Resilience — counterpart of ``resilience/``: the NaN/Inf sentinel
(:mod:`~dist_keras_tpu_torch.resilience.guards`), named fault points
(:mod:`~dist_keras_tpu_torch.resilience.faults`, on the clock seam
:mod:`~dist_keras_tpu_torch.resilience.world`), the flag-only
SIGTERM/SIGINT handler
(:mod:`~dist_keras_tpu_torch.resilience.preemption`), the shared retry
policy (:mod:`~dist_keras_tpu_torch.resilience.retry`), cluster
consensus (:mod:`~dist_keras_tpu_torch.resilience.coordination`), the
remote checkpoint tier (:mod:`~dist_keras_tpu_torch.resilience.store`),
elastic resharding restore
(:mod:`~dist_keras_tpu_torch.resilience.elastic`) and the auto-resume
supervisor (:mod:`~dist_keras_tpu_torch.resilience.supervisor`).  The
launcher's elastic relaunch (``launch.Job``) is not ported."""

from dist_keras_tpu_torch.resilience import (
    coordination,
    elastic,
    faults,
    guards,
    preemption,
    retry,
    supervisor,
    world,
)
from dist_keras_tpu_torch.resilience.coordination import (
    BarrierTimeout,
    CoordinatorPoisoned,
    FileCoordinator,
    PeerLost,
    get_coordinator,
)
from dist_keras_tpu_torch.resilience.elastic import reshard_restore
from dist_keras_tpu_torch.resilience.faults import (
    FaultInjected,
    armed,
    fault_point,
    inject,
)
from dist_keras_tpu_torch.resilience.guards import NonFiniteLossError
from dist_keras_tpu_torch.resilience.preemption import Preempted
from dist_keras_tpu_torch.resilience.retry import RetryPolicy, retry_call
from dist_keras_tpu_torch.resilience.supervisor import (
    CrashLoop,
    RestartBudget,
    supervise,
)

__all__ = [
    "coordination", "elastic", "faults", "guards", "preemption",
    "retry", "supervisor", "world",
    "BarrierTimeout", "CoordinatorPoisoned", "CrashLoop",
    "FaultInjected", "FileCoordinator", "PeerLost", "RestartBudget",
    "armed", "fault_point", "get_coordinator", "inject",
    "NonFiniteLossError", "Preempted", "RetryPolicy", "retry_call",
    "reshard_restore", "supervise",
]
