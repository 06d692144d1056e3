"""Parameter-server training mode — counterpart of the JAX package's
``ps/``.

The paper's asynchronous data-parallel optimizer family over a
central parameter server: the fault-tolerant center-variable server
(:mod:`~dist_keras_tpu_torch.ps.server`, the center in numpy on the
host), the elastic staleness-aware worker that trains on the card
(:mod:`~dist_keras_tpu_torch.ps.worker`), and the RPC client with named
retry surfaces and chaos fault points
(:mod:`~dist_keras_tpu_torch.ps.client`).  Server-side DynSGD scaling
lives in :mod:`~dist_keras_tpu_torch.ps.center`;
:mod:`~dist_keras_tpu_torch.ps.compress` is the ``DK_PS_COMPRESS``
codec; :mod:`~dist_keras_tpu_torch.ps.inproc` is the same protocol over
direct method calls.  The modules other than ``worker`` are copies of
the JAX package's (numpy and stdlib), and the wire and the checkpoints
are the JAX package's: a worker or server of either package works with
one of the other.

``PSWorkerTrainer`` is PEP-562 lazy: a SERVER process must not pay the
trainer stack's import just for touching this package — only a process
that trains loads it.
"""

from dist_keras_tpu_torch.ps.center import (CenterVariable, PSError,
                                            StaleCommit, apply_commit,
                                            dynsgd_scale)
from dist_keras_tpu_torch.ps.client import PSClient, PSUnavailable
from dist_keras_tpu_torch.ps.inproc import InProcPSClient, InProcPSServer
from dist_keras_tpu_torch.ps.server import PSServer

__all__ = [
    "CenterVariable", "PSError", "StaleCommit",
    "apply_commit", "dynsgd_scale",
    "PSClient", "PSUnavailable", "PSServer", "PSWorkerTrainer",
    "InProcPSClient", "InProcPSServer",
]


def __getattr__(name):
    if name == "PSWorkerTrainer":
        from dist_keras_tpu_torch.ps.worker import PSWorkerTrainer

        return PSWorkerTrainer
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
