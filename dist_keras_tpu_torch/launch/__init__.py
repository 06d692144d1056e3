"""The launcher: ``Job`` (rsync + ssh deployment, supervised relaunch
waves, the elastic resize), ``Punchcard`` and ``JobConfig`` — the JAX
package's ``launch/`` for the port's trainers; the CLI is
``python -m dist_keras_tpu_torch.launch``, and each host's per-card
fan-out ``python -m dist_keras_tpu_torch.launch.local``."""

from dist_keras_tpu_torch.launch.config import JobConfig
from dist_keras_tpu_torch.launch.job import Job, Punchcard

__all__ = ["Job", "JobConfig", "Punchcard"]
