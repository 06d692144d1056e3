"""Trainers — counterpart of ``trainers/``: the ``Trainer`` base,
``SingleTrainer``, and the multi-worker family on W workers stacked on
one card or split over a process group (``DistributedTrainer``, the windowed DOWNPOUR / ADAG / AEASGD /
EAMSGD, ``AveragingTrainer``, ``EnsembleTrainer`` and ``DynSGD``)."""

from dist_keras_tpu_torch.trainers.averaging import (
    AveragingTrainer,
    EnsembleTrainer,
)
from dist_keras_tpu_torch.trainers.base import (
    DistributedTrainer,
    Trainer,
    WorldMismatch,
)
from dist_keras_tpu_torch.trainers.dynsgd import DynSGD
from dist_keras_tpu_torch.trainers.single import SingleTrainer
from dist_keras_tpu_torch.trainers.windowed import (
    ADAG,
    AEASGD,
    DOWNPOUR,
    EAMSGD,
    AsynchronousDistributedTrainer,
)

__all__ = [
    "Trainer", "SingleTrainer", "DistributedTrainer",
    "AsynchronousDistributedTrainer", "DOWNPOUR", "ADAG", "AEASGD",
    "EAMSGD", "AveragingTrainer", "EnsembleTrainer", "DynSGD",
    "WorldMismatch",
]
