"""Trainers — counterpart of ``trainers/``: the ``Trainer`` base and
``SingleTrainer`` so far."""

from dist_keras_tpu_torch.trainers.base import Trainer
from dist_keras_tpu_torch.trainers.single import SingleTrainer

__all__ = ["Trainer", "SingleTrainer"]
