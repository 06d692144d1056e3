"""Counterpart of ``parallel/`` (one card so far): the TP transformer's
train step, the worker layout (``mesh.py``) and the collectives over
stacked workers (``collectives.py``)."""

from dist_keras_tpu_torch.parallel.transformer_tp import (
    make_tp_train_step,
    tp_transformer_forward,
    train_tp_transformer,
)

__all__ = ["make_tp_train_step", "tp_transformer_forward",
           "train_tp_transformer"]
