"""Training steps — counterpart of ``parallel/`` (one card so far)."""

from dist_keras_tpu_torch.parallel.transformer_tp import (
    make_tp_train_step,
    tp_transformer_forward,
    train_tp_transformer,
)

__all__ = ["make_tp_train_step", "tp_transformer_forward",
           "train_tp_transformer"]
