"""Loss registry with Keras-string parity — counterpart of ``ops/losses.py``.

The reference passes Keras loss strings straight through to
``model.compile`` (``distkeras/workers.py:~45``); the same strings map
here to functions ``loss(logits_or_preds, targets) -> 0-d tensor``.
As in the JAX package, the cross-entropies are written on *logits*
(log-softmax / log-sigmoid forms), so the zoo's models emit logits.
"""

from __future__ import annotations

import torch


def categorical_crossentropy(logits, targets):
    """One-hot targets vs logits, mean over the batch (Keras
    ``categorical_crossentropy`` with from_logits=True)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(targets * logp, dim=-1))


def sparse_categorical_crossentropy(logits, targets):
    """Integer targets vs logits."""
    logp = torch.log_softmax(logits, dim=-1)
    tgt = targets.to(torch.int64).reshape(logits.shape[:-1])
    return -torch.mean(torch.gather(logp, -1, tgt[..., None])[..., 0])


def binary_crossentropy(logits, targets):
    """Binary targets (0/1, any float shape) vs logits:
    softplus(x) - t * x, with softplus(x) = logaddexp(x, 0)."""
    logits = logits.reshape(targets.shape)
    loss = torch.logaddexp(logits, torch.zeros_like(logits)) \
        - targets * logits
    return torch.mean(loss)


def mean_squared_error(preds, targets):
    return torch.mean(torch.square(preds - targets))


def mean_absolute_error(preds, targets):
    return torch.mean(torch.abs(preds - targets))


_LOSSES = {
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "binary_crossentropy": binary_crossentropy,
    "mean_squared_error": mean_squared_error,
    "mse": mean_squared_error,
    "mean_absolute_error": mean_absolute_error,
    "mae": mean_absolute_error,
}


def get_loss(loss):
    """Resolve a Keras-style loss string or pass a callable through."""
    if callable(loss):
        return loss
    try:
        return _LOSSES[loss]
    except KeyError:
        raise ValueError(
            f"Unknown loss {loss!r}; known: {sorted(_LOSSES)}") from None


def register_loss(name, fn):
    _LOSSES[name] = fn
