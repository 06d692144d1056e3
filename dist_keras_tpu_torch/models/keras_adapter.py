"""Keras 3 (torch backend) model adapter — counterpart of
``models/keras_adapter.py``.

The reference's user contract is "hand the trainer a Keras model"
(``Trainer(keras_model, ...)``, trainers.py:~35).  The port's native
``Sequential`` covers the reference's model zoo; real Keras 3 models are
accepted through this adapter.  With ``KERAS_BACKEND=torch``,
``model.stateless_call`` exposes the model as a pure function of its
variable lists over torch tensors — the ``apply(params, x)`` contract
every trainer here consumes — and it composes with ``torch.func``'s
``grad`` and ``vmap``, so the stacked-worker trainers drive it as they
drive a ``Sequential``.

State handling: ``params`` is ``{"trainable": [...], "state": [...]}``
where ``state`` carries the model's ``non_trainable_variables``
(BatchNorm moving stats, dropout seed-generator state, which is int32).
``stateless_call`` returns the updated non-trainables each batch; the
trainers' aux-state channel (``trainers/step.py`` ``make_model_step``)
folds them back into the carried params, and takes gradients on the
``trainable`` split only.  The merges (``tree_merge_floats``, the
epoch mean) carry the integer leaves through untouched.

Devices: the params live on the adapter's device (the card unless the
caller asks for ``device="cpu"``), and ``stateless_call`` runs inside
``keras.device(...)`` for the device of the params it is given, so the
torch backend's default device (``cuda`` whenever a card is present)
never decides where the work runs.  Keras's unseeded dropout draws from
torch's global generator, not from the trainer's ``generator`` (the JAX
adapter likewise ignores ``rng``).

Keras is imported inside the functions that need it, never when this
module is imported: importing Keras loads jax where jax is installed.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dist_keras_tpu_torch.utils.device import resolve_device
from dist_keras_tpu_torch.utils.pytree import tree_cast


def _import_keras():
    os.environ.setdefault("KERAS_BACKEND", "torch")
    try:
        import keras
    except ImportError as e:
        raise ImportError(
            "the Keras adapter needs Keras 3 on its torch backend, and "
            "Keras is not installed: install it (pip install 'keras>=3') "
            "and set KERAS_BACKEND=torch before anything imports keras"
        ) from e
    if keras.backend.backend() != "torch":
        raise RuntimeError(
            "Keras is loaded with backend "
            f"{keras.backend.backend()!r}; the adapter needs "
            "KERAS_BACKEND=torch (set it before importing keras)")
    return keras


def _keras_device(device):
    """A ``torch.device`` as the name ``keras.device`` takes."""
    return str(torch.device(device))


def _tensor(value, device):
    """A fresh tensor on ``device`` from a tensor, a Keras variable or an
    array-like."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(device, copy=True)
    return torch.from_numpy(np.array(value)).to(device)


class KerasModelAdapter:
    """Wraps a built Keras 3 model into the framework's model contract:
    ``params`` tree + pure ``apply`` + weight/JSON round-trip, on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, keras_model, device=None):
        _import_keras()
        if not keras_model.built:
            raise ValueError("build the Keras model first (call it once "
                             "or specify an Input layer)")
        self._model = keras_model
        self.device = resolve_device(device)
        self.params = {
            "trainable": [_tensor(v.value, self.device)
                          for v in keras_model.trainable_variables],
            "state": [_tensor(v.value, self.device)
                      for v in keras_model.non_trainable_variables],
        }
        self.name = keras_model.name

    # ---- trainer contract -------------------------------------------
    def _stateless_call(self, params, x, training):
        import keras

        trainable = params["trainable"]
        device = trainable[0].device if trainable else self.device
        with keras.device(_keras_device(device)):
            return self._model.stateless_call(
                trainable, [s.detach() for s in params["state"]], x,
                training=training)

    def apply(self, params, x, *, training=False, generator=None):
        outputs, _ = self._stateless_call(params, x, training)
        return outputs

    def apply_with_state(self, params, x, *, training=False,
                         generator=None):
        """(y, new_state) — ``stateless_call`` hands back the updated
        non-trainables (moving stats already momentum-blended by the Keras
        layer); they replace the state split."""
        outputs, new_state = self._stateless_call(params, x, training)
        return outputs, [s.detach() for s in new_state]

    def has_state(self):
        return len(self.params["state"]) > 0

    def split_state(self, params):
        return params["trainable"], params["state"]

    def join_state(self, trainable, state):
        return {"trainable": trainable, "state": state}

    def cast_params(self, params, dtype):
        """Compute-dtype cast for the trainable split only; state stays at
        its native dtype (seed generators are integer, moving-stat blends
        need f32 resolution)."""
        return {"trainable": tree_cast(params["trainable"], dtype),
                "state": params["state"]}

    def set_params(self, params):
        import keras

        if not isinstance(params, dict):  # flat trainables (legacy callers)
            params = {"trainable": list(params),
                      "state": self.params["state"]}
        self.params = {
            "trainable": [_tensor(p, self.device)
                          for p in params["trainable"]],
            "state": [_tensor(s, self.device) for s in params["state"]],
        }
        for var, val in zip(
                self._model.trainable_variables
                + self._model.non_trainable_variables,
                self.params["trainable"] + self.params["state"]):
            with keras.device(_keras_device(var.value.device)):
                var.assign(val.to(var.value.device))

    # ---- serialization contract (utils.py:~40 dict shape) ------------
    def to_json(self):
        return self._model.to_json()

    def get_weights(self):
        """Flat list: trainables then non-trainables (round-trips through
        ``set_weights``; counts come from the model's variable lists)."""
        return [p.detach().cpu().numpy().copy()
                for p in self.params["trainable"] + self.params["state"]]

    def set_weights(self, weights):
        weights = list(weights)
        n_t = len(self._model.trainable_variables)
        n_s = len(self._model.non_trainable_variables)
        if len(weights) == n_t:  # trainables only (older serialized form)
            self.set_params({"trainable": weights,
                             "state": self.params["state"]})
        elif len(weights) == n_t + n_s:
            self.set_params({"trainable": weights[:n_t],
                             "state": weights[n_t:]})
        else:
            raise ValueError(
                f"got {len(weights)} weights; model has {n_t} trainable "
                f"+ {n_s} non-trainable variables")

    def __call__(self, x, *, training=False, generator=None):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        x = x.to(self.device)
        if torch.is_floating_point(x):
            x = x.float()
        return self.apply(self.params, x, training=training)

    @torch.no_grad()
    def predict(self, x, batch_size=None):
        return self(x).detach().cpu().numpy()

    @property
    def count_params(self):
        return sum(int(np.prod(np.shape(w))) for w in self.get_weights())


def from_keras_json(js, weights=None, device=None):
    """Rebuild an adapter from Keras architecture JSON (+ weight list), its
    variables and params on ``device`` (the card unless the caller asks
    for the CPU)."""
    keras = _import_keras()
    device = resolve_device(device)
    with keras.device(_keras_device(device)):
        model = keras.models.model_from_json(js)
        if not model.built:
            model.build(None)
    adapter = KerasModelAdapter(model, device=device)
    if weights is not None:
        adapter.set_weights(weights)
    return adapter
