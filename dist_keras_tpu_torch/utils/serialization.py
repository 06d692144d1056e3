"""Model / object serialization — counterpart of ``utils/serialization.py``
(``distkeras/utils.py``).

The serialized form is the reference's dict: ``'model'`` is the
architecture-JSON string and ``'weights'`` a flat Keras-ordered list of
numpy arrays.  The JSON is the JAX package's, so a model that either
package serialized deserializes in the other into a model computing the
same function: a ``Sequential``, a ``Transformer`` (MoE configs
included; its weights in ``jax.tree.leaves`` order) or a Keras 3 model
(``models/keras_adapter.py``, on Keras's torch backend; without Keras it
raises ``ImportError`` saying what to install).
"""

from __future__ import annotations

import json
import pickle

import numpy as np


def serialize_model(model):
    """Model -> picklable dict, same contract as utils.py:~40."""
    return {
        "model": model.to_json(),
        "weights": [np.asarray(w) for w in model.get_weights()],
    }


def deserialize_model(d, device=None):
    """dict -> Model, same contract as utils.py:~55.  A Transformer or a
    Keras adapter is built on ``device`` (the card unless
    ``device="cpu"``)."""
    from dist_keras_tpu_torch.models.model import model_from_json

    arch = json.loads(d["model"])
    if arch.get("class_name") == "Transformer":
        from dist_keras_tpu_torch.models.transformer import Transformer

        model = Transformer(cfg=arch["config"], device=device)
        model.set_weights(d["weights"])
        return model
    if arch.get("class_name") == "Sequential" and "layers" in arch and all(
            "class_name" in spec for spec in arch["layers"]):
        try:
            model = model_from_json(d["model"])
        except KeyError:
            model = None  # layer classes not ours -> fall through to Keras
        if model is not None:
            model.set_weights(d["weights"])
            return model
    from dist_keras_tpu_torch.models.keras_adapter import from_keras_json

    return from_keras_json(d["model"], d["weights"], device=device)


# Reference-spelled aliases so a dist-keras user finds the names they know.
serialize_keras_model = serialize_model
deserialize_keras_model = deserialize_model


def pickle_object(o):
    """utils.py:~170 — object -> bytes."""
    return pickle.dumps(o, protocol=pickle.HIGHEST_PROTOCOL)


def unpickle_object(b):
    """utils.py:~170 — bytes -> object."""
    return pickle.loads(b)


def uniform_weights(model, bounds=(-0.5, 0.5), seed=0):
    """utils.py:~75 — re-init every weight array uniformly in ``bounds``
    (numpy's generator, so both packages draw the same weights).

    Returns the model (weights replaced in place, reference-style)."""
    low, high = bounds
    rng = np.random.default_rng(seed)
    new = [rng.uniform(low, high, size=np.shape(w)).astype(np.asarray(w).dtype)
           for w in model.get_weights()]
    model.set_weights(new)
    return model

