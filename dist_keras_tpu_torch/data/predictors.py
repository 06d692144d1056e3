"""Inference over a Dataset — counterpart of ``data/predictors.py``
(``distkeras/predictors.py``).

The reference's ``ModelPredictor.predict(df)`` maps a deserialized model
over DataFrame partitions row by row (predictors.py:~35-60).  Here the
model's params go to the device once and the rows run through it in
batches of ``batch_size``, under ``torch.no_grad``.  The JAX package's
sharding of the batch over several devices waits for the mesh (ROADMAP
queue 1, item 12b): where it would shard (``sharded`` with more than one
card visible) the predictor raises; ``sharded=False`` runs on one card.
"""

from __future__ import annotations

import numpy as np
import torch

from dist_keras_tpu_torch.utils.device import resolve_device
from dist_keras_tpu_torch.utils.pytree import tree_map
from dist_keras_tpu_torch.utils.serialization import (
    deserialize_model,
    serialize_model,
)


class Predictor:
    """Base (predictors.py:~20): holds the serialized model."""

    def __init__(self, keras_model):
        self.serialized = serialize_model(keras_model)

    def predict(self, dataset):
        raise NotImplementedError


class ModelPredictor(Predictor):
    """predict(dataset) appends an output column of model outputs.

    Args mirror predictors.py:~35: features_col / output_col;
    ``batch_size`` rows per forward; ``device`` is the card unless the
    caller asks for the CPU."""

    def __init__(self, keras_model, features_col="features",
                 output_col="prediction", batch_size=1024, sharded=True,
                 device=None):
        super().__init__(keras_model)
        self.features_col = features_col
        self.output_col = output_col
        self.batch_size = int(batch_size)
        self.sharded = sharded
        self.device = resolve_device(device)
        if (sharded and self.device.type == "cuda"
                and torch.cuda.device_count() > 1):
            raise NotImplementedError(
                "sharding the batch over several cards is not ported yet "
                "(ROADMAP queue 1, item 12b); pass sharded=False to run on "
                "one card")

    @torch.no_grad()
    def predict(self, dataset):
        model = deserialize_model(self.serialized, device=self.device)
        params = tree_map(lambda t: t.to(self.device), model.params)
        x = np.asarray(dataset[self.features_col], dtype=np.float32)
        bs = min(self.batch_size, max(1, len(x)))

        def run(rows):
            return model.apply(params, torch.from_numpy(rows).to(self.device))

        if len(x) == 0:
            # one zero row through the same path, so the empty column
            # carries the model's real output shape and dtype
            out = run(np.zeros((1,) + x.shape[1:], np.float32))[:0]
            return dataset.with_column(self.output_col, out.cpu().numpy())
        outs = [run(np.ascontiguousarray(x[i:i + bs]))
                for i in range(0, len(x), bs)]
        out = torch.cat(outs).cpu().numpy()
        return dataset.with_column(self.output_col, out)
