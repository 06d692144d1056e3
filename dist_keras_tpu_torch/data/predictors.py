"""Inference over a Dataset — counterpart of ``data/predictors.py``
(``distkeras/predictors.py``).

The reference's ``ModelPredictor.predict(df)`` maps a deserialized model
over DataFrame partitions row by row (predictors.py:~35-60).  Here the
model's params go to the device once and the rows run through it in
batches of ``batch_size``, under ``torch.no_grad``.

With ``sharded`` (the default) and more than one card visible to a
single process, the batch is sharded over every card, as the JAX
package shards it over ``jax.devices()``: the batch is a multiple of
the shard count, the rows are padded to whole batches with the last row
(the pad stripped after), each card holds one replica of the params and
runs its shard on a stream of its own, and the outputs come back in
row order in one fetch at the end (the JAX package fetches each batch;
here no batch waits for the one before).  Under a process group
(``comm.initialize``) the predictor runs on the rank's own card only;
``sharded=False``, an explicit ``device=``, the CPU and a one-card host
run on one device, the same path with one shard.
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


def _shard_devices():
    """The devices a single process shards over: every visible card
    (``comm.local_devices()``, the CPU alone on a host without one)."""
    from dist_keras_tpu_torch.comm import backend as comm

    return comm.local_devices()


class ModelPredictor(Predictor):
    """predict(dataset) appends an output column of model outputs.

    Args mirror predictors.py:~35: features_col / output_col;
    ``batch_size`` rows per forward; ``sharded`` shards each batch over
    every card of a single process (``devices`` lists them; one device
    otherwise); ``device`` is the card unless the caller asks for the
    CPU."""

    def __init__(self, keras_model, features_col="features",
                 output_col="prediction", batch_size=1024, sharded=True,
                 device=None):
        super().__init__(keras_model)
        self.features_col = features_col
        self.output_col = output_col
        self.batch_size = int(batch_size)
        self.sharded = sharded
        from dist_keras_tpu_torch.comm import backend as comm

        devices = []
        if sharded and device is None and comm.group_info() is None:
            devices = [torch.device(d) for d in _shard_devices()]
        if len(devices) > 1:
            self.devices = devices
            self.device = devices[0]
        else:
            self.device = resolve_device(device)
            self.devices = [self.device]

    @torch.no_grad()
    def predict(self, dataset):
        """The JAX predictor's plan over ``self.devices`` (one device is
        one shard): the batch a multiple of the shard count, the rows
        padded to whole batches with the last row and the pad stripped
        after, a params replica and a stream a card, and the outputs
        fetched once, at the end, so no batch waits for the one before."""
        model = deserialize_model(self.serialized, device=self.device)
        x = np.asarray(dataset[self.features_col], dtype=np.float32)
        n, shard = len(x), len(self.devices)
        bs = min(self.batch_size, max(1, n))
        bs = max(shard, (bs // shard) * shard)
        per = bs // shard
        if n == 0:
            # one zero batch through the same path (the column keeps the
            # model's output shape and dtype)
            x = np.zeros((bs,) + x.shape[1:], np.float32)
        elif n % bs:
            x = np.concatenate([x, np.repeat(x[-1:], bs - n % bs, axis=0)])
        replicas = {}
        for dev in self.devices:     # one copy of the params a card
            if dev not in replicas:
                replicas[dev] = tree_map(lambda t: t.to(dev), model.params)
        for dev in replicas:         # uploaded before the streams read them
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
        streams = [torch.cuda.Stream(dev) if dev.type == "cuda" else None
                   for dev in self.devices]
        outs = [[] for _ in self.devices]   # a shard's, batch by batch
        for i in range(0, len(x), bs):
            for k, (dev, stream) in enumerate(zip(self.devices, streams)):
                rows = torch.from_numpy(x[i + k * per:i + (k + 1) * per])
                with torch.cuda.stream(stream):
                    if stream is not None:
                        rows = rows.pin_memory()
                    outs[k].append(model.apply(
                        replicas[dev],
                        rows.to(dev, non_blocking=stream is not None)))
        parts = []                   # the one fetch: a copy a shard
        for ys, stream in zip(outs, streams):
            with torch.cuda.stream(stream):
                parts.append(torch.cat(ys).to(
                    "cpu", non_blocking=stream is not None))
        for stream in streams:
            if stream is not None:
                stream.synchronize()
        # (batches, shards, rows a shard, ...) -> rows in order
        out = np.stack([t.numpy().reshape((-1, per) + tuple(t.shape[1:]))
                        for t in parts], axis=1)
        out = out.reshape((-1,) + out.shape[3:])[:n]
        return dataset.with_column(self.output_col, out)
