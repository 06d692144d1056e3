"""Sequential model container — counterpart of ``models/model.py``.

The reference's models cross process boundaries as (architecture JSON,
flat weight list) (``distkeras/utils.py:~40-70``); this module keeps
that contract:

- ``Sequential([...layers]).build(input_shape, seed)`` — draws the
  weights on the host from a CPU ``torch.Generator``, so a freshly built
  model is device-free, as the reference's is; trainers move the params
  to their device once.
- ``model.to_json()`` / ``model_from_json(js)`` — the reference's JSON,
  byte for byte, so a model serialized by either package loads in the
  other.
- ``model.get_weights()`` / ``set_weights(list)`` — Keras-ordered flat
  numpy weight lists (kernel then bias, layer by layer).
- ``model(x)`` / ``model.predict(x)`` — inference.

``model.params`` is the reference-layout tree, a list of per-layer
dicts of tensors; ``model.apply(params, x)`` is a plain function of it,
which is what the trainers differentiate.
"""

from __future__ import annotations

import json

import numpy as np
import torch
from torch import nn

from dist_keras_tpu_torch.models.layers import LAYER_REGISTRY, Layer
from dist_keras_tpu_torch.utils.device import resolve_device
from dist_keras_tpu_torch.utils.pytree import tree_cast, tree_map


class Sequential(nn.Module):
    def __init__(self, layers=None, name="sequential"):
        super().__init__()
        self.layers = nn.ModuleList(layers or [])
        self.name = name
        self.input_shape = None   # sans batch dim
        self.output_shape = None
        self._built = False

    def add(self, layer: Layer):
        self.layers.append(layer)

    # ------------------------------------------------------------------
    # build / init
    # ------------------------------------------------------------------
    def build(self, input_shape, seed=0):
        """Initialise parameters for ``input_shape`` (no batch dim) from
        a CPU generator seeded with ``seed``.  The draws are not the
        reference's (``jax.random`` is not reproducible in torch): parity
        tests carry the reference's weights across instead."""
        gen = torch.Generator().manual_seed(int(seed))
        self.set_params(self.init(gen, tuple(input_shape)))
        return self

    def init(self, generator, input_shape):
        """-> list of per-layer param dicts (the params tree)."""
        self.input_shape = tuple(input_shape)
        params = []
        shape = tuple(input_shape)
        for layer in self.layers:
            p, shape = layer.init(generator, shape)
            params.append(p)
        self.output_shape = tuple(shape)
        return params

    @property
    def params(self):
        """The built weights as the reference's tree (a list of per-layer
        dicts), or None before ``build``."""
        if not self._built:
            return None
        return [layer.params() for layer in self.layers]

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def apply(self, params, x, *, training=False, generator=None):
        """Forward pass over the whole stack, as a function of
        ``params``."""
        for layer, p in zip(self.layers, params):
            x = layer.apply(p, x, training=training, generator=generator)
        return x

    def apply_with_state(self, params, x, *, training=False,
                         generator=None):
        """-> ``(y, states)``: ``states`` is a per-layer list of state-leaf
        updates (empty dicts for stateless layers) — the aux-state
        channel through which BatchNorm's moving statistics advance."""
        states = []
        for layer, p in zip(self.layers, params):
            x, s = layer.apply_with_state(p, x, training=training,
                                          generator=generator)
            states.append(s)
        return x, states

    # ------------------------------------------------------------------
    # aux-state channel (BatchNorm moving stats & co.)
    # ------------------------------------------------------------------
    def has_state(self):
        return any(layer.state_names() for layer in self.layers)

    def split_state(self, params):
        """params -> (trainable, state): two parallel per-layer dict lists.
        The optimizer only ever sees ``trainable``."""
        trainable, state = [], []
        for layer, p in zip(self.layers, params):
            names = set(layer.state_names())
            trainable.append({k: v for k, v in p.items() if k not in names})
            state.append({k: v for k, v in p.items() if k in names})
        return trainable, state

    def join_state(self, trainable, state):
        return [{**t, **s} for t, s in zip(trainable, state)]

    def cast_params(self, params, dtype):
        """Compute-dtype cast that leaves state leaves (moving stats) in
        f32 — their momentum blend needs more resolution than bf16."""
        trainable, state = self.split_state(params)
        return self.join_state(tree_cast(trainable, dtype), state)

    def forward(self, x, *, training=False, generator=None, device=None):
        """``model(x)``: the forward on ``device`` (the card unless the
        caller asks for the CPU), differentiable in the model's params."""
        self._require_built()
        dev = resolve_device(device)
        params = tree_map(lambda t: t.to(dev), self.params)
        x = torch.as_tensor(x, device=dev)
        if torch.is_floating_point(x):
            x = x.float()
        return self.apply(params, x, training=training, generator=generator)

    @torch.no_grad()
    def predict(self, x, batch_size=None, device=None):
        """Host-facing inference -> numpy (Keras ``model.predict`` parity),
        on ``device`` (the card unless the caller asks for the CPU)."""
        self._require_built()
        dev = resolve_device(device)
        params = tree_map(lambda t: t.to(dev), self.params)
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            x = x.astype(np.float32)

        def run(rows):
            return self.apply(params, torch.as_tensor(rows, device=dev)
                              ).cpu().numpy()

        if batch_size is None or len(x) <= batch_size:
            return run(x)
        return np.concatenate([run(x[i:i + batch_size])
                               for i in range(0, len(x), batch_size)])

    # ------------------------------------------------------------------
    # weights (Keras flat-list contract)
    # ------------------------------------------------------------------
    def get_weights(self):
        self._require_built()
        return [p[name].detach().cpu().numpy().copy()
                for layer, p in zip(self.layers, self.params)
                for name in layer.weight_names()]

    def set_weights(self, weights):
        self._require_built()
        weights = list(weights)
        idx = 0
        new_params = []
        for layer, p in zip(self.layers, self.params):
            q = dict(p)
            for name in layer.weight_names():
                w = np.asarray(weights[idx])
                want = tuple(p[name].shape)
                if tuple(w.shape) != want:
                    raise ValueError(
                        f"weight {idx} for {layer!r}.{name}: shape "
                        f"{w.shape} != {want}")
                q[name] = torch.as_tensor(w.copy()).to(p[name].dtype)
                idx += 1
            new_params.append(q)
        if idx != len(weights):
            raise ValueError(f"got {len(weights)} weights, used {idx}")
        self.set_params(new_params)

    def set_params(self, params):
        """Install a params tree (the trainer's output) directly."""
        params = list(params)
        if len(params) != len(self.layers):
            raise ValueError(f"got params for {len(params)} layers, the "
                             f"model has {len(self.layers)}")
        for layer, p in zip(self.layers, params):
            layer.set_params(p)
        self._built = True

    def _require_built(self):
        if not self._built:
            raise RuntimeError(
                "Model is not built; call .build(input_shape) first")

    # ------------------------------------------------------------------
    # JSON round-trip (utils.py:~40 contract)
    # ------------------------------------------------------------------
    def to_json(self):
        return json.dumps({
            "class_name": "Sequential",
            "name": self.name,
            "input_shape": self.input_shape,
            "layers": [
                {"class_name": type(l).__name__, "config": l.get_config()}
                for l in self.layers
            ],
        })

    def summary(self):
        lines = [f"Model: {self.name}", "-" * 60]
        for layer in self.layers:
            lines.append(f"{type(layer).__name__:<20} {layer.get_config()}")
        if self._built:
            lines.append("-" * 60)
            lines.append(f"Total params: {self.count_params:,}")
        return "\n".join(lines)

    @property
    def count_params(self):
        return sum(int(np.prod(np.shape(w))) for w in self.get_weights())


def model_from_json(js):
    """Architecture JSON -> built Sequential (fresh weights if input_shape
    was recorded; call set_weights to restore trained ones)."""
    d = json.loads(js)
    if d.get("class_name") != "Sequential":
        raise ValueError(f"Unsupported class {d.get('class_name')!r}")
    layers = []
    for spec in d["layers"]:
        cls = LAYER_REGISTRY[spec["class_name"]]
        layers.append(cls.from_config(spec["config"]))
    m = Sequential(layers, name=d.get("name", "sequential"))
    if d.get("input_shape") is not None:
        m.build(tuple(d["input_shape"]))
    return m
