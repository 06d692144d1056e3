"""Trainer base class — counterpart of ``trainers/base.py``
(``distkeras/trainers.py``).

``Trainer`` (trainers.py:~35) holds the serialized model + loss + worker
optimizer, records wall-clock training time and exposes
``get_history()`` / ``get_training_time()``, with the JAX package's
names, defaults and semantics, plus ``device``: the card (``cuda``)
unless the caller asks for the CPU.

Not ported yet, and raising when asked for instead of being ignored:
checkpoints, resume and preemption (``checkpoint_dir``,
``checkpoint_every``, ``max_checkpoints``, ``resume``,
``handle_preemption``: ROADMAP queue 1, item 19) and
``DistributedTrainer`` (item 21).  The JAX package's jit cache has no
counterpart: the port compiles nothing.
"""

from __future__ import annotations

import time

import numpy as np

from dist_keras_tpu_torch.observability import events
from dist_keras_tpu_torch.observability import metrics as obs_metrics
from dist_keras_tpu_torch.ops.losses import get_loss
from dist_keras_tpu_torch.ops.optimizers import get_optimizer
from dist_keras_tpu_torch.resilience.guards import normalize_policy
from dist_keras_tpu_torch.utils.device import resolve_device
from dist_keras_tpu_torch.utils.serialization import (
    deserialize_model,
    serialize_model,
)

# kwargs of the reference's Trainer that wait for checkpoint.py and
# resilience/ (ROADMAP queue 1, item 19), with their off values
_UNPORTED = {"checkpoint_dir": None, "checkpoint_every": None,
             "max_checkpoints": 3, "resume": False,
             "handle_preemption": False}


class Trainer:
    def __init__(self, keras_model, loss="categorical_crossentropy",
                 worker_optimizer="adam", optimizer_kwargs=None,
                 features_col="features", label_col="label",
                 batch_size=32, num_epoch=1, seed=0, compute_dtype=None,
                 data_dtype=np.float32,
                 checkpoint_dir=None, checkpoint_every=None,
                 max_checkpoints=3, resume=False, callbacks=None,
                 nan_policy="raise", handle_preemption=False, device=None):
        given = {"checkpoint_dir": checkpoint_dir,
                 "checkpoint_every": checkpoint_every,
                 "max_checkpoints": max_checkpoints, "resume": resume,
                 "handle_preemption": handle_preemption}
        unported = sorted(
            k for k, v in given.items()
            if type(v) is not type(_UNPORTED[k]) or v != _UNPORTED[k])
        if unported:
            raise NotImplementedError(
                f"{', '.join(unported)}: checkpoints, resume and preemption "
                "are not ported yet (ROADMAP queue 1, item 19)")
        self.device = resolve_device(device)
        self.serialized_model = serialize_model(keras_model)
        self.loss = loss
        self.worker_optimizer = worker_optimizer
        self.optimizer_kwargs = dict(optimizer_kwargs or {})
        self.features_col = features_col
        self.label_col = label_col
        self.batch_size = int(batch_size)
        self.num_epoch = int(num_epoch)
        self.seed = int(seed)
        self.compute_dtype = compute_dtype
        # dtype the host batches are materialized (and copied to the
        # device) in; None keeps the columns' own dtypes (uint8 images
        # then cross at 1/4 the f32 volume and the step casts them)
        self.data_dtype = data_dtype
        self.callbacks = list(callbacks or [])
        # what the loss sentinel does on NaN/Inf: "raise", "skip" (the
        # step keeps the previous params/opt state), "halt", or None
        self.nan_policy = normalize_policy(nan_policy)
        self.nonfinite_steps = 0   # cumulative non-finite loss entries
        self._nonfinite_emitted = 0
        self.metrics = []  # per-epoch {"epoch", "mean_loss", ...}
        self.history = []
        self._t_start = None
        self._t_stop = None

    # ---- timing (trainers.py:~60) ----
    def record_training_start(self):
        self._t_start = time.time()
        events.emit("train_start", trainer=type(self).__name__,
                    num_epoch=self.num_epoch, batch_size=self.batch_size)

    def record_training_end(self):
        self._t_stop = time.time()
        events.emit("train_end", trainer=type(self).__name__,
                    seconds=self.get_training_time())

    def get_training_time(self):
        if self._t_start is None or self._t_stop is None:
            return 0.0
        return self._t_stop - self._t_start

    def get_history(self):
        """Per-step training losses; SingleTrainer -> (steps,)."""
        return self.history

    def get_averaged_history(self):
        return float(np.mean(np.asarray(self.history))) if len(
            np.ravel(self.history)) else float("nan")

    def _emit_epoch_end(self, epochs_done, losses, seconds, samples):
        """Record structured per-epoch metrics; fire callbacks.

        Under nan_policy="skip" — and only there — ``mean_loss`` averages
        the finite losses; every other policy keeps the plain mean, so a
        divergence still surfaces as a NaN mean_loss.  The non-finite
        count is reported alongside either way."""
        arr = np.asarray(losses, dtype=np.float64)
        if self.nan_policy == "skip" and arr.size:
            arr = arr[np.isfinite(arr)]
        logs = {
            "epoch": epochs_done,
            "mean_loss": float(np.mean(arr)) if arr.size else
            float("nan"),
            "seconds": float(seconds),
            "samples_per_sec": float(samples / seconds) if seconds > 0
            else float("nan"),
            "nonfinite_steps": self.nonfinite_steps
            - self._nonfinite_emitted,
        }
        self._nonfinite_emitted = self.nonfinite_steps
        self.metrics.append(logs)
        events.emit("epoch_end", trainer=type(self).__name__, **logs)
        obs_metrics.emit_snapshot(epoch=epochs_done)
        for cb in self.callbacks:
            hook = getattr(cb, "on_epoch_end", cb)
            hook(self, epochs_done, logs)

    # ---- shared plumbing ----
    def _fresh_model(self):
        return deserialize_model(self.serialized_model)

    def _resolve(self):
        """-> (model, loss_fn, optimizer)."""
        model = self._fresh_model()
        return (model, get_loss(self.loss),
                get_optimizer(self.worker_optimizer, **self.optimizer_kwargs))

    def _make_step(self, model, loss_fn, tx):
        """``make_model_step`` with this trainer's NaN policy — the seam
        every trainer builds its step through."""
        from dist_keras_tpu_torch.trainers.step import make_model_step

        return make_model_step(
            model, loss_fn, tx, self.compute_dtype,
            skip_nonfinite=(self.nan_policy == "skip"))

    def _finalize(self, params, history):
        """Install the trained params, copied to the host, into a fresh
        model; record history."""
        self.history = history
        model = self._fresh_model()
        model.set_params([{k: v.detach().cpu() for k, v in p.items()}
                          for p in params])
        return model

    def train(self, dataset, shuffle=False):
        raise NotImplementedError
