"""SingleTrainer — counterpart of ``trainers/single.py``
(``distkeras/trainers.py:~100``).

Reference path: coalesce the DataFrame to one partition and run an
epochs x train_on_batch loop in one Spark task (SURVEY.md §3.1).  The
JAX package scans all global steps in one jitted dispatch; here the
steps run as a plain Python loop over the same global step index, on
the trainer's device:

- the epoch's batches are copied to the device once (or streamed), and
  step ``t`` reads batch ``t % steps_per_epoch``, as the reference's
  scan does;
- each step's loss is written into a device tensor of the chunk, which
  the runner fetches once per chunk (``trainers/chunking.py``);
- one ``torch.Generator`` on the device, seeded with ``seed``, is the
  run's random stream (dropout masks), continuous across epochs as the
  reference's PRNG chain is.

``data_dtype=None`` ships the dataset's own dtype (uint8 images) and
casts on the device inside the step.

Checkpoints are step-granular, as the reference's: the payload is
``{"params", "opt_state", "rng", "t_units"}`` saved every
``checkpoint_every`` epochs (in steps), ``rng`` being the generator's
state, so a resumed run continues the very random stream.

``stream_chunk_steps=C`` (or a ``max_resident_bytes`` budget the epoch
exceeds) streams the epoch C steps per chunk through the double-buffered
``ChunkFeed`` instead of copying it to the card whole
(``trainers/chunking.py``); the steps read the same rows either way.
"""

from __future__ import annotations

import numpy as np
import torch

from dist_keras_tpu_torch.trainers.base import Trainer
from dist_keras_tpu_torch.trainers.chunking import init_streaming, run_chunked
from dist_keras_tpu_torch.utils.pytree import tree_map


class SingleTrainer(Trainer):
    def __init__(self, keras_model, stream_chunk_steps=None,
                 max_resident_bytes=None, **kw):
        init_streaming(self, stream_chunk_steps, max_resident_bytes,
                       name="stream_chunk_steps")
        super().__init__(keras_model, **kw)

    def train(self, dataset, shuffle=False):
        model, loss_fn, tx = self._resolve()
        if shuffle:
            dataset = dataset.shuffle(seed=self.seed)
        xb, yb = dataset.batches(
            self.batch_size, self.features_col, self.label_col,
            dtype=self.data_dtype)
        spb = xb.shape[0]  # steps per epoch
        dev = self.device

        step, opt_init = self._make_step(model, loss_fn, tx)
        params = tree_map(lambda v: v.detach().to(dev, copy=True),
                          model.params)
        opt_state = opt_init(params)
        generator = torch.Generator(device=dev).manual_seed(self.seed)

        # t_units marks the checkpoint's step counter as STEP-granular
        # (the reference's older format counted epochs)
        hint = ("if this checkpoint predates step-granular SingleTrainer "
                "state (no 't_units' leaf, step counted epochs not "
                "steps), restart training or point checkpoint_dir at a "
                "fresh directory")
        start_t, restored = self._maybe_resume(hint)
        if restored is not None:
            if "t_units" not in restored:
                raise ValueError(
                    "checkpoint predates step-granular SingleTrainer "
                    "state (no 't_units' leaf; its step counts epochs, "
                    "not steps) — restart training or point "
                    "checkpoint_dir at a fresh directory")
            state = self._restored(
                restored, {"params": params, "opt_state": opt_state,
                           "rng": generator.get_state(),
                           "t_units": np.zeros((), np.int32)},
                start_t, hint)
            params, opt_state = state["params"], state["opt_state"]
            generator.set_state(state["rng"])

        def dispatch(i, T, steps_done, data):
            nonlocal params, opt_state
            xs, ys = data
            losses = torch.empty(T, dtype=torch.float32, device=dev)
            carry = (params, opt_state, generator)
            for j in range(T):
                si = (steps_done + j) % spb
                carry, loss = step(carry, (xs[si], ys[si]))
                losses[j] = loss
            params, opt_state, _ = carry
            return losses

        # a dummy leading worker axis: the feed slices axis 1
        history = run_chunked(
            self, xb[None], yb[None], start=start_t,
            total=self.num_epoch * spb, per_epoch=spb,
            stream_units=self.stream_chunk_steps,
            cadence=(self.checkpoint_every * spb
                     if self.checkpoint_every else None),
            samples_per_unit=self.batch_size, dispatch=dispatch,
            sync_ref=lambda: params,
            state_fn=lambda: {"params": params, "opt_state": opt_state,
                              "rng": generator.get_state(),
                              "t_units": np.zeros((), np.int32)},
            carry_leaves=(params, opt_state))
        return self._finalize(params, history)
