"""SingleTrainer — counterpart of ``trainers/single.py``
(``distkeras/trainers.py:~100``).

Reference path: coalesce the DataFrame to one partition and run an
epochs x train_on_batch loop in one Spark task (SURVEY.md §3.1).  The
JAX package scans all global steps in one jitted dispatch; here the
steps run as a plain Python loop over the same global step index, on
the trainer's device:

- the epoch's batches are copied to the device once, and step ``t``
  reads batch ``t % steps_per_epoch``, as the reference's scan does;
- each step's loss is written into a device tensor of the chunk, which
  the runner fetches once per chunk (``trainers/chunking.py``);
- one ``torch.Generator`` on the device, seeded with ``seed``, is the
  run's random stream (dropout masks), continuous across epochs as the
  reference's PRNG chain is.

``data_dtype=None`` ships the dataset's own dtype (uint8 images) and
casts on the device inside the step.  Streaming (``stream_chunk_steps``,
``max_resident_bytes``) is not ported yet and raises.
"""

from __future__ import annotations

import torch

from dist_keras_tpu_torch.trainers.base import Trainer
from dist_keras_tpu_torch.trainers.chunking import init_streaming, run_chunked


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
        params = [{k: v.detach().to(dev, copy=True) for k, v in p.items()}
                  for p in model.params]
        opt_state = opt_init(params)
        generator = torch.Generator(device=dev).manual_seed(self.seed)

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

        history = run_chunked(
            self, xb, yb, total=self.num_epoch * spb, per_epoch=spb,
            samples_per_unit=self.batch_size, dispatch=dispatch,
            sync_ref=lambda: params, carry_leaves=(params, opt_state))
        return self._finalize(params, history)
