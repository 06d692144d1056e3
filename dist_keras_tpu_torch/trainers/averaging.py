"""AveragingTrainer and EnsembleTrainer — counterpart of
``trainers/averaging.py``.

- ``AveragingTrainer`` (trainers.py:~160): per epoch, every worker trains
  a full pass over its shard from the merged weights with a fresh
  optimizer, then the weights are averaged.  The reference collects the
  weight lists to the driver and numpy-means them (trainers.py:~190); the
  JAX package runs one ``pmean`` over the mesh; here it is one mean over
  the stacked workers' dimension on the card.

- ``EnsembleTrainer`` (trainers.py:~230): ``num_models`` independent
  replicas, stacked on one dimension and stepped together, with no
  merge; returns the list of models.

Across processes each rank stacks its own range of the workers (of the
models, for the ensemble: slot ``s`` holds models ``[s*mps, (s+1)*mps)``
as in the JAX package) and feeds their rows; the averaging merge is a
cross-rank ``tree_pmean_sync`` and the ensemble's models are gathered
from every rank at the end.

Both run their steps as a Python loop over the global step index, the
worker-stacked step (``trainers/step.py``) on data resident on the
device or streamed to it, with one device ``torch.Generator`` seeded with ``seed`` for
every replica's dropout (``windowed.py`` says why it cannot reproduce
the JAX package's per-worker streams).  Checkpoints are step-granular,
as the reference's: Averaging saves ``{"params", "local", "opt_state",
"rng"}``, Ensemble ``{"params", "opt_state", "rng"}`` (``params`` being
the stacked replicas), ``rng`` the generator's state.  ``stream_chunk_steps=C`` streams the data C
steps per chunk through the ``ChunkFeed`` (Ensemble's one shard per
model rides each chunk); ``max_resident_bytes`` turns streaming on when
the epoch exceeds it.
"""

from __future__ import annotations

import torch

from dist_keras_tpu_torch.comm import backend as comm
from dist_keras_tpu_torch.parallel.collectives import tree_pmean_sync
from dist_keras_tpu_torch.trainers.base import DistributedTrainer
from dist_keras_tpu_torch.trainers.chunking import (
    init_streaming,
    reject_stale_checkpoint,
    run_chunked,
)
from dist_keras_tpu_torch.utils.pytree import tree_map


class AveragingTrainer(DistributedTrainer):
    """Per-epoch weight averaging (trainers.py:~160).  History is
    ``(workers, epochs, steps)``."""

    def __init__(self, keras_model, stream_chunk_steps=None,
                 max_resident_bytes=None, **kw):
        init_streaming(self, stream_chunk_steps, max_resident_bytes,
                       name="stream_chunk_steps")
        super().__init__(keras_model, **kw)

    def train(self, dataset, shuffle=False):
        model, loss_fn, tx = self._resolve()
        if shuffle:
            dataset = dataset.shuffle(seed=self.seed)
        xs, ys = self._shards(dataset)  # (workers, steps, batch, ...)
        spe = xs.shape[1]
        step, opt_init = self._make_worker_step(model, loss_fn, tx)
        params = self._device_params(model.params)
        local = self._stack_workers(params)
        opt_state = self._stack_workers(opt_init(params))
        generator = torch.Generator(device=self.device).manual_seed(
            self.seed)
        hint = ("if this checkpoint predates step-granular "
                "AveragingTrainer state (params only, step counted "
                "epochs not steps), restart training or point "
                "checkpoint_dir at a fresh directory")
        start_t, restored = self._maybe_resume(hint)
        reject_stale_checkpoint(
            restored, "local", "AveragingTrainer",
            "params only; its step counts epochs, not steps")
        if restored is not None:
            state = self._restored(
                restored, {"params": params, "local": local,
                           "opt_state": opt_state,
                           "rng": generator.get_state()}, start_t, hint)
            params, local = state["params"], state["local"]
            opt_state = state["opt_state"]
            generator.set_state(state["rng"])

        def dispatch(i, T, steps_done, data):
            nonlocal params, local, opt_state
            xs_d, ys_d = data
            losses = []
            for t in range(steps_done, steps_done + T):
                si = t % spe
                if si == 0:
                    # epoch start: a fresh local replica of the merged
                    # params and a fresh worker optimizer (the reference
                    # recompiles per epoch, trainers.py:~170)
                    local = self._stack_workers(params)
                    opt_state = self._stack_workers(opt_init(params))
                (local, opt_state, _), loss = step(
                    (local, opt_state, generator), (xs_d[si], ys_d[si]))
                losses.append(loss)
                if si == spe - 1:
                    # epoch end: mean of the float weights, max of the
                    # lockstep integer leaves
                    params = tree_pmean_sync(local, total=self.num_workers)
            return torch.stack(losses, 1)   # (workers, T)

        history = run_chunked(
            self, xs, ys, start=start_t, total=self.num_epoch * spe,
            per_epoch=spe,
            cadence=(self.checkpoint_every * spe
                     if self.checkpoint_every else None),
            samples_per_unit=self.num_workers * self.batch_size,
            dispatch=dispatch, sync_ref=lambda: params,
            state_fn=lambda: {"params": params, "local": local,
                              "opt_state": opt_state,
                              "rng": generator.get_state()},
            carry_leaves=(params, local, opt_state),
            stream_units=self.stream_chunk_steps, unit_dims=1,
            fetch_global=comm.fetch_global)
        return self._finalize(params, history)


class EnsembleTrainer(DistributedTrainer):
    """Trains ``num_models`` independent replicas; returns a list of
    models (majority voting at predict time is up to the user, as
    upstream).

    The replicas are stacked on one dimension of the rank's device and
    stepped together.  ``num_workers`` keeps the JAX package's meaning,
    mesh slots: one per process unless passed (``min(num_models,
    processes)``), and ``num_models`` must divide evenly over them
    (``models_per_slot``).  One data shard per model, as upstream (one
    partition per model).  History is ``(num_models, epochs, steps)``."""

    def __init__(self, keras_model, num_models=2, stream_chunk_steps=None,
                 max_resident_bytes=None, **kw):
        self.num_models = int(num_models)
        slots = kw.pop("num_workers", None)
        if slots is None:
            # the process count must come after the group's bring-up
            comm.initialize(device=kw.get("device"))
            slots = min(self.num_models, comm.num_processes())
        if self.num_models % slots:
            raise ValueError(
                f"num_models={num_models} must divide evenly over "
                f"{slots} mesh slots (pad num_models or pass "
                "num_workers=<divisor>)")
        init_streaming(self, stream_chunk_steps, max_resident_bytes,
                       name="stream_chunk_steps")
        super().__init__(keras_model, num_workers=slots, **kw)
        self.models_per_slot = self.num_models // slots

    def train(self, dataset, shuffle=False):
        model, loss_fn, tx = self._resolve()
        if shuffle:
            dataset = dataset.shuffle(seed=self.seed)
        # slots [lo, hi) on this rank hold models [lo*mps, hi*mps)
        lo, hi = self._local_worker_range()
        mps = self.models_per_slot
        xs, ys = dataset.worker_shards(
            self.num_models, self.batch_size,
            features_col=self.features_col, label_col=self.label_col,
            worker_range=(lo * mps, hi * mps) if self._split else None,
            dtype=self.data_dtype)   # (local models, steps, batch, ...)
        spe = xs.shape[1]
        n = xs.shape[0]
        step, opt_init = self._make_worker_step(model, loss_fn, tx)
        params = self._device_params(model.params)
        stacked = self._stack_workers(params, n)
        opt_state = self._stack_workers(opt_init(params), n)
        generator = torch.Generator(device=self.device).manual_seed(
            self.seed)
        hint = ("if this checkpoint predates step-granular "
                "EnsembleTrainer state (no rng leaf, step counted epochs "
                "not steps), restart training or point checkpoint_dir at "
                "a fresh directory")
        start_t, restored = self._maybe_resume(hint)
        reject_stale_checkpoint(
            restored, "rng", "EnsembleTrainer",
            "no rng leaf; its step counts epochs, not steps")
        if restored is not None:
            state = self._restored(
                restored, {"params": stacked, "opt_state": opt_state,
                           "rng": generator.get_state()}, start_t, hint)
            stacked, opt_state = state["params"], state["opt_state"]
            generator.set_state(state["rng"])

        def dispatch(i, T, steps_done, data):
            nonlocal stacked, opt_state
            xs_d, ys_d = data
            carry, losses = (stacked, opt_state, generator), []
            for t in range(steps_done, steps_done + T):
                carry, loss = step(carry, (xs_d[t % spe], ys_d[t % spe]))
                losses.append(loss)
            stacked, opt_state, _ = carry
            return torch.stack(losses, 1)   # (num_models, T)

        self.history = run_chunked(
            self, xs, ys, start=start_t, total=self.num_epoch * spe,
            per_epoch=spe,
            cadence=(self.checkpoint_every * spe
                     if self.checkpoint_every else None),
            samples_per_unit=self.num_models * self.batch_size,
            dispatch=dispatch, sync_ref=lambda: stacked,
            state_fn=lambda: {"params": stacked, "opt_state": opt_state,
                              "rng": generator.get_state()},
            carry_leaves=(stacked, opt_state),
            stream_units=self.stream_chunk_steps, unit_dims=1,
            fetch_global=comm.fetch_global)
        # one device->host copy (every rank's models) for the whole
        # ensemble, then slice
        host = comm.fetch_global(stacked)
        models = []
        for i in range(self.num_models):
            m = self._fresh_model()
            m.set_params(tree_map(lambda x: torch.from_numpy(x[i].copy()),
                                  host))
            models.append(m)
        return models
