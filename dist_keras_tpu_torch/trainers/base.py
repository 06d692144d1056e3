"""Trainer base class — counterpart of ``trainers/base.py``
(``distkeras/trainers.py``).

``Trainer`` (trainers.py:~35) holds the serialized model + loss + worker
optimizer, records wall-clock training time and exposes
``get_history()`` / ``get_training_time()``, with the JAX package's
names, defaults and semantics, plus ``device``: the card (``cuda``)
unless the caller asks for the CPU.

``DistributedTrainer`` (trainers.py:~290) adds ``num_workers``: the W
workers are stacked on dimension 0 of every per-worker tensor on the
trainer's one device (``parallel/mesh.py``), where the JAX package puts
one worker on each device of a mesh.  ``master_host`` / ``master_port``
are accepted and ignored, as there.

Checkpoints, resume and preemption take the JAX package's kwargs and
semantics: ``checkpoint_dir`` (with ``checkpoint_every`` epochs,
default 1, and ``max_checkpoints`` retained), ``resume`` (``True`` for
the latest verified step, or an explicit step, as the auto-resume
supervisor passes it) and ``handle_preemption`` (SIGTERM/SIGINT ->
boundary checkpoint -> typed ``Preempted``).  The chunked dispatch loop
(``trainers/chunking.py``) owns the cadence saves and the preemption
exit; this class owns the checkpointer, the restore
(:meth:`Trainer._maybe_resume`) and the end-of-run drain.  A run's
random stream is the trainer's ``torch.Generator``: its state is the
checkpoint's ``rng`` leaf, so a resumed run draws the dropout masks an
uninterrupted one would.  A checkpoint whose ``rng`` leaf is a JAX
PRNG key was written by the reference and is refused typed.

Not ported yet, and raising when asked for instead of being ignored:
workers spread over several cards or hosts (a ``mesh``, the multi-host
environment, ``DK_COORD_WORLD`` > 1: ROADMAP queue 1, item 12b).  The
one trainer that takes ``DK_COORD_WORLD`` > 1 is ``ps.PSWorkerTrainer``,
one process on one card talking HTTP to a parameter server.  The
JAX package's jit cache has no counterpart: the port compiles nothing.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from dist_keras_tpu_torch.checkpoint import (
    CheckpointCorrupt,
    CheckpointFormatError,
    apply_template,
)
from dist_keras_tpu_torch.comm import backend as comm
from dist_keras_tpu_torch.observability import events
from dist_keras_tpu_torch.observability import metrics as obs_metrics
from dist_keras_tpu_torch.ops.losses import get_loss
from dist_keras_tpu_torch.ops.optimizers import get_optimizer
from dist_keras_tpu_torch.parallel.mesh import worker_mesh
from dist_keras_tpu_torch.resilience import coordination
from dist_keras_tpu_torch.resilience.guards import normalize_policy
from dist_keras_tpu_torch.utils import knobs
from dist_keras_tpu_torch.utils.device import resolve_device
from dist_keras_tpu_torch.utils.pytree import tree_map, tree_stack
from dist_keras_tpu_torch.utils.serialization import (
    deserialize_model,
    serialize_model,
)


def _refuse_multi_host():
    """``DK_COORD_WORLD`` > 1 asks for workers across hosts."""
    world = knobs.raw("DK_COORD_WORLD")
    if world is not None and int(world) > 1:
        raise NotImplementedError(
            f"DK_COORD_WORLD={world}: workers across hosts are not ported "
            "yet (ROADMAP queue 1, item 12b: workers across cards through "
            "torch.distributed); a trainer runs on one card")


class Trainer:
    # a PS worker (ps/worker.py) is one process on one card talking HTTP
    # and takes the multi-host launch environment; every other trainer
    # refuses it (item 12b)
    accepts_coord_world = False

    def __init__(self, keras_model, loss="categorical_crossentropy",
                 worker_optimizer="adam", optimizer_kwargs=None,
                 features_col="features", label_col="label",
                 batch_size=32, num_epoch=1, seed=0, compute_dtype=None,
                 data_dtype=np.float32,
                 checkpoint_dir=None, checkpoint_every=None,
                 max_checkpoints=3, resume=False, callbacks=None,
                 nan_policy="raise", handle_preemption=False, device=None):
        if not self.accepts_coord_world:
            _refuse_multi_host()
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
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = (int(checkpoint_every)
                                 if checkpoint_every else None)
        if self.checkpoint_every and not self.checkpoint_dir:
            raise ValueError(
                "checkpoint_every requires checkpoint_dir (otherwise the "
                "dispatch would be chunked but nothing ever saved)")
        if self.checkpoint_dir and self.checkpoint_every is None:
            self.checkpoint_every = 1
        self.max_checkpoints = int(max_checkpoints)
        # resume: False = fresh run; True = continue from the latest
        # (verified — restore() falls back past a corrupt step) step;
        # an INT = continue from exactly that step (what the auto-resume
        # supervisor passes as its resume_step)
        if isinstance(resume, bool) or resume is None:
            self.resume = bool(resume)
        else:
            self.resume = int(resume)
        # install SIGTERM/SIGINT handlers around the dispatch loop; on
        # delivery, checkpoint at the next chunk boundary and raise
        # resilience.Preempted (exit code 128+signum)
        self.handle_preemption = bool(handle_preemption)
        self._checkpointer = None
        self._last_ckpt_epoch = None  # units of the last save
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
        # drain any in-flight async checkpoint save first (bounded by
        # the coordination deadline) so a completed train() leaves its
        # last cadence save promoted — but never raise from here: it
        # also runs right before `raise Preempted`, and a raise would
        # replace the typed exit.  The clean path surfaces deferred
        # background-save errors in ChunkRunner.run's post-record probe.
        if self._checkpointer is not None:
            self._checkpointer.wait_until_finished(
                timeout_s=coordination.default_timeout_s(),
                raise_errors=False)
        self._t_stop = time.time()
        events.emit("train_end", trainer=type(self).__name__,
                    seconds=self.get_training_time())

    def get_training_time(self):
        if self._t_start is None or self._t_stop is None:
            return 0.0
        return self._t_stop - self._t_start

    def get_history(self):
        """Per-step training losses.

        Shapes by trainer: SingleTrainer -> (steps,); AveragingTrainer ->
        (workers, epochs, steps); EnsembleTrainer -> (num_models, epochs,
        steps); the windowed family (DOWNPOUR/ADAG/AEASGD/EAMSGD) ->
        (workers, epochs, windows, W); DynSGD -> (workers, epochs,
        steps)."""
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

    # ---- checkpoint / resume ----
    def _checkpointer_or_none(self):
        if self.checkpoint_dir and self._checkpointer is None:
            from dist_keras_tpu_torch.checkpoint import Checkpointer

            self._checkpointer = Checkpointer(
                self.checkpoint_dir, max_to_keep=self.max_checkpoints)
        return self._checkpointer

    def _maybe_resume(self, incompatible_hint=None):
        """-> (start units, restored host state | None).

        The restore is verified (a corrupt step is quarantined and the
        previous one loaded); the RETURNED step is authoritative, so the
        cadence counter and the dispatch start follow the state
        actually loaded.  Transient I/O errors, ``CheckpointCorrupt``
        and ``CheckpointFormatError`` propagate as themselves (the
        supervisor retries the first two); anything else is re-raised
        as a ``ValueError`` carrying ``incompatible_hint``."""
        self._last_ckpt_epoch = None
        ckptr = self._checkpointer_or_none()
        # resume=0 is an EXPLICIT step (the supervisor's resume_step can
        # be the unit-0 preemption save): test identity against False
        if self.resume is False or ckptr is None:
            return 0, None
        explicit = None if self.resume is True else int(self.resume)
        if explicit is None and ckptr.latest_step() is None:
            return 0, None
        try:
            step, state = ckptr.restore(step=explicit)
        except (OSError, CheckpointCorrupt, CheckpointFormatError):
            raise
        # dklint: ignore[broad-except] re-raised with an actionable hint
        except Exception as e:
            if incompatible_hint:
                raise ValueError(
                    f"checkpoint restore failed ({type(e).__name__}: {e}); "
                    f"{incompatible_hint}") from e
            raise
        events.emit("resume", step=int(step), requested=explicit,
                    trainer=type(self).__name__)
        self._last_ckpt_epoch = int(step)
        return int(step), state

    def _restored(self, restored, template, step, hint):
        """The restored host state on ``template``'s structure, dtypes
        and devices.  The ``rng`` leaf must be a ``torch.Generator``
        state (uint8): a JAX PRNG key (uint32) means the reference wrote
        the checkpoint, and its random stream cannot continue here."""
        rng = restored.get("rng") if isinstance(restored, dict) else None
        if rng is not None and getattr(rng, "dtype", None) not in (
                np.uint8, torch.uint8):
            raise CheckpointFormatError(
                f"checkpoint step {step} in {self.checkpoint_dir} was "
                "written by the JAX package: its 'rng' leaf is a JAX PRNG "
                f"key ({getattr(rng, 'dtype', type(rng))}), not a "
                "torch.Generator state, and its random stream cannot "
                "continue in the port.  Carry the weights and optimizer "
                "state over instead: Checkpointer.restore, then "
                "utils/bridge.py's params_from_jax and "
                "opt_state_from_optax, and start a port run from them")
        try:
            return apply_template(restored, template)
        except ValueError as e:
            raise ValueError(f"{e}; {hint}") from e

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

    def _device_params(self, params):
        """A copy of a params tree on the trainer's device."""
        return tree_map(lambda t: t.detach().to(self.device, copy=True),
                        params)

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


class DistributedTrainer(Trainer):
    """Base for every multi-worker trainer (trainers.py:~290).

    The ``num_workers`` workers live on the trainer's one device,
    stacked on dimension 0 (:meth:`_stack_workers`), so their count is
    not bounded by the number of cards.  ``mesh`` (an explicit device
    layout) and the multi-host environment raise ``NotImplementedError``
    (ROADMAP queue 1, item 12b)."""

    def __init__(self, keras_model, num_workers=2, master_host=None,
                 master_port=5000, mesh=None, **kw):
        if mesh is not None:
            raise NotImplementedError(
                "mesh: workers spread over an explicit device mesh are not "
                "ported yet (ROADMAP queue 1, item 12b: workers across "
                "cards through torch.distributed); the port stacks the "
                "workers on the trainer's one device")
        # single-process bring-up: raises on a multi-host environment
        comm.initialize()
        _refuse_multi_host()
        super().__init__(keras_model, **kw)
        self.num_workers = int(num_workers)
        # master_host/master_port: reference PS kwargs, accepted for parity
        del master_host, master_port
        self._mesh = None

    @property
    def mesh(self):
        """The :class:`~dist_keras_tpu_torch.parallel.mesh.WorkerMesh` of
        ``num_workers`` stacked slots on the trainer's device."""
        if self._mesh is None:
            self._mesh = worker_mesh(self.num_workers, self.device)
        return self._mesh

    def _shards(self, dataset):
        """-> (xs, ys) host arrays ``(num_workers, steps, batch, ...)``:
        rows dealt to workers contiguously (``Dataset.worker_shards``)."""
        return dataset.worker_shards(
            self.num_workers, self.batch_size,
            features_col=self.features_col, label_col=self.label_col,
            dtype=self.data_dtype)

    def _stack_workers(self, tree, n=None):
        """``n`` (default ``num_workers``) real copies of ``tree`` stacked
        on dim 0, on the trainer's device: the layout of per-worker
        state (local replicas, optimizer state, pulled snapshots)."""
        return tree_stack(self._device_params(tree),
                          self.num_workers if n is None else n)

    def _make_worker_step(self, model, loss_fn, tx):
        """``make_worker_step`` with this trainer's NaN policy — the
        worker-stacked counterpart of :meth:`Trainer._make_step`."""
        from dist_keras_tpu_torch.trainers.step import make_worker_step

        return make_worker_step(
            model, loss_fn, tx, self.compute_dtype,
            skip_nonfinite=(self.nan_policy == "skip"))
