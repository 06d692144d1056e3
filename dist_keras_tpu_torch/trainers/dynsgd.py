"""DynSGD — staleness-scaled commits with real staleness, counterpart of
``trainers/dynsgd.py``.

Reference semantics (workers.py:~530 + parameter_servers.py:~280): each
worker commits ``{delta, last_seen_update}`` and the PS scales the commit
by ``1/(staleness+1)`` where ``staleness = num_updates -
last_seen_update``.  Lockstep commits would have no staleness, so the
schedule is staggered as in the JAX package: worker ``i`` commits every
``communication_window`` steps at phase ``(i * window) // num_workers``.
The center then moves between a worker's pull and its next commit, and
the staleness counter measures how many center updates it missed.

The schedule — who commits at step ``t``, with what staleness — is a
pure function of ``t``, the window and the worker count, so
:func:`commit_schedule` works it out on the host once, before the run,
and the commit counters (``global_count``, ``last_seen``) are host
integers.  The JAX package computes the same values on the device with
a masked ``psum`` at every step; here a step where nobody commits runs
no merge at all, and a step where someone does reads its scale and mask
rows from the schedule, uploaded once with the data, so nothing in the
loop reads a value back from the card.

Across processes the schedule stays global (every rank works it out for
all W workers, so the staleness counters are the cluster's, as the
JAX package's masked ``psum``): each rank slices its own workers'
columns, runs the merge at every step where ANY worker commits (the
all-reduce needs every rank) and sums the commits through the
cross-rank ``tree_psum``.

Checkpoints are step-granular (``checkpoint_every_windows`` counts
windows of ``communication_window`` steps, ``checkpoint_every``
epochs): the payload is the reference's ``{"center", "pulled",
"local", "opt_state", "last_seen", "global_count", "rng"}``.  The two
counters are the schedule's at the saved step (int32, ``(workers,)``
and ``()``); a resume checks them against the schedule, so a checkpoint
of another worker count or window is refused.

``stream_chunk_windows=C`` streams the data C windows (C x
``communication_window`` steps) per chunk through the ``ChunkFeed``;
``max_resident_bytes`` turns streaming on when the epoch exceeds it.
"""

from __future__ import annotations

import numpy as np
import torch

from dist_keras_tpu_torch.comm import backend as comm
from dist_keras_tpu_torch.parallel.collectives import tree_psum
from dist_keras_tpu_torch.trainers.chunking import run_chunked
from dist_keras_tpu_torch.trainers.windowed import (
    AsynchronousDistributedTrainer,
)
from dist_keras_tpu_torch.utils.pytree import tree_map, tree_merge_floats


def commit_schedule(total_steps, window, num_workers):
    """-> ``(commits, staleness, scale)``, each ``(total_steps,
    num_workers)``: whether worker ``i`` commits after step ``t``, its
    staleness then (center updates since its last pull; 0 where it does
    not commit), and its commit's f32 scale ``1 / (staleness + 1)`` (0
    where it does not commit).  Commits at one step are all measured
    against the count before that step's commits land, as in the JAX
    package's masked ``psum``."""
    phase = (np.arange(num_workers) * window) // num_workers
    commits = np.zeros((total_steps, num_workers), bool)
    staleness = np.zeros((total_steps, num_workers), np.int64)
    last_seen = np.zeros(num_workers, np.int64)
    global_count = 0
    for t in range(total_steps):
        c = (t + 1 + phase) % window == 0
        commits[t] = c
        staleness[t] = np.where(c, global_count - last_seen, 0)
        global_count += int(c.sum())
        last_seen = np.where(c, global_count, last_seen)
    scale = np.where(commits, np.float32(1.0) / (
        staleness.astype(np.float32) + np.float32(1.0)), np.float32(0.0))
    return commits, staleness, scale.astype(np.float32)


def counters_at(commits, t):
    """-> ``(last_seen, global_count)`` before step ``t``: the commit
    counters the reference carries, from the schedule's first ``t``
    rows (int32, ``(workers,)`` and ``()``)."""
    last_seen = np.zeros(commits.shape[1], np.int32)
    global_count = 0
    for row in commits[:t]:
        global_count += int(row.sum())
        last_seen = np.where(row, global_count, last_seen).astype(np.int32)
    return last_seen, np.asarray(global_count, np.int32)


def _lead(v, x):
    """A per-worker ``(W,)`` vector shaped to broadcast over ``x``."""
    return v.reshape((-1,) + (1,) * (x.dim() - 1))


class DynSGD(AsynchronousDistributedTrainer):
    """trainers.py:~700 / workers.py:~530.  History is ``(workers,
    epochs, steps)``."""

    def merge(self, center, local):  # pragma: no cover - not windowed
        raise NotImplementedError(
            "DynSGD commits per-step with staggered phases; it does not "
            "use the windowed merge hook")

    def train(self, dataset, shuffle=False):
        model, loss_fn, tx = self._resolve()
        if shuffle:
            dataset = dataset.shuffle(seed=self.seed)
        xs, ys = self._shards(dataset)  # (workers, steps, batch, ...)
        spe = xs.shape[1]  # steps per epoch
        total_t = self.num_epoch * spe
        step, opt_init = self._make_worker_step(model, loss_fn, tx)

        commits, _, scale = commit_schedule(
            total_t, self.communication_window, self.num_workers)
        any_commit = commits.any(1)
        lo, hi = self._local_worker_range()
        scale_d = torch.from_numpy(
            np.ascontiguousarray(scale[:, lo:hi])).to(self.device)
        commits_d = torch.from_numpy(
            np.ascontiguousarray(commits[:, lo:hi])).to(self.device)

        center = self._device_params(model.params)
        pulled = self._stack_workers(center)
        local = self._stack_workers(center)
        opt_state = self._stack_workers(opt_init(center))
        generator = torch.Generator(device=self.device).manual_seed(
            self.seed)
        hint = ("if this checkpoint predates step-granular DynSGD "
                "training state (no 'rng' leaf, step counted epochs not "
                "steps), restart training or point checkpoint_dir at a "
                "fresh directory")
        start_t, restored = self._maybe_resume(hint)
        if restored is not None:
            if "rng" not in restored:
                raise ValueError(
                    "checkpoint predates step-granular DynSGD training "
                    "state (no 'rng' leaf; its step counts epochs, not "
                    "steps) — restart training or point checkpoint_dir "
                    "at a fresh directory")
            last_seen, global_count = counters_at(commits, start_t)
            state = self._restored(
                restored, {"center": center, "pulled": pulled,
                           "local": local, "opt_state": opt_state,
                           "last_seen": last_seen,
                           "global_count": global_count,
                           "rng": generator.get_state()}, start_t, hint)
            if not (np.array_equal(state["last_seen"], last_seen)
                    and int(state["global_count"]) == int(global_count)):
                raise ValueError(
                    f"checkpoint step {start_t}'s DynSGD commit counters "
                    f"(last_seen {state['last_seen'].tolist()}, "
                    f"global_count {int(state['global_count'])}) are not "
                    "this run's schedule's — it was written with another "
                    "num_workers or communication_window")
            center, pulled = state["center"], state["pulled"]
            local, opt_state = state["local"], state["opt_state"]
            generator.set_state(state["rng"])

        def state_fn():
            last_seen, global_count = counters_at(commits, done[0])
            return {"center": center, "pulled": pulled, "local": local,
                    "opt_state": opt_state, "last_seen": last_seen,
                    "global_count": global_count,
                    "rng": generator.get_state()}

        done = [start_t]   # steps dispatched so far (state_fn's step)

        def commit(t):
            nonlocal center, pulled, local
            m, s = commits_d[t], scale_d[t]
            # integer leaves are RNG state, not weights: no contribution,
            # never pulled (tree_merge_floats)
            contribution = tree_merge_floats(
                tree_map(lambda l, p: _lead(s, l) * (l.float() - p.float()),
                         local, pulled), tree_map(torch.zeros_like, local))
            center = tree_map(lambda c, d: (c + d).to(c.dtype),
                              center, tree_psum(contribution))
            # committing workers pull the fresh center
            local = tree_merge_floats(tree_map(
                lambda l, c: torch.where(_lead(m, l), c, l), local, center),
                local)
            pulled = tree_merge_floats(tree_map(
                lambda p, c: torch.where(_lead(m, p), c, p), pulled, center),
                pulled)

        def dispatch(i, T, steps_done, data):
            nonlocal local, opt_state
            xs_d, ys_d = data
            carry, losses = (local, opt_state, generator), []
            for t in range(steps_done, steps_done + T):
                carry, loss = step(carry, (xs_d[t % spe], ys_d[t % spe]))
                losses.append(loss)
                if any_commit[t]:
                    local, opt_state, _ = carry
                    commit(t)
                    carry = (local, opt_state, generator)
            local, opt_state, _ = carry
            done[0] = steps_done + T
            return torch.stack(losses, 1)   # (workers, T)

        W = self.communication_window
        history = run_chunked(
            self, xs, ys, start=start_t, total=total_t, per_epoch=spe,
            cadence=(self.checkpoint_every_windows * W
                     if self.checkpoint_every_windows
                     else self.checkpoint_every * spe
                     if self.checkpoint_every else None),
            samples_per_unit=self.num_workers * self.batch_size,
            dispatch=dispatch, sync_ref=lambda: center, state_fn=state_fn,
            carry_leaves=(center, pulled, local, opt_state, scale_d,
                          commits_d),
            stream_units=(self.stream_chunk_windows * W
                          if self.stream_chunk_windows else None),
            unit_dims=1, fetch_global=comm.fetch_global)
        return self._finalize(center, history)
