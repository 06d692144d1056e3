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
"""

from __future__ import annotations

import numpy as np
import torch

from dist_keras_tpu_torch.trainers.chunking import run_chunked, units_first
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
        n, spe = xs.shape[:2]  # workers, steps per epoch
        total_t = self.num_epoch * spe
        xs, ys = units_first(xs, 1), units_first(ys, 1)
        step, opt_init = self._make_worker_step(model, loss_fn, tx)

        commits, _, scale = commit_schedule(
            total_t, self.communication_window, n)
        any_commit = commits.any(1)
        scale_d = torch.from_numpy(scale).to(self.device)
        commits_d = torch.from_numpy(commits).to(self.device)

        center = self._device_params(model.params)
        pulled = self._stack_workers(center)
        local = self._stack_workers(center)
        opt_state = self._stack_workers(opt_init(center))
        generator = torch.Generator(device=self.device).manual_seed(
            self.seed)

        def commit(t):
            nonlocal center, pulled, local
            m, s = commits_d[t], scale_d[t]
            # integer leaves are RNG state, not weights: no contribution,
            # never pulled (tree_merge_floats)
            contribution = tree_merge_floats(
                tree_map(lambda l, p: _lead(s, l) * (l.float() - p.float()),
                         local, pulled), tree_map(torch.zeros_like, local))
            center = tree_map(lambda c, d: (c + d.sum(0)).to(c.dtype),
                              center, contribution)
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
            return torch.stack(losses, 1)   # (workers, T)

        history = run_chunked(
            self, xs, ys, total=total_t, per_epoch=spe,
            samples_per_unit=n * self.batch_size, dispatch=dispatch,
            sync_ref=lambda: center,
            carry_leaves=(center, pulled, local, opt_state, scale_d,
                          commits_d),
            worker_axis=True)
        return self._finalize(center, history)
