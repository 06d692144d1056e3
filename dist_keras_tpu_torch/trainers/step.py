"""Train-step machinery shared by the trainers — counterpart of
``trainers/step.py``.

The reference's hot loop is ``model.train_on_batch`` inside a Spark task
(``distkeras/workers.py:~60-115``).  The JAX package compiles that step
into one ``lax.scan``; here it is an eager function of tensors on the
trainer's device, ``step((params, opt_state, generator), (x, y)) ->
(carry, loss)``, which the trainers call once per batch from a Python
loop.  It never reads a value back to the host: the loss stays a 0-d
tensor on the device, and the NaN guard selects with ``torch.where``.

Mixed precision: ``compute_dtype=torch.bfloat16`` casts parameters and
inputs inside the autograd graph, so the master params, the gradients
and the optimizer state stay f32, and the loss is reduced in f32.
``data_dtype=None`` batches arrive as uint8 and are cast here, on the
device.

NaN guard: ``skip_nonfinite=True`` keeps the previous params *and*
optimizer state when the loss or a gradient is NaN/Inf — the device
half of ``nan_policy="skip"`` (``resilience.guards`` is the host half).

W workers on one card: :func:`make_worker_step` is the same step over
worker-stacked params, optimizer state and batches (``parallel/mesh.py``),
where the JAX package runs one step per device inside ``shard_map``.
"""

from __future__ import annotations

import torch
from torch.func import grad_and_value, vmap

from dist_keras_tpu_torch.ops.optimizers import apply_updates
from dist_keras_tpu_torch.utils.pytree import (
    tree_cast,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


def _input(x, compute_dtype):
    if compute_dtype is not None:
        return x.to(compute_dtype)
    if not torch.is_floating_point(x):
        return x.float()   # cast-late input pipeline (data_dtype=None)
    return x


def make_loss_fn(apply_fn, loss_fn, compute_dtype=None, training=True):
    """-> loss(params, x, y, generator) -> 0-d f32 tensor."""

    def loss_of(params, x, y, generator=None):
        if compute_dtype is not None:
            params = tree_cast(params, compute_dtype)
        preds = apply_fn(params, _input(x, compute_dtype), training=training,
                         generator=generator)
        return loss_fn(preds.float(), y.float())

    return loss_of


def make_state_loss_fn(model, loss_fn, compute_dtype=None, training=True):
    """-> loss(trainable, state, x, y, generator) -> (0-d f32 loss, new
    state) for a model with running state (BatchNorm's moving
    statistics): the state leaves stay f32 under a compute dtype."""
    cast = getattr(model, "cast_params", None) or (
        lambda p, d: tree_cast(p, d))

    def loss_of(trainable, state, x, y, generator=None):
        params = model.join_state(trainable, state)
        if compute_dtype is not None:
            params = cast(params, compute_dtype)
        preds, new_state = model.apply_with_state(
            params, _input(x, compute_dtype), training=training,
            generator=generator)
        return loss_fn(preds.float(), y.float()), new_state

    return loss_of


def _value_and_grad(fn, params, *args):
    """-> (fn(params, *args), d fn / d params), both detached; ``fn``
    may return ``(value, aux)``, whose aux is passed through."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        out = fn(tree_unflatten(params, leaves), *args)
        value = out[0] if isinstance(out, tuple) else out
        grads = torch.autograd.grad(value, leaves)
    grads = tree_unflatten(params, grads)
    if isinstance(out, tuple):
        return (value.detach(), out[1]), grads
    return value.detach(), grads


def _all_finite(loss, grads):
    """0-d bool tensor: the loss and every float grad leaf are finite."""
    oks = [torch.isfinite(loss).reshape(1)]
    oks += [torch.isfinite(g).all().reshape(1) for g in tree_leaves(grads)
            if torch.is_floating_point(g)]
    return torch.cat(oks).all()


def _select(ok, new, old):
    """Tree ``where(ok, new, old)`` — the skipped-update selector."""
    return tree_map(lambda n, o: torch.where(ok, n, o), new, old)


def make_sgd_step(apply_fn, loss_fn, tx, compute_dtype=None, training=True,
                  skip_nonfinite=False):
    """-> step((params, opt_state, generator), (x, y)) -> (carry, loss).

    One optimizer update per mini-batch (workers.py:~115).  With
    ``skip_nonfinite`` a step whose loss or grads are NaN/Inf keeps the
    incoming params AND optimizer state; the NaN loss is still returned
    for the host-side counter."""
    loss_of = make_loss_fn(apply_fn, loss_fn, compute_dtype, training)

    def step(carry, batch):
        params, opt_state, generator = carry
        x, y = batch
        loss, grads = _value_and_grad(loss_of, params, x, y, generator)
        updates, new_opt = tx.update(grads, opt_state, params)
        new_params = apply_updates(params, updates)
        if skip_nonfinite:
            ok = _all_finite(loss, grads)
            new_params = _select(ok, new_params, params)
            new_opt = _select(ok, new_opt, opt_state)
        return (new_params, new_opt, generator), loss

    return step


def make_model_step(model, loss_fn, tx, compute_dtype=None, training=True,
                    skip_nonfinite=False):
    """-> (step, opt_init) for a model object.

    For stateless models this is ``make_sgd_step(model.apply, ...)``
    with ``opt_init = tx.init``.  For models with running state
    (``model.has_state()``: BatchNorm's moving statistics) the step
    threads the aux-state channel: gradients are taken with respect to
    the trainable split only, the state split is replaced each step by
    what ``model.apply_with_state`` returns, and ``opt_init`` builds
    optimizer state over the trainable split only.  The carried params
    keep their full structure, state leaves included."""
    has_state = getattr(model, "has_state", None)
    if has_state is None or not model.has_state():
        step = make_sgd_step(model.apply, loss_fn, tx, compute_dtype,
                             training, skip_nonfinite=skip_nonfinite)
        return step, tx.init

    loss_of = make_state_loss_fn(model, loss_fn, compute_dtype, training)

    def step(carry, batch):
        params, opt_state, generator = carry
        x, y = batch
        trainable, state = model.split_state(params)
        (loss, new_state), grads = _value_and_grad(
            loss_of, trainable, state, x, y, generator)
        updates, new_opt = tx.update(grads, opt_state, trainable)
        trainable = apply_updates(trainable, updates)
        new_params = model.join_state(trainable, new_state)
        if skip_nonfinite:
            # a bad step keeps the previous params, running state (the
            # statistics of the poisoned batch) AND optimizer state
            ok = _all_finite(loss, grads)
            new_params = _select(ok, new_params, params)
            new_opt = _select(ok, new_opt, opt_state)
        return (new_params, new_opt, generator), loss

    def opt_init(params):
        return tx.init(model.split_state(params)[0])

    return step, opt_init


def _finite_per_worker(loss, grads):
    """(W,) bool tensor: worker i's loss and every float grad slot i are
    finite."""
    n = loss.shape[0]
    oks = [torch.isfinite(loss)]
    oks += [torch.isfinite(g).reshape(n, -1).all(1)
            for g in tree_leaves(grads) if torch.is_floating_point(g)]
    return torch.stack(oks).all(0)


def _select_workers(ok, new, old):
    """Tree ``where(ok[i], new[i], old[i])`` over dim 0, slot by slot."""
    return tree_map(
        lambda n, o: torch.where(ok.reshape((-1,) + (1,) * (n.dim() - 1)),
                                 n, o), new, old)


def make_worker_step(model, loss_fn, tx, compute_dtype=None, training=True,
                     skip_nonfinite=False):
    """-> (step, opt_init) for W workers stacked on dim 0:
    ``step((params[W], opt_state[W], generator), (x[W], y[W])) ->
    (carry, loss[W])``, with ``opt_init`` :func:`make_model_step`'s
    (unstacked; the trainers stack its result per worker).

    Each worker's loss and gradients come from one
    ``vmap(grad_and_value(loss), randomness="different")`` over the
    stacked params and batches: one generator feeds every worker's
    dropout, each worker drawing its own mask.  The optimizer then
    updates the stacked leaves directly: every registered optimizer is
    elementwise per leaf, and a stacked state keeps one step count per
    worker (``ops/optimizers.py``'s ``_lead``), so this is W separate
    updates.  BatchNorm's running state rides ``has_aux``, as in
    :func:`make_model_step`.  With ``skip_nonfinite`` the guard is per
    worker: a poisoned worker keeps its own params and optimizer state
    while the others step."""
    has_state = getattr(model, "has_state", None)
    stateful = has_state is not None and model.has_state()

    loss_of = (make_state_loss_fn(model, loss_fn, compute_dtype, training)
               if stateful else
               make_loss_fn(model.apply, loss_fn, compute_dtype, training))

    def step(carry, batch):
        params, opt_state, generator = carry
        x, y = batch
        if stateful:
            trainable, state = model.split_state(params)
            grads, (loss, new_state) = vmap(
                grad_and_value(lambda p, s, xi, yi: loss_of(
                    p, s, xi, yi, generator), has_aux=True),
                randomness="different")(trainable, state, x, y)
        else:
            trainable = params
            grads, loss = vmap(
                grad_and_value(lambda p, xi, yi: loss_of(
                    p, xi, yi, generator)),
                randomness="different")(params, x, y)
        updates, new_opt = tx.update(grads, opt_state, trainable)
        trainable = apply_updates(trainable, updates)
        new_params = (model.join_state(trainable, new_state) if stateful
                      else trainable)
        if skip_nonfinite:
            ok = _finite_per_worker(loss, grads)
            new_params = _select_workers(ok, new_params, params)
            new_opt = _select_workers(ok, new_opt, opt_state)
        return (new_params, new_opt, generator), loss

    def opt_init(params):
        return tx.init(model.split_state(params)[0] if stateful else params)

    return step, opt_init
