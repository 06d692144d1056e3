"""Functional optimizers with optax's semantics, and the Keras-string
registry — counterpart of ``ops/optimizers.py``.

Each optimizer is an ``(init, update)`` pair over a params tree
(``utils/pytree.py``): ``init(params) -> state`` and
``update(grads, state, params=None) -> (updates, state)``;
:func:`apply_updates` adds the updates to the params.  They follow
optax's rules (``optax`` 0.2.6), not ``torch.optim``'s:

- adam's step count starts at 0 and is incremented before the bias
  correction; its update is ``-lr * m_hat / (sqrt(v_hat + eps_root) +
  eps)`` (eps outside the square root); nadam is adam with optax's
  nesterov momentum; adamw adds ``weight_decay * p`` to adam's direction
  before the learning rate;
- rmsprop divides by ``sqrt(nu + eps)`` (eps inside the root), starting
  from ``nu = 0``; adagrad by ``where(acc > 0, rsqrt(acc + eps), 0)``
  with the accumulator starting at ``initial_accumulator_value``;
  adadelta scales by ``sqrt(prev_e_x + eps) / sqrt(cur_e_g + eps)``;
- sgd keeps no trace when ``momentum`` is None (the registry passes
  ``momentum or None``, so 0 means none), and a learning-rate schedule
  is called with the count *before* the step: the registry's linear
  warm-up gives lr 0 on the very first step.

The bias corrections and schedules are computed in f32 on the count's
device, so a step never waits for the host.  Everything runs under
``torch.no_grad()`` and returns new tensors (the inputs stay as they
were, as with optax).

On CUDA, :func:`adam`'s update and :func:`apply_updates` are two
hand-written kernels over the whole tree (``ops/multi_tensor.py``),
bit-equal to their plain versions :func:`adam_reference` and
:func:`apply_updates_reference`, which every other tree takes.  The
other optimizers' directions stay eager on every device; their updates
apply through the kernel.

The registry (:func:`get_optimizer`) maps the reference's Keras strings
to these with Keras's defaults — eps 1e-7 where Keras uses it, so the
registry's ``'adam'`` has eps 1e-7 while :func:`adam` keeps optax's
1e-8, as the two packages' TP steps and trainers do.
"""

from __future__ import annotations

import numbers
from typing import Callable, NamedTuple

import torch

from dist_keras_tpu_torch.ops import multi_tensor
from dist_keras_tpu_torch.utils.pytree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _on_cuda(tree):
    """Whether ``tree``'s first leaf lies on a CUDA device: the trees
    the kernels of ``ops/multi_tensor.py`` take (or refuse)."""
    leaves = tree_leaves(tree)
    return bool(leaves) and leaves[0].is_cuda


def _count_like(params):
    leaf = tree_leaves(params)[0]
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


def _power(base, count):
    """``base ** count`` in f32 on the count's device (optax's
    ``decay ** count`` with a weakly typed base)."""
    return torch.full((), base, dtype=torch.float32,
                      device=count.device) ** count


def _lead(s, t):
    """A count-derived value ``s`` shaped to broadcast over ``t``'s
    leading dims: ``()`` for one worker, ``(W,)`` for W stacked workers,
    each with its own count (``trainers/step.py``'s worker step)."""
    return s.reshape(s.shape + (1,) * (t.dim() - s.dim())).to(t.dtype)


def _bias_correction(moment, decay, count):
    c = 1 - _power(decay, count)
    return tree_map(lambda t: t / _lead(c, t), moment)


def linear_schedule(init_value, end_value, transition_steps):
    """``optax.linear_schedule``: a function of the step count (an int32
    tensor) -> the f32 value, ``init`` at count 0, ``end`` from count
    ``transition_steps`` on."""
    if transition_steps <= 0:
        return lambda count: torch.full((), init_value, dtype=torch.float32,
                                        device=count.device)

    def schedule(count):
        frac = 1 - count.clamp(0, transition_steps).float() / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def _with_learning_rate(direction, learning_rate):
    """``chain(direction, scale_by_learning_rate(learning_rate))``: the
    update is ``-lr * direction``; a callable ``learning_rate`` is a
    schedule of the step count, which the state then carries."""
    scheduled = callable(learning_rate)

    @torch.no_grad()
    def init(params):
        state = {"inner": direction.init(params)}
        if scheduled:
            state["count"] = _count_like(params)
        return state

    @torch.no_grad()
    def update(grads, state, params=None):
        upd, inner = direction.update(grads, state["inner"], params)
        new = {"inner": inner}
        if scheduled:
            step = -learning_rate(state["count"])
            upd = tree_map(lambda g: _lead(step, g) * g, upd)
            new["count"] = state["count"] + 1
        else:
            upd = tree_map(lambda g: -learning_rate * g, upd)
        return upd, new

    return Optimizer(init, update)


def trace(decay, nesterov=False):
    """``optax.trace``: t = g + decay * t; the update is t (or, with
    nesterov, g + decay * t).  Chained behind another optimizer it is
    EAMSGD's momentum (``chain(tx, trace(momentum, nesterov=True))``)."""

    @torch.no_grad()
    def init(params):
        return {"trace": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(grads, state, params=None):
        trace = tree_map(lambda g, t: g + decay * t, grads, state["trace"])
        upd = (tree_map(lambda g, t: g + decay * t, grads, trace)
               if nesterov else trace)
        return upd, {"trace": trace}

    return Optimizer(init, update)


def chain(*optimizers):
    """``optax.chain``: each optimizer transforms the updates of the one
    before it (the first gets the gradients); the state is the tuple of
    their states, in order."""

    @torch.no_grad()
    def init(params):
        return tuple(o.init(params) for o in optimizers)

    @torch.no_grad()
    def update(grads, state, params=None):
        new = []
        for o, s in zip(optimizers, state):
            grads, s = o.update(grads, s, params)
            new.append(s)
        return grads, tuple(new)

    return Optimizer(init, update)


def _identity():
    return Optimizer(lambda params: {},
                     lambda grads, state, params=None: (grads, state))


def sgd(learning_rate, momentum=None, nesterov=False):
    """``optax.sgd``: update = -lr * g, through a momentum trace when
    ``momentum`` is not None.  With a float learning rate and no
    momentum the state is empty."""
    if momentum is None and not callable(learning_rate):
        @torch.no_grad()
        def update(grads, state, params=None):
            return tree_map(lambda g: -learning_rate * g, grads), state

        return Optimizer(lambda params: {}, update)
    direction = (trace(momentum, nesterov) if momentum is not None
                 else _identity())
    return _with_learning_rate(direction, learning_rate)


def _scale_by_adam(b1, b2, eps, eps_root, nesterov=False):
    def init(params):
        return {"count": _count_like(params),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * g ** 2 + b2 * v, grads,
                      state["nu"])
        count = state["count"] + 1
        if nesterov:
            mu_hat = tree_map(lambda m, g: b1 * m + (1 - b1) * g,
                              _bias_correction(mu, b1, count + 1),
                              _bias_correction(grads, b1, count))
        else:
            mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        upd = tree_map(lambda m, v: m / (torch.sqrt(v + eps_root) + eps),
                       mu_hat, nu_hat)
        return upd, {"count": count, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def adam_reference(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0):
    """Plain version of :func:`adam`: the per-leaf eager operations, on
    any device."""
    inner = _scale_by_adam(b1, b2, eps, eps_root)

    @torch.no_grad()
    def update(grads, state, params=None):
        upd, state = inner.update(grads, state, params)
        return tree_map(lambda u: -learning_rate * u, upd), state

    return Optimizer(torch.no_grad()(inner.init), update)


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0):
    """``optax.adam``: state ``{"count", "mu", "nu"}`` with an int32
    count; moments kept in each param's dtype.

    A tree on CUDA takes the update kernel (``ops/multi_tensor.py``),
    one launch for every leaf, bit-equal to :func:`adam_reference`,
    which every other tree takes; the bias corrections stay eager ops
    on the count."""
    plain = adam_reference(learning_rate, b1, b2, eps, eps_root)

    @torch.no_grad()
    def update(grads, state, params=None):
        if not _on_cuda(grads):
            return plain.update(grads, state, params)
        if not isinstance(learning_rate, numbers.Real):
            raise TypeError(
                f"adam on CUDA takes a number as its learning rate; got "
                f"{type(learning_rate).__name__}")
        count = state["count"] + 1
        c1 = 1 - _power(b1, count)
        c2 = 1 - _power(b2, count)
        upd, mu, nu = multi_tensor.adam_update(
            grads, state["mu"], state["nu"], c1, c2, b1, b2, eps, eps_root,
            learning_rate, params)
        return upd, {"count": count, "mu": mu, "nu": nu}

    return Optimizer(plain.init, update)


def nadam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0):
    """``optax.nadam``: adam with nesterov momentum."""
    return _with_learning_rate(
        _scale_by_adam(b1, b2, eps, eps_root, nesterov=True), learning_rate)


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
          weight_decay=1e-4):
    """``optax.adamw``: adam's direction plus ``weight_decay * p``, then
    the learning rate."""
    inner = _scale_by_adam(b1, b2, eps, eps_root)

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("adamw's update needs the params")
        upd, state = inner.update(grads, state)
        return tree_map(lambda u, p: u + weight_decay * p, upd,
                        params), state

    return _with_learning_rate(Optimizer(inner.init, update), learning_rate)


def adagrad(learning_rate, initial_accumulator_value=0.1, eps=1e-7):
    """``optax.adagrad``: sum of squares from
    ``initial_accumulator_value``, update ``g * rsqrt(acc + eps)`` where
    ``acc > 0``, else 0."""

    def init(params):
        return {"sum_of_squares": tree_map(
            lambda p: torch.full_like(p, initial_accumulator_value), params)}

    def update(grads, state, params=None):
        acc = tree_map(lambda g, t: g * g + t, grads, state["sum_of_squares"])
        upd = tree_map(
            lambda t, g: torch.where(t > 0, torch.rsqrt(t + eps), 0.0) * g,
            acc, grads)
        return upd, {"sum_of_squares": acc}

    return _with_learning_rate(Optimizer(init, update), learning_rate)


def rmsprop(learning_rate, decay=0.9, eps=1e-8, momentum=None,
            nesterov=False):
    """``optax.rmsprop`` (not centered, no bias correction): ``g *
    rsqrt(nu + eps)``, then the learning rate, then a momentum trace
    when ``momentum`` is not None."""

    def init(params):
        return {"nu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        nu = tree_map(lambda g, n: (1 - decay) * (g * g) + decay * n, grads,
                      state["nu"])
        upd = tree_map(lambda n, g: torch.rsqrt(n + eps) * g, nu, grads)
        return upd, {"nu": nu}

    scaled = _with_learning_rate(Optimizer(init, update), learning_rate)
    if momentum is None:
        return scaled
    return chain(scaled, trace(momentum, nesterov))


def adadelta(learning_rate, rho=0.9, eps=1e-6):
    """``optax.adadelta``: ``g * sqrt(prev_e_x + eps) / sqrt(cur_e_g +
    eps)``, then the learning rate."""

    def init(params):
        return {"e_g": tree_map(torch.zeros_like, params),
                "e_x": tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        e_g = tree_map(lambda g, t: (1 - rho) * g ** 2 + rho * t, grads,
                       state["e_g"])
        upd = tree_map(
            lambda g, cur, prev: (torch.sqrt(prev + eps)
                                  / torch.sqrt(cur + eps)) * g,
            grads, e_g, state["e_x"])
        e_x = tree_map(lambda u, t: (1 - rho) * u ** 2 + rho * t, upd,
                       state["e_x"])
        return upd, {"e_g": e_g, "e_x": e_x}

    return _with_learning_rate(Optimizer(init, update), learning_rate)


@torch.no_grad()
def apply_updates_reference(params, updates):
    """Plain version of :func:`apply_updates`, on any device."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


@torch.no_grad()
def apply_updates(params, updates):
    """``optax.apply_updates``: p + u, kept in p's dtype.  A tree on
    CUDA takes the apply kernel (``ops/multi_tensor.py``), one launch
    for every leaf, bit-equal to :func:`apply_updates_reference`."""
    if _on_cuda(params):
        return multi_tensor.apply_updates(params, updates)
    return apply_updates_reference(params, updates)


# --------------------------------------------------------------------------
# the Keras-string registry (dist_keras_tpu/ops/optimizers.py)
# --------------------------------------------------------------------------

def _warmup(learning_rate, warmup_steps):
    return (linear_schedule(0.0, learning_rate, int(warmup_steps))
            if warmup_steps else learning_rate)


def _sgd(learning_rate=0.01, momentum=0.0, nesterov=False, warmup_steps=0):
    """``warmup_steps`` > 0 ramps the lr linearly from 0."""
    return sgd(_warmup(learning_rate, warmup_steps),
               momentum=momentum or None, nesterov=nesterov)


def _adam(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-7):
    return adam(learning_rate, b1=b1, b2=b2, eps=eps)


def _adagrad(learning_rate=1e-3, initial_accumulator_value=0.1, eps=1e-7,
             warmup_steps=0):
    return adagrad(_warmup(learning_rate, warmup_steps),
                   initial_accumulator_value=initial_accumulator_value,
                   eps=eps)


def _rmsprop(learning_rate=1e-3, rho=0.9, eps=1e-7, momentum=0.0):
    return rmsprop(learning_rate, decay=rho, eps=eps,
                   momentum=momentum or None)


def _adadelta(learning_rate=1e-3, rho=0.95, eps=1e-7):
    return adadelta(learning_rate, rho=rho, eps=eps)


def _nadam(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-7):
    return nadam(learning_rate, b1=b1, b2=b2, eps=eps)


def _adamw(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-7, weight_decay=4e-3):
    return adamw(learning_rate, b1=b1, b2=b2, eps=eps,
                 weight_decay=weight_decay)


_OPTIMIZERS = {
    "sgd": _sgd,
    "adam": _adam,
    "adagrad": _adagrad,
    "rmsprop": _rmsprop,
    "adadelta": _adadelta,
    "nadam": _nadam,
    "adamw": _adamw,
}


def get_optimizer(optimizer, **overrides):
    """Resolve a Keras-style optimizer string (with optional hyperparameter
    overrides) or pass an :class:`Optimizer` through; another callable
    is a factory called with the overrides."""
    if isinstance(optimizer, Optimizer):
        return optimizer
    if callable(optimizer) and not isinstance(optimizer, str):
        return optimizer(**overrides)
    try:
        factory = _OPTIMIZERS[optimizer]
    except KeyError:
        raise ValueError(
            f"Unknown optimizer {optimizer!r}; known: {sorted(_OPTIMIZERS)}"
        ) from None
    return factory(**overrides)


def register_optimizer(name, factory):
    _OPTIMIZERS[name] = factory
