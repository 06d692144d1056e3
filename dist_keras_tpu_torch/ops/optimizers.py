"""Functional optimizers with optax's semantics — counterpart of the
``optax.adam`` / ``optax.sgd`` the JAX training steps use.

Each optimizer is an ``(init, update)`` pair over a params tree
(``utils/pytree.py``): ``init(params) -> state`` and
``update(grads, state, params=None) -> (updates, state)``;
:func:`apply_updates` adds the updates to the params.  They follow
optax's rules, not ``torch.optim``'s: adam's step count starts at 0 and
is incremented before the bias correction, and its update is
``-lr * m_hat / (sqrt(v_hat + eps_root) + eps)``.  Everything runs under
``torch.no_grad()`` and returns new tensors (the inputs stay as they
were, as with optax).  The other optimizers of the JAX package are not
ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from dist_keras_tpu_torch.utils.pytree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def sgd(learning_rate):
    """Plain SGD, ``optax.sgd(learning_rate)``: update = -lr * g."""

    def init(params):
        return {}

    @torch.no_grad()
    def update(grads, state, params=None):
        return tree_map(lambda g: -learning_rate * g, grads), state

    return Optimizer(init, update)


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0):
    """``optax.adam``: state ``{"count", "mu", "nu"}`` with an int32
    count; moments kept in each param's dtype."""

    @torch.no_grad()
    def init(params):
        leaf = tree_leaves(params)[0]
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=leaf.device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(grads, state, params=None):
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * g ** 2 + b2 * v, grads,
                      state["nu"])
        count = state["count"] + 1
        # 1 - decay**count in float32, as optax computes it
        c1 = 1 - torch.tensor(b1, dtype=torch.float32,
                              device=count.device) ** count
        c2 = 1 - torch.tensor(b2, dtype=torch.float32,
                              device=count.device) ** count
        updates = tree_map(
            lambda m, v: -learning_rate * (
                (m / c1.to(m.dtype))
                / (torch.sqrt(v / c2.to(v.dtype) + eps_root) + eps)),
            mu, nu)
        return updates, {"count": count, "mu": mu, "nu": nu}

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates):
    """``optax.apply_updates``: p + u, kept in p's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)

