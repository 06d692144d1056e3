"""Parameter bridge between the JAX package's pytrees and the port.

``jax.random`` weights cannot be reproduced with a ``torch.Generator``,
so every parity test moves the reference's weights across instead of
re-initialising from a seed.  A params pytree is nested dicts and lists
of arrays (``models/transformer.py``: flat ``proj``/``pos``,
``blocks[i].{ln1,wq,...}``, ``ln_f``, ``head``); the port keeps the same
keys and the same layouts (``wq/wk/wv (d, h, dh)``, ``wo (h, dh, d)``),
with ``torch.Tensor`` leaves.  Nothing here imports JAX: a leaf only has
to support ``numpy.asarray`` (numpy arrays, jax arrays, CPU tensors).

:func:`opt_state_from_optax` carries the rest of a training state
across: the reference's optimizer state — optax's NamedTuple states, as
``checkpoint.Checkpointer.restore`` unpickles them into
``checkpoint.OptaxState`` placeholders or as the reference hands them
over with numpy leaves — into the layout of the port's optimizer of the
same registry name (``ops/optimizers.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from dist_keras_tpu_torch.utils.pytree import tree_map

__all__ = ["opt_state_from_optax", "params_from_jax", "params_to_numpy",
           "tree_map"]


def _leaf_to_tensor(leaf, device):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to(device, copy=True)
    # copy: the port's parameters must never alias the caller's buffers
    return torch.from_numpy(np.array(leaf, copy=True)).to(device)


def params_from_jax(tree, device):
    """JAX params pytree (numpy or jax leaves) -> the same tree of
    ``torch.Tensor`` leaves on ``device``, bit for bit."""
    return tree_map(lambda a: _leaf_to_tensor(a, device), tree)


def params_to_numpy(tree):
    """The port's params tree -> the same tree of numpy arrays, bit for
    bit (the inverse of :func:`params_from_jax`)."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def _optax_parts(tree):
    """The chain's states as ``[(optax class name, {field: value})]``:
    each element is an optax NamedTuple or its checkpoint placeholder
    (``checkpoint.OptaxState``, whose ``type_name`` is optax's name)."""
    if hasattr(tree, "_fields"):
        tree = (tree,)
    parts = []
    for st in tree:
        if not hasattr(st, "_fields"):
            raise ValueError(
                f"optax state element {type(st).__name__} is not a "
                "NamedTuple state")
        name = getattr(st, "type_name", type(st).__name__)
        parts.append((name, dict(zip(st._fields, st))))
    return parts


def _expect(optimizer_name, parts, *allowed):
    names = tuple(n for n, _ in parts)
    if names not in allowed:
        raise ValueError(
            f"optax state {names} is not what the registry's "
            f"{optimizer_name!r} produces (one of {list(allowed)})")
    return names


def opt_state_from_optax(optimizer_name, tree, device="cpu"):
    """The reference's optimizer state for registry optimizer
    ``optimizer_name`` -> the port's state for
    ``ops.optimizers.get_optimizer(optimizer_name, ...)``, with its
    leaves as tensors on ``device``, bit for bit.  For example adam's
    ``(ScaleByAdamState(count, mu, nu), EmptyState())`` becomes
    ``{"count", "mu", "nu"}``; a warm-up schedule's
    ``ScaleByScheduleState(count)`` becomes the port's outer
    ``"count"``.  Worker-stacked states (a leading worker dimension on
    every leaf) convert the same way.  ``ValueError`` when the state is
    not one that optimizer produces."""
    parts = _optax_parts(tree)
    t = lambda x: params_from_jax(x, device)  # noqa: E731
    name = optimizer_name
    if name == "adam":
        _expect(name, parts, ("ScaleByAdamState", "EmptyState"))
        return {k: t(parts[0][1][k]) for k in ("count", "mu", "nu")}
    if name in ("nadam", "adamw"):
        _expect(name, parts, ("ScaleByAdamState", "EmptyState"),
                ("ScaleByAdamState", "EmptyState", "EmptyState"))
        return {"inner": {k: t(parts[0][1][k])
                          for k in ("count", "mu", "nu")}}

    def scheduled(inner, sched):
        out = {"inner": inner}
        if sched[0] == "ScaleByScheduleState":
            out["count"] = t(sched[1]["count"])
        return out

    if name == "sgd":
        names = _expect(name, parts, *[(a, b) for a in (
            "EmptyState", "TraceState") for b in (
            "EmptyState", "ScaleByScheduleState")])
        if names == ("EmptyState", "EmptyState"):
            return {}
        inner = ({"trace": t(parts[0][1]["trace"])}
                 if names[0] == "TraceState" else {})
        return scheduled(inner, parts[1])
    if name == "adagrad":
        _expect(name, parts, ("ScaleByRssState", "EmptyState"),
                ("ScaleByRssState", "ScaleByScheduleState"))
        return scheduled(
            {"sum_of_squares": t(parts[0][1]["sum_of_squares"])}, parts[1])
    if name == "rmsprop":
        names = _expect(name, parts,
                        ("ScaleByRmsState", "EmptyState", "EmptyState"),
                        ("ScaleByRmsState", "EmptyState", "TraceState"))
        scaled = {"inner": {"nu": t(parts[0][1]["nu"])}}
        if names[2] == "TraceState":
            return (scaled, {"trace": t(parts[2][1]["trace"])})
        return scaled
    if name == "adadelta":
        _expect(name, parts,
                ("EmptyState", "ScaleByAdaDeltaState", "EmptyState"))
        return {"inner": {k: t(parts[1][1][k]) for k in ("e_g", "e_x")}}
    raise ValueError(
        f"no optax conversion for optimizer {optimizer_name!r}; the "
        "registry's are adam, nadam, adamw, sgd, adagrad, rmsprop and "
        "adadelta")
