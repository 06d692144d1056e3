"""The numbers that decide ``correct`` for a training cell, and the
comparison of the program's with the reference's.

Each side reports, for the first steps of a run from the same weights
and rows:

- ``loss``: each step's loss, by key;
- ``grad``: the norm of each leaf's first gradient, as the optimizer
  got it (the program's is worked out from adam's first moment after one
  step, ``mu / (1 - b1)``);
- ``change``: the norm of each leaf's change over the check's steps.

:func:`gaps` turns two such records into three numbers, each held to a
limit of the cell's own (``port_bench/limits/<cell>.json``):

- ``loss_gap``: the largest ``|loss_p - loss_r| / |loss_r|``;
- ``grad_gap``: over the leaves, the largest gap between the two norms,
  ``|g_p - g_r|``, over the reference's norm of that leaf or of the
  median leaf, whichever is larger (some gradients are all but zero);
- ``change_gap``: the same of the change, leaving out leaves whose
  reference gradient is under a thousandth of the median leaf's: those
  move under adam by round-off alone.
"""

from __future__ import annotations

import statistics

import torch

CHECK_STEPS = 3      # the steps whose losses are compared
EXCLUDE_BELOW = 1e-3


def flat(tree, prefix=""):
    """-> [(path, tensor)] of a nested dict / list tree, dict keys
    sorted, list entries by index."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += flat(v, f"{prefix}.{k}" if prefix else str(k))
    return out


def norms(pairs, scale=1.0):
    """{path: float norm * scale} of ``[(path, tensor)]``, in f64."""
    return {p: float(torch.linalg.vector_norm(t.detach().double())) * scale
            for p, t in pairs}


def change_norms(before, after):
    """{path: ||after - before||} of two trees of one structure."""
    b, a = dict(flat(before)), dict(flat(after))
    return {p: float(torch.linalg.vector_norm(
        a[p].detach().double() - b[p].detach().double())) for p in b}


def _leaf(key):
    return key.split("/", 1)[-1]


def _kept(reference):
    """-> (the median leaf's reference gradient norm, {change key: kept})
    : a change key is left out when its leaf's largest reference gradient
    (over the workers) is under :data:`EXCLUDE_BELOW` of the median's."""
    rg = reference["grad"]
    gmed = statistics.median(rg.values())
    leaf_grad = {}
    for k, r in rg.items():
        leaf_grad[_leaf(k)] = max(r, leaf_grad.get(_leaf(k), 0.0))
    return gmed, {k: leaf_grad[_leaf(k)] >= EXCLUDE_BELOW * gmed
                  for k in reference["change"]}


def gaps(program, reference):
    """-> {"loss_gap", "grad_gap", "change_gap"} of two records."""
    loss = max(abs(program["loss"][k] - r) / abs(r)
               for k, r in reference["loss"].items())
    gmed, kept = _kept(reference)
    grad = max(abs(program["grad"][k] - r) / max(r, gmed)
               for k, r in reference["grad"].items())
    change = {k: r for k, r in reference["change"].items() if kept[k]}
    cmed = statistics.median(change.values())
    return {"loss_gap": loss, "grad_gap": grad,
            "change_gap": max(abs(program["change"][k] - r) / max(r, cmed)
                              for k, r in change.items())}


def excluded(reference):
    """The change keys :func:`gaps` leaves out (their gradient is nought
    to rounding)."""
    return sorted(k for k, keep in _kept(reference)[1].items() if not keep)
