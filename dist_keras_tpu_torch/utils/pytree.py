"""Params trees — counterpart of ``utils/pytree.py``.

A params tree is nested dicts and lists (or tuples) of ``torch.Tensor``
leaves, as the JAX package's pytrees are.  Dicts are walked in insertion
order, so two trees built the same way line up leaf for leaf.
"""

from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    each tree in ``rest``) -> a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` whose leaves are ``leaves``, in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_cast(tree, dtype):
    """Cast floating leaves to ``dtype`` (the bf16 compute policy);
    other leaves pass through untouched."""
    return tree_map(
        lambda x: x.to(dtype) if torch.is_floating_point(x) else x, tree)


def tree_add(a, b):
    """a + b, leafwise."""
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    """a - b, leafwise."""
    return tree_map(torch.sub, a, b)


def tree_scale(a, s):
    """a * s for a scalar s, leafwise."""
    return tree_map(lambda x: x * s, a)


def tree_axpy(alpha, x, y):
    """alpha * x + y, leafwise (BLAS axpy over trees)."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_mean(trees):
    """Mean of a list of identically-structured trees."""
    acc = trees[0]
    for t in trees[1:]:
        acc = tree_add(acc, t)
    return tree_scale(acc, 1.0 / len(trees))


def tree_global_norm(a):
    """L2 norm over all leaves (a 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(x * x) for x in tree_leaves(a)))


def tree_merge_floats(merged, original):
    """Take ``merged`` for floating leaves and ``original`` for the rest:
    merge algebra (deltas, means) only makes sense for floating
    parameters; integer leaves pass through untouched."""
    return tree_map(lambda m, o: m if torch.is_floating_point(o) else o,
                    merged, original)


def tree_stack(tree, n):
    """``n`` copies of every leaf stacked on a new dim 0 — per-worker
    state (``parallel/mesh.py``).  The copies are real (``repeat``), never
    ``expand`` views, so an in-place update of one worker's slot can
    never write the others."""
    return tree_map(lambda x: x.unsqueeze(0).repeat(n, *([1] * x.dim())),
                    tree)


def tree_index(tree, i):
    """Slot ``i`` of a stacked tree (views of its leaves)."""
    return tree_map(lambda x: x[i], tree)


def tree_size(a):
    """Total number of elements across leaves."""
    return sum(x.numel() for x in tree_leaves(a))
