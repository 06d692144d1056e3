"""Params trees — counterpart of the parts of ``utils/pytree.py`` that the
port needs.

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
