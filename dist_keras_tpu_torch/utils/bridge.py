"""Parameter bridge between the JAX package's pytrees and the port.

``jax.random`` weights cannot be reproduced with a ``torch.Generator``,
so every parity test moves the reference's weights across instead of
re-initialising from a seed.  A params pytree is nested dicts and lists
of arrays (``models/transformer.py``: flat ``proj``/``pos``,
``blocks[i].{ln1,wq,...}``, ``ln_f``, ``head``); the port keeps the same
keys and the same layouts (``wq/wk/wv (d, h, dh)``, ``wo (h, dh, d)``),
with ``torch.Tensor`` leaves.  Nothing here imports JAX: a leaf only has
to support ``numpy.asarray`` (numpy arrays, jax arrays, CPU tensors).
"""

from __future__ import annotations

import numpy as np
import torch

from dist_keras_tpu_torch.utils.pytree import tree_map

__all__ = ["params_from_jax", "params_to_numpy", "tree_map"]


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
