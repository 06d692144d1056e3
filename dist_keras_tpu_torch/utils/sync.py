"""Host-side completion barrier — counterpart of ``utils/sync.py``.

The JAX package probes each leaf with a jitted last-element fetch;
here a CUDA stream's work completes in order, so waiting for the card
is ``torch.cuda.synchronize`` on every card the leaves live on, and
nothing at all on the CPU (eager CPU ops have finished when they
return).
"""

from __future__ import annotations

import torch

from dist_keras_tpu_torch.utils.pytree import tree_leaves


def drain(*trees):
    """Block until the work producing the tensor leaves of ``trees`` is
    done; -> the number of cards synchronized.  Non-tensor leaves and
    CPU tensors have nothing pending."""
    cards = {x.device for t in trees for x in tree_leaves(t)
             if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for dev in cards:
        torch.cuda.synchronize(dev)
    return len(cards)
