"""Where the port runs: ``cuda`` by default, the CPU only on request."""

from __future__ import annotations

import torch


def resolve_device(device=None):
    """-> the ``torch.device`` an entry point should run on.

    ``None`` (or ``"cuda"`` without an index) means the card: ``cuda``,
    or under a process group (``comm.initialize``) the rank's own (its
    card under NCCL, the shared ``cuda:0`` when the ranks share one), so
    a rank's tensors never land on another rank's card.  Asking for
    ``cuda`` on a host without one raises instead of silently running
    on the CPU; the CPU is used only when the caller asks for it
    (``device="cpu"``, as the tests do)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        import sys

        backend = sys.modules.get("dist_keras_tpu_torch.comm.backend")
        mine = None if backend is None else backend.rank_device()
        if mine is not None and mine.type == "cuda":
            return mine
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dist_keras_tpu_torch runs on CUDA by default and no CUDA "
            "device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
