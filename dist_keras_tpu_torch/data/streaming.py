"""Fixed-shape row packing — the part of the JAX package's
``data/streaming.py`` that ``serving.ServingEngine`` packs its batches
with (:func:`pad_rows`, :func:`pack_rows`, copied as they are: numpy
only).

The rest of that module — the stream sources (queue, socket, Kafka)
and ``StreamingPredictor``'s micro-batching over them — is ROADMAP
queue 1, item 14.
"""

from __future__ import annotations

import numpy as np


def pad_rows(x, batch_size):
    """Pad a (n, ...) row block up to ``batch_size`` by replicating the
    last row — the fixed-shape device batch every online path here
    dispatches (the pad is stripped from the output after)."""
    n = len(x)
    pad = batch_size - n
    if pad < 0:
        raise ValueError(f"{n} rows exceed batch_size={batch_size}")
    if pad:
        x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
    return x


def pack_rows(rows, batch_size):
    """Stack a list of feature rows into one fixed-shape padded batch;
    -> ``(x (batch_size, ...), n)`` with ``n`` the real row count."""
    n = len(rows)
    return pad_rows(np.stack(rows), batch_size), n
