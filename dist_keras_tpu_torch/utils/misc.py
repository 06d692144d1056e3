"""Misc helpers with reference parity (``distkeras/utils.py``) — a copy of
the JAX package's ``utils/misc.py``, on the port's ``Dataset``.

- ``to_vector`` (utils.py:~100): integer label -> one-hot vector.
- ``shuffle`` (utils.py:~140): shuffle a dataset's rows.
- ``precache`` (utils.py:~155): in the reference this forces Spark to
  materialise a DataFrame; here it materialises any lazy columns to numpy.
- ``new_dataframe_row`` (utils.py:~120): row dict + new column.
"""

from __future__ import annotations

import numpy as np


def to_vector(x, dim):
    """One-hot encode integer ``x`` into a float vector of length ``dim``."""
    v = np.zeros(dim, dtype=np.float32)
    v[int(x)] = 1.0
    return v


def one_hot(labels, dim, dtype=np.float32):
    """Vectorised one-hot for an int array of labels -> (n, dim)."""
    labels = np.asarray(labels, dtype=np.int64).reshape(-1)
    out = np.zeros((labels.shape[0], dim), dtype=dtype)
    out[np.arange(labels.shape[0]), labels] = 1
    return out


def shuffle(dataset, seed=None):
    """Shuffle rows. Accepts our Dataset (returns a new shuffled Dataset) or a
    numpy array / tuple of arrays (shuffled with one permutation)."""
    from dist_keras_tpu_torch.data.dataset import Dataset

    if isinstance(dataset, Dataset):
        return dataset.shuffle(seed=seed)
    rng = np.random.default_rng(seed)
    if isinstance(dataset, (tuple, list)):
        n = len(dataset[0])
        perm = rng.permutation(n)
        return type(dataset)(np.asarray(a)[perm] for a in dataset)
    a = np.asarray(dataset)
    return a[rng.permutation(len(a))]


def precache(dataset):
    """Materialise the dataset (parity with utils.py:~155). Our Dataset is
    already eager numpy, so this is a cheap identity that touches columns."""
    from dist_keras_tpu_torch.data.dataset import Dataset

    if isinstance(dataset, Dataset):
        for c in dataset.columns:
            np.asarray(dataset[c])
    return dataset


def new_dataframe_row(row, column, value):
    """Row (dict) + one new column -> new row dict (utils.py:~120)."""
    out = dict(row)
    out[column] = value
    return out


def history_average_loss(history):
    """Mean loss over a trainer history (list/array of per-step losses, or a
    list of per-worker lists)."""
    arr = np.asarray(history, dtype=np.float64)
    return float(arr.mean())
