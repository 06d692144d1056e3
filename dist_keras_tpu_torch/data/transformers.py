"""Feature transformers — parity with ``distkeras/transformers.py``; a copy
of the JAX package's ``data/transformers.py``.

The reference implements these as Spark UDF transformers; here each is a
vectorised numpy column transform over our ``Dataset``.  Same class names,
same constructor arguments, same ``transform(dataset) -> dataset`` verb:

- ``MinMaxTransformer``       (transformers.py:~50)
- ``OneHotTransformer``       (transformers.py:~120)
- ``LabelIndexTransformer``   (transformers.py:~180)
- ``ReshapeTransformer``      (transformers.py:~250)
- ``DenseTransformer``        (transformers.py:~310)

Being plain-numpy vectorised (not row-at-a-time UDFs) they run at memory
bandwidth on the host and never touch the device.
"""

from __future__ import annotations

import numpy as np

from dist_keras_tpu_torch.utils.misc import one_hot


class Transformer:
    """Base verb: transform(dataset) -> dataset (transformers.py:~25)."""

    def transform(self, dataset):
        raise NotImplementedError


class MinMaxTransformer(Transformer):
    """Linear rescale from observed range [o_min,o_max] to [n_min,n_max]."""

    def __init__(self, n_min=0.0, n_max=1.0, o_min=0.0, o_max=255.0,
                 input_col="features", output_col="features_normalized"):
        self.n_min, self.n_max = float(n_min), float(n_max)
        self.o_min, self.o_max = float(o_min), float(o_max)
        self.input_col, self.output_col = input_col, output_col

    def transform(self, dataset):
        x = np.asarray(dataset[self.input_col], dtype=np.float32)
        scale = (self.n_max - self.n_min) / (self.o_max - self.o_min)
        y = (x - self.o_min) * scale + self.n_min
        return dataset.with_column(self.output_col, y)


class OneHotTransformer(Transformer):
    """Integer label column -> one-hot float vector column."""

    def __init__(self, output_dim, input_col="label",
                 output_col="label_encoded"):
        self.output_dim = int(output_dim)
        self.input_col, self.output_col = input_col, output_col

    def transform(self, dataset):
        y = one_hot(dataset[self.input_col], self.output_dim)
        return dataset.with_column(self.output_col, y)


class LabelIndexTransformer(Transformer):
    """Prediction vector column -> argmax index column."""

    def __init__(self, output_dim=None, input_col="prediction",
                 output_col="prediction_index"):
        self.output_dim = output_dim  # kept for signature parity; unused
        self.input_col, self.output_col = input_col, output_col

    def transform(self, dataset):
        p = np.asarray(dataset[self.input_col])
        idx = np.argmax(p, axis=-1).astype(np.int64)
        return dataset.with_column(self.output_col, idx)


class ReshapeTransformer(Transformer):
    """Flat feature vectors -> tensors (e.g. 784 -> (28,28,1) for CNNs)."""

    def __init__(self, input_col="features", output_col="features_reshaped",
                 shape=None):
        if shape is None:
            raise ValueError("ReshapeTransformer needs a target shape")
        self.shape = tuple(shape)
        self.input_col, self.output_col = input_col, output_col

    def transform(self, dataset):
        x = np.asarray(dataset[self.input_col])
        y = x.reshape(len(x), *self.shape)
        return dataset.with_column(self.output_col, y)


class DenseTransformer(Transformer):
    """Sparse (indices, values, size) rows -> dense vectors.

    The reference converts Spark SparseVector columns to DenseVector
    (transformers.py:~310).  We accept either scipy.sparse matrices or an
    object column of (indices, values) pairs with ``size``.
    """

    def __init__(self, input_col="features_sparse", output_col="features",
                 size=None):
        self.input_col, self.output_col = input_col, output_col
        self.size = size

    def transform(self, dataset):
        col = dataset[self.input_col]
        # only the optional-dependency probe is forgiven: a real
        # densify error (a MemoryError from todense) must surface, not
        # fall through to the pair-row path's "needs size=" ValueError
        try:  # scipy sparse matrix stored whole
            import scipy.sparse as sp
            is_sparse = sp.issparse(col)
        except ImportError:
            is_sparse = False
        if is_sparse:
            return dataset.with_column(
                self.output_col, np.asarray(col.todense(), np.float32))
        if self.size is None:
            raise ValueError("DenseTransformer needs size= for pair rows")
        out = np.zeros((len(col), self.size), dtype=np.float32)
        for i, row in enumerate(col):
            idx, vals = row
            out[i, np.asarray(idx, dtype=np.int64)] = vals
        return dataset.with_column(self.output_col, out)


class StandardScaleTransformer(Transformer):
    """(x - mean) / std per feature — common prep in the Higgs workflow."""

    def __init__(self, input_col="features", output_col="features_scaled",
                 epsilon=1e-8):
        self.input_col, self.output_col = input_col, output_col
        self.epsilon = epsilon

    def transform(self, dataset):
        x = np.asarray(dataset[self.input_col], dtype=np.float32)
        mu = x.mean(axis=0, keepdims=True)
        sd = x.std(axis=0, keepdims=True)
        return dataset.with_column(
            self.output_col, (x - mu) / (sd + self.epsilon))
