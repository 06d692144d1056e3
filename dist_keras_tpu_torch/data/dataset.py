"""Columnar dataset — a copy of the JAX package's ``data/dataset.py``.

The port keeps its own copy (it imports nothing of the JAX package), so
``shuffle`` and ``batches`` hand both packages the same rows in the same
order for the same seed.  The reference's notes follow.

In the reference, training data is a Spark DataFrame and every component
(transformers, trainers, predictors, evaluators) speaks DataFrame:
``df.select/withColumn/repartition/rdd.mapPartitions`` (see call stacks in
SURVEY.md §3).  On a TPU host the equivalent working set is columnar numpy in
host RAM that we slice into device-ready shards; this class provides that,
with a deliberately DataFrame-flavoured API so reference users map over:

- ``select``, ``with_column``, ``count`` — DataFrame verbs.
- ``repartition(n)`` / ``coalesce(n)`` — become logical shard counts used by
  trainers (``trainers.py:~365`` repartitions to num_workers).
- ``shuffle`` — ``distkeras/utils.py:~140``.
- ``batches`` / ``device_epoch`` — the TPU-native exit: fixed-shape batched
  arrays ready for ``lax.scan``; remainders are dropped the way the
  reference's fixed mini-batching does (``workers.py:~60``).

Interop: ``from_pandas``, ``from_arrays``, ``to_pandas``.
"""

from __future__ import annotations

import numpy as np


class Dataset:
    def __init__(self, columns: dict, num_partitions: int = 1):
        cols = {k: np.asarray(v) for k, v in columns.items()}
        if not cols:
            raise ValueError("Dataset needs at least one column")
        n = {len(v) for v in cols.values()}
        if len(n) != 1:
            raise ValueError(f"ragged columns: { {k: len(v) for k, v in cols.items()} }")
        self._cols = cols
        self.num_partitions = int(num_partitions)

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @staticmethod
    def from_arrays(features, labels, features_col="features",
                    label_col="label"):
        return Dataset({features_col: np.asarray(features),
                        label_col: np.asarray(labels)})

    @staticmethod
    def from_pandas(df):
        return Dataset({c: df[c].to_numpy() for c in df.columns})

    @staticmethod
    def from_spark(sdf):
        """Spark DataFrame -> Dataset through a pandas round trip, as the
        JAX package's shim: ``sdf.toPandas()`` is duck-typed (no pyspark
        is imported), and array-typed columns (the reference's assembled
        feature vectors) become 2-D numpy columns, matching
        ``from_csv``'s layout.  ``toPandas`` needs pandas, which a host
        may lack (the card's has none): that ``ImportError`` says so."""
        # look the method up apart from calling it: an AttributeError
        # raised INSIDE a genuine toPandas() must surface as itself
        to_pandas = getattr(sdf, "toPandas", None)
        if to_pandas is None:
            raise TypeError(
                "from_spark expects a pyspark.sql.DataFrame (an object "
                f"with .toPandas()); got {type(sdf).__name__}")
        try:
            pdf = to_pandas()
        except ImportError as e:
            raise ImportError(
                "Dataset.from_spark goes through DataFrame.toPandas(), "
                "which needs pandas, and pandas is not installed on this "
                f"host ({e}); write the DataFrame to CSV and use "
                "Dataset.from_csv instead") from e
        if len(pdf) == 0:
            raise ValueError(
                "from_spark got an empty DataFrame (0 rows) — check the "
                "upstream Spark query/filters")
        cols = {}
        for c in pdf.columns:
            v = pdf[c].to_numpy()
            if v.dtype == object:  # array<float> columns come back ragged
                try:
                    v = np.stack([np.asarray(e) for e in v])
                except (ValueError, TypeError) as e:
                    raise ValueError(
                        f"from_spark: column {c!r} has rows that do not "
                        "stack into one array — variable-length arrays "
                        "or NULL entries; pad/filter them in Spark "
                        "first") from e
                if v.dtype == object:
                    # all-NULL columns stack into an object array of
                    # Nones: caught here, not as a device-copy error
                    raise ValueError(
                        f"from_spark: column {c!r} stacked to a non-"
                        "numeric object array (NULL rows?); pad/filter "
                        "them in Spark first")
            cols[c] = v
        return Dataset(cols)

    @staticmethod
    def from_csv(path, **kw):
        """CSV -> Dataset through ``data/csv.py``'s ``read_csv`` (the
        port's native reader, numpy as the fallback)."""
        from dist_keras_tpu_torch.data.csv import read_csv
        return read_csv(path, **kw)

    def to_pandas(self):
        import pandas as pd
        flat = {}
        for k, v in self._cols.items():
            flat[k] = list(v) if v.ndim > 1 else v
        return pd.DataFrame(flat)

    # ------------------------------------------------------------------
    # DataFrame verbs
    # ------------------------------------------------------------------
    @property
    def columns(self):
        return list(self._cols)

    def __getitem__(self, col):
        return self._cols[col]

    def __len__(self):
        return len(next(iter(self._cols.values())))

    def count(self):
        return len(self)

    def select(self, *cols):
        return Dataset({c: self._cols[c] for c in cols}, self.num_partitions)

    def with_column(self, name, values):
        cols = dict(self._cols)
        cols[name] = np.asarray(values)
        return Dataset(cols, self.num_partitions)

    def drop(self, *cols):
        return Dataset({k: v for k, v in self._cols.items() if k not in cols},
                       self.num_partitions)

    def take(self, n):
        return Dataset({k: v[:n] for k, v in self._cols.items()},
                       self.num_partitions)

    def concat(self, other):
        return Dataset(
            {k: np.concatenate([self._cols[k], other._cols[k]])
             for k in self._cols},
            self.num_partitions)

    def repartition(self, n):
        """Logical shard count (trainers map shards onto mesh workers)."""
        return Dataset(self._cols, num_partitions=int(n))

    coalesce = repartition

    def shuffle(self, seed=None):
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(self))
        return Dataset({k: v[perm] for k, v in self._cols.items()},
                       self.num_partitions)

    def split(self, fraction, seed=None):
        """(train, test) row split — the reference examples' randomSplit."""
        n = len(self)
        k = int(n * fraction)
        if seed is not None:
            ds = self.shuffle(seed)
        else:
            ds = self
        left = Dataset({c: v[:k] for c, v in ds._cols.items()},
                       self.num_partitions)
        right = Dataset({c: v[k:] for c, v in ds._cols.items()},
                        self.num_partitions)
        return left, right

    # ------------------------------------------------------------------
    # TPU exits: fixed-shape batch tensors
    # ------------------------------------------------------------------
    def batches(self, batch_size, features_col="features", label_col="label",
                drop_remainder=True, dtype=np.float32):
        """-> (num_batches, batch, ...) feature and label arrays.

        Fixed shapes so one jit covers every batch; the remainder is dropped
        exactly like the reference's fixed mini-batch assembly
        (workers.py:~60).  ``dtype=None`` keeps the columns' own dtypes —
        the host->device transfer then ships e.g. uint8 image bytes at 1/4
        the float32 volume and the train step casts on-device (the
        reference feeds uint8 MNIST through the same cast-late pattern).
        """
        x = np.asarray(self._cols[features_col],
                       dtype=dtype or self._cols[features_col].dtype)
        y = np.asarray(self._cols[label_col],
                       dtype=dtype or self._cols[label_col].dtype)
        n = (len(x) // batch_size) * batch_size
        if n == 0:
            raise ValueError(
                f"dataset of {len(x)} rows has no full batch of {batch_size}")
        x, y = x[:n], y[:n]
        xb = x.reshape(n // batch_size, batch_size, *x.shape[1:])
        yb = y.reshape(n // batch_size, batch_size, *y.shape[1:])
        return xb, yb

    def worker_shards(self, num_workers, batch_size, features_col="features",
                      label_col="label", worker_range=None,
                      dtype=np.float32):
        """-> (num_workers, steps, batch, ...) arrays for shard_map training.

        Rows are dealt to workers contiguously (the reference's repartition
        deals Spark partitions to executors, trainers.py:~365).  Every worker
        gets the same step count (lockstep SPMD needs rectangular data);
        trailing rows beyond ``num_workers * steps * batch_size`` are
        truncated, exactly like the reference's fixed mini-batch assembly
        drops partial batches (workers.py:~60).

        ``worker_range=(lo, hi)`` materializes ONLY workers [lo, hi) —
        the multi-host path: every host computes the identical global
        geometry from the full length, then slices its own workers' rows,
        so concatenating hosts' results equals the full deal.

        ``dtype=None`` keeps the columns' own dtypes (uint8 image bytes
        ship at 1/4 float32 H2D volume; the train step casts on-device).
        """
        x = self._cols[features_col]
        y = self._cols[label_col]
        per = len(x) // num_workers
        steps = per // batch_size
        if steps == 0:
            raise ValueError(
                f"{len(x)} rows over {num_workers} workers x batch "
                f"{batch_size}: no full step")
        lo, hi = (0, num_workers) if worker_range is None else worker_range
        rows = slice(lo * steps * batch_size, hi * steps * batch_size)
        x = np.asarray(x[rows], dtype=dtype or x.dtype)
        y = np.asarray(y[rows], dtype=dtype or y.dtype)
        xs = x.reshape(hi - lo, steps, batch_size, *x.shape[1:])
        ys = y.reshape(hi - lo, steps, batch_size, *y.shape[1:])
        return xs, ys
