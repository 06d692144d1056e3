"""Metric evaluators — parity with ``distkeras/evaluators.py``; counterpart
of the JAX package's ``data/evaluators.py`` (``LossEvaluator`` runs the
port's losses on CPU tensors).

Same verbs: ``evaluate(dataset) -> float``.  Vectorised numpy instead of RDD
count jobs (evaluators.py:~45).
"""

from __future__ import annotations

import numpy as np


class Evaluator:
    """Base (evaluators.py:~15)."""

    def evaluate(self, dataset):
        raise NotImplementedError


class AccuracyEvaluator(Evaluator):
    """Fraction of rows where prediction_col == label_col
    (evaluators.py:~30)."""

    def __init__(self, prediction_col="prediction_index", label_col="label"):
        self.prediction_col = prediction_col
        self.label_col = label_col

    def evaluate(self, dataset):
        pred = np.asarray(dataset[self.prediction_col]).reshape(-1)
        label = np.asarray(dataset[self.label_col])
        if label.ndim > 1:  # one-hot labels: compare to argmax
            label = np.argmax(label, axis=-1)
        label = label.reshape(-1)
        return float(np.mean(pred == label))


class LossEvaluator(Evaluator):
    """Mean loss of a prediction column vs labels (new capability — the
    reference only had accuracy)."""

    def __init__(self, loss="categorical_crossentropy",
                 prediction_col="prediction", label_col="label"):
        from dist_keras_tpu_torch.ops.losses import get_loss
        self.loss_fn = get_loss(loss)
        self.prediction_col = prediction_col
        self.label_col = label_col

    def evaluate(self, dataset):
        import torch
        p = torch.from_numpy(
            np.asarray(dataset[self.prediction_col], np.float32))
        y = torch.from_numpy(np.asarray(dataset[self.label_col], np.float32))
        return float(self.loss_fn(p, y))


class AUCEvaluator(Evaluator):
    """Binary ROC-AUC over a score column (Higgs workflow metric)."""

    def __init__(self, score_col="prediction", label_col="label",
                 positive_index=1):
        self.score_col = score_col
        self.label_col = label_col
        self.positive_index = positive_index

    def evaluate(self, dataset):
        s = np.asarray(dataset[self.score_col], dtype=np.float64)
        if s.ndim > 1:
            s = s[:, self.positive_index]
        y = np.asarray(dataset[self.label_col])
        if y.ndim > 1:
            y = np.argmax(y, axis=-1)
        y = (y == self.positive_index).astype(np.int64) \
            if y.max() > 1 else y.astype(np.int64)
        order = np.argsort(s, kind="mergesort")
        ranks = np.empty(len(s), dtype=np.float64)
        ranks[order] = np.arange(1, len(s) + 1)
        # tied scores get their mean rank (Mann-Whitney convention);
        # arbitrary distinct ranks would bias AUC on quantized/saturated
        # scores
        _, inv = np.unique(s, return_inverse=True)
        sums = np.bincount(inv, weights=ranks)
        counts = np.bincount(inv)
        ranks = (sums / counts)[inv]
        n_pos = int(y.sum())
        n_neg = len(y) - n_pos
        if n_pos == 0 or n_neg == 0:
            return float("nan")
        return float((ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2)
                     / (n_pos * n_neg))
