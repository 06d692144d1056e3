"""The data path: ``Dataset``, the feature transformers, the synthetic
sets, ``ModelPredictor``, the evaluators and the fixed-shape row packing
of ``data/streaming.py`` — counterpart of ``data/`` (the stream sources
and ``StreamingPredictor`` are ROADMAP queue 1, item 14; ``csv.py`` and
the native CSV reader item 23)."""

from dist_keras_tpu_torch.data.dataset import Dataset
from dist_keras_tpu_torch.data.evaluators import (
    AccuracyEvaluator,
    AUCEvaluator,
    Evaluator,
    LossEvaluator,
)
from dist_keras_tpu_torch.data.predictors import ModelPredictor, Predictor
from dist_keras_tpu_torch.data.streaming import pack_rows, pad_rows
from dist_keras_tpu_torch.data.transformers import (
    DenseTransformer,
    LabelIndexTransformer,
    MinMaxTransformer,
    OneHotTransformer,
    ReshapeTransformer,
    StandardScaleTransformer,
    Transformer,
)

__all__ = [
    "Dataset",
    "Transformer", "MinMaxTransformer", "OneHotTransformer",
    "LabelIndexTransformer", "ReshapeTransformer", "DenseTransformer",
    "StandardScaleTransformer",
    "Predictor", "ModelPredictor",
    "Evaluator", "AccuracyEvaluator", "LossEvaluator", "AUCEvaluator",
    "pack_rows", "pad_rows",
]
