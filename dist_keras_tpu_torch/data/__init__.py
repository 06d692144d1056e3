"""The data path: ``Dataset``, the feature transformers, the synthetic
sets, ``ModelPredictor`` and the evaluators — counterpart of ``data/``
(streaming, ``csv.py`` and the native CSV reader are not ported yet)."""

from dist_keras_tpu_torch.data.dataset import Dataset
from dist_keras_tpu_torch.data.evaluators import (
    AccuracyEvaluator,
    AUCEvaluator,
    Evaluator,
    LossEvaluator,
)
from dist_keras_tpu_torch.data.predictors import ModelPredictor, Predictor
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
]
