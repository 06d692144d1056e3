"""The data path — counterpart of ``data/``: ``Dataset`` (with
``from_csv`` through ``csv.py`` and the port's own native reader, and
``from_spark``), the feature transformers, the synthetic sets,
``ModelPredictor``, the evaluators, ``feed.ChunkFeed`` (the trainers'
streaming input) and ``streaming.py``'s sources and
``StreamingPredictor``."""

from dist_keras_tpu_torch.data.dataset import Dataset
from dist_keras_tpu_torch.data.evaluators import (
    AccuracyEvaluator,
    AUCEvaluator,
    Evaluator,
    LossEvaluator,
)
from dist_keras_tpu_torch.data.predictors import ModelPredictor, Predictor
from dist_keras_tpu_torch.data.streaming import (
    KafkaSource,
    QueueSource,
    SocketSource,
    StreamingPredictor,
    StreamSource,
    pack_rows,
    pad_rows,
    send_rows,
)
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
    "StreamSource", "QueueSource", "SocketSource", "KafkaSource",
    "StreamingPredictor", "send_rows", "pack_rows", "pad_rows",
]
