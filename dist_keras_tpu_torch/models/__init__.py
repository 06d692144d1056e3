"""Models: the Keras-style ``Sequential`` with its layers and zoo, and the
causal transformer."""

from dist_keras_tpu_torch.models.layers import (
    Activation,
    AvgPool2D,
    BatchNorm,
    Conv2D,
    Dense,
    Dropout,
    Embedding,
    Flatten,
    LayerNorm,
    MaxPool2D,
    Reshape,
    get_activation,
)
from dist_keras_tpu_torch.models.model import Sequential, model_from_json
from dist_keras_tpu_torch.models.zoo import (
    cifar10_convnet,
    higgs_mlp,
    mnist_cnn,
    mnist_mlp,
)

__all__ = [
    "Sequential", "model_from_json",
    "Dense", "Conv2D", "MaxPool2D", "AvgPool2D", "Flatten", "Reshape",
    "Activation", "Dropout", "LayerNorm", "BatchNorm", "Embedding",
    "get_activation",
    "mnist_mlp", "mnist_cnn", "higgs_mlp", "cifar10_convnet",
]
