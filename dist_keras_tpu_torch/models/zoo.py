"""Benchmark model zoo — counterpart of ``models/zoo.py``, with the same
architectures, names and JSON.  ``seed`` seeds a CPU ``torch.Generator``,
so the weights are not the reference's for the same seed.

The architectures the reference exercises in its examples
(``examples/mnist.py`` MLP + CNN, ``examples/workflow.ipynb`` ATLAS-Higgs
dense classifier) plus the CIFAR-10 convnet named in ``BASELINE.json``.
All emit *logits* (losses in ``ops/losses.py`` fuse the softmax).

Shapes are NHWC, as in the reference.
"""

from __future__ import annotations

from dist_keras_tpu_torch.models.layers import (
    Conv2D,
    Dense,
    Dropout,
    Flatten,
    MaxPool2D,
)
from dist_keras_tpu_torch.models.model import Sequential


def mnist_mlp(hidden=(500, 225), num_classes=10, input_dim=784, seed=0):
    """MLP from examples/mnist.py (~500/225 relu stack, softmax head)."""
    m = Sequential(name="mnist_mlp")
    for h in hidden:
        m.add(Dense(h, activation="relu"))
    m.add(Dense(num_classes))
    m.build((input_dim,), seed=seed)
    return m


def mnist_cnn(num_classes=10, input_shape=(28, 28, 1), seed=0):
    """CNN from examples/mnist.py: conv-conv-pool + dense head."""
    m = Sequential(
        [
            Conv2D(32, 3, activation="relu", padding="same"),
            Conv2D(32, 3, activation="relu", padding="same"),
            MaxPool2D(2),
            Conv2D(64, 3, activation="relu", padding="same"),
            MaxPool2D(2),
            Flatten(),
            Dense(128, activation="relu"),
            Dropout(0.25),
            Dense(num_classes),
        ],
        name="mnist_cnn",
    )
    m.build(input_shape, seed=seed)
    return m


def higgs_mlp(input_dim=28, hidden=(300, 150, 50), num_classes=2, seed=0):
    """ATLAS-Higgs dense classifier (examples/workflow.ipynb shape)."""
    m = Sequential(name="higgs_mlp")
    for h in hidden:
        m.add(Dense(h, activation="relu"))
    m.add(Dense(num_classes))
    m.build((input_dim,), seed=seed)
    return m


def cifar10_convnet(num_classes=10, input_shape=(32, 32, 3), seed=0):
    """CIFAR-10 convnet for the DynSGD config in BASELINE.json."""
    m = Sequential(
        [
            Conv2D(32, 3, activation="relu", padding="same"),
            Conv2D(32, 3, activation="relu", padding="same"),
            MaxPool2D(2),
            Dropout(0.25),
            Conv2D(64, 3, activation="relu", padding="same"),
            Conv2D(64, 3, activation="relu", padding="same"),
            MaxPool2D(2),
            Dropout(0.25),
            Flatten(),
            Dense(512, activation="relu"),
            Dropout(0.5),
            Dense(num_classes),
        ],
        name="cifar10_convnet",
    )
    m.build(input_shape, seed=seed)
    return m
