"""The port's accuracy gate: ``SingleTrainer`` on the MNIST MLP at
``tests/test_examples.py``'s tier sizes (the ``fast_gates`` fixture
picks the tier, as ``G`` does there), on the CPU, scored through
``ModelPredictor`` -> ``LabelIndexTransformer`` -> ``AccuracyEvaluator``.
It reaches the tier's ``single_mnist_mlp`` threshold (0.90 full, 0.80
fast) and prints a ``GATE_RESULT`` line in ``_gate``'s format."""

import json

import pytest

from dist_keras_tpu_torch.data import (
    AccuracyEvaluator,
    LabelIndexTransformer,
    MinMaxTransformer,
    ModelPredictor,
    OneHotTransformer,
)
from dist_keras_tpu_torch.data.synthetic import synthetic_mnist
from dist_keras_tpu_torch.models import mnist_mlp
from dist_keras_tpu_torch.trainers import SingleTrainer


@pytest.fixture(scope="module")
def tier(fast_gates):
    if fast_gates:
        return dict(fast=True, acc=0.80, mnist_n=3072, test_n=512,
                    ep_single=4)
    return dict(fast=False, acc=0.90, mnist_n=4096, test_n=1024,
                ep_single=6)


def _prep(ds):
    ds = MinMaxTransformer(0.0, 1.0, 0.0, 255.0, input_col="features",
                           output_col="fn").transform(ds)
    return OneHotTransformer(10, input_col="label",
                             output_col="le").transform(ds)


def test_single_mnist_mlp_torch(tier):
    train = _prep(synthetic_mnist(tier["mnist_n"], seed=0))
    test = _prep(synthetic_mnist(tier["test_n"], seed=1))
    t = SingleTrainer(mnist_mlp(), worker_optimizer="adam",
                      optimizer_kwargs={"learning_rate": 1e-3},
                      batch_size=64, num_epoch=tier["ep_single"],
                      features_col="fn", label_col="le", device="cpu")
    trained = t.train(train, shuffle=True)
    pred = ModelPredictor(trained, features_col="fn",
                          device="cpu").predict(test)
    pred = LabelIndexTransformer(input_col="prediction").transform(pred)
    acc = AccuracyEvaluator(prediction_col="prediction_index",
                            label_col="label").evaluate(pred)
    rec = {"name": "single_mnist_mlp_torch", "metric": "accuracy",
           "value": float(acc), "threshold": float(tier["acc"]),
           "passed": bool(acc >= tier["acc"]),
           "tier": "fast" if tier["fast"] else "full",
           "detail": "PyTorch port, CPU"}
    print(f"GATE_RESULT {json.dumps(rec)}", flush=True)
    assert acc >= tier["acc"], f"single_mnist_mlp_torch accuracy {acc}"
