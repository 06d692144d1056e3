"""The port's accuracy gates at ``tests/test_examples.py``'s tier sizes
(the ``fast_gates`` fixture picks the tier, as ``G`` does there), on the
CPU, each printing a ``GATE_RESULT`` line in ``_gate``'s format:

- ``SingleTrainer`` on the MNIST MLP, scored through ``ModelPredictor``
  -> ``LabelIndexTransformer`` -> ``AccuracyEvaluator`` (0.90 full,
  0.80 fast);
- ``ADAG`` on the MNIST CNN, 4 workers, window 12 (the BASELINE target):
  the same accuracy bars;
- ``AEASGD`` / ``EAMSGD`` on the ATLAS-Higgs dense classifier, scored by
  ``AUCEvaluator`` (0.85 full, 0.80 fast)."""

import json

import pytest

from dist_keras_tpu_torch.data import (
    AccuracyEvaluator,
    AUCEvaluator,
    LabelIndexTransformer,
    MinMaxTransformer,
    ModelPredictor,
    OneHotTransformer,
    ReshapeTransformer,
    StandardScaleTransformer,
)
from dist_keras_tpu_torch.data.synthetic import (
    synthetic_higgs,
    synthetic_mnist,
)
from dist_keras_tpu_torch.models import higgs_mlp, mnist_cnn, mnist_mlp
from dist_keras_tpu_torch.trainers import ADAG, AEASGD, EAMSGD, SingleTrainer


@pytest.fixture(scope="module")
def tier(fast_gates):
    if fast_gates:
        return dict(fast=True, acc=0.80, auc=0.80, mnist_n=3072, test_n=512,
                    higgs_n=4096, higgs_test=1024, ep_single=4, ep_adag=4,
                    ep_aeasgd=5)
    return dict(fast=False, acc=0.90, auc=0.85, mnist_n=4096, test_n=1024,
                higgs_n=8192, higgs_test=2048, ep_single=6, ep_adag=6,
                ep_aeasgd=10)


def _prep(ds):
    ds = MinMaxTransformer(0.0, 1.0, 0.0, 255.0, input_col="features",
                           output_col="fn").transform(ds)
    ds = OneHotTransformer(10, input_col="label",
                           output_col="le").transform(ds)
    return ReshapeTransformer(input_col="fn", output_col="fi",
                              shape=(28, 28, 1)).transform(ds)


@pytest.fixture(scope="module")
def mnist(tier):
    return (_prep(synthetic_mnist(tier["mnist_n"], seed=0)),
            _prep(synthetic_mnist(tier["test_n"], seed=1)))


def _gate(tier, name, metric, value, threshold):
    rec = {"name": name, "metric": metric, "value": float(value),
           "threshold": float(threshold),
           "passed": bool(value >= threshold),
           "tier": "fast" if tier["fast"] else "full",
           "detail": "PyTorch port, CPU"}
    print(f"GATE_RESULT {json.dumps(rec)}", flush=True)
    assert value >= threshold, f"{name} {metric} {value} < {threshold}"


def _accuracy(model, test, features_col):
    pred = ModelPredictor(model, features_col=features_col,
                          device="cpu").predict(test)
    pred = LabelIndexTransformer(input_col="prediction").transform(pred)
    return AccuracyEvaluator(prediction_col="prediction_index",
                             label_col="label").evaluate(pred)


def test_single_mnist_mlp_torch(tier, mnist):
    train, test = mnist
    t = SingleTrainer(mnist_mlp(), worker_optimizer="adam",
                      optimizer_kwargs={"learning_rate": 1e-3},
                      batch_size=64, num_epoch=tier["ep_single"],
                      features_col="fn", label_col="le", device="cpu")
    trained = t.train(train, shuffle=True)
    _gate(tier, "single_mnist_mlp_torch", "accuracy",
          _accuracy(trained, test, "fn"), tier["acc"])


def test_adag_mnist_cnn_w12_torch(tier, mnist):
    train, test = mnist
    t = ADAG(mnist_cnn(), num_workers=4, communication_window=12,
             worker_optimizer="adam",
             optimizer_kwargs={"learning_rate": 3e-3},
             batch_size=64, num_epoch=tier["ep_adag"],
             features_col="fi", label_col="le", device="cpu")
    trained = t.train(train, shuffle=True)
    _gate(tier, "adag_mnist_cnn_w12_torch", "accuracy",
          _accuracy(trained, test, "fi"), tier["acc"])


@pytest.fixture(scope="module")
def higgs(tier):
    def prep(n, seed):
        ds = synthetic_higgs(n, seed=seed)
        ds = StandardScaleTransformer(input_col="features",
                                      output_col="fs").transform(ds)
        return OneHotTransformer(2, input_col="label",
                                 output_col="le").transform(ds)

    return prep(tier["higgs_n"], 0), prep(tier["higgs_test"], 1)


@pytest.mark.parametrize("cls,extra", [(AEASGD, {}),
                                       (EAMSGD, {"momentum": 0.9})],
                         ids=["aeasgd", "eamsgd"])
def test_aeasgd_eamsgd_higgs_torch(tier, higgs, cls, extra):
    train, test = higgs
    t = cls(higgs_mlp(), num_workers=4, communication_window=16,
            rho=1.0, learning_rate=0.2, worker_optimizer="adam",
            optimizer_kwargs={"learning_rate": 1e-3}, batch_size=64,
            num_epoch=tier["ep_aeasgd"], features_col="fs", label_col="le",
            device="cpu", **extra)
    trained = t.train(train, shuffle=True)
    pred = ModelPredictor(trained, features_col="fs",
                          device="cpu").predict(test)
    auc = AUCEvaluator(score_col="prediction",
                       label_col="label").evaluate(pred)
    _gate(tier, f"{cls.__name__.lower()}_higgs_torch", "auc", auc,
          tier["auc"])
