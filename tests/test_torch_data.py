"""The port's copies of the JAX package's pure-numpy data modules give
identical arrays for the same seed (``synthetic``, the transformers,
``Dataset.shuffle`` / ``batches``, ``one_hot``), and its predictor and
evaluators agree with the JAX package's (predictions 1e-5 relative,
evaluators exactly or to 1e-6)."""

import numpy as np
import pytest

from dist_keras_tpu.data import dataset as jds
from dist_keras_tpu.data import evaluators as jev
from dist_keras_tpu.data import predictors as jpr
from dist_keras_tpu.data import synthetic as jsyn
from dist_keras_tpu.data import transformers as jtf
from dist_keras_tpu.models import zoo as jzoo
from dist_keras_tpu.utils import misc as jmisc
from dist_keras_tpu_torch.data import dataset as tds
from dist_keras_tpu_torch.data import evaluators as tev
from dist_keras_tpu_torch.data import predictors as tpr
from dist_keras_tpu_torch.data import synthetic as tsyn
from dist_keras_tpu_torch.data import transformers as ttf
from dist_keras_tpu_torch.utils import misc as tmisc
from dist_keras_tpu_torch.utils import serialization as tser


def _same(a, b):
    assert a.columns == b.columns
    for c in a.columns:
        np.testing.assert_array_equal(a[c], b[c])
        assert a[c].dtype == b[c].dtype


@pytest.mark.parametrize("name,n", [("synthetic_mnist", 40),
                                    ("synthetic_higgs", 64),
                                    ("synthetic_cifar10", 24)])
def test_synthetic_sets_are_identical(name, n):
    _same(getattr(tsyn, name)(n, seed=3), getattr(jsyn, name)(n, seed=3))


def test_transformers_are_identical():
    j = jsyn.synthetic_mnist(32, seed=0)
    t = tds.Dataset({c: j[c] for c in j.columns})
    steps = [("MinMaxTransformer", dict(n_min=-1.0, input_col="features",
                                        output_col="fn")),
             ("OneHotTransformer", dict(output_dim=10, output_col="le")),
             ("ReshapeTransformer", dict(input_col="fn", output_col="fi",
                                         shape=(28, 28, 1))),
             ("StandardScaleTransformer", dict(input_col="fn",
                                               output_col="fs")),
             ("LabelIndexTransformer", dict(input_col="le",
                                            output_col="li"))]
    for cls, kw in steps:
        j = getattr(jtf, cls)(**kw).transform(j)
        t = getattr(ttf, cls)(**kw).transform(t)
    _same(t, j)
    rows = [([0, 3], [1.0, 2.0]), ([1], [5.0])]
    col = np.empty(2, dtype=object)
    col[:] = rows
    dj = jtf.DenseTransformer(input_col="s", size=4).transform(
        jds.Dataset({"s": col}))
    dt = ttf.DenseTransformer(input_col="s", size=4).transform(
        tds.Dataset({"s": col}))
    np.testing.assert_array_equal(dt["features"], dj["features"])


@pytest.mark.parametrize("seed", [0, 7])
def test_dataset_shuffle_split_and_batches_are_identical(seed):
    rng = np.random.default_rng(1)
    cols = {"x": rng.normal(size=(50, 3)).astype(np.float32),
            "y": rng.integers(0, 255, size=(50,)).astype(np.uint8)}
    j, t = jds.Dataset(cols), tds.Dataset(cols)
    _same(t.shuffle(seed), j.shuffle(seed))
    for a, b in zip(t.split(0.3, seed=seed), j.split(0.3, seed=seed)):
        _same(a, b)
    for dtype in (np.float32, None):
        for a, b in zip(t.shuffle(seed).batches(8, "x", "y", dtype=dtype),
                        j.shuffle(seed).batches(8, "x", "y", dtype=dtype)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    for a, b in zip(t.worker_shards(2, 4, "x", "y"),
                    j.worker_shards(2, 4, "x", "y")):
        np.testing.assert_array_equal(a, b)
    _same(tmisc.shuffle(t, seed=seed), jmisc.shuffle(j, seed=seed))


def test_misc_helpers_are_identical():
    labels = np.array([3, 0, 2, 2])
    np.testing.assert_array_equal(tmisc.one_hot(labels, 4),
                                  jmisc.one_hot(labels, 4))
    np.testing.assert_array_equal(tmisc.to_vector(2, 5),
                                  jmisc.to_vector(2, 5))
    assert tmisc.history_average_loss([[1.0, 2.0], [3.0, 4.0]]) == \
        jmisc.history_average_loss([[1.0, 2.0], [3.0, 4.0]])


def test_model_predictor_matches_jax():
    jm = jzoo.higgs_mlp(seed=1)
    tm = tser.deserialize_model(tser.serialize_model(jm))
    ds = jsyn.synthetic_higgs(37, seed=2)
    want = jpr.ModelPredictor(jm, batch_size=16).predict(ds)
    tdata = tds.Dataset({c: ds[c] for c in ds.columns})
    got = tpr.ModelPredictor(tm, batch_size=16, device="cpu").predict(tdata)
    w = want["prediction"]
    assert got["prediction"].shape == w.shape == (37, 2)
    assert np.abs(got["prediction"] - w).max() <= 1e-5 * np.abs(w).max()
    empty = tpr.ModelPredictor(tm, device="cpu").predict(tdata.take(0))
    assert empty["prediction"].shape == (0, 2)


def _higgs_predictor_inputs(n):
    jm = jzoo.higgs_mlp(seed=1)
    tm = tser.deserialize_model(tser.serialize_model(jm))
    ds = jsyn.synthetic_higgs(64, seed=2)
    cols = {c: ds[c][:n] for c in ds.columns}
    return jm, tm, jds.Dataset(cols), tds.Dataset(cols)


@pytest.mark.parametrize("n", [0, 1, 3, 37, 64])
def test_sharded_model_predictor_matches_the_jax_sharded_one(monkeypatch, n):
    """Sharded over four CPU shards through the predictor's device seam,
    the port's rows equal the JAX predictor's sharded over the 8 virtual
    devices (1e-5 of the largest output), for row counts of none, fewer
    than the shards, ragged and whole batches."""
    import jax
    import torch

    assert len(jax.devices()) == 8
    jm, tm, jdata, tdata = _higgs_predictor_inputs(n)
    want = jpr.ModelPredictor(jm, batch_size=16).predict(jdata)["prediction"]
    cpus = [torch.device("cpu")] * 4
    monkeypatch.setattr(tpr, "_shard_devices", lambda: cpus)
    p = tpr.ModelPredictor(tm, batch_size=16)
    assert p.devices == cpus
    got = p.predict(tdata)["prediction"]
    assert got.shape == want.shape == (n, 2)
    assert got.dtype == want.dtype == np.float32
    if n:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # a batch_size under the shard count still gives each shard a row
    few = tpr.ModelPredictor(tm, batch_size=3).predict(tdata)["prediction"]
    assert few.shape == (n, 2)
    if n:
        assert np.abs(few - want).max() <= 1e-5 * np.abs(want).max()


def test_model_predictor_plans_a_shard_per_card(monkeypatch):
    """The default construction on a host with two cards plans one shard
    a card; ``sharded=False`` and an explicit device take one device."""
    import torch

    tm = tser.deserialize_model(tser.serialize_model(jzoo.higgs_mlp(seed=1)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    p = tpr.ModelPredictor(tm)
    assert p.devices == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert p.device == torch.device("cuda", 0)
    one = tpr.ModelPredictor(tm, sharded=False)
    assert one.devices == [one.device] and one.device.type == "cuda"
    cpu = tpr.ModelPredictor(tm, device="cpu")
    assert cpu.devices == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tpr.ModelPredictor(tm).devices == [torch.device("cuda")]


def test_model_predictor_under_a_process_group_uses_the_ranks_card(
        monkeypatch):
    """Under a process group the predictor takes the rank's own card and
    never the other ranks' (nor asks the seam for the host's cards)."""
    import torch

    from dist_keras_tpu_torch.comm import backend as comm

    tm = tser.deserialize_model(tser.serialize_model(jzoo.higgs_mlp(seed=1)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = [torch.device("cuda", i) for i in range(4)]
    monkeypatch.setattr(comm, "_group", comm._Group(
        1, 4, 1, 4, "nccl", cards[1], None, cards))

    def seam():
        raise AssertionError("the seam was asked for the host's cards")

    monkeypatch.setattr(tpr, "_shard_devices", seam)
    p = tpr.ModelPredictor(tm)
    assert p.devices == [cards[1]] and p.device == cards[1]


def test_local_devices_single_process_and_under_a_group(monkeypatch):
    """``local_devices()`` is ``jax.local_devices()``: every visible card
    of a single process (the CPU alone without one), the rank's one
    device under a group; ``global_devices()`` follows."""
    import torch

    from dist_keras_tpu_torch.comm import backend as comm

    assert comm.group_info() is None
    if not torch.cuda.is_available():
        assert comm.local_devices() == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cards = [torch.device("cuda", i) for i in range(3)]
    assert comm.local_devices() == cards
    assert comm.global_devices() == cards
    monkeypatch.setattr(comm, "_group", comm._Group(
        2, 3, 2, 3, "nccl", cards[2], None, cards))
    assert comm.local_devices() == [cards[2]]
    assert comm.global_devices() == cards


def test_evaluators_match_jax():
    rng = np.random.default_rng(0)
    scores = rng.normal(size=(64, 2)).astype(np.float32)
    scores[:8] = scores[8:16]   # ties in the AUC ranks
    label = rng.integers(0, 2, 64)
    cols = {"prediction": scores, "label": np.eye(2, dtype=np.float32)[label],
            "prediction_index": scores.argmax(-1)}
    j, t = jds.Dataset(cols), tds.Dataset(cols)
    assert tev.AccuracyEvaluator().evaluate(t) == \
        jev.AccuracyEvaluator().evaluate(j)
    assert tev.AUCEvaluator().evaluate(t) == jev.AUCEvaluator().evaluate(j)
    np.testing.assert_allclose(tev.LossEvaluator().evaluate(t),
                               jev.LossEvaluator().evaluate(j), rtol=1e-6)
