"""The port's SingleTrainer against the JAX package's on the same rows
and the same initial weights (CPU).

Tolerances: with sgd the per-step loss history within 1e-5 relative and
the final params within 1e-5 absolute (f32, the same batches in the
same order; 18 steps of different BLAS rounding); with adam the loss
history within 1e-3 relative (adam's first updates are about +-lr
wherever a gradient is tiny, which amplifies rounding, so the params
are not compared)."""

import jax
import numpy as np
import pytest
import torch

from dist_keras_tpu.data.dataset import Dataset as JDataset
from dist_keras_tpu.models import layers as jl
from dist_keras_tpu.models import model as jmodel
from dist_keras_tpu.resilience.guards import NonFiniteLossError as JNaN
from dist_keras_tpu.trainers.single import SingleTrainer as JSingle
from dist_keras_tpu_torch.data.dataset import Dataset as TDataset
from dist_keras_tpu_torch.models import layers as tl
from dist_keras_tpu_torch.models import model as tmodel
from dist_keras_tpu_torch.resilience.guards import NonFiniteLossError as TNaN
from dist_keras_tpu_torch.trainers import SingleTrainer as TSingle
from dist_keras_tpu_torch.utils.bridge import params_to_numpy

BATCH, EPOCHS, ROWS = 16, 3, 100   # 6 steps per epoch, 4 rows dropped


def _models():
    jm = jmodel.Sequential([jl.Dense(16, activation="relu"), jl.Dense(3)])
    jm.build((10,), seed=0)
    tm = tmodel.Sequential([tl.Dense(16, activation="relu"), tl.Dense(3)])
    tm.build((10,))
    tm.set_weights(jm.get_weights())
    return jm, tm


def _columns(uint8=False, nan_row=None):
    rng = np.random.default_rng(0)
    if uint8:
        x = rng.integers(0, 255, size=(ROWS, 10)).astype(np.uint8)
    else:
        x = rng.normal(size=(ROWS, 10)).astype(np.float32)
    if nan_row is not None:
        x[nan_row, 0] = np.nan
    label = rng.integers(0, 3, ROWS)
    return {"x": x, "y": np.eye(3, dtype=np.float32)[label]}


def _pair(optimizer="sgd", lr=0.1, uint8=False, nan_row=None, **kw):
    jm, tm = _models()
    cols = _columns(uint8, nan_row)
    common = dict(worker_optimizer=optimizer,
                  optimizer_kwargs={"learning_rate": lr},
                  batch_size=BATCH, num_epoch=EPOCHS, features_col="x",
                  label_col="y", seed=3, **kw)
    if uint8:
        common["data_dtype"] = None
    jt, tt = JSingle(jm, **common), TSingle(tm, device="cpu", **common)
    return (jt, JDataset(cols)), (tt, TDataset(cols))


@pytest.mark.parametrize("uint8", [False, True], ids=["f32", "uint8"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_sgd_history_and_params_match_jax(shuffle, uint8):
    lr = 1e-3 if uint8 else 0.1   # uint8 features reach 255
    (jt, jds), (tt, tds) = _pair(lr=lr, uint8=uint8)
    jm = jt.train(jds, shuffle=shuffle)
    tm = tt.train(tds, shuffle=shuffle)
    jh, th = np.asarray(jt.get_history()), np.asarray(tt.get_history())
    assert th.shape == jh.shape == (EPOCHS * (ROWS // BATCH),)
    np.testing.assert_allclose(th, jh, rtol=1e-5)
    assert th[-1] < th[0]
    for a, b in zip(jax.tree.leaves(params_to_numpy(tm.params)),
                    jax.tree.leaves(jm.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)
    assert isinstance(tm, tmodel.Sequential)
    assert all(p.device.type == "cpu" for p in tm.parameters())


def test_adam_history_matches_jax():
    (jt, jds), (tt, tds) = _pair("adam", lr=1e-2)
    jt.train(jds, shuffle=True)
    tt.train(tds, shuffle=True)
    np.testing.assert_allclose(tt.get_history(), jt.get_history(),
                               rtol=1e-3)


def test_metrics_callbacks_and_history_have_the_reference_shape():
    jseen, tseen = [], []
    (jt, jds), (tt, tds) = _pair(
        callbacks=[lambda tr, epoch, logs: jseen.append((epoch, logs))])
    tt.callbacks = [lambda tr, epoch, logs: tseen.append((epoch, logs))]
    jt.train(jds)
    tt.train(tds)
    assert [e for e, _ in tseen] == [e for e, _ in jseen] == [1, 2, 3]
    assert len(tt.metrics) == len(jt.metrics) == EPOCHS
    for tm_, jm_ in zip(tt.metrics, jt.metrics):
        assert list(tm_) == list(jm_)
        assert tm_["epoch"] == jm_["epoch"]
        assert tm_["nonfinite_steps"] == jm_["nonfinite_steps"] == 0
        np.testing.assert_allclose(tm_["mean_loss"], jm_["mean_loss"],
                                   rtol=1e-5)
    assert [logs for _, logs in tseen] == tt.metrics
    assert isinstance(tt.get_history(), list)
    assert np.asarray(tt.get_history()).shape == np.asarray(
        jt.get_history()).shape
    np.testing.assert_allclose(tt.get_averaged_history(),
                               jt.get_averaged_history(), rtol=1e-5)
    assert tt.get_training_time() > 0


def test_one_metrics_record_without_callbacks():
    (jt, jds), (tt, tds) = _pair()
    jt.train(jds)
    tt.train(tds)
    assert [m["epoch"] for m in tt.metrics] == [
        m["epoch"] for m in jt.metrics] == [EPOCHS]


def test_nan_policy_raise_matches_jax():
    (jt, jds), (tt, tds) = _pair(nan_row=40)
    with pytest.raises(JNaN) as jerr:
        jt.train(jds)
    with pytest.raises(TNaN) as terr:
        tt.train(tds)
    assert terr.value.nonfinite == jerr.value.nonfinite > 0
    assert terr.value.units_done == jerr.value.units_done


def test_nan_policy_skip_matches_jax():
    (jt, jds), (tt, tds) = _pair(nan_row=40, nan_policy="skip")
    jm = jt.train(jds)
    tm = tt.train(tds)
    jh, th = np.asarray(jt.get_history()), np.asarray(tt.get_history())
    np.testing.assert_array_equal(np.isnan(th), np.isnan(jh))
    assert np.isnan(th).sum() == EPOCHS   # the poisoned batch, each epoch
    np.testing.assert_allclose(th[~np.isnan(th)], jh[~np.isnan(jh)],
                               rtol=1e-5)
    assert tt.nonfinite_steps == jt.nonfinite_steps == EPOCHS
    for a, b in zip(jax.tree.leaves(params_to_numpy(tm.params)),
                    jax.tree.leaves(jm.params)):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tt.metrics[-1]["mean_loss"],
                               jt.metrics[-1]["mean_loss"], rtol=1e-5)


def test_nan_policy_halt_matches_jax():
    # per-epoch chunks (a callback), so the halt stops after epoch 1
    (jt, jds), (tt, tds) = _pair(nan_row=40, nan_policy="halt",
                                 callbacks=[lambda *a: None])
    jt.train(jds)
    tt.train(tds)
    assert len(tt.get_history()) == len(jt.get_history()) == ROWS // BATCH
    # unguarded, the NaN reaches the params: steps 3..6 of epoch 1
    assert [m["nonfinite_steps"] for m in tt.metrics] == [
        m["nonfinite_steps"] for m in jt.metrics] == [4]


def test_the_card_is_the_default_device(monkeypatch):
    _, tm = _models()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSingle(tm)
    assert TSingle(tm, device="cpu").device == torch.device("cpu")


def test_chunk_plan_matches_jax():
    from dist_keras_tpu.trainers import chunking as jc
    from dist_keras_tpu_torch.trainers import chunking as tc

    for start, total, per_epoch in [(0, 18, 6), (4, 18, 6), (0, 7, 7),
                                    (9, 9, 3), (2, 23, 5)]:
        for bounds in (False, True):
            assert tc.chunk_plan(start, total, per_epoch,
                                 epoch_bounds=bounds) == jc.chunk_plan(
                start, total, per_epoch, epoch_bounds=bounds)


def test_chunk_plan_cadence_matches_jax():
    from dist_keras_tpu.trainers import chunking as jc
    from dist_keras_tpu_torch.trainers import chunking as tc

    for start, total, per_epoch in [(0, 18, 6), (4, 18, 6), (0, 7, 7),
                                    (9, 9, 3), (2, 23, 5), (7, 40, 4)]:
        for bounds in (False, True):
            for cadence in (None, 1, 3, 5):
                assert tc.chunk_plan(
                    start, total, per_epoch, epoch_bounds=bounds,
                    cadence=cadence) == jc.chunk_plan(
                    start, total, per_epoch, epoch_bounds=bounds,
                    cadence=cadence)
