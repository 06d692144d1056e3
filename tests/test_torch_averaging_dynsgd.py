"""The port's AveragingTrainer, EnsembleTrainer and DynSGD against the JAX
package's on the CPU (the JAX trainers on ``conftest.py``'s 8 virtual
devices, the port's with the workers stacked on one device), from the
same bridged weights and rows.

Tolerances (f32, sgd, no dropout): loss history within 1e-5 relative,
final params within 1e-5 absolute; DynSGD's commit schedule (who
commits after which step, with what staleness) exactly."""

import jax
import numpy as np
import pytest
import torch

from dist_keras_tpu.data.dataset import Dataset as JDataset
from dist_keras_tpu.models import layers as jl
from dist_keras_tpu.models import model as jmodel
from dist_keras_tpu.trainers import averaging as javg
from dist_keras_tpu.trainers import dynsgd as jdyn
from dist_keras_tpu_torch.data.dataset import Dataset as TDataset
from dist_keras_tpu_torch.models import layers as tl
from dist_keras_tpu_torch.models import model as tmodel
from dist_keras_tpu_torch.trainers import averaging as tavg
from dist_keras_tpu_torch.trainers import dynsgd as tdyn
from dist_keras_tpu_torch.utils.bridge import params_to_numpy

BATCH, EPOCHS = 8, 2


def _models():
    jm = jmodel.Sequential([jl.Dense(16, activation="relu"), jl.Dense(3)])
    jm.build((10,), seed=0)
    tm = tmodel.Sequential([tl.Dense(16, activation="relu"), tl.Dense(3)])
    tm.build((10,))
    tm.set_weights(jm.get_weights())
    return jm, tm


def _columns(rows, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(rows, 10)).astype(np.float32),
            "y": np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)]}


def _pair(jcls, tcls, rows, **kw):
    jm, tm = _models()
    cols = _columns(rows)
    common = dict(worker_optimizer="sgd",
                  optimizer_kwargs={"learning_rate": 0.1},
                  batch_size=BATCH, num_epoch=EPOCHS, features_col="x",
                  label_col="y", seed=3, **kw)
    jt, tt = jcls(jm, **common), tcls(tm, device="cpu", **common)
    return (jt, jt.train(JDataset(cols))), (tt, tt.train(TDataset(cols)))


def _assert_params_close(tparams, jparams, atol=1e-5):
    for a, b in zip(jax.tree.leaves(params_to_numpy(tparams)),
                    jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0)


@pytest.mark.parametrize("workers", [2, 4])
def test_averaging_matches_jax(workers):
    (jt, jm), (tt, tm) = _pair(javg.AveragingTrainer, tavg.AveragingTrainer,
                               workers * 5 * BATCH + 3, num_workers=workers)
    jh, th = np.asarray(jt.get_history()), np.asarray(tt.get_history())
    assert th.shape == jh.shape == (workers, EPOCHS, 5)
    np.testing.assert_allclose(th, jh, rtol=1e-5)
    _assert_params_close(tm.params, jm.params)


def test_averaging_starts_each_epoch_from_the_mean():
    """Every worker's first loss of epoch 2 is the loss of the averaged
    params on its first batch: the workers restart from one point."""
    _, tm = _models()
    cols = _columns(3 * 4 * BATCH)
    t = tavg.AveragingTrainer(tm, num_workers=3, worker_optimizer="sgd",
                              batch_size=BATCH, num_epoch=1,
                              features_col="x", label_col="y", device="cpu")
    once = t.train(TDataset(cols))
    t2 = tavg.AveragingTrainer(tm, num_workers=3, worker_optimizer="sgd",
                               batch_size=BATCH, num_epoch=2,
                               features_col="x", label_col="y",
                               device="cpu")
    t2.train(TDataset(cols))
    first = np.asarray(t2.get_history())[:, 1, 0]
    xs, ys = TDataset(cols).worker_shards(3, BATCH, "x", "y")
    from dist_keras_tpu_torch.ops.losses import categorical_crossentropy

    with torch.no_grad():
        want = [float(categorical_crossentropy(
            once.apply(once.params, torch.from_numpy(xs[i, 0])),
            torch.from_numpy(ys[i, 0]))) for i in range(3)]
    np.testing.assert_allclose(first, want, rtol=1e-5)


def test_ensemble_matches_jax_with_four_models_on_one_slot():
    (jt, jms), (tt, tms) = _pair(javg.EnsembleTrainer, tavg.EnsembleTrainer,
                                 4 * 5 * BATCH, num_models=4)
    assert tt.num_workers == 1 and tt.models_per_slot == 4
    jh, th = np.asarray(jt.get_history()), np.asarray(tt.get_history())
    assert th.shape == jh.shape == (4, EPOCHS, 5)
    np.testing.assert_allclose(th, jh, rtol=1e-5)
    assert len(tms) == len(jms) == 4
    for tm, jm in zip(tms, jms):
        _assert_params_close(tm.params, jm.params)
    assert len({float(tm.params[0]["kernel"][0, 0].detach()) for tm in tms}) == 4


def test_ensemble_slots_must_divide_the_models():
    _, tm = _models()
    t = tavg.EnsembleTrainer(tm, num_models=6, num_workers=3, device="cpu")
    assert t.num_workers == 3 and t.models_per_slot == 2
    with pytest.raises(ValueError, match="divide evenly"):
        tavg.EnsembleTrainer(tm, num_models=6, num_workers=4, device="cpu")


@pytest.mark.parametrize("workers,window", [(4, 4), (4, 3), (3, 5)])
def test_dynsgd_matches_jax(workers, window):
    (jt, jm), (tt, tm) = _pair(jdyn.DynSGD, tdyn.DynSGD,
                               workers * 7 * BATCH, num_workers=workers,
                               communication_window=window)
    jh, th = np.asarray(jt.get_history()), np.asarray(tt.get_history())
    assert th.shape == jh.shape == (workers, EPOCHS, 7)
    np.testing.assert_allclose(th, jh, rtol=1e-5)
    _assert_params_close(tm.params, jm.params)


def _reference_schedule(steps, window, n):
    """The JAX package's per-step counters (dynsgd.py's scan body),
    replayed on plain ints."""
    phases = [(i * window) // n for i in range(n)]
    last_seen, global_count, out = [0] * n, 0, []
    for t in range(steps):
        commits = [(t + 1 + phases[i]) % window == 0 for i in range(n)]
        out.append([(c, global_count - last_seen[i] if c else 0)
                    for i, c in enumerate(commits)])
        global_count += sum(commits)
        last_seen = [global_count if c else s
                     for c, s in zip(commits, last_seen)]
    return out


@pytest.mark.parametrize("steps,window,n", [(24, 4, 4), (30, 5, 8),
                                            (17, 3, 2), (40, 12, 4)])
def test_dynsgd_schedule_is_the_references(steps, window, n):
    commits, staleness, scale = tdyn.commit_schedule(steps, window, n)
    ref = _reference_schedule(steps, window, n)
    assert commits.tolist() == [[c for c, _ in row] for row in ref]
    assert staleness.tolist() == [[s for _, s in row] for row in ref]
    want = np.where(commits, np.float32(1) / (staleness.astype(np.float32)
                                              + np.float32(1)), 0)
    assert scale.dtype == np.float32
    np.testing.assert_array_equal(scale, want.astype(np.float32))
    assert staleness.max() > 0   # the schedule exercises the scaling
