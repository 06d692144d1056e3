"""The port's windowed trainers (DOWNPOUR, ADAG, AEASGD, EAMSGD) and its
worker-stacked step against the JAX package's, on the CPU: the JAX
trainers on the 8 virtual devices of ``conftest.py``, the port's with
the workers stacked on one device.

Tolerances (f32, sgd, no dropout, the same bridged weights and rows):
history of shape ``(workers, epochs, windows, W)`` within 1e-5 relative,
final center params within 1e-5 absolute; a conv model within 1e-4
(rounding through conv's different summation orders); the stacked step
against W separate ``make_model_step`` steps within 1e-6."""

import jax
import numpy as np
import optax
import pytest
import torch

from dist_keras_tpu.data.dataset import Dataset as JDataset
from dist_keras_tpu.models import layers as jl
from dist_keras_tpu.models import model as jmodel
from dist_keras_tpu.trainers import windowed as jw
from dist_keras_tpu_torch.data.dataset import Dataset as TDataset
from dist_keras_tpu_torch.models import layers as tl
from dist_keras_tpu_torch.models import model as tmodel
from dist_keras_tpu_torch.ops import optimizers as toptim
from dist_keras_tpu_torch.ops.losses import categorical_crossentropy as tcce
from dist_keras_tpu_torch.trainers import step as tstep
from dist_keras_tpu_torch.trainers import windowed as tw
from dist_keras_tpu_torch.utils.bridge import params_to_numpy
from dist_keras_tpu_torch.utils.pytree import tree_index, tree_stack

WORKERS, BATCH, WINDOW, EPOCHS = 4, 8, 3, 2
ROWS = 230          # 7 steps per worker: 2 windows of 3, 1 step dropped


def _dense():
    jm = jmodel.Sequential([jl.Dense(16, activation="relu"), jl.Dense(3)])
    jm.build((10,), seed=0)
    tm = tmodel.Sequential([tl.Dense(16, activation="relu"), tl.Dense(3)])
    tm.build((10,))
    tm.set_weights(jm.get_weights())
    return jm, tm


def _conv():
    def layers(m):
        return [m.Conv2D(4, 3, activation="relu", padding="same"),
                m.MaxPool2D(2), m.Flatten(), m.Dense(3)]

    jm = jmodel.Sequential(layers(jl))
    jm.build((8, 8, 1), seed=0)
    tm = tmodel.Sequential(layers(tl))
    tm.build((8, 8, 1))
    tm.set_weights(jm.get_weights())
    return jm, tm


def _batchnorm():
    jm = jmodel.Sequential([jl.Dense(16, activation="relu"), jl.BatchNorm(),
                            jl.Dense(3)])
    jm.build((10,), seed=0)
    tm = tmodel.Sequential([tl.Dense(16, activation="relu"), tl.BatchNorm(),
                            tl.Dense(3)])
    tm.build((10,))
    tm.set_weights(jm.get_weights())
    return jm, tm


def _columns(rows=ROWS, shape=(10,), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, *shape)).astype(np.float32)
    return {"x": x, "y": np.eye(3, dtype=np.float32)[
        rng.integers(0, 3, rows)]}


def _run(jcls, tcls, models=_dense, cols=None, lr=0.1, optimizer="sgd",
         **kw):
    jm, tm = models()
    cols = _columns() if cols is None else cols
    common = dict(num_workers=WORKERS, communication_window=WINDOW,
                  worker_optimizer=optimizer,
                  optimizer_kwargs={"learning_rate": lr}, batch_size=BATCH,
                  num_epoch=EPOCHS, features_col="x", label_col="y", seed=3,
                  **kw)
    jt, tt = jcls(jm, **common), tcls(tm, device="cpu", **common)
    with pytest.warns(UserWarning) as jwarn:
        jtrained = jt.train(JDataset(cols))
    with pytest.warns(UserWarning) as twarn:
        ttrained = tt.train(TDataset(cols))
    assert [str(w.message) for w in twarn] == [str(w.message) for w in jwarn]
    return (jt, jtrained), (tt, ttrained)


def _assert_params_close(tm, jm, atol):
    for a, b in zip(jax.tree.leaves(params_to_numpy(tm.params)),
                    jax.tree.leaves(jm.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0)


FAMILY = [("DOWNPOUR", {}), ("ADAG", {}),
          ("AEASGD", {"rho": 1.0, "learning_rate": 0.2}),
          ("EAMSGD", {"rho": 1.0, "learning_rate": 0.2, "momentum": 0.9})]


@pytest.mark.parametrize("overlap", [False, True], ids=["blocked", "overlap"])
@pytest.mark.parametrize("name,extra", FAMILY, ids=[f for f, _ in FAMILY])
def test_windowed_family_matches_jax(name, extra, overlap):
    (jt, jm), (tt, tm) = _run(getattr(jw, name), getattr(tw, name),
                              comm_overlap=overlap, **extra)
    assert tt._overlap is jt._overlap is overlap
    jh, th = np.asarray(jt.get_history()), np.asarray(tt.get_history())
    assert th.shape == jh.shape == (WORKERS, EPOCHS, 2, WINDOW)
    np.testing.assert_allclose(th, jh, rtol=1e-5)
    _assert_params_close(tm, jm, 1e-5)
    assert isinstance(tm, tmodel.Sequential)
    assert all(p.device.type == "cpu" for p in tm.parameters())


def test_conv_model_matches_jax():
    cols = _columns(shape=(8, 8, 1))
    (jt, jm), (tt, tm) = _run(jw.ADAG, tw.ADAG, models=_conv, cols=cols,
                              lr=0.05)
    np.testing.assert_allclose(np.asarray(tt.get_history()),
                               np.asarray(jt.get_history()), rtol=1e-4)
    _assert_params_close(tm, jm, 1e-4)


def test_batchnorm_state_rides_the_merge_as_in_jax():
    (jt, jm), (tt, tm) = _run(jw.ADAG, tw.ADAG, models=_batchnorm)
    np.testing.assert_allclose(np.asarray(tt.get_history()),
                               np.asarray(jt.get_history()), rtol=1e-5)
    _assert_params_close(tm, jm, 1e-5)
    mm = tm.params[1]["moving_mean"].numpy()
    assert not np.allclose(mm, 0.0), "moving_mean never updated"


def test_adam_history_matches_jax():
    (jt, _), (tt, _) = _run(jw.ADAG, tw.ADAG, optimizer="adam", lr=1e-2)
    np.testing.assert_allclose(np.asarray(tt.get_history()),
                               np.asarray(jt.get_history()), rtol=1e-3)


@pytest.mark.parametrize("rows,window", [(64, 5), (40, 9)],
                         ids=["drops", "shrinks"])
def test_window_warnings_match_jax(rows, window):
    jm, tm = _dense()
    cols = _columns(rows)
    common = dict(num_workers=WORKERS, communication_window=window,
                  worker_optimizer="sgd", batch_size=BATCH,
                  features_col="x", label_col="y")
    with pytest.warns(UserWarning) as jwarn:
        jw.ADAG(jm, **common).train(JDataset(cols))
    with pytest.warns(UserWarning) as twarn:
        t = tw.ADAG(tm, device="cpu", **common)
        t.train(TDataset(cols))
    msgs = [str(w.message) for w in twarn]
    assert msgs == [str(w.message) for w in jwarn] and msgs
    # ADAG divides by the configured window, not the shrunk one
    assert t.communication_window == window


def test_overlap_follows_the_knob(monkeypatch):
    monkeypatch.setenv("DK_COMM_OVERLAP", "1")
    (jt, jm), (tt, tm) = _run(jw.DOWNPOUR, tw.DOWNPOUR)
    assert tt._overlap is jt._overlap is True
    np.testing.assert_allclose(np.asarray(tt.get_history()),
                               np.asarray(jt.get_history()), rtol=1e-5)


def test_workers_diverge_between_commits():
    """Workers with different rows hold different replicas before the
    first commit (the counterpart of test_algorithm_parity.py's
    test_workers_actually_diverge_between_commits)."""
    _, tm = _dense()
    cols = _columns(4 * 6 * BATCH)
    t = tw.DOWNPOUR(tm, num_workers=4, communication_window=6,
                    worker_optimizer="sgd",
                    optimizer_kwargs={"learning_rate": 0.1},
                    batch_size=BATCH, num_epoch=1, features_col="x",
                    label_col="y", device="cpu")
    t.train(TDataset(cols))
    last = np.asarray(t.get_history())[:, -1, -1, -1]
    assert np.unique(np.round(last, 6)).size == 4


def test_pull_gives_real_copies():
    local = {"w": torch.zeros(3, 2)}
    pulled = tw._pull({"w": torch.ones(2)}, local)
    pulled["w"][0].add_(5.0)
    assert pulled["w"][1].tolist() == [1.0, 1.0]
    assert pulled["w"].stride() == (2, 1)


# -- the worker-stacked step ----------------------------------------------

def _stacked_vs_single(models, tx, xs, ys, skip=False):
    _, tm = models()
    params = [{k: v.detach().clone() for k, v in p.items()}
              for p in tm.params]
    n = xs.shape[0]
    wstep, wopt = tstep.make_worker_step(tm, tcce, tx, skip_nonfinite=skip)
    sstep, sopt = tstep.make_model_step(tm, tcce, tx, skip_nonfinite=skip)
    g = torch.Generator().manual_seed(0)
    carry = (tree_stack(params, n), tree_stack(wopt(params), n), g)
    singles = [(params, sopt(params), g) for _ in range(n)]
    for t in range(xs.shape[1]):
        carry, loss = wstep(carry, (xs[:, t], ys[:, t]))
        for i in range(n):
            singles[i], li = sstep(singles[i], (xs[i, t], ys[i, t]))
            np.testing.assert_allclose(loss[i].numpy(), li.numpy(),
                                       rtol=1e-6, equal_nan=True)
    for i in range(n):
        for a, b in zip(tree_index(carry[0], i), singles[i][0]):
            for k in a:
                np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                           atol=1e-6, rtol=0)
        for a, b in zip(jax.tree.leaves(params_to_numpy(
                tree_index(carry[1], i))), jax.tree.leaves(
                params_to_numpy(singles[i][1]))):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    return carry


def _worker_batches(n=3, steps=4, seed=0):
    rng = np.random.default_rng(seed)
    xs = torch.from_numpy(rng.normal(size=(n, steps, 6, 10)).astype(
        np.float32))
    ys = torch.from_numpy(np.eye(3, dtype=np.float32)[
        rng.integers(0, 3, (n, steps, 6))])
    return xs, ys


@pytest.mark.parametrize("optimizer", ["sgd", "adam", "adagrad_warmup"])
@pytest.mark.parametrize("models", [_dense, _batchnorm],
                         ids=["dense", "batchnorm"])
def test_stacked_step_equals_separate_steps(models, optimizer):
    tx = (toptim.get_optimizer("adagrad", learning_rate=0.05,
                               warmup_steps=3)
          if optimizer == "adagrad_warmup"
          else toptim.get_optimizer(optimizer, learning_rate=0.05))
    xs, ys = _worker_batches()
    carry = _stacked_vs_single(models, tx, xs, ys)
    if optimizer == "adam":
        assert carry[1]["count"].tolist() == [4, 4, 4]


@pytest.mark.parametrize("name", sorted(toptim._OPTIMIZERS) + [
    "sgd_warmup_momentum"])
def test_stacked_update_is_w_separate_updates(name):
    """Every registered optimizer applied to stacked leaves (one count
    per worker) gives each worker's own update, bit for bit."""
    tx = (toptim.get_optimizer("sgd", learning_rate=0.05, momentum=0.9,
                               warmup_steps=2)
          if name == "sgd_warmup_momentum"
          else toptim.get_optimizer(name, learning_rate=0.05))
    rng = np.random.default_rng(1)
    n = 3

    def tree(*lead):
        return [{"kernel": torch.from_numpy(rng.normal(
            size=(*lead, 4, 2)).astype(np.float32)),
            "bias": torch.from_numpy(rng.normal(
                size=(*lead, 2)).astype(np.float32))}]

    params = tree(n)
    stacked = tree_stack(tx.init(tree_index(params, 0)), n)
    singles = [tx.init(tree_index(params, i)) for i in range(n)]
    for _ in range(3):
        grads = tree(n)
        upd, stacked = tx.update(grads, stacked, params)
        for i in range(n):
            ui, singles[i] = tx.update(tree_index(grads, i), singles[i],
                                       tree_index(params, i))
            for a, b in zip(jax.tree.leaves(params_to_numpy(
                    tree_index(upd, i))), jax.tree.leaves(
                    params_to_numpy(ui))):
                np.testing.assert_array_equal(a, b)


def test_stacked_step_skips_only_the_poisoned_worker():
    xs, ys = _worker_batches()
    xs[1, 2, 0, 0] = float("nan")   # worker 1, step 2
    tx = toptim.get_optimizer("adam", learning_rate=0.05)
    carry = _stacked_vs_single(_dense, tx, xs, ys, skip=True)
    # worker 1 skipped one update: its adam count lags the others'
    assert carry[1]["count"].tolist() == [4, 3, 4]
    assert all(torch.isfinite(p).all() for layer in carry[0]
               for p in layer.values())


def test_stacked_step_draws_a_dropout_mask_per_worker():
    tm = tmodel.Sequential([tl.Dense(32), tl.Dropout(0.5)])
    tm.build((4,))
    step, opt_init = tstep.make_worker_step(
        tm, lambda p, y: ((p - y) ** 2).mean(),
        toptim.get_optimizer("sgd"))
    x = torch.ones(3, 2, 4)
    params = tree_stack(tm.params, 3)
    g = torch.Generator().manual_seed(0)
    _, loss = step((params, tree_stack(opt_init(tm.params), 3), g),
                   (x, torch.zeros(3, 2, 32)))
    assert torch.unique(loss).numel() == 3


def test_eamsgd_chain_follows_optax():
    rng = np.random.default_rng(0)
    p = rng.normal(size=(5,)).astype(np.float32)
    grads = [rng.normal(size=(5,)).astype(np.float32) for _ in range(4)]
    otx = optax.chain(optax.sgd(0.1), optax.trace(decay=0.9, nesterov=True))
    ttx = toptim.chain(toptim.get_optimizer("sgd", learning_rate=0.1),
                       toptim.trace(0.9, nesterov=True))
    ostate, tstate = otx.init(p), ttx.init({"w": torch.from_numpy(p)})
    for g in grads:
        ou, ostate = otx.update(g, ostate, p)
        tu, tstate = ttx.update({"w": torch.from_numpy(g)}, tstate)
        np.testing.assert_allclose(tu["w"].numpy(), np.asarray(ou),
                                   rtol=1e-6, atol=1e-7)


# -- what is not ported ----------------------------------------------------

@pytest.mark.parametrize("kw,item", [
    ({"checkpoint_every_windows": 2}, "item 19"),
    ({"checkpoint_dir": "ck"}, "item 19"),
    ({"stream_chunk_windows": 2}, "item 20"),
    ({"max_resident_bytes": 1 << 20}, "item 20"),
    ({"mesh": object()}, "item 12b")], ids=lambda v: str(v)[:24])
def test_unported_kwargs_raise(kw, item):
    _, tm = _dense()
    with pytest.raises(NotImplementedError, match=item):
        tw.ADAG(tm, device="cpu", **kw)


def test_master_kwargs_and_parallelism_factor_are_accepted():
    _, tm = _dense()
    t = tw.DOWNPOUR(tm, master_host="h", master_port=1, num_workers=3,
                    parallelism_factor=4, device="cpu")
    assert t.num_workers == 3 and t.parallelism_factor == 4
    assert t.mesh.shape == {"workers": 3}
    assert t.mesh.device == torch.device("cpu")
