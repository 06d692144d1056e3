"""The port's hot reload (``dist_keras_tpu_torch/serving/reload.py``) on
the CPU: the ``CheckpointWatcher`` cases of ``tests/test_serving.py``
(promoted steps reloaded, the background loop across a ``serve.reload``
fault, a corrupt step skipped, the newest verifiable step chosen, a
restore failure that keeps its convictions, no quarantine by a reader)
against the port's ``Checkpointer``; a step the JAX package wrote,
picked up and served equal to the JAX model on the same params; the
watcher's default placement (the whole state restored, its params
onto the engine's own), also over a real ``SingleTrainer`` directory;
and the ``BlueGreenEngine`` drain contract across two cutovers under
continuous load, no request lost."""

import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from dist_keras_tpu.checkpoint import Checkpointer as JaxCheckpointer
from dist_keras_tpu.models import mnist_mlp as jax_mnist_mlp
from dist_keras_tpu_torch.checkpoint import MANIFEST_NAME, Checkpointer
from dist_keras_tpu_torch.models import mnist_mlp
from dist_keras_tpu_torch.resilience import faults
from dist_keras_tpu_torch.resilience.faults import FaultInjected
from dist_keras_tpu_torch.serving import (
    BlueGreenEngine,
    CheckpointWatcher,
    ServingEngine,
)
from dist_keras_tpu_torch.utils.pytree import tree_leaves, tree_map

TOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _model():
    return mnist_mlp(hidden=(8,), input_dim=4, num_classes=3)


def _rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 4)) \
        .astype(np.float32)


def _engine(m):
    return ServingEngine(m, replicas=1, batch_ladder=(1, 4),
                         max_latency_s=0.002, device="cpu")


def _scaled(m, k):
    return {"params": tree_map(lambda a: a.detach() * k, m.params)}


def _apply(m, params, rows):
    with torch.no_grad():
        return m.apply(params, torch.from_numpy(rows)).numpy()


# -- CheckpointWatcher (tests/test_serving.py) --------------------------
def test_checkpoint_watcher_reloads_promoted_steps(tmp_path):
    m = _model()
    eng = _engine(m)
    try:
        base = eng.predict(_rows(4), timeout_s=120)
        ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
        w = CheckpointWatcher(eng, ck, poll_s=0.5)
        assert w.poll_once() is None
        ck.save(1, _scaled(m, 0.25))
        assert w.poll_once() == 1
        assert w.last_step == 1 and w.reloads == 1
        after = eng.predict(_rows(4), timeout_s=120)
        assert not np.allclose(after, base)
        np.testing.assert_allclose(
            after, _apply(m, _scaled(m, 0.25)["params"], _rows(4)),
            atol=TOL)
        assert w.poll_once() is None
        ck.save(0, {"params": m.params})
        assert w.poll_once() is None
    finally:
        eng.close()


def test_checkpoint_watcher_background_loop_and_fault(tmp_path):
    m = _model()
    eng = _engine(m)
    try:
        ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=3)
        seen = []
        w = CheckpointWatcher(eng, ck, poll_s=0.02,
                              on_error=lambda s, e: seen.append(e))
        with w:
            ck.save(1, {"params": m.params})
            deadline = time.monotonic() + 20
            while w.reloads < 1 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert w.reloads == 1
            faults.inject("serve.reload")
            ck.save(2, {"params": m.params})
            deadline = time.monotonic() + 20
            while not seen and time.monotonic() < deadline:
                time.sleep(0.02)
            assert w.errors >= 1
            assert seen and isinstance(seen[0], FaultInjected)
            deadline = time.monotonic() + 20
            while w.last_step != 2 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert w.last_step == 2
        assert eng.predict(_rows(2), timeout_s=120).shape == (2, 3)
    finally:
        eng.close()


def test_checkpoint_watcher_skips_corrupt_step(tmp_path, flip_one_byte):
    m = _model()
    eng = _engine(m)
    try:
        base = eng.predict(_rows(4), timeout_s=120)
        ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=3)
        w = CheckpointWatcher(eng, ck, poll_s=0.5)
        ck.save(1, _scaled(m, 0.25)).wait()
        flip_one_byte(str(tmp_path / "ck" / "step_00000001"))
        assert w.poll_once() is None
        assert w.skipped_corrupt == 1 and w.reloads == 0
        np.testing.assert_allclose(
            eng.predict(_rows(4), timeout_s=120), base)
        assert w.last_step == 1
        ck.save(2, _scaled(m, 0.25))
        assert w.poll_once() == 2
        assert not np.allclose(eng.predict(_rows(4), timeout_s=120), base)
    finally:
        eng.close()


def test_checkpoint_watcher_falls_back_to_newest_verified_step(
        tmp_path, flip_one_byte):
    m = _model()
    eng = _engine(m)
    try:
        base = eng.predict(_rows(4), timeout_s=120)
        ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=5)
        w = CheckpointWatcher(eng, ck, poll_s=0.5, initial_step=0)
        ck.save(1, _scaled(m, 0.25)).wait()
        ck.save(2, _scaled(m, 0.5)).wait()
        flip_one_byte(str(tmp_path / "ck" / "step_00000002"))
        assert w.poll_once() == 1
        assert w.reloads == 1 and w.skipped_corrupt == 1
        assert w.last_step == 2
        assert not np.allclose(eng.predict(_rows(4), timeout_s=120), base)
        assert w.poll_once() is None
        assert w.skipped_corrupt == 1
        ck.save(3, _scaled(m, 0.75))
        assert w.poll_once() == 3
    finally:
        eng.close()


def test_checkpoint_watcher_restore_failure_keeps_convictions(
        tmp_path, monkeypatch, flip_one_byte):
    m = _model()
    eng = _engine(m)
    try:
        ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=5)
        w = CheckpointWatcher(eng, ck, poll_s=0.5, initial_step=0)
        ck.save(1, {"params": m.params}).wait()
        ck.save(2, {"params": m.params}).wait()
        flip_one_byte(str(tmp_path / "ck" / "step_00000002"))
        real_restore = ck.restore
        monkeypatch.setattr(
            ck, "restore",
            lambda *a, **k: (_ for _ in ()).throw(OSError("hiccup")))
        with pytest.raises(OSError):
            w.poll_once()
        assert w.skipped_corrupt == 1
        assert w.last_step == 0
        monkeypatch.setattr(ck, "restore", real_restore)
        assert w.poll_once() == 1
        assert w.skipped_corrupt == 1
        assert w.last_step == 2
    finally:
        eng.close()


def test_checkpoint_watcher_never_quarantines_rot_after_probe(
        tmp_path, monkeypatch):
    m = _model()
    eng = _engine(m)
    try:
        ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=3)
        w = CheckpointWatcher(eng, ck, poll_s=0.5, initial_step=0)
        ck.save(1, {"params": m.params}).wait()
        monkeypatch.setattr(ck, "verify", lambda step=None: "ok")
        mpath = str(tmp_path / "ck" / "step_00000001" / MANIFEST_NAME)
        with open(mpath) as f:
            manifest = json.load(f)
        rel = next(iter(manifest["files"]))
        manifest["files"][rel]["sha256"] = "0" * 64
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        assert w.poll_once() == 1
        assert w.reloads == 1
        assert os.path.isdir(str(tmp_path / "ck" / "step_00000001"))
        assert not os.path.isdir(
            str(tmp_path / "ck" / "step_00000001.corrupt"))
    finally:
        eng.close()


# -- the port's own: templates and JAX-written steps --------------------
def test_watcher_restores_onto_the_engine_params(tmp_path, monkeypatch):
    """No template given: each step is restored whole to the host, as
    the JAX watcher does, and its params are placed onto the engine's
    own (their dtypes and devices); a given template is passed to the
    restore as it is."""
    m = _model()
    eng = _engine(m)
    seen, swapped = [], []
    try:
        ck = Checkpointer(str(tmp_path / "ck"))
        real = ck.restore
        monkeypatch.setattr(ck, "restore", lambda **kw: (
            seen.append(kw["template"]), real(**kw))[1])
        real_set = eng.set_params
        monkeypatch.setattr(eng, "set_params", lambda state, step=None: (
            swapped.append(state), real_set(state, step=step)))
        served = eng.params
        w = CheckpointWatcher(eng, ck, initial_step=0)
        ck.save(1, _scaled(m, 0.5)).wait()
        assert w.poll_once() == 1
        assert seen == [None]
        (placed,) = swapped
        got, want = tree_leaves(placed), tree_leaves(served)
        assert len(got) == len(want) > 0
        assert all(isinstance(x, torch.Tensor) and x.dtype == y.dtype
                   and x.device == y.device for x, y in zip(got, want))
        np.testing.assert_allclose(
            eng.predict(_rows(4), timeout_s=120),
            _apply(m, _scaled(m, 0.5)["params"], _rows(4)), atol=TOL)
        # a given template wins, and is the restore's own
        given = {"params": m.params}
        w2 = CheckpointWatcher(eng, ck, initial_step=0, template=given)
        ck.save(2, _scaled(m, 0.25)).wait()
        assert w2.poll_once() == 2
        assert seen[-1] is given
    finally:
        eng.close()


@pytest.mark.parametrize("color", ["engine", "bluegreen"])
def test_watcher_serves_a_single_trainer_directory(tmp_path, color):
    """A watcher pointed at a real training directory: the port's
    ``SingleTrainer`` saves ``{params, opt_state, rng, t_units}``; each
    promoted step serves its params, equal to the trained model's."""
    from dist_keras_tpu_torch.data.dataset import Dataset
    from dist_keras_tpu_torch.trainers import SingleTrainer

    rng = np.random.default_rng(4)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)]
    ckdir = str(tmp_path / "ck")
    eng = (_engine(_model()) if color == "engine"
           else BlueGreenEngine(lambda: _engine(_model())))
    try:
        w = CheckpointWatcher(eng, Checkpointer(ckdir), initial_step=0)
        t = SingleTrainer(_model(), loss="categorical_crossentropy",
                          worker_optimizer="adam", batch_size=16,
                          num_epoch=2, features_col="x", label_col="y",
                          seed=3, checkpoint_dir=ckdir, device="cpu")
        trained = t.train(Dataset({"x": x, "y": y}))
        state = Checkpointer(ckdir).restore()[1]
        assert sorted(state) == ["opt_state", "params", "rng", "t_units"]
        step = Checkpointer(ckdir).latest_step()
        assert w.poll_once() == step and w.reloads == 1 and w.errors == 0
        rows = _rows(6)
        np.testing.assert_allclose(
            eng.predict(rows, timeout_s=120),
            _apply(trained, trained.params, rows), atol=TOL)
    finally:
        eng.close()


def test_watcher_picks_up_a_step_the_jax_package_wrote(tmp_path):
    jm = jax_mnist_mlp(hidden=(8,), input_dim=4, num_classes=3)
    tm = _model()
    tm.set_weights(jm.get_weights())
    eng = _engine(tm)
    try:
        w = CheckpointWatcher(eng, Checkpointer(str(tmp_path)),
                              initial_step=0)
        scaled = jax.tree.map(lambda a: np.asarray(a) * 0.5, jm.params)
        JaxCheckpointer(str(tmp_path)).save(7, {"params": scaled}).wait()
        assert w.poll_once() == 7
        rows = _rows(5)
        np.testing.assert_allclose(
            eng.predict(rows, timeout_s=120),
            np.asarray(jm.apply(scaled, rows)), atol=TOL)
    finally:
        eng.close()


# -- BlueGreenEngine: two cutovers under load ---------------------------
def test_bluegreen_two_cutovers_under_load_lose_nothing(tmp_path):
    models = []

    def make():
        m = _model()
        models.append(m)
        return ServingEngine(m, replicas=1, batch_ladder=(1, 8),
                             max_latency_s=0.001, max_queue=100000,
                             device="cpu")

    bg = BlueGreenEngine(make)
    ck = Checkpointer(str(tmp_path))
    w = CheckpointWatcher(bg, ck, initial_step=0)
    rows = _rows(32, seed=4)
    futs = []
    stop = threading.Event()

    def submitter():
        i = 0
        while not stop.is_set():
            futs.append(bg.submit(rows[i % len(rows)]))
            i += 1
            time.sleep(0.0005)

    t = threading.Thread(target=submitter, daemon=True)
    t.start()
    try:
        for step, k in ((1, 0.5), (2, 0.25)):
            time.sleep(0.1)
            state = _scaled(models[0], k)
            ck.save(step, state).wait()
            assert w.poll_once() == step
            np.testing.assert_allclose(
                bg.predict(rows[:4], timeout_s=60),
                _apply(models[0], state["params"], rows[:4]), atol=TOL)
        assert bg.cutovers == 2 and bg.stats()["active_engine"] == 0
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    done = [f.result(timeout=60) for f in futs]
    assert len(done) == len(futs) > 100
    assert all(np.shape(d) == (3,) for d in done)
    assert bg.active.stats()["errors"] == bg.standby.stats()["errors"] == 0
    bg.close()
