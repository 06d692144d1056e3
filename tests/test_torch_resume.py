"""Checkpoints, resume and preemption in the port's trainers, port against
port, mirroring ``tests/test_checkpoint_resume.py`` (CPU, small sizes).

Every resumed run is held BIT-EQUAL to the uninterrupted one: on the
CPU the port's eager steps are deterministic, and the checkpoint carries
the whole training state — params, optimizer state, worker replicas,
staleness counters and the ``torch.Generator`` state, so a model with
dropout draws the same masks after the resume as without it."""

import os
import shutil
import signal

import numpy as np
import pytest
import torch

from dist_keras_tpu_torch import trainers as tt
from dist_keras_tpu_torch.checkpoint import (
    CheckpointCorrupt,
    CheckpointFormatError,
    Checkpointer,
)
from dist_keras_tpu_torch.data.dataset import Dataset
from dist_keras_tpu_torch.models import layers as tl
from dist_keras_tpu_torch.models import model as tmodel
from dist_keras_tpu_torch.resilience import preemption
from dist_keras_tpu_torch.resilience.preemption import Preempted

ROWS, FEATURES, CLASSES = 128, 12, 5
KW = dict(loss="categorical_crossentropy", worker_optimizer="adam",
          batch_size=16, features_col="x", label_col="y", seed=3,
          device="cpu")

TRAINER_CONFIGS = [
    ("SingleTrainer", {}),
    ("ADAG", {"num_workers": 4, "communication_window": 2}),
    ("DynSGD", {"num_workers": 4, "communication_window": 3}),
    ("AveragingTrainer", {"num_workers": 4}),
]


def _data(rows=ROWS):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(rows, FEATURES)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, rows)]
    return Dataset({"x": x, "y": y})


def _model(dropout=0.0):
    layers = [tl.Dense(16, activation="relu")]
    if dropout:
        layers.append(tl.Dropout(dropout))
    m = tmodel.Sequential(layers + [tl.Dense(CLASSES)])
    m.build((FEATURES,), seed=0)
    return m


def _bit_equal(a, b):
    for wa, wb in zip(a.get_weights(), b.get_weights()):
        np.testing.assert_array_equal(wa, wb)


def _tail_equal(resumed, control):
    """The resumed run's losses are the uninterrupted run's last ones."""
    r = np.asarray(resumed.get_history())
    c = np.asarray(control.get_history())
    r, c = r.reshape(r.shape[0], -1) if r.ndim > 1 else r, (
        c.reshape(c.shape[0], -1) if c.ndim > 1 else c)
    np.testing.assert_array_equal(r, c[..., c.shape[-1] - r.shape[-1]:])


@pytest.fixture(autouse=True)
def _clean_preemption():
    preemption.clear()
    yield
    preemption.clear()


@pytest.mark.parametrize("name,extra", TRAINER_CONFIGS,
                         ids=[n for n, _ in TRAINER_CONFIGS])
def test_preemption_resume_matches_uninterrupted(tmp_path, name, extra):
    """Train 2 epochs + checkpoint, 'die', resume a fresh trainer to 4
    epochs: the result is bit-equal to an uninterrupted 4-epoch run."""
    cls = getattr(tt, name)
    ds = _data()
    ckdir = str(tmp_path / "ck")
    cls(_model(), num_epoch=2, checkpoint_dir=ckdir, checkpoint_every=1,
        **KW, **extra).train(ds)
    t2 = cls(_model(), num_epoch=4, checkpoint_dir=ckdir,
             checkpoint_every=1, resume=True, **KW, **extra)
    resumed = t2.train(ds)
    t3 = cls(_model(), num_epoch=4, **KW, **extra)
    control = t3.train(ds)
    _bit_equal(resumed, control)
    _tail_equal(t2, t3)
    # the resumed run executed epochs 3..4 only
    assert [m["epoch"] for m in t2.metrics] == [3, 4]


def test_dropout_resume_holds_the_generator_state(tmp_path, monkeypatch):
    """A model with dropout resumes bit-equal only because the
    checkpoint carries the generator's state: with the restored ``rng``
    leaf swapped for a freshly seeded generator's, the resumed run draws
    other masks and parts from the uninterrupted one."""
    ds = _data()
    kw = dict(KW, num_workers=4, communication_window=2)

    def resumed_run(ckdir):
        tt.ADAG(_model(0.5), num_epoch=2, checkpoint_dir=ckdir,
                checkpoint_every=1, **kw).train(ds)
        return tt.ADAG(_model(0.5), num_epoch=4, checkpoint_dir=ckdir,
                       resume=True, **kw).train(ds)

    control = tt.ADAG(_model(0.5), num_epoch=4, **kw).train(ds)
    _bit_equal(resumed_run(str(tmp_path / "a")), control)
    restored = tt.Trainer._restored

    def forget_rng(self, *args):
        state = restored(self, *args)
        state["rng"] = torch.Generator().manual_seed(self.seed).get_state()
        return state

    monkeypatch.setattr(tt.Trainer, "_restored", forget_rng)
    forgot = resumed_run(str(tmp_path / "b"))
    assert any(not np.array_equal(a, b) for a, b in zip(
        forgot.get_weights(), control.get_weights()))


def test_window_granular_mid_epoch_resume(tmp_path):
    """checkpoint_every_windows cuts INSIDE an epoch: die right after the
    first, mid-epoch save, resume, and the result is bit-equal; the
    resumed run's history stays flat (workers, windows, W)."""
    ds = _data(512)   # 4 workers x batch 16: 4 windows of 2 per epoch
    kw = dict(KW, num_workers=4, communication_window=2)
    ckdir = str(tmp_path / "ck")

    class Die(RuntimeError):
        pass

    def poison(trainer, epoch, logs):
        raise Die   # at epoch 1's end, after the save at window 3

    t1 = tt.ADAG(_model(), num_epoch=3, checkpoint_dir=ckdir,
                 checkpoint_every_windows=3, callbacks=[poison], **kw)
    with pytest.raises(Die):
        t1.train(ds)
    assert t1._checkpointer.all_steps() == [3]
    t2 = tt.ADAG(_model(), num_epoch=3, checkpoint_dir=ckdir,
                 checkpoint_every_windows=3, resume=True, **kw)
    resumed = t2.train(ds)
    t3 = tt.ADAG(_model(), num_epoch=3, **kw)
    _bit_equal(resumed, t3.train(ds))
    assert np.asarray(t2.get_history()).shape == (4, 9, 2)  # flat
    _tail_equal(t2, t3)


def test_resume_noop_when_target_reached(tmp_path):
    ds = _data()
    ckdir = str(tmp_path / "ck")
    done = tt.SingleTrainer(_model(), num_epoch=3, checkpoint_dir=ckdir,
                            **KW).train(ds)
    t2 = tt.SingleTrainer(_model(), num_epoch=3, checkpoint_dir=ckdir,
                          resume=True, **KW)
    _bit_equal(done, t2.train(ds))
    assert t2.get_history() == [] and t2.metrics == []


def test_resume_cadence_from_nonmultiple_epoch(tmp_path):
    """Saves land on the cadence grid counted from the resume point (in
    steps), and the final boundary's save always lands."""
    ds = _data()
    spb = ROWS // 16
    ckdir = str(tmp_path / "ck")
    t1 = tt.SingleTrainer(_model(), num_epoch=7, checkpoint_dir=ckdir,
                          checkpoint_every=3, max_checkpoints=10, **KW)
    t1.train(ds)
    steps1 = t1._checkpointer.all_steps()
    assert steps1 and set(steps1) <= {3 * spb, 6 * spb, 7 * spb}
    assert steps1[-1] == 7 * spb
    t2 = tt.SingleTrainer(_model(), num_epoch=13, checkpoint_dir=ckdir,
                          checkpoint_every=3, max_checkpoints=10,
                          resume=True, **KW)
    t2.train(ds)
    steps2 = [s for s in t2._checkpointer.all_steps() if s > 7 * spb]
    assert steps2 and set(steps2) <= {10 * spb, 13 * spb}
    assert steps2[-1] == 13 * spb


@pytest.mark.parametrize("cls,kw", [
    (tt.SingleTrainer, {"checkpoint_every": 1}),
    (tt.ADAG, {"checkpoint_every_windows": 2})],
    ids=["checkpoint_every", "checkpoint_every_windows"])
def test_cadence_requires_checkpoint_dir(cls, kw):
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        cls(_model(), **KW, **kw)


def test_checkpoint_dir_defaults_to_every_epoch():
    t = tt.SingleTrainer(_model(), checkpoint_dir="unused", **KW)
    assert t.checkpoint_every == 1 and t.max_checkpoints == 3
    assert t.resume is False and tt.SingleTrainer(
        _model(), resume=0, **KW).resume == 0


def test_ensemble_checkpoint_resume(tmp_path):
    ds = _data()
    ckdir = str(tmp_path / "ck")
    tt.EnsembleTrainer(_model(0.5), num_models=4, num_epoch=2,
                       checkpoint_dir=ckdir, **KW).train(ds)
    t2 = tt.EnsembleTrainer(_model(0.5), num_models=4, num_epoch=4,
                            checkpoint_dir=ckdir, resume=True, **KW)
    resumed = t2.train(ds)
    control = tt.EnsembleTrainer(_model(0.5), num_models=4, num_epoch=4,
                                 **KW).train(ds)
    for a, b in zip(resumed, control):
        _bit_equal(a, b)


def test_explicit_resume_step_and_verified_fallback(tmp_path,
                                                    flip_one_byte):
    """resume=<int> continues from exactly that step; a corrupt latest
    step is quarantined and the run resumes from the previous one, the
    same lineage bit for bit."""
    ds = _data()
    ckdir = str(tmp_path / "ck")
    t1 = tt.SingleTrainer(_model(), num_epoch=4, checkpoint_dir=ckdir,
                          checkpoint_every=2, max_checkpoints=5, **KW)
    t1.train(ds)
    lo, hi = t1._checkpointer.all_steps()
    ck2 = str(tmp_path / "ck2")
    shutil.copytree(ckdir, ck2)
    t2 = tt.SingleTrainer(_model(), num_epoch=6, checkpoint_dir=ck2,
                          checkpoint_every=2, max_checkpoints=5,
                          resume=lo, **KW)
    resumed = t2.train(ds)
    assert t2.metrics[0]["epoch"] == 4
    ck3 = str(tmp_path / "ck3")
    shutil.copytree(ckdir, ck3)
    flip_one_byte(os.path.join(ck3, f"step_{hi:08d}"))
    t3 = tt.SingleTrainer(_model(), num_epoch=6, checkpoint_dir=ck3,
                          checkpoint_every=2, max_checkpoints=5,
                          resume=True, **KW)
    healed = t3.train(ds)
    assert t3.metrics[0]["epoch"] == 4
    assert os.path.isdir(os.path.join(ck3, f"step_{hi:08d}.corrupt"))
    _bit_equal(healed, resumed)


def test_resume_restore_errors_stay_typed(tmp_path, flip_one_byte,
                                          monkeypatch):
    """CheckpointCorrupt and transient OSErrors propagate as themselves
    (the supervisor retries them); a structure the trainer cannot use
    is an actionable ValueError."""
    ds = _data()
    ckdir = str(tmp_path / "ck")
    Checkpointer(ckdir).save(1, {"w": np.arange(8.0)}).wait()
    flip_one_byte(os.path.join(ckdir, "step_00000001"))
    with pytest.raises(CheckpointCorrupt):
        tt.SingleTrainer(_model(), num_epoch=1, checkpoint_dir=ckdir,
                         resume=True, **KW).train(ds)

    ck2 = str(tmp_path / "ck2")
    Checkpointer(ck2).save(1, {"w": np.arange(8.0)}).wait()
    with pytest.raises(ValueError, match="t_units"):
        tt.SingleTrainer(_model(), num_epoch=1, checkpoint_dir=ck2,
                         resume=True, **KW).train(ds)

    def _disk_died(self, step=None, template=None, verify=None,
                   elastic=None):
        raise OSError("I/O error reading payload")

    monkeypatch.setattr(Checkpointer, "restore", _disk_died)
    with pytest.raises(OSError, match="I/O error"):
        tt.SingleTrainer(_model(), num_epoch=1, checkpoint_dir=ck2,
                         resume=True, **KW).train(ds)


def test_overlap_checkpoint_refuses_a_blocked_resume(tmp_path):
    """A checkpoint written under comm_overlap carries the in-flight
    'pending' commit; resuming it with the overlap off is refused, with
    it on the run resumes bit-equal."""
    ds = _data()
    kw = dict(KW, num_workers=4, communication_window=2, comm_overlap=True)
    ckdir = str(tmp_path / "ck")
    tt.DOWNPOUR(_model(), num_epoch=2, checkpoint_dir=ckdir, **kw).train(ds)
    blocked = dict(kw, comm_overlap=False)
    with pytest.raises(ValueError, match="pending"):
        tt.DOWNPOUR(_model(), num_epoch=4, checkpoint_dir=ckdir,
                    resume=True, **blocked).train(ds)
    resumed = tt.DOWNPOUR(_model(), num_epoch=4, checkpoint_dir=ckdir,
                          resume=True, **kw).train(ds)
    _bit_equal(resumed, tt.DOWNPOUR(_model(), num_epoch=4, **kw).train(ds))


def test_sigterm_from_a_callback_preempts_with_a_verified_step(tmp_path):
    """preemption.request(SIGTERM) at epoch 2 -> the next boundary saves,
    verifies and raises Preempted (exit code 143) naming the step; the
    resumed run finishes bit-equal to the uninterrupted one."""
    ds = _data()
    spb = ROWS // 16
    ckdir = str(tmp_path / "ck")

    def sigterm_at_2(trainer, epoch, logs):
        if epoch == 2:
            preemption.request(signal.SIGTERM)

    t1 = tt.SingleTrainer(_model(0.5), num_epoch=5, checkpoint_dir=ckdir,
                          checkpoint_every=4, handle_preemption=True,
                          callbacks=[sigterm_at_2], **KW)
    with pytest.raises(Preempted) as info:
        t1.train(ds)
    assert info.value.code == 143
    assert info.value.saved_step == 2 * spb
    assert Checkpointer(ckdir).verify(2 * spb) == "ok"
    preemption.clear()
    t2 = tt.SingleTrainer(_model(0.5), num_epoch=5, checkpoint_dir=ckdir,
                          resume=True, **KW)
    control = tt.SingleTrainer(_model(0.5), num_epoch=5, **KW)
    _bit_equal(t2.train(ds), control.train(ds))


def test_a_reference_training_checkpoint_is_refused_typed(tmp_path):
    """A checkpoint whose rng leaf is a JAX PRNG key was written by the
    reference: resume refuses it, naming the carry-over route."""
    import jax

    from dist_keras_tpu.checkpoint import Checkpointer as JCheckpointer

    ds = _data()
    m = _model()
    ckdir = str(tmp_path / "ck")
    params = [{k: v.detach().numpy() for k, v in p.items()}
              for p in m.params]
    JCheckpointer(ckdir).save(16, {
        "params": params, "opt_state": {}, "t_units": np.zeros((), np.int32),
        "rng": np.asarray(jax.random.PRNGKey(3))}).wait()
    with pytest.raises(CheckpointFormatError, match="opt_state_from_optax"):
        tt.SingleTrainer(m, num_epoch=2, checkpoint_dir=ckdir, resume=True,
                         **KW).train(ds)


@pytest.mark.parametrize("cls", [tt.SingleTrainer, tt.ADAG],
                         ids=lambda c: c.__name__)
def test_coordination_world_above_one_needs_something_to_coordinate(
        monkeypatch, tmp_path, cls):
    """DK_COORD_WORLD > 1 is taken with DK_COORD_DIR (the ranks vote
    through the FileCoordinator; the two-process runs are in
    test_torch_multiprocess.py); with neither that nor a process group
    the trainer would train alone, which raises."""
    from dist_keras_tpu_torch.resilience import coordination

    monkeypatch.setenv("DK_COORD_WORLD", "2")
    monkeypatch.setenv("DK_COORD_RANK", "1")
    monkeypatch.delenv("DK_COORD_DIR", raising=False)
    with pytest.raises(ValueError, match="train alone"):
        cls(_model(), **KW)
    monkeypatch.setenv("DK_COORD_DIR", str(tmp_path / "coord"))
    t = cls(_model(), **KW)
    assert (coordination.rank(), coordination.world()) == (1, 2)
    if cls is tt.ADAG:
        # no process group: every rank stacks all of its workers
        assert (t.mesh.world, t.mesh.num_local) == (1, t.num_workers)


def test_a_worker_split_checkpoint_refuses_another_world(monkeypatch,
                                                         tmp_path):
    """A step written by a world of two (each rank's payload holds only
    its own workers) resumed by one process raises typed WorldMismatch
    instead of restoring another rank's workers."""
    from dist_keras_tpu_torch.checkpoint import Checkpointer

    ckdir = str(tmp_path / "ck")
    for rank in (1, 0):   # non-leader first: the leader promotes
        Checkpointer(ckdir, rank=rank, world=2).save(
            4, {"center": np.zeros(2, np.float32)}).wait()
    assert Checkpointer(ckdir, rank=0, world=2).all_steps() == [4]
    t = tt.ADAG(_model(), num_workers=2, checkpoint_dir=ckdir, resume=True,
                **KW)
    with pytest.raises(tt.WorldMismatch, match="written by 2"):
        t.train(_data())
