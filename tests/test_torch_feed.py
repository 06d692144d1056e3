"""The port's streaming input (``data/feed.py`` and the trainers'
``stream_chunk_steps`` / ``stream_chunk_windows`` / ``max_resident_bytes``)
against its resident path and against the JAX package's streamed runs —
``tests/test_streaming_feed.py`` on the port.

- streamed training is BIT-EQUAL to resident training in every trainer
  (the same steps on the same rows in the same order), and within 1e-5
  of the JAX streamed run from the same bridged weights (f32, sgd: loss
  history relative — 1e-6 absolute for a loss near zero, whose f32
  rounding alone is ~1e-8 — and final params absolute);
- at most two chunks are ever on the device (instrumented);
- ``max_resident_bytes`` turns streaming on exactly when the epoch
  exceeds it — on one card every worker's rows count;
- checkpoint / resume composes with streaming bit-exactly;
- the chunk-plan helpers equal the JAX package's over a hypothesis grid.

The card-only parts of the feed (the copy stream, the pinned ring's
slot reuse, ``record_stream``) are in ``test_torch_feed_cuda.py``."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dist_keras_tpu.data.dataset import Dataset as JDataset
from dist_keras_tpu.models import mnist_mlp as jmlp
from dist_keras_tpu.trainers import chunking as jchunk
from dist_keras_tpu.trainers import (
    ADAG as JADAG,
    AEASGD as JAEASGD,
    DOWNPOUR as JDOWNPOUR,
    EAMSGD as JEAMSGD,
    AveragingTrainer as JAveraging,
    DynSGD as JDynSGD,
    EnsembleTrainer as JEnsemble,
    SingleTrainer as JSingle,
)
from dist_keras_tpu_torch.data.dataset import Dataset as TDataset
from dist_keras_tpu_torch.data.feed import ChunkFeed, DevicePut
from dist_keras_tpu_torch.models import mnist_mlp as tmlp
from dist_keras_tpu_torch.trainers import chunking as tchunk
from dist_keras_tpu_torch.trainers import (
    ADAG,
    AEASGD,
    DOWNPOUR,
    EAMSGD,
    AveragingTrainer,
    DynSGD,
    EnsembleTrainer,
    SingleTrainer,
)

ROWS, DIM = 512, 8
COMMON = dict(worker_optimizer="sgd", optimizer_kwargs={"learning_rate": 0.05},
              batch_size=8, num_epoch=2, label_col="label_encoded")
WINDOWED = dict(num_workers=4, communication_window=4)
ELASTIC = dict(rho=1.0, learning_rate=0.2)

# name -> (port class, JAX class, trainer kwargs, streaming kwargs);
# every streaming chunk cuts the epoch somewhere inside it
CASES = {
    "SingleTrainer": (SingleTrainer, JSingle, dict(batch_size=16),
                      dict(stream_chunk_steps=5)),
    "DOWNPOUR": (DOWNPOUR, JDOWNPOUR, WINDOWED,
                 dict(stream_chunk_windows=2)),
    "ADAG": (ADAG, JADAG, WINDOWED, dict(stream_chunk_windows=3)),
    "AEASGD": (AEASGD, JAEASGD, {**WINDOWED, **ELASTIC},
               dict(stream_chunk_windows=2)),
    "EAMSGD": (EAMSGD, JEAMSGD, {**WINDOWED, **ELASTIC, "momentum": 0.9},
               dict(stream_chunk_windows=3)),
    "EAMSGD-overlap": (EAMSGD, JEAMSGD,
                       {**WINDOWED, **ELASTIC, "momentum": 0.9,
                        "comm_overlap": True},
                       dict(stream_chunk_windows=1)),
    "ADAG-overlap": (ADAG, JADAG, {**WINDOWED, "comm_overlap": True},
                     dict(stream_chunk_windows=1)),
    "DynSGD": (DynSGD, JDynSGD, WINDOWED, dict(stream_chunk_windows=2)),
    "AveragingTrainer": (AveragingTrainer, JAveraging, dict(num_workers=4),
                         dict(stream_chunk_steps=6)),
    "EnsembleTrainer": (EnsembleTrainer, JEnsemble,
                        dict(num_models=8, num_workers=4),
                        dict(stream_chunk_steps=3)),
}


def _columns(seed=0):
    """``conftest.py``'s blobs set: 2 gaussian classes, one-hot labels."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, size=ROWS)
    centers = np.stack([np.full(DIM, -1.0), np.full(DIM, 1.0)])
    x = (centers[y] + rng.normal(size=(ROWS, DIM))).astype(np.float32)
    return {"features": x, "label": y,
            "label_encoded": np.eye(2, dtype=np.float32)[y]}


COLS = _columns()


def _models():
    jm = jmlp(hidden=(16,), input_dim=DIM, num_classes=2)
    tm = tmlp(hidden=(16,), input_dim=DIM, num_classes=2)
    tm.set_weights(jm.get_weights())
    return jm, tm


def _port(cls, kw, **extra):
    t = cls(_models()[1], device="cpu", **{**COMMON, **kw, **extra})
    return t, t.train(TDataset(COLS))


def _weights(trained):
    ms = trained if isinstance(trained, list) else [trained]
    return [w for m in ms for w in m.get_weights()]


def _bit_equal(a, b):
    wa, wb = _weights(a), _weights(b)
    assert len(wa) == len(wb)
    for x, y in zip(wa, wb):
        np.testing.assert_array_equal(x, y)


# -- ChunkFeed unit behaviour ---------------------------------------------

def test_chunk_feed_views_and_residency():
    xs = np.arange(4 * 10 * 3).reshape(4, 10, 3).astype(np.float32)
    ys = np.arange(4 * 10).reshape(4, 10).astype(np.float32)
    puts = []

    def put(*views):
        puts.append(tuple(v.copy() for v in views))
        return puts[-1]

    spans = [(0, 4), (4, 4), (8, 2), (0, 4)]  # wraps to the next epoch
    feed = ChunkFeed(spans, put, xs, ys)
    for i in range(len(spans)):
        xv, yv = feed.get(i)
        s, k = spans[i]
        np.testing.assert_array_equal(xv, xs[:, s:s + k])
        np.testing.assert_array_equal(yv, ys[:, s:s + k])
        feed.prefetch(i + 1)
        feed.release(i)
    assert feed.put_count == len(spans)   # each chunk copied once
    assert feed.peak_resident_chunks <= 2  # the double-buffer bound
    assert feed.put_bytes == sum(xs[:, s:s + k].nbytes + ys[:, s:s + k].nbytes
                                 for s, k in spans)
    # prefetch is idempotent: a live chunk is not put again
    feed2 = ChunkFeed(spans, put, xs, ys)
    feed2.prefetch(0)
    feed2.prefetch(0)
    feed2.get(0)
    assert feed2.put_count == 1
    feed2.close()
    assert feed2._arrays == () and not feed2._bufs


@pytest.mark.parametrize("unit_dims", [None, 1, 2])
def test_device_put_lays_chunks_out_as_the_resident_path(unit_dims):
    """On the CPU a put is one copy of the chunk in the resident layout:
    the same rows the resident path's whole-epoch copy holds."""
    rng = np.random.default_rng(0)
    shape = {None: (1, 6, 5, 3), 1: (4, 6, 5, 3), 2: (4, 3, 2, 5, 3)}
    xs = rng.normal(size=shape[unit_dims]).astype(np.float32)
    layout = tchunk._layout(unit_dims)
    put = DevicePut("cpu", layout, max_units=2)
    resident = np.ascontiguousarray(layout(xs))
    for start in (0, 1):
        (chunk,) = put(xs[:, start:start + 2])
        assert isinstance(chunk, torch.Tensor) and chunk.is_contiguous()
        np.testing.assert_array_equal(chunk.numpy(),
                                      resident[start:start + 2])


# -- streamed == resident, bit for bit; == the JAX streamed run ----------

@pytest.mark.parametrize("name", list(CASES))
def test_streamed_equals_resident_and_jax(name):
    cls, jcls, kw, skw = CASES[name]
    t_res, m_res = _port(cls, kw)
    t_str, m_str = _port(cls, kw, **skw)
    assert not t_res._streamed and t_str._streamed
    _bit_equal(m_res, m_str)
    np.testing.assert_array_equal(np.asarray(t_res.get_history()),
                                  np.asarray(t_str.get_history()))
    feed = t_str._last_feed
    assert feed.peak_resident_chunks <= 2
    assert feed.put_count == len(feed) > 2
    assert feed._arrays == ()   # closed at the run's end

    jm, _ = _models()
    jt = jcls(jm, **{**COMMON, **kw, **skw})
    j_trained = jt.train(JDataset(COLS))
    assert jt._streamed
    th, jh = np.asarray(t_str.get_history()), np.asarray(jt.get_history())
    assert th.shape == jh.shape
    np.testing.assert_allclose(th, jh, rtol=1e-5, atol=1e-6)
    for a, b in zip(_weights(m_str), _weights(j_trained)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)


def test_stream_chunk_larger_than_the_epoch():
    """C >= the windows of an epoch is one chunk per epoch: still
    streamed, still bit-equal."""
    _, m_res = _port(ADAG, WINDOWED)
    t, m_str = _port(ADAG, WINDOWED, stream_chunk_windows=10_000)
    assert t._streamed and len(t._last_feed) == COMMON["num_epoch"]
    _bit_equal(m_res, m_str)


# -- the budget switch -----------------------------------------------------

def _epoch_bytes(workers=4, batch=8):
    xs, ys = TDataset(COLS).worker_shards(workers, batch,
                                          label_col="label_encoded")
    return xs.nbytes + ys.nbytes, xs.shape[1]


def test_auto_stream_on_budget():
    """A budget under the epoch's bytes (all four workers' rows: they
    share the card) streams C = budget // (2 x a window's bytes) windows
    a chunk, and two chunks fit the budget; bit-equal to resident."""
    epoch, steps = _epoch_bytes()
    wpe = steps // WINDOWED["communication_window"]
    per_window = epoch // wpe
    budget = 2 * per_window + per_window // 2   # C = 1
    assert epoch > budget
    t, trained = _port(ADAG, WINDOWED, max_resident_bytes=budget)
    assert t._streamed, "the budget should have forced streaming"
    max_chunk = max(k for _, k in t._last_feed._spans)
    assert max_chunk == budget // (2 * per_window) == 1
    assert 2 * per_window * max_chunk <= budget
    assert t._last_feed.peak_resident_chunks <= 2
    _, m_res = _port(ADAG, WINDOWED)
    _bit_equal(m_res, trained)


@pytest.mark.parametrize("name", ["SingleTrainer", "EnsembleTrainer"])
def test_auto_stream_on_budget_step_trainers(name):
    cls, _, kw, _ = CASES[name]
    t_res, m_res = _port(cls, kw)
    t, trained = _port(cls, kw, max_resident_bytes=2048)
    assert t._streamed and not t_res._streamed
    assert t._last_feed.peak_resident_chunks <= 2
    _bit_equal(m_res, trained)


def test_no_stream_under_budget():
    t, _ = _port(ADAG, WINDOWED, max_resident_bytes=1 << 30)
    assert not t._streamed   # fits: the resident path


@pytest.mark.parametrize("cls,name", [
    (ADAG, "stream_chunk_windows"), (DynSGD, "stream_chunk_windows"),
    (SingleTrainer, "stream_chunk_steps"),
    (AveragingTrainer, "stream_chunk_steps"),
    (EnsembleTrainer, "stream_chunk_steps")],
    ids=lambda v: getattr(v, "__name__", v))
@pytest.mark.parametrize("bad", [-2, 0])
def test_invalid_stream_params_raise(cls, name, bad):
    _, tm = _models()
    with pytest.raises(ValueError, match=name):
        cls(tm, device="cpu", **{name: bad})
    with pytest.raises(ValueError, match="max_resident_bytes"):
        cls(tm, device="cpu", max_resident_bytes=bad)


# -- streaming x checkpoints ----------------------------------------------

class _Die(Exception):
    pass


def _bomb(trainer, epoch, logs):
    raise _Die()


def test_stream_resume_of_a_finished_run(tmp_path):
    """Resuming a completed streamed run returns the restored model."""
    kw = dict(stream_chunk_windows=2, checkpoint_dir=str(tmp_path / "ck"),
              checkpoint_every_windows=2)
    _, m_full = _port(ADAG, WINDOWED, **kw)
    t2, m_again = _port(ADAG, WINDOWED, resume=True, **kw)
    _bit_equal(m_full, m_again)
    assert len(t2._last_feed) == 0 and t2.get_history() == []


def test_stream_feed_closed_after_a_crash():
    """A raising callback must not leave the feed pinning host arrays."""
    t = ADAG(_models()[1], device="cpu", stream_chunk_windows=2,
             callbacks=[_bomb], **COMMON, **WINDOWED)
    with pytest.raises(_Die):
        t.train(TDataset(COLS))
    assert t._last_feed._arrays == () and not t._last_feed._bufs


@pytest.mark.parametrize("name", ["SingleTrainer", "ADAG", "DynSGD"])
def test_stream_mid_epoch_resume_bit_exact(tmp_path, name):
    """A streamed run that dies after its first mid-epoch checkpoint,
    resumed streamed, ends bit-equal to the uninterrupted streamed run
    (the chunk grid is epoch-aligned, so the resumed plan reuses it)."""
    cls, _, kw, skw = CASES[name]
    if cls is SingleTrainer:
        ck = dict(checkpoint_every=1)
        extra = dict(num_epoch=3)
    else:
        ck = dict(checkpoint_every_windows=3)   # not an epoch divisor
        extra = {}
    _, m_full = _port(cls, kw, **skw, **extra)
    d = str(tmp_path / "ck")
    calls = []

    def die_once(trainer, epoch, logs):
        calls.append(epoch)
        raise _Die()

    t = cls(_models()[1], device="cpu", checkpoint_dir=d,
            callbacks=[die_once], **{**COMMON, **kw, **skw, **ck, **extra})
    with pytest.raises(_Die):
        t.train(TDataset(COLS))
    assert calls == [1]
    assert t._checkpointer_or_none().latest_step() is not None
    t2, m_resumed = _port(cls, kw, checkpoint_dir=d, resume=True,
                          **skw, **ck, **extra)
    assert t2._streamed
    _bit_equal(m_full, m_resumed)


# -- the plan helpers against the JAX package's ---------------------------

@settings(max_examples=200, deadline=None)
@given(per_epoch=st.integers(1, 12), epochs=st.integers(1, 4),
       start_frac=st.floats(0, 1), epoch_bounds=st.booleans(),
       cadence=st.one_of(st.none(), st.integers(1, 15)),
       data_chunk=st.one_of(st.none(), st.integers(1, 15)),
       budget=st.one_of(st.none(), st.integers(1, 5000)),
       requested=st.one_of(st.none(), st.integers(1, 20)),
       epoch_bytes=st.integers(1, 8000))
def test_plan_helpers_equal_jax(per_epoch, epochs, start_frac, epoch_bounds,
                                cadence, data_chunk, budget, requested,
                                epoch_bytes):
    total = per_epoch * epochs
    start = int(start_frac * total)
    kw = dict(epoch_bounds=epoch_bounds, cadence=cadence,
              data_chunk=data_chunk)
    plan = tchunk.chunk_plan(start, total, per_epoch, **kw)
    assert plan == jchunk.chunk_plan(start, total, per_epoch, **kw)
    assert sum(plan) == total - start
    spans = tchunk.epoch_spans(plan, start, per_epoch)
    assert spans == jchunk.epoch_spans(plan, start, per_epoch)
    if data_chunk:
        # every streamed chunk is one slice inside one epoch
        assert all(o + k <= per_epoch and k <= data_chunk for o, k in spans)
    assert (tchunk.resolve_stream_chunk(requested, budget, epoch_bytes,
                                        per_epoch)
            == jchunk.resolve_stream_chunk(requested, budget, epoch_bytes,
                                           per_epoch))
