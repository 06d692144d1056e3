"""The port's ``ServingEngine`` on the CPU, case for case against the JAX
package's serving tests: predictions equal to the JAX ``ServingEngine``
on bridged weights (``mnist_mlp`` and a narrow ``mnist_cnn``, logits to
1e-5), the ladder's shape bound, the latency flush, oversized splits,
typed overload, drain and close, a hot swap with zero dropped requests,
the ``serve.*`` fault points, bad arguments, ragged rows at the door, a
recoverable drain timeout and the ``serve_*`` events."""

import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from dist_keras_tpu.models import mnist_cnn as jax_mnist_cnn
from dist_keras_tpu.models import mnist_mlp as jax_mnist_mlp
from dist_keras_tpu.serving import ServingEngine as JaxServingEngine
from dist_keras_tpu_torch.models import mnist_cnn, mnist_mlp
from dist_keras_tpu_torch.observability import events as obs_events
from dist_keras_tpu_torch.observability import metrics
from dist_keras_tpu_torch.resilience import faults
from dist_keras_tpu_torch.resilience.faults import FaultInjected
from dist_keras_tpu_torch.serving import Overloaded, ServingEngine
from dist_keras_tpu_torch.utils.pytree import tree_map

PARITY_TOL = 1e-5
CNN_SHAPE = (8, 8, 1)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _model():
    return mnist_mlp(hidden=(8,), input_dim=4, num_classes=3)


def _rows(n, seed=0, shape=(4,)):
    return np.random.default_rng(seed).normal(size=(n,) + shape) \
        .astype(np.float32)


def _engine(model=None, **kw):
    kw.setdefault("replicas", 1)
    return ServingEngine(model or _model(), device="cpu", **kw)


def _direct(model, rows):
    with torch.no_grad():
        return model.apply(model.params, torch.from_numpy(rows)).numpy()


@pytest.fixture(scope="module")
def engine_and_model():
    m = _model()
    eng = _engine(m, replicas=2, batch_ladder=(1, 4, 16),
                  max_latency_s=0.005, max_queue=256)
    yield eng, m
    if eng.running:
        eng.close()


# -- parity with the JAX engine on bridged weights ---------------------
@pytest.mark.parametrize("name", ["mnist_mlp", "mnist_cnn"])
def test_predictions_match_the_jax_engine(name):
    if name == "mnist_mlp":
        jm = jax_mnist_mlp(hidden=(16, 8), input_dim=6, num_classes=4)
        tm = mnist_mlp(hidden=(16, 8), input_dim=6, num_classes=4)
        shape = (6,)
    else:
        jm = jax_mnist_cnn(input_shape=CNN_SHAPE)
        tm = mnist_cnn(input_shape=CNN_SHAPE)
        shape = CNN_SHAPE
    tm.set_weights(jm.get_weights())
    rows = _rows(37, seed=3, shape=shape)
    ladder = dict(batch_ladder=(1, 8, 32), max_latency_s=0.002)
    jeng = JaxServingEngine(jm, replicas=2, **ladder)
    teng = ServingEngine(tm, replicas=2, device="cpu", **ladder)
    try:
        want = jeng.predict(rows, timeout_s=120)
        got = teng.predict(rows, timeout_s=120)
    finally:
        jeng.close()
        teng.close()
    assert got.shape == want.shape == (37, 10 if name == "mnist_cnn"
                                       else 4)
    # relative to each row's largest logit
    err = np.abs(got - want).max(axis=1) / np.abs(want).max(axis=1)
    assert err.max() < PARITY_TOL, err.max()
    assert (got.argmax(1) == want.argmax(1)).all()
    st = teng.stats()
    assert st["completed"] == 37 and st["errors"] == 0
    assert st["retrace_count"] <= st["retrace_bound"] == 3


def test_engine_parity_with_direct_apply(engine_and_model):
    eng, m = engine_and_model
    rows = _rows(23)
    preds = eng.predict(rows, timeout_s=120)
    want = _direct(m, rows)
    assert preds.shape == want.shape
    assert np.allclose(preds, want, atol=1e-5)


def test_engine_ladder_bounds_shapes(engine_and_model):
    eng, _ = engine_and_model
    for n in (1, 2, 3, 5, 9, 16, 7, 4):
        eng.predict(_rows(n, seed=n), timeout_s=120)
    st = eng.stats()
    assert st["retrace_count"] <= st["retrace_bound"] == 3
    assert set(st["shapes_dispatched"]) <= {1, 4, 16}


def test_engine_single_row_flushes_within_latency(engine_and_model):
    eng, _ = engine_and_model
    t0 = time.monotonic()
    eng.submit(_rows(1)[0]).result(timeout=120)
    # generous bound: the flush bound is 5 ms, a warm predict ~1 ms
    assert time.monotonic() - t0 < 5.0


def test_engine_oversized_predict_splits_across_batches(engine_and_model):
    eng, m = engine_and_model
    rows = _rows(50)  # > max rung 16: spans multiple dispatches
    preds = eng.predict(rows, timeout_s=120)
    assert np.allclose(preds, _direct(m, rows), atol=1e-5)


def test_engine_overload_typed_rejection():
    m = _model()
    # a 1-deep queue with the predict held shut: the 2nd..Nth submits
    # must reject with the typed Overloaded, not block or drop
    eng = _engine(m, batch_ladder=(1,), max_latency_s=10.0, max_queue=1)
    gate = threading.Event()
    orig = eng._apply

    def slow_apply(p, x):
        gate.wait(30)
        return orig(p, x)

    eng._apply = slow_apply
    try:
        futs = [eng.submit(_rows(1)[0])]
        rejected = 0
        for _ in range(8):
            try:
                futs.append(eng.submit(_rows(1)[0]))
            except Overloaded as e:
                rejected += 1
                assert e.reason == "queue_full"
                assert e.capacity == 1
        assert rejected >= 6
        gate.set()
        for f in futs:
            f.result(timeout=120)  # admitted ones all deliver
    finally:
        gate.set()
        eng.close()
    st = eng.stats()
    assert st["completed"] == len(futs)
    assert st["rejected"] == rejected


def test_engine_drain_delivers_everything_then_rejects():
    eng = _engine(replicas=2, batch_ladder=(1, 8), max_latency_s=0.002,
                  max_queue=512)
    futs = [eng.submit(r) for r in _rows(40)]
    out = eng.drain(timeout_s=120)
    assert all(f.done() for f in futs)
    assert out["delivered"] == 40 and out["errored"] == 0
    with pytest.raises(Overloaded) as ei:
        eng.submit(_rows(1)[0])
    assert ei.value.reason == "draining"
    assert not eng.running


def test_engine_close_without_drain_fails_pending_typed():
    eng = _engine(batch_ladder=(4,), max_latency_s=30.0, max_queue=64)
    # latency bound far out + partial rung: requests sit in the queue
    futs = [eng.submit(r) for r in _rows(2)]
    eng.close(drain=False)
    for f in futs:
        if f.done() and f.exception() is None:
            continue  # raced into the batcher before the cut — delivered
        with pytest.raises(Overloaded):
            f.result(timeout=10)


def test_engine_hot_swap_zero_dropped():
    m = _model()
    eng = _engine(m, replicas=2, batch_ladder=(1, 8), max_latency_s=0.001,
                  max_queue=4096)
    try:
        rows = _rows(16)
        base = eng.predict(rows[:4], timeout_s=120)
        futs = []
        for i in range(300):
            futs.append(eng.submit(rows[i % 16]))
            if i == 150:
                eng.set_params(tree_map(lambda a: a * 0.5, m.params))
        res = [f.result(timeout=120) for f in futs]
        assert len(res) == 300  # zero dropped across the swap
        after = eng.predict(rows[:4], timeout_s=120)
        assert not np.allclose(after, base)
        assert eng.reload_count == 1
        # a full training-state dict with numpy leaves works too
        host = tree_map(lambda t: t.detach().numpy(), m.params)
        eng.set_params({"params": host, "epoch": 3})
        again = eng.predict(rows[:4], timeout_s=120)
        assert np.allclose(again, base, atol=1e-5)
    finally:
        eng.close()


def test_engine_fault_enqueue_and_predict_typed(engine_and_model):
    eng, _ = engine_and_model
    with faults.armed("serve.enqueue"):
        with pytest.raises(FaultInjected):
            eng.submit(_rows(1)[0])
    with faults.armed("serve.predict"):
        fut = eng.submit(_rows(1)[0])
        with pytest.raises(FaultInjected):
            fut.result(timeout=60)  # typed on the future, never a hang
    # the engine survives both
    assert eng.predict(_rows(3), timeout_s=120).shape == (3, 3)


@pytest.mark.parametrize("kw", [dict(batch_ladder=()),
                                dict(batch_ladder=(0, 4)),
                                dict(max_queue=0), dict(replicas=0),
                                dict(devices=[])])
def test_engine_bad_args(kw):
    with pytest.raises(ValueError):
        ServingEngine(_model(), device="cpu", **kw)


def test_engine_runs_on_the_devices_it_is_given():
    eng = ServingEngine(_model(), replicas=3, batch_ladder=(1, 4),
                        devices=[torch.device("cpu")])
    try:
        assert eng.predict(_rows(9), timeout_s=60).shape == (9, 3)
        assert eng.stats()["devices"] == ["cpu"] * 3
        assert eng.resize(1) == 1 and eng.resize(2) == 2
        assert eng.predict(_rows(5), timeout_s=60).shape == (5, 3)
        assert eng.stats()["replicas"] == 2
    finally:
        eng.close()
    with pytest.raises(Overloaded):
        eng.resize(3)


def test_engine_emits_events(tmp_path, monkeypatch):
    monkeypatch.setenv("DK_OBS_DIR", str(tmp_path))
    obs_events.reset()
    try:
        m = _model()
        eng = _engine(m, batch_ladder=(1, 4), max_latency_s=0.002)
        eng.predict(_rows(6), timeout_s=120)
        eng.set_params(m.params)
        eng.drain(timeout_s=60)
    finally:
        obs_events.reset()
        monkeypatch.delenv("DK_OBS_DIR")
    kinds = set()
    with open(tmp_path / "events-rank_0.jsonl") as f:
        for line in f:
            kinds.add(json.loads(line)["kind"])
    for want in ("serve_enqueue", "serve_batch_flush", "serve_predict",
                 "serve_reload", "serve_drain_begin", "serve_drain"):
        assert want in kinds, (want, kinds)
    obs_events.reset()


def test_engine_feeds_the_registry(engine_and_model):
    eng, _ = engine_and_model
    before = metrics.snapshot()["counters"].get("serve.completed", 0)
    eng.predict(_rows(5), timeout_s=60)
    snap = metrics.snapshot()
    assert snap["counters"]["serve.completed"] >= before + 5
    assert snap["counters"]["perf.dispatches"] >= 1
    assert snap["counters"]["perf.h2d_bytes"] > 0


# -- review-pass regressions -------------------------------------------
def test_engine_ragged_rows_rejected_at_the_door():
    m = _model()
    eng = _engine(m, batch_ladder=(4,), max_latency_s=0.05, max_queue=64)
    try:
        f1 = eng.submit(np.zeros(4, np.float32))  # locks the shape
        with pytest.raises(ValueError, match="feature shape"):
            eng.submit(np.zeros(7, np.float32))
        f1.result(timeout=60)  # the well-formed neighbour is untouched
        # an explicit constructor lock rejects even the FIRST bad row
        eng2 = _engine(m, batch_ladder=(1,), feature_shape=(4,))
        with pytest.raises(ValueError, match="feature shape"):
            eng2.submit(np.zeros(5, np.float32))
        eng2.close()
        assert eng.predict(_rows(3), timeout_s=60).shape == (3, 3)
        out = eng.drain(timeout_s=30)  # and still drains (no wedge)
        assert out["duration_s"] < 30
    finally:
        if eng.running:
            eng.close()


def test_engine_drain_timeout_is_recoverable():
    eng = _engine(batch_ladder=(1,), max_latency_s=0.001, max_queue=8)
    gate = threading.Event()
    orig = eng._apply
    eng._apply = lambda p, x: (gate.wait(30), orig(p, x))[1]
    fut = eng.submit(_rows(1)[0])
    with pytest.raises(TimeoutError):
        eng.drain(timeout_s=0.05)  # in-flight batch outlives the budget
    gate.set()
    fut.result(timeout=30)  # still delivered — never dropped
    out = eng.drain(timeout_s=30)  # a later drain CAN finish the job
    assert out["delivered"] == 1
    assert not eng.running  # workers actually stopped this time


def test_jax_params_serve_through_the_bridge():
    # a JAX trainer's params tree (jax arrays) swaps straight in
    jm = jax_mnist_mlp(hidden=(8,), input_dim=4, num_classes=3, seed=5)
    eng = _engine(batch_ladder=(1, 8), max_latency_s=0.002)
    try:
        eng.set_params(jax.tree.map(np.asarray, jm.params))
        rows = _rows(8, seed=9)
        got = eng.predict(rows, timeout_s=60)
        want = np.asarray(jm.apply(jm.params, rows))
        assert np.allclose(got, want, atol=1e-5)
    finally:
        eng.close()
