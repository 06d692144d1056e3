"""The port's streaming inference (``data/streaming.py``) —
``tests/test_streaming.py``'s nine cases on the port (``device="cpu"``),
plus its predictions against the JAX ``StreamingPredictor``'s on the
same rows from the same bridged weights (f32, within 1e-5 absolute) and
the ``stream.fetch`` fault retried under the predictor's
``RetryPolicy``."""

import threading

import numpy as np
import pytest

from dist_keras_tpu.data import QueueSource as JQueueSource
from dist_keras_tpu.data import StreamingPredictor as JStreamingPredictor
from dist_keras_tpu.models import mnist_mlp as jmlp
from dist_keras_tpu_torch.data import (
    Dataset,
    KafkaSource,
    ModelPredictor,
    QueueSource,
    SocketSource,
    StreamingPredictor,
    send_rows,
)
from dist_keras_tpu_torch.models import mnist_mlp
from dist_keras_tpu_torch.observability import metrics
from dist_keras_tpu_torch.resilience import faults


def _model(input_dim=8, classes=3):
    return mnist_mlp(hidden=(16,), input_dim=input_dim, num_classes=classes)


def _predictor(model, **kw):
    return StreamingPredictor(model, device="cpu", **kw)


def _rows(n=50, d=8, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def test_queue_stream_matches_batch_predictor():
    model = _model()
    rows = _rows(50)
    src = QueueSource()
    for r in rows:
        src.put(r)
    src.close()

    pred = _predictor(model, batch_size=16, max_latency_s=0.01)
    got_rows, got_preds = [], []
    for x, p in pred.predict_stream(src):
        got_rows.append(x)
        got_preds.append(p)
    got_rows = np.concatenate(got_rows)
    got_preds = np.concatenate(got_preds)

    assert got_rows.shape == rows.shape
    np.testing.assert_allclose(got_rows, rows, atol=1e-6)  # arrival order

    # identical numbers to the batch ModelPredictor on the same rows
    ds = Dataset({"features": rows, "label": np.zeros(len(rows))})
    want = ModelPredictor(model, features_col="features",
                          device="cpu").predict(ds)["prediction"]
    np.testing.assert_allclose(got_preds, np.asarray(want), atol=1e-5)


def test_partial_batch_flush_and_padding():
    """37 rows with batch 16 -> micro-batches 16, 16, 5; the padded tail
    must strip its pad."""
    model = _model()
    rows = _rows(37)
    src = QueueSource()
    for r in rows:
        src.put(r)
    src.close()
    pred = _predictor(model, batch_size=16, max_latency_s=0.01)
    sizes = [len(x) for x, _ in pred.predict_stream(src)]
    assert sizes == [16, 16, 5]


def test_run_sink_and_max_batches():
    model = _model()
    src = QueueSource()
    for r in _rows(40):
        src.put(r)
    src.close()
    pred = _predictor(model, batch_size=8, max_latency_s=0.01)
    seen = []
    total = pred.run(src, lambda x, p: seen.append(len(x)), max_batches=3)
    assert total == 24 and seen == [8, 8, 8]


def test_socket_source_pipeline():
    """Producer thread -> TCP framing -> streaming predictions, in order."""
    model = _model()
    rows = _rows(23)
    src = SocketSource()
    producer = threading.Thread(target=send_rows,
                                args=(src.address, rows), daemon=True)
    producer.start()
    pred = _predictor(model, batch_size=8, max_latency_s=0.05)
    got = np.concatenate([x for x, _ in pred.predict_stream(src)])
    producer.join(timeout=5)
    np.testing.assert_allclose(got, rows, atol=1e-6)


def test_latency_flush_without_close():
    """A trickle (fewer rows than batch_size, source still open) must
    flush on the latency bound, not hang."""
    model = _model()
    src = QueueSource()
    for r in _rows(3):
        src.put(r)
    pred = _predictor(model, batch_size=16, max_latency_s=0.05)
    it = pred.predict_stream(src)
    x, p = next(it)  # must arrive despite no close() and no full batch
    assert len(x) == 3
    src.close()


def test_socket_source_sequential_producers():
    """A producer disconnecting WITHOUT the end-of-stream frame hands off
    to the next producer; only the empty frame closes the source."""
    model = _model()
    rows_a, rows_b = _rows(10, seed=1), _rows(10, seed=2)
    src = SocketSource()

    def produce():
        send_rows(src.address, rows_a, close=False)   # plain disconnect
        send_rows(src.address, rows_b, close=True)    # end-of-stream

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    pred = _predictor(model, batch_size=8, max_latency_s=0.05)
    got = np.concatenate([x for x, _ in pred.predict_stream(src)])
    t.join(timeout=5)
    np.testing.assert_allclose(got, np.concatenate([rows_a, rows_b]),
                               atol=1e-6)


def test_queue_close_idempotent():
    src = QueueSource()
    src.put(np.zeros(4))
    src.close()
    src.close()  # second close must not wedge `closed`
    assert src.get(0.01) is not None
    assert src.get(0.01) is None
    assert src.closed


def test_socket_source_surfaces_producer_errors():
    """A corrupt frame must raise on the consumer side, not truncate the
    stream into a clean end-of-stream."""
    import socket as socketlib
    import struct
    import time

    src = SocketSource()
    with socketlib.create_connection(src.address) as conn:
        bad = b"not json"
        conn.sendall(struct.pack(">I", len(bad)) + bad)
        time.sleep(0.2)  # let the serve thread hit the decode error
    try:
        src.get(0.1)
        raised = False
    except RuntimeError as e:
        raised = True
        assert "producer stream failed" in str(e)
    assert raised


def test_socket_source_consumer_close():
    """close() terminates a stream whose producer died without the
    end-of-stream frame (no hang, no leaked listener)."""
    model = _model()
    rows = _rows(5)
    src = SocketSource()
    send_rows(src.address, rows, close=False)  # producer dies, no EOS
    pred = _predictor(model, batch_size=8, max_latency_s=0.02)
    it = pred.predict_stream(src)
    x, _ = next(it)
    assert len(x) == 5
    src.close()  # consumer ends the stream
    assert list(it) == []


def _bridged(input_dim=8, classes=3):
    jm = jmlp(hidden=(16,), input_dim=input_dim, num_classes=classes)
    tm = mnist_mlp(hidden=(16,), input_dim=input_dim, num_classes=classes)
    tm.set_weights(jm.get_weights())
    return jm, tm


def _drain(pred, rows, source_cls):
    src = source_cls()
    for r in rows:
        src.put(r)
    src.close()
    return [(x, np.asarray(p)) for x, p in pred.predict_stream(src)]


def test_predictions_match_the_jax_streaming_predictor():
    jm, tm = _bridged()
    rows = _rows(45, seed=3)
    got = _drain(_predictor(tm, batch_size=16, max_latency_s=0.01), rows,
                 QueueSource)
    want = _drain(JStreamingPredictor(jm, batch_size=16,
                                      max_latency_s=0.01), rows, JQueueSource)
    assert [len(x) for x, _ in got] == [len(x) for x, _ in want] == [16, 16,
                                                                      13]
    for (gx, gp), (wx, wp) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        assert gp.shape == wp.shape
        np.testing.assert_allclose(gp, wp, atol=1e-5, rtol=0)


def test_fetch_fault_is_retried_and_loses_no_row():
    """An injected ``stream.fetch`` OSError is retried by the predictor's
    RetryPolicy: every row still arrives, in order, and the counters
    count what was predicted."""
    faults.clear()
    metrics.reset()
    try:
        rows = _rows(20, seed=4)
        src = QueueSource()
        for r in rows:
            src.put(r)
        src.close()
        pred = _predictor(_model(), batch_size=8, max_latency_s=0.01)
        spec = faults.inject("stream.fetch", at=3, action="raise",
                             exc=OSError)
        got = np.concatenate([x for x, _ in pred.predict_stream(src)])
        np.testing.assert_array_equal(got, rows)
        assert spec.fired == 1
        counters = metrics.snapshot()["counters"]
        assert counters["stream.rows"] == 20
        assert counters["stream.batches"] == 3
    finally:
        faults.clear()


def test_kafka_source_raises_with_instructions():
    with pytest.raises(ImportError, match="kafka-python"):
        KafkaSource("topic")


def test_streaming_predictor_defaults_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingPredictor(_model())
