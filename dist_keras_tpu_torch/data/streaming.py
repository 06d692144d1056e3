"""Streaming inference — counterpart of ``data/streaming.py``, the
Kafka / Spark-Streaming pipeline of the reference
(``examples/kafka_producer.py`` and its streaming notebook, SURVEY.md
§2.4): rows arrive on a topic, are micro-batched, and a trained model
appends predictions to each micro-batch.

- :func:`pad_rows` / :func:`pack_rows` — the fixed-shape row packing
  ``serving.ServingEngine`` packs its batches with too (numpy only);
- ``StreamSource`` — a pull iterator of feature rows: ``QueueSource``
  (in-process, the local stand-in for a topic), ``SocketSource``
  (length-prefixed JSON rows over TCP, stdlib only; :func:`send_rows`
  is the producer) and ``KafkaSource`` (its import gated: no host of the
  port has a kafka client, and without one it raises with
  instructions);
- ``StreamingPredictor`` — micro-batching with ONE fixed batch shape:
  rows are packed into ``batch_size``-row batches (padded, the pad
  stripped after), and a partial batch is flushed after
  ``max_latency_s`` so a trickling topic still gets timely predictions.
  On the card each micro-batch goes up through one pinned buffer and
  comes back in one fetch, as ``ServingEngine`` does.  Each poll of the
  source runs the ``stream.fetch`` fault point under the predictor's
  ``RetryPolicy``; ``stream.batches`` / ``stream.rows`` count what it
  predicted.

Use ``predict_stream`` as a generator of (rows, predictions) ticks, or
``run(source, sink)`` to push batches at a callback.
"""

from __future__ import annotations

import json
import queue
import socket
import struct
import threading
import time

import numpy as np
import torch

from dist_keras_tpu_torch.data.predictors import Predictor
from dist_keras_tpu_torch.observability import metrics as _metrics
from dist_keras_tpu_torch.resilience.faults import fault_point
from dist_keras_tpu_torch.resilience.retry import RetryPolicy
from dist_keras_tpu_torch.utils.device import resolve_device
from dist_keras_tpu_torch.utils.pytree import tree_map
from dist_keras_tpu_torch.utils.serialization import deserialize_model

_SENTINEL = object()


def pad_rows(x, batch_size):
    """Pad a (n, ...) row block up to ``batch_size`` by replicating the
    last row — the fixed-shape device batch every online path here
    dispatches (the pad is stripped from the output after)."""
    n = len(x)
    pad = batch_size - n
    if pad < 0:
        raise ValueError(f"{n} rows exceed batch_size={batch_size}")
    if pad:
        x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
    return x


def pack_rows(rows, batch_size):
    """Stack a list of feature rows into one fixed-shape padded batch;
    -> ``(x (batch_size, ...), n)`` with ``n`` the real row count."""
    n = len(rows)
    return pad_rows(np.stack(rows), batch_size), n


class StreamSource:
    """Pull interface: ``get(timeout) -> row | None`` (None = nothing yet),
    ``closed`` property ends the stream."""

    def get(self, timeout):
        raise NotImplementedError

    @property
    def closed(self):
        raise NotImplementedError


class QueueSource(StreamSource):
    """In-process source backed by ``queue.Queue`` — the local stand-in
    for a Kafka topic (the reference's kafka_producer pushes rows the same
    way).  Producers call ``put(row)`` / ``close()``."""

    def __init__(self, maxsize=0):
        self._q = queue.Queue(maxsize=maxsize)
        self._closed = False

    def put(self, row):
        if self._closed:
            raise ValueError("source is closed")
        self._q.put(np.asarray(row, dtype=np.float32))

    def close(self):
        if self._closed:  # idempotent: a second sentinel would make
            return        # `closed` (qsize <= 1) unreachable forever
        self._closed = True
        self._q.put(_SENTINEL)

    def get(self, timeout):
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        if item is _SENTINEL:
            self._q.put(_SENTINEL)  # keep draining consumers unblocked
            return None
        return item

    @property
    def closed(self):
        return self._closed and self._q.qsize() <= 1


class SocketSource(StreamSource):
    """Rows as length-prefixed JSON arrays over TCP (4-byte big-endian
    length + utf-8 JSON list — the reference's networking.py framing, with
    JSON instead of pickle for safety).

    Producers connect sequentially (one at a time, like partitioned Kafka
    consumers); a plain disconnect ends that producer and the accept loop
    waits for the next, while an explicit empty frame (length 0) is the
    END-OF-STREAM marker that closes the whole source.  The loop runs on a
    daemon thread feeding an internal queue, so ``get`` has the same
    semantics as QueueSource.
    """

    def __init__(self, host="127.0.0.1", port=0, backlog=4):
        self._inner = QueueSource()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(backlog)
        self.address = self._srv.getsockname()  # (host, bound port)
        self.error = None      # serve-thread failure, re-raised in get()
        self._shutdown = False
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        try:
            end_of_stream = False
            while not end_of_stream:
                try:
                    conn, _ = self._srv.accept()
                except OSError:
                    break  # close() shut the listener down
                with conn:
                    while True:
                        hdr = _recvall(conn, 4)
                        if hdr is None:
                            break  # producer disconnected; accept next
                        (n,) = struct.unpack(">I", hdr)
                        if n == 0:
                            end_of_stream = True
                            break
                        payload = _recvall(conn, n)
                        if payload is None:
                            break
                        self._inner.put(
                            json.loads(payload.decode("utf-8")))
        # dklint: ignore[broad-except] listener thread surfaces the error to the consumer via self.error
        except Exception as e:
            if not self._shutdown:  # surface to the consumer, never a
                self.error = e      # silent clean end-of-stream; but a
                # consumer-initiated close() racing a producer is a clean
                # shutdown, not a stream failure
        finally:
            self._inner.close()
            self._srv.close()

    def close(self):
        """Consumer-side shutdown: stop accepting, end the stream (the
        only way to terminate when a producer died before its
        end-of-stream frame)."""
        self._shutdown = True
        try:
            self._srv.close()  # unblocks accept() with OSError
        except OSError:  # pragma: no cover
            pass
        self._inner.close()

    def get(self, timeout):
        if self.error is not None:
            raise RuntimeError(
                "SocketSource producer stream failed") from self.error
        return self._inner.get(timeout)

    @property
    def closed(self):
        return self._inner.closed


def _recvall(conn, n):
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def send_rows(address, rows, close=True):
    """Producer helper: stream rows to a ``SocketSource`` (the
    kafka_producer.py role).  ``rows``: iterable of 1-D feature arrays."""
    with socket.create_connection(address) as conn:
        for row in rows:
            payload = json.dumps(
                np.asarray(row, dtype=np.float32).tolist()).encode("utf-8")
            conn.sendall(struct.pack(">I", len(payload)) + payload)
        if close:
            conn.sendall(struct.pack(">I", 0))


class KafkaSource(StreamSource):
    """Kafka topic source (gated: no host of the port has a kafka
    client; without one the constructor raises its ImportError)."""

    def __init__(self, topic, value_deserializer=None, **consumer_kw):
        try:
            from kafka import KafkaConsumer  # type: ignore
        except ImportError as e:  # pragma: no cover - no kafka in image
            raise ImportError(
                "KafkaSource needs the kafka-python package, which is not "
                "installed on this host; use SocketSource/QueueSource, or "
                "install kafka-python in your own environment.") from e
        de = value_deserializer or (
            lambda b: np.asarray(json.loads(b.decode("utf-8")), np.float32))
        self._consumer = KafkaConsumer(
            topic, value_deserializer=de, **consumer_kw)
        self._closed = False

    def get(self, timeout):  # pragma: no cover - no kafka in image
        recs = self._consumer.poll(timeout_ms=int(timeout * 1000),
                                   max_records=1)
        for batch in recs.values():
            for rec in batch:
                return rec.value
        return None

    @property
    def closed(self):  # pragma: no cover
        return self._closed

    def close(self):  # pragma: no cover
        self._closed = True
        self._consumer.close()


class StreamingPredictor(Predictor):
    """Micro-batching streaming inference at one fixed batch shape.

    Predictions for rows arriving on a source, in arrival order, as the
    reference's Spark-Streaming pipeline makes them.  ``batch_size``
    rows are packed per forward; a partial batch is flushed after
    ``max_latency_s`` (padded to the fixed shape, the pad stripped from
    the output), so every forward of the stream has one shape.
    ``device`` is the card unless the caller asks for the CPU."""

    def __init__(self, keras_model, batch_size=256, max_latency_s=0.05,
                 poll_timeout_s=0.01, fetch_retry=None, device=None):
        super().__init__(keras_model)  # serialized-model round trip
        self.batch_size = int(batch_size)
        self.max_latency_s = float(max_latency_s)
        self.poll_timeout_s = float(poll_timeout_s)
        self.device = resolve_device(device)
        # transient transport errors (a reconnecting producer surfaces as
        # OSError/ConnectionError from the socket layer) are retried; a
        # clean end of stream or a RuntimeError stream failure is final
        self.fetch_retry = fetch_retry or RetryPolicy(
            attempts=3, backoff=0.02, jitter=0.0, retryable=(OSError,),
            name="stream.fetch")
        # per micro-batch accounting, resolved ONCE: the yield loop must
        # not pay the registry lock per tick
        self._m_batches = _metrics.counter("stream.batches")
        self._m_rows = _metrics.counter("stream.rows")
        self._model = deserialize_model(self.serialized, device=self.device)
        self._params = tree_map(lambda t: t.detach().to(self.device),
                                self._model.params)
        self._host = None   # the pinned upload buffer (on the card)

    @torch.inference_mode()
    def _predict(self, x):
        """One fixed-shape batch -> host predictions: a pinned upload
        and one fetch on the card."""
        host = torch.from_numpy(x)
        if self.device.type == "cuda":
            if self._host is None:
                self._host = torch.empty(host.shape, dtype=host.dtype,
                                         pin_memory=True)
            # the previous batch's upload is done: its fetch waited
            self._host.copy_(host)
            host = self._host
        out = self._model.apply(self._params,
                                host.to(self.device, non_blocking=True))
        return out.cpu().numpy()

    def _fetch(self, source):
        """One retried poll of the source (the ``"stream.fetch"`` fault
        point covers each attempt)."""
        def attempt():
            fault_point("stream.fetch")
            return source.get(self.poll_timeout_s)

        return self.fetch_retry.call(attempt)

    def predict_stream(self, source):
        """-> generator of (rows (n, F), predictions (n, C)) micro-batches."""
        pending = []
        deadline = None
        while True:
            row = self._fetch(source)
            now = time.monotonic()
            if row is not None:
                pending.append(np.asarray(row, dtype=np.float32))
                if deadline is None:
                    deadline = now + self.max_latency_s
            flush = (len(pending) >= self.batch_size
                     or (pending and deadline is not None
                         and now >= deadline)
                     or (pending and source.closed))
            if flush:
                n = min(len(pending), self.batch_size)
                chunk, pending = pending[:n], pending[n:]
                deadline = (time.monotonic() + self.max_latency_s
                            if pending else None)
                x, n = pack_rows(chunk, self.batch_size)
                preds = self._predict(x)[:n]
                self._m_batches.inc()
                self._m_rows.inc(n)
                yield x[:n], preds
            elif not pending and source.closed:
                return

    def run(self, source, sink, max_batches=None):
        """Push mode: ``sink(rows, predictions)`` per micro-batch.
        Returns the number of rows predicted."""
        total = 0
        for i, (rows, preds) in enumerate(self.predict_stream(source)):
            sink(rows, preds)
            total += len(rows)
            if max_batches is not None and i + 1 >= max_batches:
                break
        return total
