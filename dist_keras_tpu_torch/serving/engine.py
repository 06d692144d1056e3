"""Online serving engine — dynamic batching over fixed-shape replicas.

Counterpart of ``serving/engine.py``: concurrent callers ``submit()``
individual feature rows, a dynamic batcher packs them into device
batches, and N model replicas execute them in parallel.

Design points (each the reference's):

- **Fixed-shape batch ladder.** Requests are packed into the smallest
  rung of ``batch_ladder`` that fits (padded, pad stripped from the
  output — ``data.streaming.pack_rows``), so the number of distinct
  batch shapes ever dispatched is bounded by the ladder size, and
  ragged arrival patterns can never grow it.  :meth:`ServingEngine.stats`
  reports it as ``retrace_count`` against ``retrace_bound``.
- **Latency-bounded flushes.** A partial batch is flushed after
  ``max_latency_s`` even when the rung is not full.
- **Admission control / backpressure.** Admission is bounded on the
  count of admitted-but-unresolved requests (``max_queue`` — queued AND
  batched in flight); past the bound a submit rejects with a typed
  :class:`Overloaded` (the HTTP front end answers 503).  The same typed
  rejection covers a draining/stopped engine.
- **Hot reload.** :meth:`set_params` swaps each replica's parameters
  BETWEEN batches (a replica reads its params reference once per
  batch), so a new checkpoint rolls in with zero dropped requests.
- **Graceful drain.** :meth:`drain` stops admission, flushes every
  pending request at once, waits for every in-flight batch, then stops
  the worker threads.  Nothing admitted is ever dropped.
- **Typed errors, never hangs.** A failing predict (including the
  ``"serve.predict"`` fault point) sets the EXCEPTION on every future
  in that batch; ``"serve.enqueue"`` covers admission the same way.

PyTorch idiom: the model is a port ``Sequential`` deserialized from
``serialize_model`` (the reference's contract); each replica holds the
params on its device and runs on its own ``torch.cuda.Stream`` (replicas
beyond the card count share cards round-robin), under
``torch.inference_mode()``, in f32.  A batch goes to the card through
pinned host memory, and its predictions come back in one fetch, which
waits on the replica's stream only — never on the whole device.

Observability: ``serve_enqueue`` / ``serve_batch_flush`` /
``serve_predict`` / ``serve_reload`` / ``serve_drain`` events, the
``serve.*`` registry metrics, and with tracing on the batcher and
replica threads stamp ``serve.queue_wait`` / ``serve.batch`` /
``serve.exec`` spans into each request's trace.
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from dist_keras_tpu_torch.data.streaming import pack_rows
from dist_keras_tpu_torch.observability import events, metrics, perf, spans
from dist_keras_tpu_torch.resilience.faults import fault_point
from dist_keras_tpu_torch.utils.bridge import params_from_jax
from dist_keras_tpu_torch.utils.device import resolve_device
from dist_keras_tpu_torch.utils.serialization import (
    deserialize_model,
    serialize_model,
)


class Overloaded(RuntimeError):
    """Typed admission rejection — queue full, draining, or stopped.

    ``reason`` is one of ``"queue_full"`` / ``"draining"`` /
    ``"stopped"`` — or, from the decode engine, ``"kv_exhausted"`` (its
    door reserves worst-case KV pages per sequence),
    ``"deadline_infeasible"`` and ``"shed_batch"``; ``pending`` /
    ``capacity`` let a front end answer 503 with real numbers.  Requests
    already admitted are unaffected: rejection is strictly at the door,
    never a drop.
    """

    def __init__(self, reason, pending=None, capacity=None):
        self.reason = str(reason)
        self.pending = pending
        self.capacity = capacity
        super().__init__(
            f"serving engine rejected the request ({self.reason}"
            + (f"; pending={pending}/{capacity}" if pending is not None
               else "") + ")")


# t: monotonic admission instant (queue-wait math); tw: wall-clock twin
# (retro span timestamps); ctx: the submitter's captured trace context
_Request = collections.namedtuple("_Request",
                                  ("x", "future", "t", "tw", "ctx"))


def serving_devices(device=None, devices=None):
    """The devices an engine's replicas go on: ``devices`` when given
    (each checked like ``device``), else every visible card for the
    default ``device=None``, else ``[device]``."""
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("devices= must name at least one device")
        return devs
    dev = resolve_device(device)
    if device is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def stream_for(device):
    """A fresh stream of its own on a card, None on the CPU."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def on_stream(stream):
    """Context running the calling thread's device work on ``stream``
    (a no-op for the CPU's None)."""
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def put_params(params, devices):
    """-> {device: params tree on that device}, one copy per distinct
    device; each copy is complete before it is returned (its copy
    stream is synchronized), so a replica on another stream may read it
    at once."""
    out = {}
    for dev in devices:
        if dev in out:
            continue
        out[dev] = params_from_jax(params, dev)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
    return out


class _Replica:
    """One model replica: its device, its stream, its params (the
    hot-reload swap point — a reference assignment, read once per
    batch) and its inbox."""

    def __init__(self, index, device, params):
        self.index = index
        self.device = device
        self.stream = stream_for(device)
        self.params = params
        self.inbox = queue.Queue()
        self.batches = 0


class ServingEngine:
    """Owns the request queue, the dynamic batcher, and N replicas.

    Args:
      keras_model: a port ``Sequential`` (anything
        ``utils.serialization`` round-trips) — the same contract as
        ``data.predictors.Predictor``.
      replicas: number of model replicas.  Default: one per device.
        Replicas beyond the device count share devices round-robin,
        each on its own stream.
      batch_ladder: ascending fixed batch shapes; the largest rung is
        the max batch per dispatch.
      max_latency_s: flush bound for partial batches.
      max_queue: admission bound on admitted-but-unresolved requests
        (queued + batched in flight).
      devices: explicit ``torch.device`` list.
      feature_shape: expected per-row shape, enforced AT THE DOOR
        (``ValueError``, the front end's 400).  Default None locks to
        the first admitted row's shape.
      device: where the replicas run when ``devices`` is not given: the
        default ``None`` is every visible card; ``"cpu"`` runs on the
        CPU.
    """

    def __init__(self, keras_model, replicas=None,
                 batch_ladder=(1, 8, 32, 128), max_latency_s=0.01,
                 max_queue=1024, devices=None, feature_shape=None,
                 device=None):
        self.serialized = serialize_model(keras_model)
        ladder = sorted(set(int(b) for b in batch_ladder))
        if not ladder or ladder[0] < 1:
            raise ValueError(f"batch_ladder {batch_ladder!r} must hold "
                             "positive ints")
        self.batch_ladder = tuple(ladder)
        self.max_batch = ladder[-1]
        self.max_latency_s = float(max_latency_s)
        self.max_queue = int(max_queue)
        if self.max_queue < 1:
            raise ValueError(f"max_queue={max_queue} must be >= 1")

        self.feature_shape = (None if feature_shape is None
                              else tuple(feature_shape))
        self._model = deserialize_model(self.serialized)
        self._host_params = self._model.params
        self._devices = serving_devices(device, devices)
        n = int(replicas) if replicas is not None else len(self._devices)
        if n < 1:
            raise ValueError(f"replicas={replicas} must be >= 1")
        self._next_replica_index = n
        placed = put_params(self._host_params, self._devices)
        self._replicas = [self._make_replica(i, placed) for i in range(n)]

        self._cond = threading.Condition()
        self._pending = collections.deque()
        self._inflight = 0          # batches dispatched, not yet delivered
        self._outstanding = 0       # requests admitted, not yet resolved
        self._draining = False
        self._stopped = False
        self._drained = threading.Event()
        self._rr = 0                # round-robin tiebreaker
        self._shapes = set()        # rungs actually dispatched
        self.reload_count = 0

        # engine-local instruments (several engines can coexist in one
        # process, and drain counts must be per-engine truths) ...
        self._m_predict = metrics.Histogram("serve.predict_s")
        self._m_fill = metrics.Histogram("serve.fill_ratio")
        self._m_wait = metrics.Histogram("serve.queue_wait_s")
        self._n_enqueued = 0
        self._n_completed = 0
        self._n_rejected = 0
        self._n_errors = 0
        self._n_batches = 0
        # ... plus the process-wide registry every subsystem shares
        self._reg_enqueued = metrics.counter("serve.enqueued")
        self._reg_completed = metrics.counter("serve.completed")
        self._reg_rejected = metrics.counter("serve.rejected")
        self._reg_errors = metrics.counter("serve.errors")
        self._reg_predict = metrics.histogram("serve.predict_s")
        self._reg_pending = metrics.gauge("serve.pending")

        self._replica_threads = [self._replica_thread(rep)
                                 for rep in self._replicas]
        self._batcher_thread = threading.Thread(
            target=self._batcher_loop, daemon=True, name="dk-serve-batch")
        for t in self._replica_threads + [self._batcher_thread]:
            t.start()

    def _make_replica(self, index, placed):
        dev = self._devices[index % len(self._devices)]
        return _Replica(index, dev, placed[dev])

    def _replica_thread(self, rep):
        return threading.Thread(target=self._replica_loop, args=(rep,),
                                daemon=True,
                                name=f"dk-serve-replica-{rep.index}")

    def _apply(self, params, x):
        """The model's forward for one padded batch (a seam tests wrap)."""
        return self._model.apply(params, x)

    # -- admission ------------------------------------------------------
    def submit(self, row):
        """Enqueue one feature row; -> ``concurrent.futures.Future``
        resolving to the prediction row (or raising the predict error).
        Raises :class:`Overloaded` at the door — never drops silently."""
        fault_point("serve.enqueue")
        x = np.asarray(row, dtype=np.float32)
        fut = Future()
        with self._cond:
            if self._draining or self._stopped:
                self._n_rejected += 1
                self._reg_rejected.inc()
                raise Overloaded(
                    "draining" if self._draining else "stopped")
            if self._outstanding >= self.max_queue:
                self._n_rejected += 1
                self._reg_rejected.inc()
                raise Overloaded("queue_full",
                                 pending=self._outstanding,
                                 capacity=self.max_queue)
            # shape check AT THE DOOR (bad request, not backpressure):
            # it protects the shape bound AND the neighbours a ragged
            # row would otherwise drag down inside a shared batch
            if self.feature_shape is None:
                self.feature_shape = x.shape
            elif x.shape != self.feature_shape:
                raise ValueError(
                    f"row shape {x.shape} does not match this engine's "
                    f"feature shape {self.feature_shape} (locked at "
                    "construction or by the first admitted row)")
            self._pending.append(_Request(x, fut, time.monotonic(),
                                          time.time(), spans.capture()))
            self._outstanding += 1
            self._n_enqueued += 1
            pending = len(self._pending)
            # gauge set INSIDE the lock: set outside, a descheduled
            # updater could overwrite a newer depth with its stale one
            self._reg_pending.set(self._outstanding)
            self._cond.notify()
        self._reg_enqueued.inc()
        events.emit("serve_enqueue", pending=pending)
        return fut

    def predict(self, rows, timeout_s=None):
        """Convenience: submit every row, gather results into one
        (n, ...) array.  Re-raises the first per-row error."""
        futs = [self.submit(r) for r in rows]
        return np.stack([f.result(timeout=timeout_s) for f in futs])

    # -- batcher --------------------------------------------------------
    def _take_batch(self):
        """Blocking: -> list of requests to pack (<= max rung), or None
        when the engine stopped with nothing left."""
        with self._cond:
            while not self._pending:
                if self._stopped or self._draining:
                    return None
                # the batcher's idle park: every producer (submit) and
                # both lifecycle exits notify under this cond
                self._cond.wait()
            # at least one request: wait up to the latency bound for a
            # full largest rung — unless draining, which flushes NOW
            deadline = time.monotonic() + self.max_latency_s
            while (len(self._pending) < self.max_batch
                   and not self._draining and not self._stopped):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            take = [self._pending.popleft()
                    for _ in range(min(len(self._pending),
                                       self.max_batch))]
            if take:
                self._inflight += 1
            self._cond.notify_all()
        return take or self._take_batch()

    def _rung_for(self, n):
        for b in self.batch_ladder:
            if n <= b:
                return b
        return self.max_batch  # n == max_batch by construction

    def _pick_replica(self):
        """Least-loaded by inbox depth, round-robin on ties."""
        depths = [r.inbox.qsize() for r in self._replicas]
        best = min(depths)
        for i in range(self._rr, self._rr + len(self._replicas)):
            i %= len(self._replicas)
            if depths[i] == best:
                self._rr = (i + 1) % len(self._replicas)
                return self._replicas[i]
        return self._replicas[0]  # pragma: no cover - unreachable

    def _batcher_loop(self):
        while True:
            take = self._take_batch()
            if take is None:
                # draining: keep flushing until the queue is empty, so
                # every admitted request is delivered before shutdown
                with self._cond:
                    if self._pending:
                        continue
                    if self._stopped or self._draining:
                        break
                    continue  # pragma: no cover - spurious wake
            try:
                rung = self._rung_for(len(take))
                x, n = pack_rows([r.x for r in take], rung)
            # a ragged batch fails ITS OWN futures typed, never the
            # batcher thread
            except Exception as e:  # noqa: BLE001
                with self._cond:
                    self._n_errors += len(take)
                    self._outstanding -= len(take)
                    self._reg_pending.set(self._outstanding)
                    self._inflight -= 1
                    self._cond.notify_all()
                self._reg_errors.inc(len(take))
                events.emit("serve_batch_error", n=len(take),
                            error=type(e).__name__)
                for r in take:
                    r.future.set_exception(e)
                continue
            now = time.monotonic()
            with self._cond:  # stats() iterates _shapes under the lock
                self._shapes.add((rung,) + x.shape[1:])
            for r in take:
                self._m_wait.observe(now - r.t)
            if events.enabled():
                # retro-stamp each request's queue wait into ITS OWN
                # trace (submit wall clock -> this pop)
                noww = time.time()
                for r in take:
                    spans.span_at("serve.queue_wait", r.ctx, r.tw,
                                  noww)
            self._m_fill.observe(n / rung)
            with spans.resume(take[0].ctx):
                with spans.span("serve.batch", rung=rung, n=n):
                    events.emit("serve_batch_flush", rung=rung, n=n,
                                fill_ratio=n / rung)
                    # pick + put UNDER the admission lock: resize()
                    # retires replicas under the same lock, so a batch
                    # never lands in an inbox past its sentinel
                    with self._cond:
                        self._pick_replica().inbox.put((x, take))

    # -- replicas -------------------------------------------------------
    def _forward(self, rep, x):
        """One padded batch through ``rep`` -> host numpy predictions.
        The upload goes through pinned memory on the replica's stream;
        the one fetch waits on that stream only."""
        host = torch.from_numpy(x)
        if rep.device.type == "cuda":
            host = host.pin_memory()
        t0 = time.perf_counter()
        xb = host.to(rep.device, non_blocking=True)
        perf.h2d(x.nbytes, time.perf_counter() - t0)
        out = self._apply(rep.params, xb)
        t0 = time.perf_counter()
        preds = out.cpu().numpy()
        perf.d2h(preds.nbytes, time.perf_counter() - t0)
        return preds

    def _replica_loop(self, rep):
        with torch.inference_mode(), on_stream(rep.stream):
            while True:
                # the replica's idle park: the batcher is the only
                # producer, and shutdown posts the None sentinel after
                # joining it
                item = rep.inbox.get()
                if item is None:
                    break
                self._run_batch(rep, *item)

    def _run_batch(self, rep, x, reqs):
        t0 = time.perf_counter()
        tw0 = time.time()
        try:
            fault_point("serve.predict")
            perf.count_dispatch()  # one model launch sequence per batch
            preds = self._forward(rep, x)
        # the predict error lands TYPED on every future in the batch
        except Exception as e:  # noqa: BLE001
            with self._cond:
                self._n_errors += len(reqs)
                self._outstanding -= len(reqs)
                self._reg_pending.set(self._outstanding)
            self._reg_errors.inc(len(reqs))
            events.emit("serve_predict_error", replica=rep.index,
                        n=len(reqs), error=type(e).__name__)
            for r in reqs:
                r.future.set_exception(e)
        else:
            dt = time.perf_counter() - t0
            rep.batches += 1
            with self._cond:
                self._n_batches += 1
                self._n_completed += len(reqs)
                self._outstanding -= len(reqs)
                self._reg_pending.set(self._outstanding)
            self._reg_completed.inc(len(reqs))
            ex = ((reqs[0].ctx.trace_id, reqs[0].ctx.span_id)
                  if reqs and reqs[0].ctx is not None else None)
            self._m_predict.observe(dt, exemplar=ex)
            self._reg_predict.observe(dt, exemplar=ex)
            events.emit("serve_predict", replica=rep.index,
                        n=len(reqs), rung=len(x), duration_s=dt)
            if events.enabled():
                tw1 = time.time()
                for r in reqs:
                    spans.span_at("serve.exec", r.ctx, tw0, tw1,
                                  replica=rep.index, rung=len(x))
            for r, p in zip(reqs, preds[:len(reqs)]):
                r.future.set_result(p)
        finally:
            with self._cond:
                self._inflight -= 1
                self._cond.notify_all()

    # -- hot reload -----------------------------------------------------
    def set_params(self, state, step=None):
        """Swap every replica's parameters between batches.

        ``state`` is a params tree (tensor or numpy leaves) or a
        training-state dict holding one under ``"params"``.  In-flight
        batches finish on the params they started with; the next batch
        a replica picks up sees the new ones — zero dropped requests, no
        lock on the predict path."""
        params = (state["params"]
                  if isinstance(state, dict) and "params" in state
                  else state)
        placed = put_params(params, self._devices)
        for rep in self._replicas:
            rep.params = placed[rep.device]
        self._host_params = params
        self.reload_count += 1
        metrics.counter("serve.reloads").inc()
        events.emit("serve_reload", step=step,
                    replicas=len(self._replicas))

    # -- elastic replica set --------------------------------------------
    def resize(self, n):
        """Grow or shrink the replica set in place.  Grow: new replicas
        share the device list round-robin and start on the CURRENT
        params.  Shrink: a retired replica's sentinel is posted under
        the lock the batcher dispatches under, so it lands after any
        batch already routed there — the retiree delivers its backlog,
        then exits.  -> the new replica count.  Raises
        :class:`Overloaded` on a draining or stopped engine."""
        n = int(n)
        if n < 1:
            raise ValueError(f"resize({n}): must keep >= 1 replica")
        started = []
        with self._cond:
            if self._stopped or self._draining:
                raise Overloaded(
                    "stopped" if self._stopped else "draining")
            cur = len(self._replicas)
            if n < cur:
                retired = self._replicas[n:]
                del self._replicas[n:]
                self._rr = 0
                for rep in retired:
                    rep.inbox.put(None)
            elif n > cur:
                placed = {r.device: r.params for r in self._replicas}
                for _ in range(n - cur):
                    idx = self._next_replica_index
                    self._next_replica_index += 1
                    dev = self._devices[idx % len(self._devices)]
                    if dev not in placed:
                        placed.update(put_params(self._host_params, [dev]))
                    rep = _Replica(idx, dev, placed[dev])
                    self._replicas.append(rep)
                    t = self._replica_thread(rep)
                    # every thread ever started, so shutdown joins all
                    self._replica_threads.append(t)
                    started.append(t)
        for t in started:  # start outside the lock; inboxes buffer
            t.start()
        return n

    # -- lifecycle ------------------------------------------------------
    def drain(self, timeout_s=None):
        """Graceful shutdown: stop admission (typed rejection), flush
        everything pending immediately, deliver every in-flight batch,
        then stop the workers.  -> dict of delivery counts.  Raises
        ``TimeoutError`` if the backlog outlives ``timeout_s`` (the
        workers keep delivering regardless)."""
        t0 = time.perf_counter()
        with self._cond:
            self._draining = True
            backlog = len(self._pending) + self._inflight
            self._cond.notify_all()
        events.emit("serve_drain_begin", backlog=backlog)
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        with self._cond:
            while self._outstanding:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"drain: {self._outstanding} admitted requests "
                        f"unresolved after {timeout_s}s "
                        f"({len(self._pending)} queued, "
                        f"{self._inflight} batches in flight)")
                self._cond.wait(remaining)
        # unconditional + idempotent: a previous drain that timed out
        # left the workers alive, and this call must stop them
        self._shutdown_threads()
        out = {"delivered": self._n_completed,
               "errored": self._n_errors,
               "rejected": self._n_rejected,
               "duration_s": time.perf_counter() - t0}
        events.emit("serve_drain", **out)
        return out

    def _shutdown_threads(self):
        with self._cond:
            first = not self._stopped
            self._stopped = True
            self._cond.notify_all()
        if not first:  # idempotent: a second caller waits, not re-stops
            self._drained.wait(timeout=10)
            return
        # the BATCHER joins FIRST: it may be between popping a batch and
        # dispatching it — a sentinel posted before that dispatch would
        # park the batch behind it forever
        if self._batcher_thread is not threading.current_thread():
            self._batcher_thread.join(timeout=10)
        for rep in self._replicas:
            rep.inbox.put(None)
        for t in self._replica_threads:
            if t is not threading.current_thread():
                t.join(timeout=10)
        self._drained.set()

    def close(self, drain=True, timeout_s=None):
        """Stop the engine.  ``drain=True`` (default) delivers the
        backlog first; ``drain=False`` fails pending futures with a
        typed :class:`Overloaded` (still never a silent drop)."""
        if self._stopped:
            return
        if drain:
            self.drain(timeout_s=timeout_s)
            return
        with self._cond:
            self._draining = True
            pending, self._pending = list(self._pending), \
                collections.deque()
            self._outstanding -= len(pending)
            self._reg_pending.set(self._outstanding)
            self._n_rejected += len(pending)
            self._cond.notify_all()
        self._reg_rejected.inc(len(pending))
        for r in pending:
            r.future.set_exception(Overloaded("stopped"))
        self._shutdown_threads()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @property
    def draining(self):
        return self._draining

    @property
    def running(self):
        return not self._stopped

    def stats(self):
        """JSON-ready engine counters — the ``/metricsz`` payload core."""
        with self._cond:
            pending, inflight = len(self._pending), self._inflight
            outstanding = self._outstanding
            enq, done = self._n_enqueued, self._n_completed
            rej, err, nb = self._n_rejected, self._n_errors, \
                self._n_batches
            shapes = sorted(self._shapes)
        return {
            "replicas": len(self._replicas),
            "devices": [str(r.device) for r in self._replicas],
            "batch_ladder": list(self.batch_ladder),
            "feature_shape": (list(self.feature_shape)
                              if self.feature_shape else None),
            "pending": pending,
            "outstanding": outstanding,
            "inflight_batches": inflight,
            "enqueued": enq,
            "completed": done,
            "rejected": rej,
            "errors": err,
            "batches": nb,
            "reloads": self.reload_count,
            "batches_by_replica": [r.batches for r in self._replicas],
            "shapes_dispatched": [s[0] for s in shapes],
            # the shape bound: distinct batch shapes ever dispatched
            # can never exceed the ladder size
            "retrace_count": len(shapes),
            "retrace_bound": len(self.batch_ladder),
            "draining": self._draining,
            "fill_ratio": self._m_fill.summary(),
            "predict_s": self._m_predict.summary(),
            "queue_wait_s": self._m_wait.summary(),
        }
