"""Perf attribution — what the host can always measure, and the card's
own clock for the phases that name a device.

A copy of the JAX package's ``observability/perf.py`` on the port's
``metrics``, without its retrace listener (eager PyTorch builds no
executables; the serving engines count their dispatched shapes against
their ladder's ``retrace_bound`` instead).  Always on, cheap enough for
production:

- **Dispatches** — model launches enqueued by the framework's own hot
  loops (:func:`count_dispatch` at each chunk, serving replica batch and
  decode prefill / step): the dispatch *granularity the framework
  chose*, which is exactly the knob batch ladders turn.
- **H2D / D2H bytes + walls** — :func:`h2d` / :func:`d2h`.
- **Phases** — :func:`phase` times a named region into the
  ``perf.phase.<name>`` registry histogram (host wall) and appends one
  record to a bounded in-memory ring (:func:`records`), in entry order,
  with the index of its open parent phase.  Given a CUDA ``device``, the
  phase also records a timing event on the device's current stream at
  entry and at exit, so its record gains ``device_s`` (entry to exit on
  the stream) and ``queue_s`` (how long the entry event waited in the
  launch queue: its execution time on the host clock less the host time
  it was recorded at).  Under any running ``torch.profiler`` the phase
  opens a ``record_function`` range of its name, so the profiler's
  timeline shows the program's phases around the kernels.

Vocabulary: ``ChunkRunner`` records ``data`` / ``step`` / ``comm`` /
``ckpt``, ``AsyncMerge`` ``comm_overlap`` / ``comm_blocked``, the PS
worker ``ps_*``; a trainer call's data ``shard`` / ``layout``; the
windowed trainers ``window`` / ``merge``; the transformer's TP step
``tp.step`` with ``tp.forward`` / ``tp.backward`` / ``tp.grad_reduce`` /
``tp.optimizer`` inside.

**The shared clock.**  Each card keeps one anchor: an event recorded
when the current stream is found idle (``Stream.query()``), with
``time.perf_counter`` read beside it.  A device event maps to the host
clock as ``anchor_host + anchor.elapsed_time(e) / 1e3``; the anchor is
renewed at the next idle moment at least :data:`REANCHOR_S` later.
``perf_counter`` is CLOCK_MONOTONIC, which every process of the host
shares, so the ranks' records line up too.

Events are read without blocking once :data:`FOLD_AT` records wait (as
``parallel/collectives.py`` folds its own), and all of them by
``records(block=True)``.  Nothing is written on the hot path; the
records leave through :func:`records`, and their per-phase device totals
through :func:`snapshot` (the ``perf_sample`` event and the report).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import sys
import threading
import time

from dist_keras_tpu_torch.observability import metrics, spans

# comm_overlap / comm_blocked are the round-19 split of the boundary
# collective wall: AsyncMerge (parallel/collectives.py) charges the
# async enqueue to comm_overlap and the deferred block_until_ready to
# comm_blocked, so "how much of the collective hid under compute" is a
# first-class histogram instead of a guess inside "comm"
PHASES = ("data", "step", "comm", "comm_overlap", "comm_blocked", "ckpt")

RING = 65536        # phase records kept, the oldest dropped first
FOLD_AT = 256       # read the finished events once this many records wait
REANCHOR_S = 1.0    # least seconds between two anchors of one card

_lock = threading.Lock()
_tls = threading.local()       # this thread's open phases
_seq = itertools.count()
_ring = collections.deque(maxlen=RING)
_pending = []                  # records whose events are not read yet
_anchors = {}                  # card index -> (event, perf_counter)
_device_totals = {}            # name -> [count, device_s, queue_s, queued]


class _Record:
    __slots__ = ("name", "seq", "parent", "host_start", "host_s",
                 "device_s", "queue_s", "events")

    def __init__(self, name, seq, parent):
        self.name, self.seq, self.parent = name, seq, parent
        self.host_start = self.host_s = None
        self.device_s = self.queue_s = self.events = None

    def as_dict(self):
        return {"name": self.name, "seq": self.seq, "parent": self.parent,
                "host_start": self.host_start, "host_s": self.host_s,
                "device_s": self.device_s, "queue_s": self.queue_s}


def count_dispatch(n=1):
    """Count ``n`` model launches enqueued by a framework hot loop (per
    chunk / per serving batch — not per kernel)."""
    metrics.counter("perf.dispatches").inc(n)


def h2d(nbytes, seconds):
    """Record one host->device transfer: bytes shipped + the enqueue
    wall (a non-blocking copy from pinned memory is async — the DMA
    overlaps compute, so the enqueue wall is the host-side cost that
    exists)."""
    metrics.counter("perf.h2d_bytes").inc(int(nbytes))
    metrics.histogram("perf.h2d_s").observe(seconds)


def d2h(nbytes, seconds):
    """Record one device->host fetch: bytes + the BLOCKING wall.  On
    the streamed training path this wall doubles as the depth-2
    backpressure barrier (see ``ChunkRunner``), so it includes the wait
    for the dispatched compute — which is precisely the "host overlap
    wall" a device-only claim needs a CPU-measurable proxy for."""
    metrics.counter("perf.d2h_bytes").inc(int(nbytes))
    metrics.histogram("perf.d2h_s").observe(seconds)


def _cuda_index(device):
    """The card index of a CUDA ``device``, else None (no torch import:
    a process that has not loaded torch has no card in use)."""
    torch = sys.modules.get("torch")
    if device is None or torch is None:
        return None
    d = device if isinstance(device, torch.device) else torch.device(device)
    if d.type != "cuda":
        return None
    return d.index if d.index is not None else torch.cuda.current_device()


def _record_event(torch, stream):
    e = torch.cuda.Event(enable_timing=True)
    e.record(stream)
    return e


def _anchor(torch, index, stream):
    """The card's anchor, renewed first when the last is
    :data:`REANCHOR_S` old and ``stream`` has nothing left to run."""
    a = _anchors.get(index)
    if (a is None or time.perf_counter() - a[1] >= REANCHOR_S) \
            and stream.query():
        t = time.perf_counter()
        e = _record_event(torch, stream)
        a = _anchors[index] = (e, (t + time.perf_counter()) / 2)
    return a


def _host_time(anchor, event):
    """A finished ``event`` recorded after ``anchor`` on the host's
    clock."""
    return anchor[1] + anchor[0].elapsed_time(event) / 1e3


def anchor_time(event, index):
    """``event`` (recorded on card ``index`` after its anchor) on the
    host's ``perf_counter`` clock, waiting for it; None before the card
    has an anchor."""
    a = _anchors.get(index)
    if a is None:
        return None
    event.synchronize()
    return _host_time(a, event)


def _fold(block):
    """Read the events of the waiting records that have finished (all of
    them with ``block``) into their ``device_s`` / ``queue_s``."""
    global _pending
    with _lock:
        waiting, _pending = _pending, []
    keep = []
    for rec in waiting:
        start, end, anchor = rec.events
        events = (start, end) if anchor is None else (anchor[0], start, end)
        if block:
            for e in events:
                e.synchronize()
        elif not all(e.query() for e in events):
            keep.append(rec)
            continue
        rec.device_s = start.elapsed_time(end) / 1e3
        if anchor is not None:
            rec.queue_s = _host_time(anchor, start) - rec.host_start
        rec.events = None
        with _lock:
            tot = _device_totals.setdefault(rec.name, [0, 0.0, 0.0, 0])
            tot[0] += 1
            tot[1] += rec.device_s
            if rec.queue_s is not None:
                tot[2] += rec.queue_s
                tot[3] += 1
    if keep:
        with _lock:
            _pending = keep + _pending


@contextlib.contextmanager
def phase(name, device=None):
    """Always-on timed phase: observes ``perf.phase.<name>`` (registry
    histogram) and appends a record to the ring (a clock read, a deque
    append, no I/O).  With a CUDA ``device`` two timing events more,
    read later (``device_s``, ``queue_s``); under a running
    ``torch.profiler`` a ``record_function`` range of ``name``."""
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    rec = _Record(name, next(_seq), st[-1].seq if st else None)
    _ring.append(rec)
    st.append(rec)
    rng = None
    if spans.device_trace_active():
        rng = sys.modules["torch"].autograd.profiler.record_function(name)
        rng.__enter__()
    index = _cuda_index(device)
    if index is not None:
        torch = sys.modules["torch"]
        stream = torch.cuda.current_stream(index)
        anchor = _anchor(torch, index, stream)
    t0 = rec.host_start = time.perf_counter()
    if index is not None:
        start = _record_event(torch, stream)
    try:
        yield
    finally:
        if index is not None:
            end = _record_event(torch, stream)
        rec.host_s = time.perf_counter() - t0
        # dklint: metrics=perf.phase.*
        metrics.histogram(f"perf.phase.{name}").observe(rec.host_s)
        if rng is not None:
            rng.__exit__(None, None, None)
        st.pop()
        if index is not None:
            rec.events = (start, end, anchor)
            with _lock:
                _pending.append(rec)
                due = len(_pending) >= FOLD_AT
            if due:
                _fold(block=False)


def records(block=False):
    """The ring's phase records, oldest first, as dicts: ``name``,
    ``seq`` (its index), ``parent`` (the open parent phase's ``seq`` on
    its thread, or None), ``host_start`` (``perf_counter``), ``host_s``
    (None while open), and for a phase on a card ``device_s`` and
    ``queue_s`` once its events are read — ``block`` waits for all of
    them."""
    _fold(block)
    return [r.as_dict() for r in list(_ring)]


def reset(ring=RING):
    """Forget every record, pending event, anchor and device total; the
    ring then keeps ``ring`` records."""
    global _ring, _pending
    with _lock:
        _ring = collections.deque(maxlen=ring)
        _pending = []
        _anchors.clear()
        _device_totals.clear()


def snapshot(snap=None):
    """Compact JSON-ready perf-attribution snapshot — the
    ``perf_sample`` event payload and the report's per-rank row.
    Percentile-free (totals only): this runs on every sampler tick,
    which passes its already-taken registry ``snap`` in so one tick
    walks the registry once, not twice.  A phase timed on a card adds
    its read records' ``device_count``, ``device_total_s`` and
    ``queue_mean_s``."""
    if snap is None:
        snap = metrics.snapshot(percentiles=False)
    counters, hists = snap["counters"], snap["histograms"]
    _fold(block=False)
    with _lock:
        device = {k: list(v) for k, v in _device_totals.items()}
    phases = {}
    for name, h in hists.items():
        if name.startswith("perf.phase."):
            key = name[len("perf.phase."):]
            row = phases[key] = {
                "count": h["count"],
                "total_s": round(h["total"], 6),
                "mean_s": (round(h["total"] / h["count"], 6)
                           if h["count"] else None),
            }
            if key in device:
                n, dev_s, queue_s, queued = device[key]
                row.update(device_count=n,
                           device_total_s=round(dev_s, 6),
                           queue_mean_s=(round(queue_s / queued, 6)
                                         if queued else None))
    return {
        "dispatches": counters.get("perf.dispatches", 0),
        "h2d_bytes": counters.get("perf.h2d_bytes", 0),
        "d2h_bytes": counters.get("perf.d2h_bytes", 0),
        "phases": phases,
    }
