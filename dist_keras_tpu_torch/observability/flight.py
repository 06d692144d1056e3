"""Flight recorder — a crash-safe ring of the most recent span/event
records, dumped to ``DK_OBS_DIR`` when something goes wrong.

The JSONL event log answers "what happened over the whole run"; the
flight recorder answers the incident question — "what were the last N
things this process did" — and guarantees that answer SURVIVES the
incident: a bounded in-memory ring (the ``timeseries.TimeSeries``
bounded-ring idiom, applied to whole records) holds the tail of the
event stream, and :func:`dump` writes it atomically as one JSON file
the moment a trigger fires:

- **watchdog alert transitions** (``watchdog.Watchdog.check`` dumps on
  every rule that starts firing, and stamps the dump path into the
  alert payload — so a ``DK_ALERT_CMD`` webhook line names the
  artifact, not just the symptom);
- **preemption** (the dispatch loop's boundary notice and the
  ``preemption.on_request`` watcher both dump before the drain);
- **unhandled crash** — :func:`attach` chains ``sys.excepthook`` and
  ``threading.excepthook``, so an exception nobody caught (on ANY
  thread) leaves a ``flightrec-*.json`` beside the event files
  (``SystemExit``/``KeyboardInterrupt`` are deliberate exits, not
  crashes — skipped);
- **on demand** via the ``/tracez`` endpoint both HTTP servers serve
  (:func:`tracez_doc`), or a direct :func:`dump` call.

The ring is attached by ``events._resolve`` exactly when ``DK_OBS_DIR``
selects an event log, so the zero-cost contract holds: recorder off =
no ring, no hooks, no per-emit work.  Ring capacity is
``DK_TRACE_RING`` records (default 2048); each record is the same dict
the event writer serialized, trace ids included — which is what makes a
set of dumps from different hosts stitchable by ``trace_id``
(:func:`read_dumps` + ``trace_export.chrome_trace``).
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time

from dist_keras_tpu_torch.observability import events, metrics
from dist_keras_tpu_torch.utils import knobs

_DUMP_PREFIX = "flightrec"


class FlightRecorder:
    """Bounded ring of event records + atomic dump writer."""

    def __init__(self, capacity=None):
        if capacity is None:
            capacity = int(knobs.get("DK_TRACE_RING"))
        self.capacity = max(16, int(capacity))
        self._ring = collections.deque(maxlen=self.capacity)
        # one lock for append AND copy: deque.append alone is
        # thread-safe, but list(deque) raises "deque mutated during
        # iteration" against a concurrent appender — and a dump that
        # dies of that is lost exactly when the process is busiest.
        # An uncontended acquire is ~100ns against the µs-scale json
        # serialization each ringed record already paid.
        self._lock = threading.Lock()
        self._dump_seq = 0

    def record(self, rec):
        """Ring one record (the event writer's dict, post-serialize)."""
        with self._lock:
            self._ring.append(rec)

    def records(self):
        """Chronological copy of the retained records."""
        with self._lock:
            return list(self._ring)

    def __len__(self):
        return len(self._ring)

    def stats(self):
        return {"capacity": self.capacity, "n": len(self._ring),
                "dumps": self._dump_seq}

    def dump(self, reason, directory, rank, **fields):
        """Write the ring to ``<directory>/flightrec-rank_{r}-p{pid}-
        NNN-<reason>.json`` (tmp + rename, so a reader never sees a
        torn dump); -> the path.  The pid in the name keeps a
        supervised RELAUNCH into the same obs dir from overwriting the
        previous incarnation's post-mortem (same rank, fresh seq
        counter).  Raises on failure — :func:`dump` (module level) is
        the never-throws wrapper."""
        with self._lock:
            seq = self._dump_seq
            self._dump_seq += 1
        safe = "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in str(reason)) or "dump"
        path = os.path.join(
            directory,
            f"{_DUMP_PREFIX}-rank_{rank}-p{os.getpid()}-{seq:03d}-"
            f"{safe}.json")
        doc = {"reason": str(reason), "t": time.time(), "rank": rank,
               "pid": os.getpid(), "fields": dict(fields),
               "n": len(self._ring), "records": self.records()}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
        os.replace(tmp, path)
        return path


# --- tail-based trace retention -------------------------
#
# Event kinds that belong to a per-request trace: these are the
# records retention may buffer (everything else — lifecycle events,
# perf samples, alerts — always writes through immediately).
_RETAIN_KINDS = frozenset({
    "span_begin", "span_end", "serve_enqueue", "serve_batch_flush",
    "serve_batch_error", "serve_predict_error",
})
# Span paths whose ``span_end`` marks a request's END — the tail-based
# decision point for that trace's local buffer.  Matched on the dotted
# path suffix so a root nested under an outer span still decides.
_ROOT_SPANS = ("serve.request", "serve.client", "route.forward")


def _is_root_end(rec):
    if rec.get("kind") != "span_end":
        return False
    path = str(rec.get("span", ""))
    return any(path == r or path.endswith("." + r) for r in _ROOT_SPANS)


class TraceRetention:
    """Keep full span records only for requests worth keeping.

    Buffers trace-stamped records per ``trace_id`` (custody taken from
    the event writer via ``events._set_retainer``) and decides at
    request END — the root span's ``span_end`` — whether to flush the
    buffer to the log or drop it:

    - **slow**: root duration >= ``slow_s`` (``DK_TRACE_RETAIN_SLOW_S``,
      defaulting to the SLO latency bar ``DK_SLO_LATENCY_S``) — every
      objective-breaching request keeps its complete trace;
    - **errored**: any buffered record carries an ``error`` field or an
      error kind;
    - **head-sampled**: a pure hash of the trace id falls under
      ``DK_TRACE_SAMPLE`` — a deterministic healthy-traffic baseline
      (replays keep the same traces; no RNG).

    Everything else is dropped (counted, not logged), so steady
    healthy traffic stops growing the event log linearly.  The
    in-flight buffer is bounded by ``DK_TRACE_RETAIN_BUDGET`` traces;
    past the budget the OLDEST buffer is flushed — fail OPEN: memory
    pressure can only make retention keep more, never lose an
    incident's trace.  :func:`dump` flushes all in-flight buffers
    first, so an alert/crash artifact always includes the traces that
    were still in progress.
    """

    def __init__(self, slow_s=None, sample=None, budget=None):
        if slow_s is None:
            slow_s = knobs.get("DK_TRACE_RETAIN_SLOW_S")
            if slow_s is None:
                slow_s = knobs.get("DK_SLO_LATENCY_S")
        self.slow_s = float(slow_s)
        self.sample = float(knobs.get("DK_TRACE_SAMPLE")
                            if sample is None else sample)
        self.budget = max(1, int(knobs.get("DK_TRACE_RETAIN_BUDGET")
                                 if budget is None else budget))
        self._buf = collections.OrderedDict()  # trace_id -> [records]
        self._writer = None
        self._lock = threading.Lock()

    def offer(self, rec, writer):
        """The ``events`` seam: -> True when custody of ``rec`` is
        taken (buffered or decided here), False to write through."""
        if rec.get("kind") not in _RETAIN_KINDS:
            return False
        tid = rec.get("trace_id")
        if not tid:
            return False
        self._writer = writer
        evicted = decided = None
        with self._lock:
            buf = self._buf.get(tid)
            if buf is None:
                if len(self._buf) >= self.budget:
                    _, evicted = self._buf.popitem(last=False)
                buf = self._buf[tid] = []
            buf.append(rec)
            if _is_root_end(rec):
                decided = self._buf.pop(tid)
            inflight = len(self._buf)
        if evicted is not None:
            # budget overflow: fail open — flush, never drop unseen
            metrics.counter("trace.retained").inc()
            self._flush(evicted, writer)
        if decided is not None:
            if self._keep(decided, rec):
                metrics.counter("trace.retained").inc()
                self._flush(decided, writer)
            else:
                metrics.counter("trace.dropped").inc()
                metrics.counter("trace.dropped_records").inc(
                    len(decided))
        metrics.gauge("trace.inflight").set(inflight)
        return True

    def _keep(self, records, root_rec):
        try:
            dur = float(root_rec.get("duration_s") or 0.0)
        except (TypeError, ValueError):
            dur = 0.0
        if dur >= self.slow_s:
            return True
        for r in records:
            if "error" in r or "error" in str(r.get("kind", "")):
                return True
        if self.sample > 0.0:
            try:
                h = int(str(root_rec.get("trace_id", ""))[:8], 16)
            except ValueError:
                h = 0
            if h / 0xFFFFFFFF < self.sample:
                return True
        return False

    def _flush(self, records, writer):
        sink = events._sink
        for r in records:
            writer.write(r)
            if sink is not None:
                sink(r)

    def flush_all(self):
        """Flush every in-flight buffer (drain / incident dump /
        process teardown): undecided traces are retained — fail open.
        Never throws; -> the number of records flushed."""
        with self._lock:
            bufs = list(self._buf.values())
            self._buf.clear()
        w, n = self._writer, 0
        for records in bufs:
            if w is None:
                break
            try:
                self._flush(records, w)
                metrics.counter("trace.retained").inc()
                n += len(records)
            # dklint: ignore[broad-except] a failed flush must not add a failure to the drain/incident path
            except Exception as e:
                print(f"[dk.observability] WARNING: trace retention "
                      f"flush failed: {e!r}", file=sys.stderr,
                      flush=True)
                break
        metrics.gauge("trace.inflight").set(0)
        return n

    def stats(self):
        with self._lock:
            inflight = len(self._buf)
        return {"inflight": inflight, "slow_s": self.slow_s,
                "sample": self.sample, "budget": self.budget}


_lock = threading.Lock()
_recorder = None
_retention = None
_hooks_installed = False


def recorder():
    """The process-wide recorder (created on first use)."""
    global _recorder
    with _lock:
        if _recorder is None:
            _recorder = FlightRecorder()
        return _recorder


def attach():
    """Arm the recorder: register the events sink (every emitted record
    is ringed) and chain the crash hooks.  Called by ``events._resolve``
    when ``DK_OBS_DIR`` selects a writer; idempotent.  The sink is the
    module-level :func:`record` — it resolves ``recorder()`` per call,
    so a test's :func:`reset` swaps in a fresh ring without the sink
    feeding a discarded one.  When ``DK_TRACE_RETAIN`` is armed this
    also installs the tail-based :class:`TraceRetention` policy into
    the event seam."""
    global _retention
    events._sink = record
    if knobs.get("DK_TRACE_RETAIN"):
        with _lock:
            if _retention is None:
                _retention = TraceRetention()
        events._set_retainer(_retention.offer)
    _install_crash_hooks()


def retention():
    """The active :class:`TraceRetention` policy, or None when
    ``DK_TRACE_RETAIN`` is off."""
    return _retention


def retain_flush():
    """Flush every in-flight retention buffer to the event log (drain
    paths, incident dumps); no-op when retention is off.  -> records
    flushed."""
    r = _retention
    return r.flush_all() if r is not None else 0


def record(rec):
    recorder().record(rec)


def dump(reason, **fields):
    """Dump the ring to the active ``DK_OBS_DIR``; -> the dump path, or
    None (log disabled, or the write failed — a recorder dump is a
    best-effort artifact and must NEVER add a failure to the incident
    it records).  Emits one ``flight_dump`` event naming the path and
    counts ``flight.dumps``."""
    d = events.obs_dir()
    if d is None:
        return None
    # flush in-flight retention buffers FIRST: the incident's own
    # trace is usually still undecided at alert time, and a dump that
    # lost it would defeat the whole "every incident keeps its trace"
    # contract
    retain_flush()
    try:
        path = recorder().dump(reason, d, events.rank() or 0, **fields)
    # dklint: ignore[broad-except] a failed dump must not add a failure to the incident it records
    except Exception as e:
        print(f"[dk.observability] WARNING: flight dump ({reason}) "
              f"failed: {e!r}", file=sys.stderr, flush=True)
        return None
    metrics.counter("flight.dumps").inc()
    events.emit("flight_dump", reason=str(reason), path=path,
                n=len(recorder()), **fields)
    return path


def _install_crash_hooks():
    """Chain ``sys.excepthook`` + ``threading.excepthook`` so an
    UNHANDLED exception on any thread dumps the ring before the
    process (or thread) dies.  The previous hooks always run after —
    this is a recorder, not an error handler."""
    global _hooks_installed
    with _lock:
        if _hooks_installed:
            return
        _hooks_installed = True
    prev_sys = sys.excepthook
    prev_threading = threading.excepthook

    def _crash_dump(exc_type, exc, where):
        if issubclass(exc_type, (SystemExit, KeyboardInterrupt)):
            return  # deliberate exits (incl. Preempted) are not crashes
        dump("crash", error=exc_type.__name__,
             detail=str(exc)[:200], where=where)

    def _sys_hook(exc_type, exc, tb):
        _crash_dump(exc_type, exc, "main")
        prev_sys(exc_type, exc, tb)

    def _threading_hook(args):
        _crash_dump(args.exc_type, args.exc_value,
                    getattr(args.thread, "name", "?"))
        prev_threading(args)

    sys.excepthook = _sys_hook
    threading.excepthook = _threading_hook


def tracez_doc():
    """The ``/tracez`` payload: recorder stats + the retained records
    (JSON-ready — every record already round-tripped the writer's
    serializer)."""
    rec = recorder()
    r = _retention
    return {"rank": events.rank(), "enabled": events.enabled(),
            **rec.stats(),
            "retention": r.stats() if r is not None else None,
            "records": rec.records()}


def load_dump(path):
    """Read one dump file -> its document (the :func:`dump` schema)."""
    with open(path) as f:
        return json.load(f)


def dump_files(directory):
    """-> sorted paths of every ``flightrec-*.json`` under
    ``directory`` (including ``host_{i}/`` subdirs — the
    ``Job.collect_obs`` layout, same convention as
    ``report.event_files``)."""
    directory = os.path.abspath(os.path.expanduser(str(directory)))
    out = []
    roots = [directory]
    try:
        for name in os.listdir(directory):
            p = os.path.join(directory, name)
            if name.startswith("host_") and os.path.isdir(p):
                roots.append(p)
    except OSError:
        return []
    for root in roots:
        try:
            names = os.listdir(root)
        except OSError:
            continue
        out.extend(os.path.join(root, n) for n in names
                   if n.startswith(_DUMP_PREFIX + "-")
                   and n.endswith(".json"))
    return sorted(out)


def read_dumps(directory):
    """Merge every host's recorder dumps into ONE deduplicated timeline
    ordered by ``(t, rank, seq)`` — the stitching input for
    ``trace_export``.  Two dumps from one process overlap (the ring
    retains history across dumps); records are deduplicated by
    ``(pid, rank, seq)`` — seq is unique per event writer, and the
    dump's recorded pid distinguishes two INCARNATIONS of the same
    rank (a supervised relaunch restarts seq at 0; without the pid its
    records would vanish as false duplicates).  A torn/unreadable dump
    is skipped, not fatal — the merger must work best exactly when the
    run died worst."""
    seen = set()
    records = []
    for path in dump_files(directory):
        try:
            doc = load_dump(path)
        except (OSError, ValueError):
            continue
        pid = doc.get("pid")
        for rec in doc.get("records", ()):
            key = (pid, rec.get("rank", doc.get("rank", 0)),
                   rec.get("seq"))
            if key in seen:
                continue
            seen.add(key)
            records.append(rec)
    records.sort(key=lambda e: (e.get("t", 0.0), e.get("rank", 0),
                                e.get("seq", 0)))
    return records


def reset():
    """Drop the ring (tests).  The chained excepthooks stay installed
    and the installed flag stays set — re-chaining on every reset would
    stack hook frames; the hooks read the live recorder through
    :func:`dump`, so a fresh ring is all a test needs."""
    global _recorder, _retention
    with _lock:
        _recorder = None
        _retention = None
