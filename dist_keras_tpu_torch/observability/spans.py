"""Distributed span tracing — causal, cross-thread, cross-process regions.

A copy of the JAX package's ``observability/spans.py`` (it is framework
free) on the port's ``events``, ``metrics`` and ``knobs``; the one
change is the device-trace annotation, which is
``torch.profiler.record_function`` here instead of
``jax.profiler.TraceAnnotation``.

``span("ckpt.save")`` wraps a block with ``span_begin`` / ``span_end``
events (the end event carries ``duration_s``), nests — the emitted name
is the dot-joined path of every open span on this thread — and records
the duration into ``metrics.histogram("span.<path>")`` so the run report
can summarize per-phase time without re-deriving it from timestamps.

**Trace context** (round 16): every span carries identity —

- a **root** span (no open parent on its thread, no resumed context)
  mints a fresh ``trace_id`` (32 hex chars) — or joins the job-wide
  trace when ``DK_TRACE_ID`` is exported (``launch.Job`` mints one per
  job, so every host of a pod shares it);
- every span mints its own ``span_id`` (16 hex chars) and records its
  ``parent_id``, so a post-hoc reader can reconstruct the tree;
- a context can be **captured on one thread and resumed on another**
  (:func:`capture` / :func:`resume`) — the serving engine hands the
  handler thread's context across the batcher/replica handoff, and the
  async checkpoint writer resumes the training thread's context, so
  one request (or one save) is a single connected trace across threads;
- cross-process propagation rides a ``traceparent``-style header
  (:func:`traceparent` / :func:`parse_traceparent` — the W3C
  ``00-<trace>-<span>-01`` shape) on serving requests, and the
  ``DK_TRACE_ID`` env on launched pods.

Ids come from one process-wide RNG seeded by ``DK_TRACE_SEED`` when set
(deterministic replay for gates and tests) and by OS entropy otherwise.
Spans that cannot be a context manager (the batch picked my request up
on another thread *then*) are stamped retroactively with
:func:`span_at`, which emits a single ``span_end`` record carrying
explicit ``t0`` + ``duration_s``.

When a **device trace is active** (a caller running ``torch.profiler``
flips :func:`set_device_trace`), each span additionally opens a
``torch.profiler.record_function`` range so the same names show up
inside the profiler's timeline — one annotation vocabulary for both the
host-side event log and the device trace.  Nothing here imports torch
unless that flag is on, so spans stay usable in processes that never
touch a device.

Zero-cost contract: with ``DK_OBS_DIR`` unset and no device trace, a
span is ONE SHARED no-op context-manager object — no clock read, no id
mint, no per-call allocation retained (the ``--obs-only`` gate checks
the disabled path allocates nothing across 10k calls).  ``capture``
returns None and ``resume(None)`` is a no-op, so instrumented seams pay
a boolean check when tracing is off.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time

from dist_keras_tpu_torch.observability import events, metrics
from dist_keras_tpu_torch.utils import knobs

# The span vocabulary — every name a `span(...)` / `span_at(...)` call
# site may open.  Entries containing ``*`` are fnmatch patterns for
# dynamic families (the call site carries a ``# dklint: spans=<pat>``
# annotation).  Adding a span call site?  Register the name here or the
# ``span-unregistered`` lint rule (the JAX package's ``analysis``)
# fails the tree — the report, the Perfetto export and operator tooling
# treat this as the closed set of phase names they can attribute.
KNOWN_SPANS = (
    # trainer dispatch loop (trainers/chunking.py)
    "train.run",
    # checkpointing (checkpoint.py — also opened on the async writer
    # thread, resumed from the saving thread's context)
    "ckpt.save",
    # serving request lifecycle (serving/server.py + serving/engine.py;
    # serve.client is the CALLER-side root a traced client opens before
    # sending its traceparent header — the gate's client worker does)
    "serve.request", "serve.batch", "serve.queue_wait", "serve.exec",
    "serve.reload", "serve.client",
    # decode serving (serving/decode.py + serving/server.py): the
    # /generate handler's live span and the scheduler's retro-stamped
    # prefill window — together with serve.queue_wait they attribute
    # time-to-first-token per request
    "serve.generate", "serve.prefill",
    # router forward hop (serving/router.py — parent of the backend's
    # serve.request via the propagated traceparent header)
    "route.forward",
    # parameter-server commit apply (ps/server.py)
    "ps.commit",
    # perf phases under an open device trace (observability/perf.py)
    "perf.*",
)

_tls = threading.local()           # per-thread open-span stack + base ctx
_device_trace_active = False       # toggled by utils.profiling.trace

# id minting: one process-wide RNG; DK_TRACE_SEED makes the id sequence
# a pure function of the seed (the chaos/gate replay convention)
_rng_lock = threading.Lock()
_rng = None

# thread-stack registry for the /statusz open-span summary: ident ->
# (thread name, live stack reference).  Entries for dead threads are
# pruned on read (open_spans) under the same lock.
_reg_lock = threading.Lock()
_stacks = {}


def _get_rng():
    global _rng
    with _rng_lock:
        if _rng is None:
            seed = knobs.get("DK_TRACE_SEED")
            _rng = (random.Random(seed) if seed is not None
                    else random.Random())
        return _rng


def new_trace_id():
    """Mint a 32-hex-char trace id (128 bits)."""
    rng = _get_rng()
    with _rng_lock:
        return f"{rng.getrandbits(128):032x}"


def new_span_id():
    """Mint a 16-hex-char span id (64 bits)."""
    rng = _get_rng()
    with _rng_lock:
        return f"{rng.getrandbits(64):016x}"


class SpanContext:
    """A capturable, resumable position in a trace: ``(trace_id,
    span_id)``.  Spans opened under a resumed context parent to
    ``span_id`` and share ``trace_id`` — across threads, and (via the
    ``traceparent`` header / ``DK_TRACE_ID`` env) across processes."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id, span_id):
        self.trace_id = str(trace_id)
        self.span_id = str(span_id)

    def __eq__(self, other):
        return (isinstance(other, SpanContext)
                and self.trace_id == other.trace_id
                and self.span_id == other.span_id)

    def __hash__(self):
        return hash((self.trace_id, self.span_id))

    def __repr__(self):
        return f"SpanContext({self.trace_id!r}, {self.span_id!r})"


def set_device_trace(active):
    """Record whether a ``torch.profiler`` device trace is running —
    spans forward to ``record_function`` only while it is."""
    global _device_trace_active
    _device_trace_active = bool(active)


def device_trace_active():
    return _device_trace_active


def _prune_stacks_locked():
    """Drop registry entries for dead threads (caller holds
    ``_reg_lock``)."""
    alive = {t.ident for t in threading.enumerate()}
    for ident in [i for i in _stacks if i not in alive]:
        del _stacks[ident]


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
        t = threading.current_thread()
        with _reg_lock:
            # prune at REGISTRATION cadence (once per thread, not per
            # span): per-request HTTP handler threads would otherwise
            # grow the registry without bound on a server whose
            # operator never polls /statusz (the read-side prune)
            _prune_stacks_locked()
            _stacks[t.ident] = (t.name, st)
    return st


class _NoopSpan:
    """The disabled path: one shared reusable context manager — entering
    and exiting it allocates nothing and reads no clock."""

    __slots__ = ()

    def __enter__(self):
        return ""

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()  # the one shared instance; span() hands it out


def _root_ids():
    """(trace_id, parent_id) for a span with no open parent on this
    thread: the resumed base context wins, then the job-wide
    ``DK_TRACE_ID``, then a freshly minted trace."""
    base = getattr(_tls, "base", None)
    if base is not None:
        return base.trace_id, base.span_id
    job_trace = knobs.raw("DK_TRACE_ID")
    if job_trace:
        return job_trace, None
    return new_trace_id(), None


@contextlib.contextmanager
def _span_impl(name, fields):
    st = _stack()
    sid = new_span_id()
    if st:
        trace, parent = st[-1][2], st[-1][1]
    else:
        trace, parent = _root_ids()
    st.append((str(name), sid, trace))
    path = ".".join(e[0] for e in st)
    ann = None
    if _device_trace_active:
        try:
            import torch.profiler

            ann = torch.profiler.record_function(path)
            ann.__enter__()
        # dklint: ignore[broad-except] the device trace must not break host spans
        except Exception:  # the device trace must not break host spans
            ann = None
    events.emit("span_begin", span=path, trace_id=trace, span_id=sid,
                parent_id=parent, tid=threading.get_ident(), **fields)
    t0 = time.perf_counter()
    try:
        yield path
    finally:
        dt = time.perf_counter() - t0
        if ann is not None:
            try:
                ann.__exit__(None, None, None)
            # dklint: ignore[broad-except] profiler teardown is best-effort
            except Exception:  # pragma: no cover - profiler teardown
                pass
        events.emit("span_end", span=path, trace_id=trace, span_id=sid,
                    parent_id=parent, tid=threading.get_ident(),
                    duration_s=dt, **fields)
        if events.enabled():
            # dklint: metrics=span.*
            metrics.histogram(f"span.{path}").observe(dt)
        st.pop()


def span(name, **fields):
    """Context manager: a named, nested, timed region with trace
    identity.

    >>> with span("train.run"):
    ...     with span("chunk", i=0):
    ...         ...   # events: train.run, train.run.chunk
    """
    if not events.enabled() and not _device_trace_active:
        return _NOOP
    return _span_impl(name, fields)


def span_at(name, ctx, t0, t1, **fields):
    """Stamp a span RETROACTIVELY: one ``span_end`` record with explicit
    ``t0`` + ``duration_s``, parented to ``ctx`` (or a fresh root when
    None).  The cross-thread stages that cannot be a live context
    manager — the queue wait a request paid before the batcher popped
    it, the inference window a replica executed for a whole batch — are
    recorded this way, one record per request.  -> the new span's
    :class:`SpanContext`, or None when the event log is off."""
    if not events.enabled():
        return None
    sid = new_span_id()
    if ctx is not None:
        trace, parent = ctx.trace_id, ctx.span_id
    else:
        trace, parent = _root_ids()
    dur = float(t1) - float(t0)
    events.emit("span_end", span=str(name), trace_id=trace, span_id=sid,
                parent_id=parent, tid=threading.get_ident(),
                t0=float(t0), duration_s=dur, **fields)
    # dklint: metrics=span.*
    metrics.histogram(f"span.{name}").observe(dur)
    return SpanContext(trace, sid)


def current():
    """The innermost open span's :class:`SpanContext` on this thread —
    or the resumed base context, or None (tracing off / no open span)."""
    st = getattr(_tls, "stack", None)
    if st:
        return SpanContext(st[-1][2], st[-1][1])
    return getattr(_tls, "base", None)


def capture():
    """Capture the current context for another thread to
    :func:`resume`.  None when there is nothing to capture (which
    :func:`resume` accepts as a no-op) — so the seam code is one
    unconditional ``capture()`` / ``resume(ctx)`` pair."""
    if not events.enabled() and not _device_trace_active:
        return None
    return current()


@contextlib.contextmanager
def resume(ctx):
    """Adopt a captured :class:`SpanContext` on THIS thread: spans
    opened inside parent to ``ctx.span_id`` and join its trace.  The
    previous base is restored on exit; ``resume(None)`` is a no-op."""
    if ctx is None:
        yield None
        return
    prev = getattr(_tls, "base", None)
    _tls.base = ctx
    try:
        yield ctx
    finally:
        _tls.base = prev


def current_path():
    """The dot-joined open-span path on this thread ('' at top level)."""
    st = getattr(_tls, "stack", None)
    return ".".join(e[0] for e in st) if st else ""


def traceparent(ctx=None):
    """The W3C-style ``00-<trace>-<span>-01`` header value for ``ctx``
    (default: the current context), or None with nothing to carry."""
    if ctx is None:
        ctx = current()
    if ctx is None:
        return None
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


def parse_traceparent(header):
    """Parse a ``traceparent`` header -> :class:`SpanContext`, or None
    for a missing/malformed value (a bad header degrades to a fresh
    root trace — never an error into the serving path)."""
    if not header:
        return None
    parts = str(header).strip().split("-")
    if len(parts) != 4:
        return None
    _, trace, parent, _ = parts
    if len(trace) != 32 or len(parent) != 16:
        return None
    try:
        int(trace, 16), int(parent, 16)
    except ValueError:
        return None
    return SpanContext(trace, parent)


def open_spans():
    """Per-thread open-span paths — the ``/statusz`` summary.  Dead
    threads' registry entries are pruned here; only threads with at
    least one open span appear."""
    out = {}
    with _reg_lock:
        _prune_stacks_locked()
        items = list(_stacks.items())
    for ident, (name, st) in items:
        if st:
            out[f"{name} ({ident})"] = ".".join(e[0] for e in st)
    return out


def _current_ids():
    """events.py context provider: the trace identity every event
    emitted under an open span is stamped with (``setdefault``, so span
    events' explicit ids win).  None when no span is open."""
    st = getattr(_tls, "stack", None)
    if st:
        return {"trace_id": st[-1][2], "span_id": st[-1][1]}
    base = getattr(_tls, "base", None)
    if base is not None:
        return {"trace_id": base.trace_id, "span_id": base.span_id}
    return None


def reset():
    """Forget the seeded RNG so ``DK_TRACE_SEED`` is re-read — tests
    that flip the env need this.  The thread-stack registry is NOT
    cleared: live threads keep their cached thread-local stack object,
    so wiping the registry would orphan them from ``open_spans`` for
    the rest of the process; dead threads are pruned on read anyway."""
    global _rng
    with _rng_lock:
        _rng = None


# every event emitted while a span is open carries the trace identity —
# the "chunk"/"coord"/"ckpt_save" breadcrumbs stitch into the same tree
# as the spans without any extra emission
def _exemplar_ids():
    """metrics.py exemplar provider: the current span's ``(trace_id,
    span_id)`` tuple, or None when no span is open.  Only consulted
    when the SLO plane (``DK_SLO``) is armed — the disarmed observe
    path never calls this."""
    ids = _current_ids()
    return (ids["trace_id"], ids["span_id"]) if ids else None


events._set_context_provider(_current_ids)
metrics._set_exemplar_provider(_exemplar_ids)
