"""Structured event log — append-only, per-host JSONL under ``DK_OBS_DIR``.

The port's own copy of ``dist_keras_tpu/observability/events.py``, with
the same file format, the same vocabulary (:data:`KNOWN_EVENTS`) and the
same contract:

- **One JSONL file per host** (``events-rank_{i}.jsonl``), so hosts never
  contend on a shared file; the JAX package's report merger reads the
  port's files as its own.
- **Atomic line writer**: each event is serialized to one line and
  written with a single ``os.write`` on an ``O_APPEND`` fd — concurrent
  writers never interleave partial lines, and a crash mid-run loses at
  most the event being written, never the file.
- **Zero-cost when off**: with ``DK_OBS_DIR`` unset, :func:`emit` is one
  cached boolean check — no file handles, no JSON encoding.
- **Never throws into training code**: any failure (disk full, bad
  field, closed fd) degrades to a dropped event plus ONE warning per
  process on stderr.

Env knobs (``utils/knobs.py``): ``DK_OBS_DIR`` (directory, created on
first emit; unset = disabled), ``DK_OBS_FLUSH=1`` (fsync after every
line), ``DK_OBS_ROTATE_MB`` / ``DK_OBS_ROTATE_KEEP`` (size cap per file
and rotated segments kept; ``seq`` stays monotonic across rotations).

Event schema: every record carries ``t`` (``time.time()``), ``seq`` (a
per-process monotonic counter), ``rank`` (``DK_COORD_RANK`` > ``RANK``,
as ``torchrun`` exports it, > 0), ``kind``, and the emitting seam's
keyword fields.  The flight recorder the JAX package attaches to this
log is not ported; the trace-context and retention seams stay, empty.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

from dist_keras_tpu_torch.utils import knobs

_lock = threading.Lock()
_resolved = False      # has the DK_OBS_DIR decision been made?
_writer = None         # EventWriter when enabled, None when disabled
_warned = False        # one dropped-event warning per process
_ctx_provider = None   # current trace identity per thread (a seam)
_retainer = None       # tail-based trace-retention policy (a seam)


def _set_context_provider(fn):
    """Register a trace-context provider (the JAX package's
    ``spans._current_ids``; the port has none yet): every emitted event
    is stamped with the current thread's open-span trace identity via
    ``setdefault``."""
    global _ctx_provider
    _ctx_provider = fn


def _set_retainer(fn):
    """Register a tail-based retention policy (the JAX package's
    ``flight.TraceRetention.offer``; the port has none yet): called with
    each fully-stamped record and the writer BEFORE the file write;
    returning True means the policy took custody and the record is not
    written now.  ``None`` (the default) keeps the write path
    untouched."""
    global _retainer
    _retainer = fn


# The event vocabulary — every ``kind`` a seam of either package emits,
# the JAX package's list as it stands.  Adding an emit("...") call site?
# Register the kind here and in the JAX package's list.  A flat tuple:
# report tooling treats it as the closed set of kinds it can attribute.
KNOWN_EVENTS = (
    # training lifecycle (trainers/base.py, trainers/chunking.py)
    "train_start", "train_end", "epoch_end", "chunk", "resume",
    "metrics",
    # spans (observability/spans.py)
    "span_begin", "span_end",
    # checkpointing (checkpoint.py)
    "ckpt_save", "ckpt_promote", "ckpt_restore", "ckpt_verify",
    "ckpt_corrupt",
    "ckpt_async_enqueue", "ckpt_async_coalesced", "ckpt_async_error",
    # differential + remote checkpoint tier (checkpoint.py,
    # resilience/store.py)
    "ckpt_diff", "ckpt_gc", "ckpt_push", "ckpt_pull",
    "ckpt_remote_prune",
    # resilience seams
    "retry", "retry_exhausted", "fault", "nonfinite", "nan_halt",
    "preempt_signal", "preempt", "preempt_exit",
    "coord", "coord_error", "barrier", "peer_dead",
    "supervisor_restart", "supervisor_giveup",
    "elastic_resize", "reshard_restore",
    # serving (serving/)
    "serve_enqueue", "serve_batch_flush", "serve_batch_error",
    "serve_predict", "serve_predict_error",
    "serve_reload", "serve_reload_error", "reload_skipped_corrupt",
    "serve_listen", "serve_drain_begin", "serve_drain_signal",
    "serve_drain",
    # serving router + autoscaler (serving/router.py,
    # serving/autoscale.py, serving/reload.py)
    "route_evict", "route_readmit", "route_cutover",
    "autoscale_resize",
    # parameter-server training mode (ps/)
    "ps_pull", "ps_commit", "ps_stale_scaled",
    "ps_worker_join", "ps_worker_lapse",
    # fused flash backward graduation (ops/pallas)
    "fused_bwd_rejected",
    # telemetry plane (observability/)
    "perf_sample", "watchdog_alert", "watchdog_clear",
    "metrics_exporter_listen", "flight_dump",
    # SLO plane (observability/slo.py)
    "slo_transition",
    # bench driver (repo-root bench.py)
    "bench_probe_begin", "bench_probe_end", "bench_config_begin",
    "bench_config_end", "bench_config_skipped", "bench_complete",
    # cluster simulator (sim/)
    "sim_scenario_begin", "sim_scenario_end",
    # continuous-batching decode engine (serving/decode.py,
    # ops/pallas/decode_attention.py)
    "decode_admit", "decode_prefill", "decode_step",
    "decode_complete", "decode_cancel", "decode_error",
    "decode_drain", "decode_kernel_rejected",
    # decode survivability (serving/decode.py): replica quarantine +
    # sequence-level recovery, deadline rejection/expiry, brownout
    # shedding, allocator self-check leak reports
    "decode_quarantine", "decode_recover", "decode_deadline",
    "decode_shed", "decode_kv_leak",
    # router hedged retries + streaming relay (serving/router.py)
    "route_hedge", "route_stream_error",
)


def _default_rank():
    """This host's rank from the environment alone: the coordination
    identity wins, then the launcher's ``RANK``, then 0."""
    for v in (knobs.raw("DK_COORD_RANK"), os.environ.get("RANK")):
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    return 0


class EventWriter:
    """Append-only JSONL writer for one host's event file.

    Exposed as a class (rather than only the module-level singleton) so
    tests and launcher-side tools can write a specific rank's file
    explicitly; training code should use :func:`emit`.
    """

    def __init__(self, directory, rank=None, fsync=None,
                 rotate_bytes=None, rotate_keep=None):
        self.directory = os.path.abspath(os.path.expanduser(directory))
        self.rank = _default_rank() if rank is None else int(rank)
        if fsync is None:
            # registry bool convention ("fsync" is just another truthy
            # spelling); unset -> the registered False default
            fsync = knobs.get("DK_OBS_FLUSH")
        self.fsync = bool(fsync)
        if rotate_bytes is None:
            # registry-parsed: malformed falls back to the registered
            # default (log unbounded, not die)
            rotate_bytes = int(knobs.get("DK_OBS_ROTATE_MB") * 2**20)
        self.rotate_bytes = max(0, int(rotate_bytes))  # 0 = never rotate
        if rotate_keep is None:
            rotate_keep = int(knobs.get("DK_OBS_ROTATE_KEEP"))
        self.rotate_keep = max(1, int(rotate_keep))
        self.path = os.path.join(self.directory,
                                 f"events-rank_{self.rank}.jsonl")
        os.makedirs(self.directory, exist_ok=True)
        self._fd = os.open(self.path,
                           os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            self._bytes = os.fstat(self._fd).st_size
        except OSError:  # pragma: no cover - exotic fs
            self._bytes = 0
        self._seq = 0
        self._lock = threading.Lock()

    def _rotate(self):
        """Shift ``path.N`` -> ``path.N+1`` (dropping past ``keep``),
        retire the active file to ``path.1``, open a fresh one.  Caller
        holds the lock; ``seq`` keeps counting, so the merged timeline
        orders seamlessly across segments.

        The OLD fd closes LAST: POSIX renames follow the open file, so
        every step up to the new ``os.open`` leaves ``self._fd`` valid —
        a rotation that dies midway (ENOSPC, a log cleaner racing the
        shifts) keeps appending to the still-open descriptor and simply
        retries at the next emit, instead of stranding a CLOSED fd
        number that a later ``os.write`` could spray into whatever
        unrelated file the process reused it for."""
        last = f"{self.path}.{self.rotate_keep}"
        if os.path.exists(last):
            os.remove(last)
        for i in range(self.rotate_keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        old = self._fd
        self._fd = os.open(self.path,
                           os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        self._bytes = 0
        try:
            os.close(old)
        except OSError:  # pragma: no cover - double close
            pass

    def make_record(self, kind, **fields):
        """Stamp one record (``t``/``seq``/``rank``/``kind`` + fields)
        WITHOUT writing it.  Split from :meth:`write` for tail-based
        retention: a buffered record keeps its event-time stamps, so a
        trace flushed seconds later still merges into the timeline at
        the instant it happened (the report sorts by ``(t, rank,
        seq)``, not file order)."""
        with self._lock:
            seq = self._seq
            self._seq += 1
        record = {"t": time.time(), "seq": seq, "rank": self.rank,
                  "kind": str(kind)}
        record.update(fields)
        return record

    def emit(self, kind, **fields):
        """Write one event line; -> the record dict.  Raises on failure — the module-level
        :func:`emit` is the never-throws wrapper."""
        return self.write(self.make_record(kind, **fields))

    def write(self, record):
        """Serialize + append one already-stamped record; -> it."""
        # default=str: an event must not be droppable by an exotic field
        # type (numpy scalar, Path, exception instance)
        line = (json.dumps(record, default=str) + "\n").encode("utf-8")
        if not self.rotate_bytes:
            # unbounded log: the O_APPEND write alone is the atomicity
            # story — concurrent writers need no lock at all
            os.write(self._fd, line)
            if self.fsync:
                os.fsync(self._fd)
            return record
        # size-capped log: the write, the size check and a possible
        # rotation must be one unit, or a concurrent writer could emit
        # into a just-retired fd
        with self._lock:
            os.write(self._fd, line)
            if self.fsync:
                os.fsync(self._fd)
            self._bytes += len(line)
            if self._bytes >= self.rotate_bytes:
                self._rotate()
        return record

    def close(self):
        try:
            os.close(self._fd)
        except OSError:  # pragma: no cover - double close
            pass


def _resolve():
    global _resolved, _writer
    with _lock:
        if _resolved:
            return
        directory = knobs.raw("DK_OBS_DIR")
        if directory:
            try:
                _writer = EventWriter(directory)
            # event-log open failure degrades to disabled + one warning
            except Exception as e:
                _warn_once(f"could not open event log in "
                           f"{directory!r}: {e!r}")
                _writer = None
        _resolved = True


def _warn_once(msg):
    global _warned
    if _warned:
        return
    _warned = True
    print(f"[dk.observability] WARNING: {msg} — further events are "
          "dropped silently", file=sys.stderr, flush=True)


def enabled():
    """True iff ``DK_OBS_DIR`` selected an event log (cached; call
    :func:`reset` after changing the env)."""
    if not _resolved:
        _resolve()
    return _writer is not None


def obs_dir():
    """The active event-log directory, or None when disabled."""
    if not _resolved:
        _resolve()
    return _writer.directory if _writer is not None else None


def rank():
    """The active writer's rank (None when disabled) — lets seams make
    leader-only decisions (e.g. who writes the merged report) without
    re-deriving the identity env."""
    if not _resolved:
        _resolve()
    return _writer.rank if _writer is not None else None


def emit(kind, **fields):
    """Emit one structured event — the seam-facing entry point.

    No-op when ``DK_OBS_DIR`` is unset (one boolean check).  NEVER
    raises: a failed write degrades to a dropped event plus one warning,
    because this is called from checkpoint commits, signal-adjacent
    paths and retry loops that must not die of their own telemetry.
    """
    if not _resolved:
        _resolve()
    w = _writer
    if w is None:
        return
    try:
        prov = _ctx_provider
        if prov is not None:
            ctx = prov()
            if ctx:
                for k, v in ctx.items():
                    fields.setdefault(k, v)
        rec = w.make_record(kind, **fields)
        ret = _retainer
        if ret is not None and ret(rec, w):
            # retention took custody: written (or dropped) when the
            # request ends — the tail-based decision point
            return
        w.write(rec)
    # the never-throws emit contract: dropped event + one warning
    except Exception as e:
        _warn_once(f"event emit failed ({kind}): {e!r}")


def reset():
    """Close the writer and forget the cached ``DK_OBS_DIR`` decision —
    tests that flip the env need a fresh resolution."""
    global _resolved, _writer, _warned, _retainer
    with _lock:
        if _writer is not None:
            _writer.close()
        _writer = None
        _resolved = False
        _warned = False
        _retainer = None
