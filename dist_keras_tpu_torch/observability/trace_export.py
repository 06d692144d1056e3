"""Chrome trace-event export — open a run in Perfetto.

Turns a merged event timeline (``report.read_events``) or a set of
flight-recorder dumps (``flight.read_dumps``) into Chrome trace-event
JSON (the ``{"traceEvents": [...]}`` shape ``ui.perfetto.dev`` and
``chrome://tracing`` both load):

- every ``span_end`` record becomes a complete ("X") slice — track =
  (rank as pid, emitting thread as tid), wall-clock microseconds,
  ``args`` carrying the trace identity (``trace_id``/``span_id``/
  ``parent_id``) and the span's own fields;
- a parent→child edge that crosses a thread or a host becomes a flow
  arrow ("s"/"f" pair keyed by the child's span id) — the serving
  handler→batcher→replica handoff and the trainer→async-writer
  checkpoint handoff render as connected arrows, and two hosts' dumps
  stitch into one timeline because both sides carry the same
  ``trace_id``;
- breadcrumb events (``chunk``, ``ckpt_save``, ``preempt``,
  ``watchdog_alert``, ...) become thread-scoped instants so the
  incident context sits inline with the slices.

:func:`connected_traces` is the verification half: it groups spans by
``trace_id`` and reports, per trace, the roots (no ``parent_id``), any
ORPHANS (a ``parent_id`` that resolves to no span in the trace — a
broken link), and which edges crossed threads/ranks — the ``--obs-only``
gate asserts every serving request is one fully connected trace.
"""

from __future__ import annotations

import json

# registry snapshots and sampler ticks are bulk payloads, not moments —
# rendering them as instants buries the timeline
_SKIP_INSTANTS = ("metrics", "perf_sample", "span_begin", "span_end")


def _span_ends(records, trace_id=None):
    out = []
    for ev in records:
        if ev.get("kind") != "span_end":
            continue
        if trace_id is not None and ev.get("trace_id") != trace_id:
            continue
        out.append(ev)
    return out


def _slice_ts_us(ev):
    """Slice start in wall-clock microseconds: ``span_at`` records
    carry an explicit ``t0``; live spans emit ``span_end`` right at the
    end, so start = emit time - duration."""
    dur = float(ev.get("duration_s", 0.0) or 0.0)
    t0 = ev.get("t0")
    if t0 is None:
        t0 = float(ev.get("t", 0.0)) - dur
    return float(t0) * 1e6, dur * 1e6


def chrome_trace(records, trace_id=None, instants=True):
    """-> the Chrome trace-event document for a merged timeline.

    ``records``: ``report.read_events`` or ``flight.read_dumps``
    output.  ``trace_id`` restricts the export to one trace (spans
    only; instants are rank-wide context and stay unless ``instants``
    is off)."""
    spans = _span_ends(records, trace_id=trace_id)
    events = []
    seen_tracks = {}  # (pid, tid) -> True (thread_name metadata once)
    seen_pids = set()
    index = {}        # span_id -> (pid, tid, ts_us)
    for ev in spans:
        pid = int(ev.get("rank", 0))
        tid = int(ev.get("tid", 0) or 0)
        ts, dur = _slice_ts_us(ev)
        sid = ev.get("span_id")
        if sid:
            index[sid] = (pid, tid, ts)
        if pid not in seen_pids:
            seen_pids.add(pid)
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": f"rank {pid}"}})
        if (pid, tid) not in seen_tracks:
            seen_tracks[(pid, tid)] = True
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": f"tid {tid}"}})
        args = {k: v for k, v in ev.items()
                if k not in ("t", "seq", "kind", "tid", "t0")}
        events.append({"ph": "X", "name": str(ev.get("span", "?")),
                       "cat": "span", "pid": pid, "tid": tid,
                       "ts": ts, "dur": max(dur, 1.0), "args": args})
    # flow arrows for every cross-thread / cross-host parent edge
    for ev in spans:
        parent = ev.get("parent_id")
        sid = ev.get("span_id")
        if not parent or parent not in index or not sid:
            continue
        ppid, ptid, pts = index[parent]
        cpid = int(ev.get("rank", 0))
        ctid = int(ev.get("tid", 0) or 0)
        if (ppid, ptid) == (cpid, ctid):
            continue  # same track: nesting already shows the edge
        cts, _ = _slice_ts_us(ev)
        events.append({"ph": "s", "cat": "handoff", "name": "handoff",
                       "id": sid, "pid": ppid, "tid": ptid, "ts": pts})
        events.append({"ph": "f", "cat": "handoff", "name": "handoff",
                       "bp": "e", "id": sid, "pid": cpid, "tid": ctid,
                       "ts": max(cts, pts)})
    # critical-path flow arrows: the dominant chain of each
    # request renders as its own arrow family, so Perfetto shows WHERE
    # a slow request's time went without hand-tracing the tree
    traces = {}
    for ev in spans:
        tr = ev.get("trace_id")
        if tr:
            traces.setdefault(tr, []).append(ev)
    for tr, tspans in sorted(traces.items()):
        cp = critical_path(tspans)
        if cp is None or len(cp["path"]) < 2:
            continue
        for parent_hop, child_hop in zip(cp["path"], cp["path"][1:]):
            sid = child_hop.get("span_id")
            if not sid or sid not in index \
                    or parent_hop.get("span_id") not in index:
                continue
            ppid, ptid, pts = index[parent_hop["span_id"]]
            cpid, ctid, cts = index[sid]
            events.append({"ph": "s", "cat": "critical_path",
                           "name": "critical_path", "id": f"cp-{sid}",
                           "pid": ppid, "tid": ptid, "ts": pts})
            events.append({"ph": "f", "cat": "critical_path",
                           "name": "critical_path", "bp": "e",
                           "id": f"cp-{sid}", "pid": cpid, "tid": ctid,
                           "ts": max(cts, pts)})
    if instants:
        for ev in records:
            kind = ev.get("kind", "?")
            if kind in _SKIP_INSTANTS:
                continue
            events.append({
                "ph": "i", "s": "t", "name": str(kind), "cat": "event",
                "pid": int(ev.get("rank", 0)),
                "tid": int(ev.get("tid", 0) or 0),
                "ts": float(ev.get("t", 0.0)) * 1e6,
                "args": {k: v for k, v in ev.items()
                         if k not in ("t", "seq", "kind", "tid")}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path, records, trace_id=None, instants=True):
    """Write :func:`chrome_trace` output to ``path``; -> the event
    count (load the file at ``ui.perfetto.dev`` → "Open trace file")."""
    doc = chrome_trace(records, trace_id=trace_id, instants=instants)
    with open(path, "w") as f:
        json.dump(doc, f, default=str)
    return len(doc["traceEvents"])


# span name -> hop category for the per-request latency attribution
# table (suffix-matched on the dotted path, so a root nested under an
# outer span still classifies)
_HOP_CATEGORY = {
    "serve.client": "client_overhead",
    "route.forward": "forward_hop",
    "serve.request": "host_overhead",
    "serve.queue_wait": "queue_wait",
    "serve.batch": "batch",
    "serve.exec": "replica_compute",
    "serve.reload": "reload_stall",
}


def _category(span_name):
    path = str(span_name)
    for name, cat in _HOP_CATEGORY.items():
        if path == name or path.endswith("." + name):
            return cat
    return "other"


def _interval_s(ev):
    ts, dur = _slice_ts_us(ev)
    return ts / 1e6, (ts + dur) / 1e6


def _union_len(intervals):
    """Total length of a union of (a, b) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if end is None or a >= end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def critical_path(spans):
    """Per-request latency attribution over ONE trace's ``span_end``
    records (possibly spanning ranks — the router-stitched tree).

    -> ``{"trace_id", "root", "rank", "total_s", "path": [hop, ...],
    "by_category": {category: seconds}, "critical": hop}`` or None
    when the trace has no usable root.

    Two complementary views of the same tree:

    - ``by_category``: exact decomposition of the root's elapsed time
      by hop SELF time (duration minus the union of direct children's
      overlap), so queue wait vs forward hop vs replica compute vs
      reload stall sum to the total — nothing double-counted, nothing
      lost;
    - ``path``: the dominant chain root -> deepest hop, descending
      into the longest child at each level (each hop:
      ``{"span", "category", "rank", "tid", "duration_s", "self_s"}``)
      — the "where did THIS request's time go" answer; ``critical``
      is the single hop with the largest self time anywhere in the
      tree (the one to fix).
    """
    by_id = {ev["span_id"]: ev for ev in spans if ev.get("span_id")}
    children = {}
    roots = []
    for ev in spans:
        parent = ev.get("parent_id")
        if parent and parent in by_id:
            children.setdefault(parent, []).append(ev)
        else:
            roots.append(ev)
    if not roots:
        return None
    root = max(roots, key=lambda ev: float(ev.get("duration_s", 0.0)
                                           or 0.0))

    def _hop(ev):
        a, b = _interval_s(ev)
        kids = children.get(ev.get("span_id"), ())
        overlap = _union_len(
            [(max(a, ka), min(b, kb))
             for ka, kb in (_interval_s(k) for k in kids)])
        return {
            "span": str(ev.get("span", "?")),
            "category": _category(ev.get("span", "")),
            "rank": int(ev.get("rank", 0)),
            "tid": int(ev.get("tid", 0) or 0),
            "span_id": ev.get("span_id"),
            "duration_s": round(max(0.0, b - a), 6),
            "self_s": round(max(0.0, (b - a) - overlap), 6),
        }

    # exact decomposition: every reachable node's self time, grouped
    by_category = {}
    hops = []
    stack = [root]
    seen = set()
    while stack:
        ev = stack.pop()
        sid = ev.get("span_id")
        if sid in seen:
            continue
        seen.add(sid)
        hop = _hop(ev)
        hops.append(hop)
        by_category[hop["category"]] = round(
            by_category.get(hop["category"], 0.0) + hop["self_s"], 6)
        stack.extend(children.get(sid, ()))
    # the dominant chain: descend into the longest child each level
    path = []
    ev = root
    while ev is not None:
        path.append(_hop(ev))
        kids = children.get(ev.get("span_id"), ())
        ev = max(kids, key=lambda k: float(k.get("duration_s", 0.0)
                                           or 0.0)) if kids else None
    critical = max(hops, key=lambda h: h["self_s"])
    return {
        "trace_id": root.get("trace_id"),
        "root": str(root.get("span", "?")),
        "rank": int(root.get("rank", 0)),
        "total_s": round(float(root.get("duration_s", 0.0) or 0.0), 6),
        "path": path,
        "by_category": by_category,
        "critical": critical,
    }


def request_paths(records, worst=None):
    """:func:`critical_path` for every trace in a merged timeline,
    sorted worst-first by root duration (``worst`` caps the list) —
    the report's exemplar-linked worst-N table: each row's
    ``trace_id`` is exactly what a scrape exemplar references."""
    traces = {}
    for ev in _span_ends(records):
        tr = ev.get("trace_id")
        if tr:
            traces.setdefault(tr, []).append(ev)
    out = []
    for spans in traces.values():
        cp = critical_path(spans)
        if cp is not None:
            out.append(cp)
    out.sort(key=lambda cp: cp["total_s"], reverse=True)
    return out[:worst] if worst else out


def connected_traces(records):
    """Connectivity report per ``trace_id`` over the ``span_end``
    records of a merged timeline:

    ``{trace_id: {"spans": n, "roots": [span names], "orphans":
    [span names], "ranks": [...], "cross_thread": n, "cross_rank": n,
    "connected": bool}}``

    ``connected`` means every span reaches a root of its trace via
    ``parent_id`` links — the acceptance shape for "one request is one
    trace"."""
    traces = {}
    for ev in _span_ends(records):
        tr = ev.get("trace_id")
        if not tr:
            continue
        traces.setdefault(tr, []).append(ev)
    out = {}
    for tr, spans in traces.items():
        ids = {ev["span_id"]: ev for ev in spans if ev.get("span_id")}
        roots, orphans = [], []
        cross_thread = cross_rank = 0
        for ev in spans:
            parent = ev.get("parent_id")
            if parent is None:
                roots.append(ev.get("span", "?"))
            elif parent not in ids:
                orphans.append(ev.get("span", "?"))
            else:
                pev = ids[parent]
                if pev.get("rank") != ev.get("rank"):
                    cross_rank += 1
                elif pev.get("tid") != ev.get("tid"):
                    cross_thread += 1
        out[tr] = {
            "spans": len(spans),
            "roots": sorted(roots),
            "orphans": sorted(orphans),
            "ranks": sorted({int(ev.get("rank", 0)) for ev in spans}),
            "cross_thread": cross_thread,
            "cross_rank": cross_rank,
            "connected": not orphans and bool(roots),
        }
    return out


def render_traces(records):
    """Human-readable per-trace connectivity summary (the CLI's
    ``--traces`` section)."""
    traces = connected_traces(records)
    if not traces:
        return ("no traced spans found (spans carry trace ids when "
                "DK_OBS_DIR was set during the run)")
    lines = [f"# traces ({len(traces)})"]
    for tr, row in sorted(traces.items()):
        mark = "ok " if row["connected"] else "BROKEN"
        lines.append(
            f"{mark} {tr}: {row['spans']} spans, roots "
            f"{row['roots']}, ranks {row['ranks']}, "
            f"{row['cross_thread']} thread-handoffs, "
            f"{row['cross_rank']} host-handoffs"
            + (f", ORPHANS {row['orphans']}" if row["orphans"] else ""))
    return "\n".join(lines)
