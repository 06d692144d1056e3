"""The traced window: ``torch.profiler`` over a few steady steps, read
back from its Chrome trace into what the per-layer readers take.

Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events.  The window is the host range
:data:`WINDOW` that the harness opens after a synchronise and closes
after another, so every device operation of its steps lies inside it.
``busy_s`` is the union of the device operations' intervals,
``window_s`` the range's length; their difference is the card's idle
time, and its longest gaps are labelled with the innermost host
operation that was running when each began.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from collections import defaultdict

WINDOW = "port_bench.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
GEMM = re.compile(r"gemm|gemv|cutlass|nvjet|xmma|cublas|splitk", re.I)
ATTENTION = (("flash_fwd", "fwd"), ("flash_bwd_dq", "bwd_dq"),
             ("flash_bwd_dkv", "bwd_dkv"), ("flash_bwd_fused", "bwd_fused"))


def kind_of(name, cat="kernel"):
    """-> "memory", "collective", "attn:<launch>", "gemm" or "other"."""
    if cat != "kernel":
        return "memory"
    if name.startswith("nccl"):
        return "collective"
    for prefix, launch in ATTENTION:
        if prefix in name:
            return f"attn:{launch}"
    if GEMM.search(name):
        return "gemm"
    return "other"


class TraceView:
    """What a per-layer reader reads: the device operations of the
    traced window (``ops``: (name, kind, seconds)), ``busy_s`` and
    ``window_s``, the ``steps`` it holds, and the run's facts that the
    harness adds (``facts``: samples/s of the untraced window, FLOPs a
    sample, attention launch shapes, the untraced window's steps and
    collective stats)."""

    def __init__(self, ops, busy_s, window_s, steps, gaps, facts):
        self.ops, self.busy_s, self.window_s = ops, busy_s, window_s
        self.steps, self.gaps, self.facts = steps, gaps, facts

    def seconds(self, predicate):
        return sum(s for name, kind, s in self.ops if predicate(kind))

    def count(self, predicate):
        return sum(1 for name, kind, s in self.ops if predicate(kind))

    def breakdown(self, top=10):
        """{"device_ops": the ``top`` operations by total seconds,
        "idle_gaps": the ``top`` longest gaps by host operation}."""
        by_name = defaultdict(float)
        for name, _, s in self.ops:
            by_name[name[:160]] += s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.gaps[:top]]}


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_chrome_trace(path, steps, facts, top_gaps=10):
    """-> :class:`TraceView` of an exported Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window, device, host = None, [], []
    for e in events:
        cat, dur = e.get("cat"), e.get("dur")
        if dur is None:
            continue
        if cat in DEVICE_CATS:
            device.append((e["name"], cat, float(e["ts"]), float(dur)))
        elif cat in HOST_CATS:
            if e.get("name") == WINDOW:
                window = (float(e["ts"]), float(e["ts"]) + float(dur))
            else:
                host.append((float(e["ts"]), float(e["ts"]) + float(dur),
                             e["name"]))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW!r} range")
    lo, hi = window
    ops = [(n, kind_of(n, c), d * 1e-6) for n, c, ts, d in device]
    busy = _merge([(max(ts, lo), min(ts + d, hi)) for _, _, ts, d in device
                   if ts + d > lo and ts < hi])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top_gaps]
    host.sort()
    starts = [h[0] for h in host]
    labelled = []
    for length, at in gaps:
        i = bisect.bisect_right(starts, at)
        covering = [h for h in host[max(0, i - 4000):i] if h[1] >= at]
        name = (min(covering, key=lambda h: h[1] - h[0])[2] if covering
                else "no host operation")
        labelled.append((name, length * 1e-6))
    return TraceView(ops, busy_s, (hi - lo) * 1e-6, steps, labelled, facts)


def traced(run_steps, steps, facts_fn, cuda=True):
    """Run ``run_steps()`` (which enqueues the window's ``steps`` steps)
    under the profiler between two synchronises; -> :class:`TraceView`.
    ``facts_fn()`` is called after the window, for facts that the steps
    themselves produced.  The trace is written under ``TMPDIR`` and
    removed once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            run_steps()
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="port_bench_trace_", suffix=".json")
    os.close(fd)
    try:
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        view = read_chrome_trace(path, steps, facts_fn())
        view.facts["trace_read_s"] = time.perf_counter() - t0
    finally:
        os.unlink(path)
    return view
