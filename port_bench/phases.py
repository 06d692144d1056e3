"""The program's phase records (``observability/perf.py``
``perf.records``) as the phase readers take them.

The records are read in the rank process, after the traced window, with
``block=True`` so that every device time is in.  A program without
them (one older than its phase clock) gives None, and so does every
reader then.

TP step: the ``tp.step`` records of the untraced window are
``[-(n + m):-m]`` of all of them, n the window's steps
(``facts["window_steps"]``) and m the traced window's; a phase of a step
is its child of that name.  ADAG: the untraced ``train`` call lies
between the last two ``layout`` records (the window is one call, and
the traced call follows it); its ``shard`` is the last one before its
``layout``.
"""

from __future__ import annotations

import statistics


def records():
    """Every phase record of this process, or None."""
    try:
        from dist_keras_tpu_torch.observability import perf
    except ImportError:
        return None
    read = getattr(perf, "records", None)
    return read(block=True) if read is not None else None


def window_steps(trace, recs=None):
    """The ``tp.step`` records of the untraced window, or None."""
    recs = records() if recs is None else recs
    n, m = trace.facts.get("window_steps"), trace.steps
    if not recs or not n:
        return None
    steps = [r for r in recs if r["name"] == "tp.step"]
    if len(steps) < n + m:
        return None
    return steps[len(steps) - n - m:len(steps) - m]


def median_ms(values):
    values = [v for v in values if v is not None]
    return statistics.median(values) * 1e3 if values else None


def tp_phase_ms(trace, name, recs=None):
    """The median device time (ms) of the window steps' ``name`` phase."""
    recs = records() if recs is None else recs
    steps = window_steps(trace, recs)
    if not steps:
        return None
    seqs = {r["seq"] for r in steps}
    return median_ms(r["device_s"] for r in recs
                     if r["name"] == name and r["parent"] in seqs)


def untraced_call(recs):
    """(its ``shard`` record or None, its ``layout`` record, the records
    up to the next call's ``layout``) of the untraced ``train`` call, or
    None."""
    if not recs:
        return None
    layouts = [i for i, r in enumerate(recs) if r["name"] == "layout"]
    if len(layouts) < 2:
        return None
    lo, hi = layouts[-2], layouts[-1]
    shard = next((r for r in reversed(recs[:lo]) if r["name"] == "shard"),
                 None)
    return shard, recs[lo], recs[lo:hi]
