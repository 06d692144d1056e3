"""The port's run report (``dist_keras_tpu_torch/observability/report.py``)
against the JAX package's on the same event directories: a synthetic one
(the PS attribution, preemption, checkpoints, decode survivability,
perf samples, a torn line, rotated segments and a ``host_N/`` subdir) and
one written by a run of the port's ``PSServer``.  ``summarize``,
``perf_summary``, ``read_events`` and ``event_files`` agree exactly,
and ``render`` / ``write_report`` print the same text, but for the
retrace column, which the port does not have (eager PyTorch compiles
nothing): its perf summary and ``--perf`` text are the JAX package's
without it."""

import json
import re
import time

import numpy as np
import pytest

from dist_keras_tpu.observability import report as jreport
from dist_keras_tpu_torch.observability import events
from dist_keras_tpu_torch.observability import report
from dist_keras_tpu_torch.ps import PSClient, PSServer

_PS_EVENTS = [
    {"t": 1.0, "rank": 0, "kind": "ps_worker_join", "wid": "w0",
     "worker_rank": 3, "rejoined": False},
    {"t": 2.0, "rank": 0, "kind": "ps_commit", "wid": "w0",
     "version": 1, "staleness": 0, "scale": 1.0},
    {"t": 3.0, "rank": 0, "kind": "ps_commit", "wid": "w0",
     "version": 2, "staleness": 2, "scale": 1 / 3},
    {"t": 4.0, "rank": 0, "kind": "ps_stale_scaled", "wid": "w1",
     "staleness": 9, "cap": 4, "rejected": True},
    {"t": 5.0, "rank": 0, "kind": "ps_worker_lapse", "wid": "w0",
     "reason": "lease"},
]

_OTHER_EVENTS = [
    {"t": 0.5, "seq": 0, "rank": 1, "kind": "span_end",
     "span": "train.run", "duration_s": 2.5},
    {"t": 0.6, "seq": 1, "rank": 1, "kind": "coord", "op": "barrier",
     "duration_s": 0.1},
    {"t": 0.7, "seq": 2, "rank": 1, "kind": "retry", "name": "ps.pull"},
    {"t": 0.8, "seq": 3, "rank": 1, "kind": "retry_exhausted",
     "name": "ps.commit"},
    {"t": 0.9, "seq": 4, "rank": 1, "kind": "fault", "point": "ps.join"},
    {"t": 1.1, "seq": 5, "rank": 1, "kind": "ckpt_save", "step": 4},
    {"t": 1.2, "seq": 6, "rank": 1, "kind": "ckpt_promote", "step": 4},
    {"t": 1.3, "seq": 7, "rank": 1, "kind": "epoch_end",
     "nonfinite_steps": 2},
    {"t": 1.4, "seq": 8, "rank": 1, "kind": "preempt_signal",
     "signum": 15},
    {"t": 1.5, "seq": 9, "rank": 1, "kind": "decode_quarantine",
     "replica": 0, "orphans": 3, "cause": "kill"},
    {"t": 1.6, "seq": 10, "rank": 1, "kind": "decode_recover", "dst": 1},
    {"t": 1.7, "seq": 11, "rank": 1, "kind": "decode_deadline",
     "phase": "admission"},
    {"t": 1.8, "seq": 12, "rank": 1, "kind": "perf_sample",
     "retraces": 1, "dispatches": 9, "phases": {}},
    {"t": 1.9, "seq": 13, "rank": 1, "kind": "metrics",
     "counters": {"perf.dispatches": 4},
     "histograms": {"perf.phase.step": {"count": 2, "total": 0.5}}},
    {"t": 2.1, "seq": 14, "rank": 1, "kind": "watchdog_alert",
     "rule": "stall", "seconds": 3.0},
]


def _write(path, evs, torn=False):
    path.parent.mkdir(parents=True, exist_ok=True)
    text = "".join(json.dumps(e) + "\n" for e in evs)
    if torn:
        text += '{"t": 9.9, "kind": "ps_co'
    path.write_text(text)


@pytest.fixture
def synthetic_dir(tmp_path):
    d = tmp_path / "obs"
    _write(d / "events-rank_0.jsonl", _PS_EVENTS, torn=True)
    _write(d / "events-rank_1.jsonl.1", _OTHER_EVENTS[:6])
    _write(d / "host_1" / "events-rank_1.jsonl", _OTHER_EVENTS[6:])
    return d


def _same_everywhere(d):
    evs, jevs = report.read_events(str(d)), jreport.read_events(str(d))
    assert evs == jevs
    assert [p for _, p in report.event_files(str(d))] == [
        p for _, p in jreport.event_files(str(d))]
    assert report.summarize(evs) == jreport.summarize(jevs)
    assert report.perf_summary(evs) == _without_retraces(
        jreport.perf_summary(jevs))
    assert report.render(str(d)) == jreport.render(str(d))
    assert report.render_perf(str(d)) == re.sub(
        r"retraces=\d+ ", "", jreport.render_perf(str(d)))
    return report.summarize(evs)


def _without_retraces(summary):
    """The JAX package's perf summary less its retrace column: eager
    PyTorch compiles nothing, so the port reports no retraces."""
    for row in summary["per_rank"].values():
        del row["retraces"]
    return summary


def test_synthetic_directory_summarizes_like_jax(synthetic_dir, tmp_path):
    s = _same_everywhere(synthetic_dir)
    assert s["ps"]["commits_by_worker"] == {"w0": 2}
    assert s["ps"]["staleness_hist"] == {0: 1, 2: 1}
    assert s["ps"]["rejected_stale"] == 1
    assert s["ps"]["joins"] == [{"wid": "w0", "rank": 3,
                                 "rejoined": False}]
    assert s["ps"]["lapses"][0]["reason"] == "lease"
    assert s["preempt_signalled"] == {1: 15}
    assert s["checkpoints"]["promoted"] == [4]
    assert s["nonfinite_steps"] == 2
    assert s["decode"]["deadline"]["infeasible"] == 1
    assert report.summarize(report.read_events(str(synthetic_dir)))[
        "n_events"] == len(_PS_EVENTS) + len(_OTHER_EVENTS)
    out = report.write_report(str(synthetic_dir),
                              out_path=str(tmp_path / "mine.txt"))
    jout = jreport.write_report(str(synthetic_dir),
                                out_path=str(tmp_path / "theirs.txt"))
    text = open(out).read()
    assert text == open(jout).read()
    assert "parameter server: commits by worker: w0 x2" in text
    assert "over-cap commits refused (typed): 1" in text


def test_empty_directory(tmp_path):
    assert report.read_events(str(tmp_path)) == []
    assert "no events found" in report.render(str(tmp_path))
    assert report.render(str(tmp_path)) == jreport.render(str(tmp_path))


def test_port_server_run_is_attributed(tmp_path, monkeypatch):
    """A port ``PSServer`` run's event log: joins, commits (one stale by
    1), and the lapses the reaper writes, attributed alike by both
    packages' reports."""
    d = tmp_path / "obs"
    monkeypatch.setenv("DK_OBS_DIR", str(d))
    events.reset()
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32)}
    try:
        srv = PSServer(params=params, port=0, lease_s=0.2)
        srv.start()
        try:
            addr = "%s:%d" % srv.address
            c = PSClient(addr, attempts=2, backoff=0.01, rpc_timeout_s=30)
            j = c.join(rank=1)
            c.commit(j["wid"], 0, {"w": np.ones((4, 3), np.float32)})
            c2 = PSClient(addr, attempts=2, backoff=0.01, rpc_timeout_s=30)
            j2 = c2.join()
            c2.commit(j2["wid"], 0, {"w": np.ones((4, 3), np.float32)})
            deadline = time.time() + 10
            while (srv.center.stats()["workers"] > 0
                   and time.time() < deadline):
                time.sleep(0.05)
            assert srv.center.stats()["workers"] == 0
        finally:
            srv.close()
    finally:
        events.reset()
    s = _same_everywhere(d)
    assert sum(s["ps"]["commits_by_worker"].values()) == 2
    assert s["ps"]["staleness_hist"] == {0: 1, 1: 1}
    assert len(s["ps"]["joins"]) == 2
    assert {lp["wid"] for lp in s["ps"]["lapses"]} == {
        j["wid"] for j in s["ps"]["joins"]}
    assert all(lp["reason"] == "lease" for lp in s["ps"]["lapses"])
    assert s["phases"]["ps.commit"]["count"] == 2
    text = report.render(str(d))
    assert "parameter server: commits by worker" in text
    assert "worker lapse" in text
