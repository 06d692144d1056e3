"""The port's live observability plane against the JAX package's copies
on the same inputs: ``timeseries`` windows and snapshot folding, each
watchdog rule's firings (and the ``Watchdog``'s transition-only alerts),
``slo`` burn rates, the burn rule and ``breaching()``, ``flight``'s
tail-based retention decisions and ``tracez_doc``, ``trace_export``'s
Chrome trace JSON, critical paths and connectivity, ``prometheus.render``
with exemplars, ``report.render_slo`` / ``slo_summary``, ``statusz``
(apart from the ``build`` block, which reports torch where the JAX copy
reports jax), the events-to-flight seam, and the report CLI."""

import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

import dist_keras_tpu.observability.__main__ as jax_cli
import dist_keras_tpu_torch.observability.__main__ as cli
from dist_keras_tpu.observability import events as j_events
from dist_keras_tpu.observability import flight as j_flight
from dist_keras_tpu.observability import metrics as j_metrics
from dist_keras_tpu.observability import prometheus as j_prometheus
from dist_keras_tpu.observability import report as j_report
from dist_keras_tpu.observability import slo as j_slo
from dist_keras_tpu.observability import spans as j_spans
from dist_keras_tpu.observability import statusz as j_statusz
from dist_keras_tpu.observability import timeseries as j_timeseries
from dist_keras_tpu.observability import trace_export as j_trace_export
from dist_keras_tpu.observability import watchdog as j_watchdog
from dist_keras_tpu_torch.observability import (
    events,
    flight,
    metrics,
    prometheus,
    report,
    slo,
    spans,
    statusz,
    timeseries,
    trace_export,
    watchdog,
)

JAX = SimpleNamespace(events=j_events, flight=j_flight, metrics=j_metrics,
                      prometheus=j_prometheus, report=j_report, slo=j_slo,
                      spans=j_spans, statusz=j_statusz,
                      timeseries=j_timeseries, trace_export=j_trace_export,
                      watchdog=j_watchdog)
PORT = SimpleNamespace(events=events, flight=flight, metrics=metrics,
                       prometheus=prometheus, report=report, slo=slo,
                       spans=spans, statusz=statusz, timeseries=timeseries,
                       trace_export=trace_export, watchdog=watchdog)


def _reset(o):
    o.events.reset()
    o.metrics.reset()
    o.flight.reset()
    o.spans.reset()
    o.timeseries.reset()
    o.slo.reset()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("DK_OBS_DIR", "DK_SLO", "DK_TRACE_RETAIN", "DK_OBS_SAMPLE_S",
              "DK_TRACE_SEED", "DK_COORD_DIR", "DK_COORD_WORLD"):
        monkeypatch.delenv(k, raising=False)
    for o in (JAX, PORT):
        _reset(o)
    yield
    for o in (JAX, PORT):
        _reset(o)


def _both(fn, *args):
    """-> fn's result on each package; the test asserts them equal."""
    got = fn(PORT, *args)
    want = fn(JAX, *args)
    return got, want


def _lists(x):
    return json.loads(json.dumps(x, default=lambda a: np.asarray(a)
                                 .tolist()))


# -- timeseries ---------------------------------------------------------
def _timeseries(o, seed):
    rng = np.random.default_rng(seed)
    ts = o.timeseries.TimeSeries("x", window=16)
    t = np.cumsum(rng.uniform(0.1, 1.0, size=50)) + 100.0
    v = rng.normal(size=50)
    out = []
    for i in range(50):
        ts.append(float(v[i]), t=float(t[i]))
        if i % 7 == 0:
            out.append([ts.values(), ts.since(float(t[i]) - 2.0),
                        ts.span_s(), ts.total_appended, ts.latest])
    snap = {"counters": {"a.b": int(rng.integers(100))},
            "gauges": {"g": float(rng.normal()), "s": "text"},
            "histograms": {"h": {"count": 3, "total": 1.5,
                                 "p50": 0.4}}}
    o.timeseries.record_snapshot(snap, t=5.0)
    o.timeseries.record_snapshot(snap, t=6.0)
    out.append({n: o.timeseries.get(n).values()
                for n in o.timeseries.names()})
    return _lists(out)


@pytest.mark.parametrize("seed", range(3))
def test_timeseries_windows(seed):
    got, want = _both(_timeseries, seed)
    assert got == want


# -- watchdog rules -----------------------------------------------------
def _watchdog(o, seed):
    rng = np.random.default_rng(seed)
    ts = o.timeseries
    rules = [o.watchdog.StepTimeRegression(recent_s=5.0),
             o.watchdog.ThroughputStall("perf.dispatches", window_s=4.0,
                                        pending_metric="serve.pending"),
             o.watchdog.QueueDepthGrowth(samples=4, min_depth=8)]
    wd = o.watchdog.Watchdog(rules=[
        o.watchdog.StepTimeRegression(recent_s=5.0),
        o.watchdog.QueueDepthGrowth(samples=4, min_depth=8)])
    alerts = []
    wd.alert_sink = alerts.append
    count = total = disp = 0.0
    out = []
    for i in range(80):
        now = 1000.0 + i
        step = 0.02 if i < 50 else 0.02 * rng.uniform(2.5, 4.0)
        n = int(rng.integers(1, 5))
        count += n
        total += n * step * rng.uniform(0.9, 1.1)
        if i < 30 or i > 60:
            disp += int(rng.integers(1, 4))
        ts.series("perf.phase.step.count").append(count, t=now)
        ts.series("perf.phase.step.total").append(total, t=now)
        ts.series("perf.dispatches").append(disp, t=now)
        depth = (i % 20) * 1.5 if i % 40 < 20 else rng.uniform(0, 30)
        ts.series("serve.pending").append(float(depth), t=now)
        out.append([r.evaluate(now) for r in rules])
        wd.check(now=now)
    return _lists([out, alerts, wd.firing()])


@pytest.mark.parametrize("seed", range(3))
def test_watchdog_rules_fire_alike(seed):
    got, want = _both(_watchdog, seed)
    assert got == want
    firings = {i for tick in got[0] for i, (f, _) in enumerate(tick) if f}
    assert firings == {0, 1, 2}


def _heartbeat(o, coord):
    return _lists(o.watchdog.HeartbeatQuiet().evaluate(time.time()))


def test_heartbeat_quiet_reads_the_port_coordination(tmp_path,
                                                     monkeypatch):
    hb = tmp_path / "hb"
    hb.mkdir()
    now = time.time()
    for r, age in ((0, 0.0), (1, 600.0), (2, 0.0)):
        p = hb / f"rank_{r}"
        p.write_text("")
        os.utime(p, (now - age, now - age))
    monkeypatch.setenv("DK_COORD_DIR", str(tmp_path))
    monkeypatch.setenv("DK_COORD_WORLD", "3")
    got, want = _both(_heartbeat, tmp_path)
    assert got == want and got[0] is True
    assert got[1]["ranks"] == [1]


# -- SLO burn rates -----------------------------------------------------
def _slo(o, seed):
    rng = np.random.default_rng(seed)
    avail = {"good": 0.0, "total": 0.0}
    lat = {"good": 0.0, "total": 0.0}
    reg = o.slo.Registry()
    reg.register(o.slo.Objective(
        "serve_availability", 0.999,
        lambda: (avail["good"], avail["total"])))
    reg.register(o.slo.Objective(
        "serve_latency", 0.99, lambda: (lat["good"], lat["total"])))
    rule = o.slo.SLOBurnRate(registry=reg)
    out = []
    for i in range(120):
        n = float(rng.integers(50, 150))
        bad = n * (0.3 if 40 <= i < 60 else rng.uniform(0, 0.002))
        avail["good"] += n - bad
        avail["total"] += n
        lat["good"] += n - bad / 3
        lat["total"] += n
        reg.evaluate(i * 15.0)
        out.append([reg.results(), reg.breaching(),
                    rule.evaluate(i * 15.0)])
    obj = o.slo.latency("serve_latency", threshold_s=0.1, target=0.99)
    h = o.metrics.histogram("span.serve.request")
    for v in rng.uniform(0, 0.3, size=40):
        h.observe(float(v))
    out.append(obj.source())
    return _lists(out)


@pytest.mark.parametrize("seed", range(3))
def test_slo_burn_rates_and_rule(seed):
    got, want = _both(_slo, seed)
    assert got == want
    assert any(tick[1] for tick in got[:-1])


def _breaching(o):
    o.slo.reset()
    o.slo.install_defaults()
    out = [o.slo.breaching()]
    h = o.metrics.histogram("span.serve.request")
    for i in range(2):
        for _ in range(50):
            h.observe(9.0)
        o.slo.maybe_evaluate(1000.0 + i * 10.0)
    out.append(o.slo.breaching())
    out.append(o.slo.status_doc())
    return _lists(out)


def test_breaching_under_dk_slo(monkeypatch):
    monkeypatch.setenv("DK_SLO", "1")
    got, want = _both(_breaching)
    assert got == want
    assert got[0] == [] and "serve_latency" in got[1]


# -- flight: retention decisions and /tracez ----------------------------
def _retention(o, seed):
    rng = np.random.default_rng(seed)
    writes = []

    class W:
        def write(self, rec):
            writes.append(rec)

    r = o.flight.TraceRetention(slow_s=0.05, sample=0.0, budget=3)
    w = W()
    decisions = []
    open_traces = []
    for i in range(120):
        roll = rng.random()
        if roll < 0.3 or not open_traces:
            tid = f"{i:032x}"
            open_traces.append(tid)
            rec = {"kind": "span_begin", "span": "serve.request",
                   "trace_id": tid, "span_id": f"{i:016x}",
                   "parent_id": None, "t": float(i)}
        elif roll < 0.5:
            tid = open_traces[int(rng.integers(len(open_traces)))]
            rec = {"kind": rng.choice(["serve_enqueue",
                                       "serve_batch_error"]),
                   "trace_id": tid, "t": float(i)}
        elif roll < 0.6:
            rec = {"kind": "train_start", "t": float(i)}
        else:
            tid = open_traces.pop(int(rng.integers(len(open_traces))))
            rec = {"kind": "span_end", "span": "serve.request",
                   "trace_id": tid, "span_id": "e" * 16,
                   "parent_id": None, "t": float(i),
                   "duration_s": float(rng.choice([0.01, 0.2]))}
        decisions.append(r.offer(dict(rec), w))
    stats = r.stats()
    flushed = r.flush_all()
    return _lists([decisions, writes, stats, flushed, r.stats()])


@pytest.mark.parametrize("seed", range(3))
def test_retention_decisions(seed):
    got, want = _both(_retention, seed)
    assert got == want
    assert True in got[0] and False in got[0]


def _tracez(o, d):
    _reset(o)
    with o.spans.span("serve.request", n=2):
        o.events.emit("serve_enqueue", pending=1)
        o.events.emit("serve_batch_flush", n=2, rung=4)
    doc = o.flight.tracez_doc()
    drop = {"t", "t0", "tid", "pid", "duration_s", "trace_id", "span_id",
            "parent_id", "seq"}
    doc["records"] = [{k: v for k, v in rec.items() if k not in drop}
                      for rec in doc["records"]]
    _reset(o)
    return _lists(doc)


def test_tracez_doc(tmp_path, monkeypatch):
    monkeypatch.setenv("DK_OBS_DIR", str(tmp_path / "port"))
    got = _tracez(PORT, tmp_path)
    monkeypatch.setenv("DK_OBS_DIR", str(tmp_path / "jax"))
    want = _tracez(JAX, tmp_path)
    assert got == want
    assert [r["kind"] for r in got["records"]] == [
        "span_begin", "serve_enqueue", "serve_batch_flush", "span_end"]


def test_events_attach_the_flight_recorder_and_reset_detaches(
        tmp_path, monkeypatch):
    """The seam restored in the port's ``events``: the first resolution
    attaches the recorder (each record rung), ``reset`` detaches it."""
    monkeypatch.setenv("DK_OBS_DIR", str(tmp_path))
    events.reset()
    flight.reset()
    events.emit("train_start", trainer="t")
    assert events._sink is not None
    assert [r["kind"] for r in flight.recorder().records()] == \
        ["train_start"]
    events.reset()
    assert events._sink is None
    monkeypatch.delenv("DK_OBS_DIR")
    events.emit("train_start", trainer="t")
    assert len(flight.recorder().records()) == 1


# -- trace_export -------------------------------------------------------
def _span(rank, span, trace, sid, parent, t0, dur, **extra):
    return {"kind": "span_end", "rank": rank, "tid": 1, "span": span,
            "trace_id": trace, "span_id": sid, "parent_id": parent,
            "t": t0 + dur, "t0": t0, "duration_s": dur, "seq": 0,
            **extra}


def _records(seed):
    """A router-stitched trace (tests/test_slo.py's) plus seeded span
    trees across three ranks, one with an orphan."""
    trace = "ab" * 16
    recs = [
        _span(0, "serve.client", trace, "a" * 16, None, 0.0, 0.50),
        _span(0, "route.forward", trace, "b" * 16, "a" * 16, 0.01, 0.48),
        _span(1, "serve.request", trace, "c" * 16, "b" * 16, 0.02, 0.05,
              error="ConnectionError"),
        _span(2, "serve.request", trace, "d" * 16, "b" * 16, 0.08, 0.40),
        _span(2, "serve.request.serve.exec", trace, "e" * 16, "d" * 16,
              0.10, 0.30),
        {"kind": "serve_enqueue", "rank": 2, "tid": 3, "t": 0.09,
         "trace_id": trace, "span_id": "d" * 16, "seq": 1},
    ]
    rng = np.random.default_rng(seed)
    names = ["serve.request", "serve.queue_wait", "serve.exec",
             "route.forward", "ckpt.save"]
    for k in range(6):
        tr = f"{k + 1:032x}"
        ids = [f"{k:08x}{0:08x}"]
        t0 = float(k)
        recs.append(_span(int(rng.integers(3)), "serve.client", tr,
                          ids[0], None, t0, 1.0))
        for j in range(1, 6):
            sid = f"{k:08x}{j:08x}"
            parent = ids[int(rng.integers(len(ids)))]
            if k == 5 and j == 5:
                parent = "f" * 16      # an orphan
            a = t0 + float(rng.uniform(0, 0.5))
            recs.append(_span(int(rng.integers(3)),
                              names[int(rng.integers(len(names)))], tr,
                              sid, parent, a, float(rng.uniform(0, 0.4))))
            ids.append(sid)
    return recs


def _trace_export(o, seed):
    recs = _records(seed)
    te = o.trace_export
    spans_of = [r for r in recs if r["kind"] == "span_end"
                and r["trace_id"] == "ab" * 16]
    return _lists([te.chrome_trace(recs), te.chrome_trace(recs,
                                                          instants=False),
                   te.chrome_trace(recs, trace_id="ab" * 16),
                   te.critical_path(spans_of),
                   te.request_paths(recs), te.request_paths(recs, worst=2),
                   te.connected_traces(recs), te.render_traces(recs)])


@pytest.mark.parametrize("seed", range(3))
def test_trace_export(seed):
    got, want = _both(_trace_export, seed)
    assert got == want
    assert not all(row["connected"] for row in got[6].values())


# -- prometheus ---------------------------------------------------------
def _snapshot(seed):
    rng = np.random.default_rng(seed)
    hist = {}
    for name in ("span.serve.request", "serve.predict_s", "perf.phase.step"):
        vals = rng.uniform(0, 1, size=5)
        hist[name] = {"count": 5, "total": float(vals.sum()),
                      "mean": float(vals.mean()), "min": float(vals.min()),
                      "max": float(vals.max()), "p50": float(vals[2]),
                      "p95": float(vals[3]), "p99": float(vals[4])}
    hist["span.serve.request"]["exemplars"] = [
        {"value": float(v), "trace_id": f"{i:032x}", "span_id": f"{i:016x}",
         "t": 1.0 + i} for i, v in enumerate(rng.uniform(0, 1, size=3))]
    return {"counters": {"serve.completed": int(rng.integers(1000)),
                         "route.hedges": 2, "perf.dispatches": 0},
            "gauges": {"serve.pending": float(rng.integers(9)),
                       "route.backends_live": 2, "slo.burn": 0.5,
                       "odd name-x": 1.0, "not.numeric": "x"},
            "histograms": hist}


def _prometheus(o, seed):
    snap = _snapshot(seed)
    p = o.prometheus
    return [p.render(snap), p.render(snap, labels={"job": "serve"},
                                     extra_gauges={"serve.engine.x": 3,
                                                   "route.pool.live": 1},
                                     rank=4),
            p.metric_name("serve.predict_s"), p.CONTENT_TYPE]


@pytest.mark.parametrize("seed", range(3))
def test_prometheus_render_with_exemplars(seed):
    got, want = _both(_prometheus, seed)
    assert got == want
    assert any(line.startswith("# {") and 'trace_id="' in line
               for line in got[0].splitlines())


def _live_exemplars(o):
    with o.spans.span("serve.request"):
        o.metrics.histogram("span.serve.request").observe(0.7)
    text = o.prometheus.render(o.metrics.snapshot(percentiles=True))
    # the span's exit observes its own duration too: keep ours
    return [(len(line.split('"')[1]), len(line.split('"')[3]))
            for line in text.splitlines()
            if line.startswith("# {") and line.endswith(" 0.7")]


def test_exemplars_captured_under_open_span(tmp_path, monkeypatch):
    monkeypatch.setenv("DK_SLO", "1")
    monkeypatch.setenv("DK_OBS_DIR", str(tmp_path / "port"))
    got = _live_exemplars(PORT)
    monkeypatch.setenv("DK_OBS_DIR", str(tmp_path / "jax"))
    want = _live_exemplars(JAX)
    assert got == want == [(16, 32)]


# -- report: the SLO section --------------------------------------------
def _render_slo(o, seed):
    evs = [
        {"kind": "slo_transition", "rank": 1, "t": 10.0,
         "firing": ["serve_latency"], "cleared": []},
        {"kind": "watchdog_alert", "rank": 1, "t": 10.0,
         "rule": "slo_burn_rate", "objective": "serve_latency",
         "target": 0.99, "burn_5m": 38.0, "burn_1h": 21.5,
         "burn_6h": 8.2, "page": "fast"},
        {"kind": "slo_transition", "rank": 2, "t": 12.0, "firing": [],
         "cleared": ["serve_availability"]},
    ] + _records(seed)
    return _lists([o.report.render_slo(None, events=evs, worst=3),
                   o.report.slo_summary(evs)])


@pytest.mark.parametrize("seed", range(2))
def test_render_slo(seed):
    got, want = _both(_render_slo, seed)
    assert got == want
    assert "critical hop" in got[0]


def test_cli_slo_dumps_perfetto(tmp_path, monkeypatch, capsys):
    """The port's report CLI against the JAX one on a directory the
    port wrote (events, a flight dump): the same text and Perfetto
    JSON."""
    obs = tmp_path / "obs"
    monkeypatch.setenv("DK_OBS_DIR", str(obs))
    monkeypatch.setenv("DK_TRACE_SEED", "7")
    _reset(PORT)
    with spans.span("serve.client"):
        with spans.span("serve.request", n=1):
            events.emit("serve_enqueue", pending=1)
    flight.dump("on_demand")
    _reset(PORT)
    outs = []
    for main in (cli.main, jax_cli.main):
        res = []
        for args in (["--slo"], ["--traces"], ["--dumps", "--traces"],
                     ["--perfetto", str(tmp_path / f"{len(outs)}.json")]):
            rc = main([str(obs), *args])
            res.append((rc, capsys.readouterr().out))
        res.append(json.loads(
            (tmp_path / f"{len(outs)}.json").read_text()))
        outs.append(res)
    got, want = outs
    assert got[:3] == want[:3]
    assert got[3][0] == want[3][0] == 0
    assert got[4] == want[4]
    assert any(e["ph"] == "X" for e in got[4]["traceEvents"])


# -- statusz ------------------------------------------------------------
def _statusz(o):
    doc = o.statusz.status_doc(extra={"engine": {"x": 1}})
    doc.pop("uptime_s")
    return _lists(doc)


def test_statusz_apart_from_build(monkeypatch):
    monkeypatch.setenv("DK_SLO", "1")
    got, want = _both(_statusz)
    gb, wb = got.pop("build"), want.pop("build")
    assert got == want
    assert set(gb) - set(wb) == {"torch", "cuda", "device"}
    assert set(wb) - set(gb) == {"jax"}
    assert {k: gb[k] for k in ("python", "platform", "pid")} == \
        {k: wb[k] for k in ("python", "platform", "pid")}
