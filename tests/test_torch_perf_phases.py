"""``observability.perf.phase``: the ring of phase records, the
profiler's ranges, and the card's clock.

On the CPU: the ring keeps records in entry order with their open
parent's index, drops the oldest past its bound, and holds no device
fields without a CUDA device; a phase opens a ``record_function`` range
under a bare ``torch.profiler.profile`` (no ``utils.profiling.trace``)
and none without one; past its bound the ring retains no memory, and a
span with the event log off and no profiler is still the shared no-op.

On a card (marked ``cuda``, skipped elsewhere; the file imports no JAX,
so the card's host runs it with ``python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_perf_phases.py``): a phase's
``device_s`` is its work's event-timed length within 5%; ``queue_s`` is
under 0.1 ms on an idle stream and the queued work's length behind it;
an event recorded after a synchronise maps to the host clock within
100 us.
"""

import json
import threading
import time
import tracemalloc

import pytest
import torch

from dist_keras_tpu_torch.observability import events, metrics, perf, spans


@pytest.fixture(autouse=True)
def _clean():
    perf.reset()
    metrics.reset()
    yield
    perf.reset()
    metrics.reset()


def _names(recs):
    return [r["name"] for r in recs]


def test_records_keep_entry_order_and_parent_index():
    with perf.phase("a"):
        with perf.phase("b"):
            with perf.phase("c"):
                pass
        with perf.phase("d"):
            pass
    with perf.phase("e"):
        pass
    recs = perf.records()
    assert _names(recs) == ["a", "b", "c", "d", "e"]
    seq = {r["name"]: r["seq"] for r in recs}
    assert [r["parent"] for r in recs] == [None, seq["a"], seq["b"],
                                           seq["a"], None]
    assert [r["seq"] for r in recs] == sorted(seq.values())
    a, b, c = recs[:3]
    assert a["host_start"] <= b["host_start"] <= c["host_start"]
    assert c["host_s"] <= b["host_s"] <= a["host_s"]
    assert metrics.histogram("perf.phase.a").summary()["count"] == 1


def test_an_open_phase_has_no_host_seconds_yet():
    with perf.phase("open"):
        (rec,) = perf.records()
        assert rec["host_s"] is None and rec["host_start"] is not None
    assert perf.records()[0]["host_s"] >= 0


def test_the_ring_drops_the_oldest_record_past_its_bound():
    perf.reset(ring=4)
    for i in range(6):
        with perf.phase(f"p{i}"):
            pass
    recs = perf.records()
    assert _names(recs) == ["p2", "p3", "p4", "p5"]
    assert [r["seq"] for r in recs] == sorted(r["seq"] for r in recs)


def test_a_phase_on_another_thread_has_its_own_parents():
    got = {}

    def other():
        with perf.phase("other"):
            got["open"] = True

    with perf.phase("main"):
        t = threading.Thread(target=other)
        t.start()
        t.join()
    recs = {r["name"]: r for r in perf.records()}
    assert got["open"] and recs["other"]["parent"] is None


@pytest.mark.parametrize("device", [None, "cpu", torch.device("cpu")])
def test_no_device_fields_without_a_cuda_device(device):
    with perf.phase("x", device=device):
        torch.ones(4).sum()
    (rec,) = perf.records(block=True)
    assert rec["device_s"] is None and rec["queue_s"] is None
    assert rec["host_s"] > 0
    row = perf.snapshot()["phases"]["x"]
    assert row["count"] == 1
    assert "device_total_s" not in row and "queue_mean_s" not in row


def test_a_bare_profiler_shows_the_phases_as_ranges(tmp_path):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with perf.phase("tp.step"):
            with perf.phase("tp.optimizer"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    ranges = {e["name"]: e for e in evs if e.get("cat") == "user_annotation"}
    step, opt = ranges["tp.step"], ranges["tp.optimizer"]
    assert step["ts"] <= opt["ts"]
    assert opt["ts"] + opt["dur"] <= step["ts"] + step["dur"]
    assert _names(perf.records()) == ["tp.step", "tp.optimizer"]


def test_no_range_without_a_profiler(monkeypatch):
    opened = []
    real = torch.autograd.profiler.record_function

    def counting(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting)
    with perf.phase("quiet"):
        pass
    assert opened == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with perf.phase("loud"):
            pass
    assert opened == ["loud"]


def test_the_disabled_path_retains_nothing(monkeypatch):
    monkeypatch.delenv("DK_OBS_DIR", raising=False)
    events.reset()
    perf.reset(ring=64)
    # the ring full, and the histogram's window of recent samples too
    for _ in range(metrics.Histogram.WINDOW + 100):
        with perf.phase("hot"):
            pass
    assert spans.span("a") is spans.span("b")
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(10_000):
            with perf.phase("hot"):
                pass
            with spans.span("hot"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = {s.traceback[0].filename: s.size_diff
             for s in after.compare_to(before, "filename")
             if s.size_diff > 0}
    assert sum(grown.values()) < 64 * 1024, grown
    assert len(perf.records()) == 64


# -- the card -------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA events exist only on a card")
    return torch.device("cuda", torch.cuda.current_device())


def _sleep_length(dev, cycles):
    """Seconds that ``torch.cuda._sleep(cycles)`` takes, event-timed."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3


def _anchored(dev):
    """A fresh anchor for ``dev``: a phase on its idle stream."""
    torch.cuda.synchronize(dev)
    with perf.phase("anchor", device=dev):
        pass
    torch.cuda.synchronize(dev)


@pytest.mark.cuda
def test_device_seconds_match_the_events_length():
    dev = _card()
    cycles = 40_000_000           # about 20 ms
    _sleep_length(dev, cycles)    # warm-up
    want = _sleep_length(dev, cycles)
    with perf.phase("sleep", device=dev):
        torch.cuda._sleep(cycles)
    (rec,) = [r for r in perf.records(block=True) if r["name"] == "sleep"]
    assert abs(rec["device_s"] - want) <= 0.05 * want, (rec, want)
    row = perf.snapshot()["phases"]["sleep"]
    assert row["device_count"] == 1
    assert row["device_total_s"] == pytest.approx(rec["device_s"], abs=1e-6)


@pytest.mark.cuda
def test_queue_seconds_on_an_idle_stream_and_behind_work():
    dev = _card()
    cycles = 40_000_000
    _anchored(dev)
    length = _sleep_length(dev, cycles)
    with perf.phase("idle", device=dev):
        pass
    torch.cuda.synchronize(dev)
    torch.cuda._sleep(cycles)
    with perf.phase("behind", device=dev):
        pass
    recs = {r["name"]: r for r in perf.records(block=True)}
    assert 0 <= recs["idle"]["queue_s"] < 1e-4, recs["idle"]
    assert 0.9 * length <= recs["behind"]["queue_s"] <= 1.1 * length, (
        recs["behind"], length)


@pytest.mark.cuda
def test_an_event_maps_to_the_host_clock():
    dev = _card()
    _anchored(dev)
    time.sleep(0.2)
    torch.cuda.synchronize(dev)
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    t = time.perf_counter()
    got = perf.anchor_time(e, dev.index)
    assert abs(got - t) < 1e-4, got - t
