"""The six phase readers on synthetic phase records: the TP step's
forward / backward / optimizer / host lead over the untraced window's
steps only, ADAG's merge and a call's data over the untraced call only,
and None where the program has no records or no device time."""

import pytest

from port_bench import harness, phases
from port_bench.trace import TraceView

TP = ("tp_step.forward_ms", "tp_step.backward_ms", "tp_step.optimizer_ms",
      "tp_step.host_lead_ms")
ADAG = ("adag.merge_ms", "train_call.data_ms")


class _Ring:
    def __init__(self):
        self.recs = []

    def add(self, name, parent=None, host_s=0.0, device_s=None,
            queue_s=None):
        rec = {"name": name, "seq": len(self.recs), "parent": parent,
               "host_start": float(len(self.recs)), "host_s": host_s,
               "device_s": device_s, "queue_s": queue_s}
        self.recs.append(rec)
        return rec["seq"]


def _tp_ring(values, device=True):
    """One TP step a value v: forward v ms, backward 2v, optimizer 3v,
    the step's entry queued 4v."""
    ring = _Ring()
    for v in values:
        s = ring.add("tp.step", device_s=6 * v / 1e3 if device else None,
                     queue_s=4 * v / 1e3 if device else None)
        for name, k in (("tp.forward", 1), ("tp.backward", 2),
                        ("tp.optimizer", 3)):
            ring.add(name, parent=s,
                     device_s=k * v / 1e3 if device else None)
    return ring.recs


def _view(n, m):
    return TraceView([], 0.0, 0.0, m, [], {"window_steps": n})


def _read(monkeypatch, recs, name, view):
    monkeypatch.setattr(phases, "records", lambda: recs)
    return harness.load_reader(name).read(view)


@pytest.mark.parametrize("name,k", list(zip(TP, (1, 2, 3, 4))))
def test_tp_readers_take_the_untraced_windows_median(monkeypatch, name, k):
    # two check steps, the window's three (1, 2, 9), the traced two
    recs = _tp_ring([100, 100, 1, 2, 9, 50, 50])
    assert _read(monkeypatch, recs, name, _view(3, 2)) == pytest.approx(
        2 * k)


@pytest.mark.parametrize("name", TP)
def test_tp_readers_are_silent_without_device_time_or_steps(monkeypatch,
                                                            name):
    assert _read(monkeypatch, _tp_ring([1, 2, 3], device=False), name,
                 _view(2, 1)) is None
    assert _read(monkeypatch, _tp_ring([1, 2]), name, _view(2, 1)) is None
    assert _read(monkeypatch, None, name, _view(2, 1)) is None
    assert _read(monkeypatch, [], name, _view(2, 1)) is None


def _adag_ring(device=True):
    """The check call, the window call (merges 1, 3, 2 ms; shard 40 ms,
    layout 60 ms) and the traced call."""
    ring = _Ring()
    for shard, layout, merges in ((5.0, 5.0, (9, 9)),
                                  (40.0, 60.0, (1, 3, 2)),
                                  (7.0, 7.0, (9,))):
        ring.add("shard", host_s=shard / 1e3)
        ring.add("layout", host_s=layout / 1e3)
        step = ring.add("step")
        for v in merges:
            ring.add("window", parent=step, device_s=0.1 if device else None)
            ring.add("merge", parent=step,
                     device_s=v / 1e3 if device else None)
    return ring.recs


def test_adag_merge_is_the_untraced_calls_median(monkeypatch):
    assert _read(monkeypatch, _adag_ring(), "adag.merge_ms",
                 _view(None, 4)) == pytest.approx(2.0)
    assert _read(monkeypatch, _adag_ring(device=False), "adag.merge_ms",
                 _view(None, 4)) is None


def test_a_calls_data_is_its_shard_and_layout(monkeypatch):
    got = _read(monkeypatch, _adag_ring(device=False), "train_call.data_ms",
                _view(None, 4))
    assert got == pytest.approx(100.0)


@pytest.mark.parametrize("name", ADAG)
def test_adag_readers_need_two_calls(monkeypatch, name):
    one = [r for r in _adag_ring() if r["seq"] < 8]
    assert _read(monkeypatch, one, name, _view(None, 4)) is None
    assert _read(monkeypatch, None, name, _view(None, 4)) is None


@pytest.mark.parametrize("name", TP + ADAG)
def test_each_reader_is_rank0s(name):
    assert harness.load_reader(name).COMBINE == "rank0"
