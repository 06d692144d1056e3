"""The port's ``utils/profiling.py`` on the CPU, against the JAX
package's.

- ``StepTimer``'s summaries equal the JAX one's on the same observed
  durations (both wrap their package's metrics histogram).
- ``trace(logdir)`` records CPU activity into a Chrome trace that holds an
  open span's name, a ``perf.phase``'s and an ``annotate`` region's;
  spans detect the running profiler (any profiler, not only
  ``trace``'s) and forward inside it and not after, also when the body
  raises.
- A process that has started CUDA but whose ``torch.profiler`` cannot
  record it gets an error, never a CPU-only trace.

The card's half (CUDA kernel events inside a span's range) is in
``tests/test_torch_profiling_cuda.py``.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

import dist_keras_tpu.utils.profiling as jax_profiling
from dist_keras_tpu_torch import utils as port_utils
from dist_keras_tpu_torch.observability import metrics, spans
from dist_keras_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _clean():
    assert not spans.device_trace_active()
    metrics.reset()
    yield
    assert not spans.device_trace_active()
    metrics.reset()


def _durations(kind):
    rng = np.random.default_rng(0)
    return {"empty": [], "one": [0.25],
            "many": list(rng.exponential(0.01, 300)),
            "ties": [0.5] * 7 + [0.1] * 3}[kind]


@pytest.mark.parametrize("kind", ["empty", "one", "many", "ties"])
def test_step_timer_summary_equals_the_jax_one(kind):
    got, want = profiling.StepTimer(), jax_profiling.StepTimer()
    for d in _durations(kind):
        got.observe(d)
        want.observe(d)
    assert got.summary() == want.summary()
    assert list(got.times) == list(want.times)
    got.reset()
    want.reset()
    assert got.summary() == want.summary()


def test_named_step_timer_registers_in_the_metrics_registry():
    t = profiling.StepTimer(name="train.step")
    with t:
        pass
    t.observe(0.5)
    assert t.summary()["count"] == 2
    assert metrics.histogram("train.step").summary()["count"] == 2
    assert profiling.StepTimer().summary()["count"] == 0


def test_profiling_is_a_lazy_submodule_of_utils():
    assert "profiling" in port_utils.__all__
    assert port_utils.profiling is profiling
    with pytest.raises(AttributeError):
        port_utils.nothing_here


def _trace_events(logdir):
    files = glob.glob(os.path.join(str(logdir), "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_the_span_and_annotate_names(tmp_path):
    from dist_keras_tpu_torch.observability import perf

    with profiling.trace(tmp_path):
        assert spans.device_trace_active()
        with spans.span("train.step"):
            with profiling.annotate("train.step.body"):
                with perf.phase("tp.forward"):
                    torch.ones(8, 8) @ torch.ones(8, 8)
        region = profiling.annotate("again")
        for _ in range(2):
            with region:
                torch.zeros(3).sum()
    assert not spans.device_trace_active()
    evs = _trace_events(tmp_path)
    names = [e.get("name") for e in evs if e.get("cat") == "user_annotation"]
    assert names.count("train.step") == 1
    assert names.count("train.step.body") == 1
    assert names.count("tp.forward") == 1
    assert names.count("again") == 2
    step = next(e for e in evs if e.get("name") == "train.step")
    body = next(e for e in evs if e.get("name") == "train.step.body")
    fwd = next(e for e in evs if e.get("name") == "tp.forward")
    assert step["ts"] <= body["ts"] <= fwd["ts"]
    assert fwd["ts"] + fwd["dur"] <= body["ts"] + body["dur"] \
        <= step["ts"] + step["dur"]
    # CPU activity only: no CUDA here, and none asked for
    assert not any(e.get("cat") == "kernel" for e in evs)
    assert any(e.get("cat") == "cpu_op" for e in evs)


def test_spans_forward_only_inside_trace(tmp_path, monkeypatch):
    from dist_keras_tpu_torch.observability import events

    monkeypatch.delenv("DK_OBS_DIR", raising=False)
    events.reset()
    # outside a trace (and with the event log off) a span is the no-op
    assert spans.span("x") is spans.span("y")
    with profiling.trace(tmp_path):
        assert spans.span("x") is not spans.span("y")
    assert spans.span("x") is spans.span("y")
    # any profiler counts, not only trace()'s
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert spans.device_trace_active()
        assert spans.span("x") is not spans.span("y")
    assert not spans.device_trace_active()
    assert spans.span("x") is spans.span("y")


def test_device_trace_flag_restored_after_an_exception(tmp_path):
    with pytest.raises(RuntimeError, match="boom"):
        with profiling.trace(tmp_path):
            assert spans.device_trace_active()
            with spans.span("train.step"):
                raise RuntimeError("boom")
    assert not spans.device_trace_active()
    # the trace of the failed body is still written
    assert any(e.get("name") == "train.step"
               for e in _trace_events(tmp_path))


def test_a_card_the_profiler_cannot_record_is_an_error(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="CPU-only trace"):
        with profiling.trace(tmp_path):
            pass
    assert not spans.device_trace_active()
    assert not glob.glob(os.path.join(str(tmp_path), "*.json"))


def test_cuda_activity_is_asked_for_once_cuda_has_started(monkeypatch):
    acts = torch.profiler.ProfilerActivity
    assert profiling._activities() == [acts.CPU]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {acts.CPU, acts.CUDA})
    assert profiling._activities() == [acts.CPU, acts.CUDA]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert profiling._activities() == [acts.CPU]
