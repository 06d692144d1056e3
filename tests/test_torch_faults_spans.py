"""The port's copies of the framework-free resilience and observability
modules (``resilience/faults.py``, ``resilience/world.py``,
``resilience/preemption.py``, ``observability/spans.py``,
``observability/perf.py``) held against the JAX package's on the same
inputs: every case runs once over each package's module, and where the
two must agree (``DK_FAULTS`` parsing, the seeded chaos schedule,
seeded trace ids) the port is compared with the reference directly."""

import json
import os
import signal
import threading

import numpy as np
import pytest

from dist_keras_tpu.observability import events as jax_events
from dist_keras_tpu.observability import metrics as jax_metrics
from dist_keras_tpu.observability import perf as jax_perf
from dist_keras_tpu.observability import spans as jax_spans
from dist_keras_tpu.resilience import faults as jax_faults
from dist_keras_tpu.resilience import preemption as jax_preemption
from dist_keras_tpu.resilience import world as jax_world
from dist_keras_tpu_torch.observability import events as t_events
from dist_keras_tpu_torch.observability import metrics as t_metrics
from dist_keras_tpu_torch.observability import perf as t_perf
from dist_keras_tpu_torch.observability import spans as t_spans
from dist_keras_tpu_torch.resilience import faults as t_faults
from dist_keras_tpu_torch.resilience import preemption as t_preemption
from dist_keras_tpu_torch.resilience import world as t_world

PKGS = {
    "jax": dict(faults=jax_faults, world=jax_world, spans=jax_spans,
                events=jax_events, metrics=jax_metrics, perf=jax_perf,
                preemption=jax_preemption),
    "torch": dict(faults=t_faults, world=t_world, spans=t_spans,
                  events=t_events, metrics=t_metrics, perf=t_perf,
                  preemption=t_preemption),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    mods = PKGS[request.param]
    mods["faults"].clear()
    yield mods
    mods["faults"].clear()


def _spec_key(s):
    return (s.point, s.at, s.times, s.action, s.exc.__name__, s.value)


# -- faults: DK_FAULTS parsing -----------------------------------------
@pytest.mark.parametrize("entry,want", [
    ("checkpoint.save@1", ("checkpoint.save", 1, 1, "raise",
                           "FaultInjected", None)),
    ("job.rsync@0x2:action=replace,value=30",
     ("job.rsync", 0, 2, "replace", "FaultInjected", 30.0)),
    ("decode.step", ("decode.step", 0, 1, "raise", "FaultInjected", None)),
    ("decode.step@3x2:exc=OSError", ("decode.step", 3, 2, "raise",
                                     "OSError", None)),
    ("serve.predict@2:action=delay,value=0.5",
     ("serve.predict", 2, 1, "delay", "FaultInjected", 0.5)),
    ("step.loss:action=corrupt", ("step.loss", 0, 1, "corrupt",
                                  "FaultInjected", None)),
    ("  decode.admit@0 ", ("decode.admit", 0, 1, "raise", "FaultInjected",
                           None)),
])
def test_env_entry_parses_as_the_reference_does(entry, want):
    got = t_faults._parse_env_entry(entry)
    assert _spec_key(got) == want
    assert _spec_key(jax_faults._parse_env_entry(entry)) == want


@pytest.mark.parametrize("entry", ["checkpoint.save@x2", "@1",
                                   "a@b@1", "decode.step@1:action=explode"])
def test_malformed_env_entries_fail_loudly(pkg, entry):
    with pytest.raises(ValueError):
        pkg["faults"]._parse_env_entry(entry)


def test_blank_entry_parses_to_nothing(pkg):
    assert pkg["faults"]._parse_env_entry("   ") is None


@pytest.mark.parametrize("exc", ["PeerLost", "BarrierTimeout"])
def test_coordination_exceptions_resolve_as_the_reference(exc):
    from dist_keras_tpu_torch.resilience import coordination

    spec = t_faults._parse_env_entry(f"coord.barrier@0:exc={exc}")
    assert spec.exc is getattr(coordination, exc)
    assert jax_faults._parse_env_entry(
        f"coord.barrier@0:exc={exc}").exc.__name__ == exc


def test_known_points_are_the_reference_registry_in_order():
    assert t_faults.KNOWN_POINTS == jax_faults.KNOWN_POINTS
    assert set(t_faults._EXC_NAMES) == set(jax_faults._EXC_NAMES)


def test_load_env_arms_the_schedule(pkg, monkeypatch):
    f = pkg["faults"]
    monkeypatch.setenv("DK_FAULTS",
                       "decode.step@1;serve.predict@0:action=replace,"
                       "value=7")
    f.load_env(force=True)
    assert f.fault_point("decode.step") is None
    with pytest.raises(f.FaultInjected, match="decode.step"):
        f.fault_point("decode.step")
    assert f.fault_point("decode.step") is None
    assert f.fault_point("serve.predict", 3) == 7.0
    assert f.fault_point("serve.predict", 3) == 3
    monkeypatch.setenv("DK_FAULTS", "decode.step@x")
    with pytest.raises(ValueError, match="malformed"):
        f.load_env(force=True)


# -- faults: schedules -------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7, 20260117])
@pytest.mark.parametrize("rate,horizon", [(0.25, 20), (1.0, 3), (0.5, 7)])
def test_chaos_schedule_equals_the_reference(seed, rate, horizon):
    got = t_faults.chaos_schedule(seed, rate=rate, horizon=horizon)
    want = jax_faults.chaos_schedule(seed, rate=rate, horizon=horizon)
    assert [_spec_key(s) for s in got] == [_spec_key(s) for s in want]
    assert got, "a seeded schedule armed nothing"
    pts = ("decode.admit", "decode.kv_alloc", "decode.step")
    got = t_faults.chaos_schedule(seed, rate=1.0, horizon=horizon,
                                  points=pts, horizon_s=2.0)
    want = jax_faults.chaos_schedule(seed, rate=1.0, horizon=horizon,
                                     points=pts, horizon_s=2.0)
    assert ([(_spec_key(s), s.at_s) for s in got]
            == [(_spec_key(s), s.at_s) for s in want])


def test_chaos_schedule_rejects_bad_knobs(pkg):
    f = pkg["faults"]
    with pytest.raises(ValueError):
        f.chaos_schedule(0, rate=1.5)
    with pytest.raises(ValueError):
        f.chaos_schedule(0, horizon=0)
    with pytest.raises(ValueError):
        f.chaos_schedule(0, horizon_s=0)


def test_seeded_chaos_env_arms_the_same_points(pkg, monkeypatch):
    f = pkg["faults"]
    monkeypatch.setenv("DK_FAULTS", "")
    monkeypatch.setenv("DK_FAULTS_SEED", "11")
    monkeypatch.setenv("DK_FAULTS_RATE", "1.0")
    monkeypatch.setenv("DK_FAULTS_HORIZON", "1")
    monkeypatch.setenv("DK_FAULTS_POINTS", "decode.step,serve.enqueue")
    f.load_env(force=True)
    for point in ("decode.step", "serve.enqueue"):
        with pytest.raises((f.FaultInjected, OSError)):
            f.fault_point(point)   # horizon 1: the very first call
        assert f.fault_point(point) is None
    monkeypatch.setenv("DK_FAULTS_POINTS", "decode.nope")
    with pytest.raises(ValueError, match="unknown fault point"):
        f.load_env(force=True)


def test_inject_counts_from_arming_and_disarms(pkg):
    f = pkg["faults"]
    for _ in range(3):
        f.fault_point("decode.admit")
    assert f.call_count("decode.admit") == 3
    spec = f.inject("decode.admit", at=1, times=2)
    f.fault_point("decode.admit")                 # call 0 from arming
    for _ in range(2):
        with pytest.raises(f.FaultInjected):
            f.fault_point("decode.admit")
    f.fault_point("decode.admit")
    assert spec.fired == 2
    with f.armed("decode.step", exc=OSError):
        with pytest.raises(OSError):
            f.fault_point("decode.step")
    f.fault_point("decode.step")                  # disarmed on exit


def test_actions_replace_corrupt_and_delay(pkg):
    f = pkg["faults"]
    with f.armed("step.loss", action="corrupt"):
        out = f.fault_point("step.loss", np.ones(3, np.float32))
    assert np.isnan(out[0]) and np.all(out[1:] == 1)
    with f.armed("job.rsync", action="replace", value=30):
        assert f.fault_point("job.rsync", 0) == 30
    with f.armed("serve.predict", action="delay", value=0.0):
        assert f.fault_point("serve.predict", "v") == "v"
    with f.armed("step.loss", action="corrupt"):
        with pytest.raises(ValueError, match="no value"):
            f.fault_point("step.loss")
    with pytest.raises(ValueError, match="unknown fault action"):
        f.inject("step.loss", action="explode")


def test_time_armed_spec_fires_on_the_world_clock(pkg):
    f, world = pkg["faults"], pkg["world"]

    class Clock(world.World):
        def __init__(self):
            self.t = 100.0

        def time(self):
            return self.t

        def monotonic(self):
            return self.t

        def sleep(self, seconds):
            self.t += seconds

    clock = Clock()
    with world.use(clock):
        [spec] = f.chaos_schedule(3, rate=1.0, points=("decode.recover",),
                                  horizon_s=5.0)
        with f._lock:
            f._specs.setdefault(spec.point, []).append(spec)
        assert f.fault_point("decode.recover") is None
        clock.sleep(5.0)
        with pytest.raises((f.FaultInjected, OSError)):
            f.fault_point("decode.recover")
        assert f.fault_point("decode.recover") is None
    assert world.current() is not clock


def test_fired_fault_writes_an_event(pkg, tmp_path, monkeypatch):
    f, events = pkg["faults"], pkg["events"]
    monkeypatch.setenv("DK_OBS_DIR", str(tmp_path))
    events.reset()
    try:
        with f.armed("serve.enqueue"):
            with pytest.raises(f.FaultInjected):
                f.fault_point("serve.enqueue")
    finally:
        events.reset()
    [line] = (tmp_path / "events-rank_0.jsonl").read_text().splitlines()
    ev = json.loads(line)
    assert (ev["kind"], ev["point"], ev["exc"]) == ("fault", "serve.enqueue",
                                                    "FaultInjected")


# -- spans -------------------------------------------------------------
@pytest.mark.parametrize("header", [
    None, "", "garbage", "00-abc-def-01",
    "00-" + "g" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "1" * 31 + "-" + "1" * 16 + "-01",
    "00-" + "1" * 32 + "-" + "1" * 16,
])
def test_malformed_traceparent_is_a_fresh_root(pkg, header):
    assert pkg["spans"].parse_traceparent(header) is None


def test_traceparent_round_trip(pkg):
    sp = pkg["spans"]
    ctx = sp.SpanContext("a" * 32, "b" * 16)
    hdr = sp.traceparent(ctx)
    assert hdr == f"00-{'a' * 32}-{'b' * 16}-01"
    assert sp.parse_traceparent(hdr) == ctx
    assert sp.parse_traceparent(" " + hdr + " ") == ctx
    assert sp.traceparent(None) is None      # nothing open, nothing sent


def test_disabled_spans_are_one_shared_noop(pkg, monkeypatch):
    sp, events = pkg["spans"], pkg["events"]
    monkeypatch.delenv("DK_OBS_DIR", raising=False)
    events.reset()
    try:
        assert sp.span("serve.request") is sp.span("serve.batch")
        assert sp.capture() is None
        with sp.resume(None) as got:
            assert got is None
        assert sp.span_at("serve.exec", None, 0.0, 1.0) is None
    finally:
        events.reset()


def _records(tmp_path):
    return [json.loads(x) for x in
            (tmp_path / "events-rank_0.jsonl").read_text().splitlines()]


def test_span_at_and_resume_stitch_one_trace(pkg, tmp_path, monkeypatch):
    sp, events = pkg["spans"], pkg["events"]
    monkeypatch.setenv("DK_OBS_DIR", str(tmp_path))
    events.reset()
    got = {}
    try:
        incoming = sp.SpanContext("c" * 32, "d" * 16)
        with sp.resume(incoming):
            with sp.span("serve.request", n=2):
                ctx = sp.capture()
                echo = sp.traceparent()

                def worker():
                    got["ctx"] = sp.span_at("serve.exec", ctx, 10.0, 10.25,
                                            replica=1)

                t = threading.Thread(target=worker)
                t.start()
                t.join()
    finally:
        events.reset()
    recs = _records(tmp_path)
    begin = next(r for r in recs if r["kind"] == "span_begin")
    ends = {r["span"]: r for r in recs if r["kind"] == "span_end"}
    assert begin["span"] == "serve.request"
    assert begin["trace_id"] == "c" * 32 and begin["parent_id"] == "d" * 16
    assert echo == f"00-{'c' * 32}-{begin['span_id']}-01"
    ex = ends["serve.exec"]
    assert ex["t0"] == 10.0 and ex["duration_s"] == pytest.approx(0.25)
    assert ex["parent_id"] == begin["span_id"]
    assert ex["trace_id"] == "c" * 32 and ex["replica"] == 1
    assert got["ctx"] == sp.SpanContext("c" * 32, ex["span_id"])
    assert ends["serve.request"]["duration_s"] >= 0


def test_seeded_trace_ids_equal_the_reference(monkeypatch):
    monkeypatch.setenv("DK_TRACE_SEED", "42")
    jax_spans.reset()
    t_spans.reset()
    try:
        assert ([t_spans.new_trace_id(), t_spans.new_span_id()]
                == [jax_spans.new_trace_id(), jax_spans.new_span_id()])
    finally:
        monkeypatch.delenv("DK_TRACE_SEED")
        jax_spans.reset()
        t_spans.reset()


def test_nested_span_paths_and_current(pkg, tmp_path, monkeypatch):
    sp, events = pkg["spans"], pkg["events"]
    monkeypatch.setenv("DK_OBS_DIR", str(tmp_path))
    events.reset()
    try:
        assert sp.current() is None
        with sp.span("serve.request"):
            outer = sp.current()
            with sp.span("serve.batch") as path:
                assert path == "serve.request.serve.batch"
                assert sp.current_path() == path
                inner = sp.current()
        assert sp.current() is None
    finally:
        events.reset()
    assert inner.trace_id == outer.trace_id and inner != outer


# -- perf --------------------------------------------------------------
def test_perf_counters_and_snapshot(pkg):
    perf, metrics = pkg["perf"], pkg["metrics"]
    metrics.reset()
    try:
        perf.count_dispatch()
        perf.count_dispatch(2)
        perf.h2d(1024, 0.001)
        perf.d2h(64, 0.002)
        with perf.phase("step"):
            pass
        snap = perf.snapshot()
    finally:
        metrics.reset()
    assert (snap["dispatches"], snap["h2d_bytes"], snap["d2h_bytes"]) \
        == (3, 1024, 64)
    assert snap["phases"]["step"]["count"] == 1
    if perf is jax_perf:
        assert snap["retraces"] == 0 and snap["traces"] == 0
    else:   # eager PyTorch compiles nothing: no retrace counters
        assert set(snap) == {"dispatches", "h2d_bytes", "d2h_bytes",
                             "phases"}


def test_perf_has_no_retrace_listener_in_eager_pytorch():
    assert not hasattr(t_perf, "install") and not hasattr(t_perf,
                                                          "installed")
    assert not {"perf.retraces", "perf.traces", "perf.compile_s"} & set(
        t_metrics.KNOWN_METRICS)
    assert t_perf.PHASES == jax_perf.PHASES


# -- preemption --------------------------------------------------------
def test_preempted_exits_128_plus_signum(pkg):
    e = pkg["preemption"].Preempted(signal.SIGTERM, saved_step=4)
    assert isinstance(e, SystemExit)
    assert e.exit_code == 143 and e.saved_step == 4


def test_signal_handler_only_sets_the_flag_then_escalates(pkg):
    pre = pkg["preemption"]
    calls = []
    old = signal.signal(signal.SIGUSR1, lambda s, f: calls.append(s))
    pre.clear()
    try:
        assert pre.install(signals=(signal.SIGUSR1,))
        os.kill(os.getpid(), signal.SIGUSR1)
        assert pre.requested() == signal.SIGUSR1
        assert calls == []                    # first delivery: flag only
        os.kill(os.getpid(), signal.SIGUSR1)
        assert calls == [signal.SIGUSR1]      # second: the displaced one
    finally:
        pre.restore()
        pre.clear()
        signal.signal(signal.SIGUSR1, old)


def test_install_off_the_main_thread(pkg):
    pre = pkg["preemption"]
    out = {}

    def run():
        out["lenient"] = pre.install(strict=False)
        try:
            pre.install()
        except RuntimeError as e:
            out["strict"] = str(e)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert out["lenient"] is False and "MAIN thread" in out["strict"]


def test_on_request_fires_once_from_a_watcher_thread(pkg):
    pre = pkg["preemption"]
    pre.clear()
    fired = threading.Event()
    seen = []

    def callback(signum):
        seen.append((signum, threading.current_thread().name))
        fired.set()

    stop = pre.on_request(callback, poll_s=0.01)
    try:
        pre.request(signal.SIGTERM)
        assert fired.wait(30)
        assert seen == [(signal.SIGTERM, "dk-preempt-watch")]
        assert pre.requested() == signal.SIGTERM
    finally:
        stop()
        pre.clear()
