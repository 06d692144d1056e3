"""The retry policy and the auto-resume supervisor, held against the
port with the reference's own checks (``tests/test_resilience.py``'s
retry tests, ``tests/test_self_healing.py``'s supervisor and budget
tests, ``tests/test_perf_telemetry.py``'s alert seam), and a supervised
trainer run end to end: a SIGTERM mid-run, a relaunch handed
``latest_verified_step()`` as ``resume_step``, a bit-equal finish."""

import json
import os
import signal
import time

import numpy as np
import pytest

from dist_keras_tpu_torch.checkpoint import Checkpointer
from dist_keras_tpu_torch.resilience import (
    CrashLoop,
    Preempted,
    RestartBudget,
    RetryPolicy,
    faults,
    preemption,
    supervise,
    supervisor,
)
from dist_keras_tpu_torch.resilience.retry import retry


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    preemption.clear()
    supervisor.clear_alert_sinks()
    yield
    faults.clear()
    preemption.clear()
    preemption.restore()
    supervisor.clear_alert_sinks()


def _state(scale=1.0):
    return {"w": np.arange(32, dtype=np.float64) * scale,
            "b": np.ones(4, dtype=np.float32)}


def _payload(ck, step):
    # drain the async writer first: these tests poke the committed
    # bytes directly, and with DK_CKPT_ASYNC (default on) a just-issued
    # save may still be streaming out of the background thread
    ck.wait_until_finished()
    return os.path.join(ck.directory, f"step_{step:08d}")



def test_retry_backoff_schedule_and_recovery():
    sleeps, calls = [], []
    pol = RetryPolicy(attempts=4, backoff=0.1, multiplier=2.0, jitter=0.0,
                      retryable=(OSError,), sleep=sleeps.append)

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert pol.call(flaky) == "ok"
    assert len(calls) == 3
    assert sleeps == [0.1, 0.2]  # exponential, deterministic (jitter=0)


def test_retry_gives_up_with_original_error():
    sleeps = []
    pol = RetryPolicy(attempts=3, backoff=0.01, jitter=0.0,
                      retryable=(OSError,), sleep=sleeps.append)

    def dead():
        raise OSError("permanent")

    with pytest.raises(OSError, match="permanent") as ei:
        pol.call(dead)
    assert ei.value._retry_attempts == 3
    assert len(sleeps) == 2  # no sleep after the final attempt


def test_retry_nonretryable_passes_straight_through():
    calls = []
    pol = RetryPolicy(attempts=5, retryable=(OSError,),
                      sleep=lambda s: None)

    def typed():
        calls.append(1)
        raise ValueError("not transient")

    with pytest.raises(ValueError):
        pol.call(typed)
    assert len(calls) == 1


def test_retry_deadline_stops_early():
    clock = {"t": 0.0}
    sleeps = []

    def fake_sleep(s):
        sleeps.append(s)
        clock["t"] += s

    pol = RetryPolicy(attempts=100, backoff=1.0, multiplier=1.0,
                      jitter=0.0, timeout=2.5, retryable=(OSError,),
                      sleep=fake_sleep, clock=lambda: clock["t"])

    def dead():
        raise OSError("x")

    with pytest.raises(OSError):
        pol.call(dead)
    # 1.0 + 1.0 spent sleeping, third sleep clipped to the 0.5 left,
    # then the deadline blocks any further attempt
    assert sum(sleeps) <= 2.5 + 1e-9
    assert len(sleeps) <= 3


def test_retry_jitter_is_deterministic():
    a = RetryPolicy(attempts=2, backoff=1.0, jitter=0.5, seed=7)
    b = RetryPolicy(attempts=2, backoff=1.0, jitter=0.5, seed=7)
    da, db = a.delay(1), b.delay(1)
    assert da == db and 0.5 <= da <= 1.5


def test_retry_decorator():
    calls = []

    @retry(attempts=3, backoff=0.0, retryable=(OSError,),
           sleep=lambda s: None)
    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise OSError
        return 5

    assert flaky() == 5
    assert len(calls) == 2



def test_remaining_deadline_none_without_timeout():
    assert RetryPolicy(attempts=2).remaining_deadline() is None


def test_remaining_deadline_full_before_any_call():
    pol = RetryPolicy(attempts=2, timeout=30.0)
    # a nested surface asking EARLY must read the full budget, not 0
    assert pol.remaining_deadline() == 30.0


def test_remaining_deadline_counts_down_and_clips_at_zero():
    t = [100.0]
    pol = RetryPolicy(attempts=2, timeout=10.0, clock=lambda: t[0],
                      sleep=lambda s: None)
    pol.start_deadline()
    t[0] = 104.0
    assert pol.remaining_deadline() == pytest.approx(6.0)
    t[0] = 120.0
    assert pol.remaining_deadline() == 0.0


def test_call_arms_the_same_deadline():
    t = [0.0]
    pol = RetryPolicy(attempts=1, timeout=5.0, clock=lambda: t[0],
                      sleep=lambda s: None)
    pol.call(lambda: t.__setitem__(0, 2.0))
    assert pol.remaining_deadline() == pytest.approx(3.0)


def test_restart_budget_rolling_window():
    t = [0.0]
    b = RestartBudget(2, window_s=10.0, clock=lambda: t[0])
    assert b.record("OSError") is True        # 1 in window
    assert b.record("OSError") is True        # 2 in window
    assert b.record("OSError") is False       # 3 > budget
    t[0] = 20.0                               # window slides past all
    assert b.record("OSError") is True
    assert len(b.evidence) == 1


def test_restart_budget_rejects_bad_knobs():
    with pytest.raises(ValueError, match="max_restarts"):
        RestartBudget(-1, 10.0)
    with pytest.raises(ValueError, match="window"):
        RestartBudget(1, 0.0)


def test_supervise_restarts_transient_then_returns():
    calls = []
    sleeps = []

    def fn(attempt, resume_step):
        calls.append((attempt, resume_step))
        if attempt < 2:
            raise OSError(f"transient {attempt}")
        return "done"

    assert supervise(fn, max_restarts=3, backoff=0.1, multiplier=2.0,
                     budget_window_s=60.0,
                     sleep=sleeps.append) == "done"
    assert calls == [(0, None), (1, None), (2, None)]
    assert sleeps == [pytest.approx(0.1), pytest.approx(0.2)]


def test_supervise_fatal_never_retried():
    calls = []

    def fn(attempt, resume_step):
        calls.append(attempt)
        raise ValueError("bad config")

    with pytest.raises(ValueError, match="bad config"):
        supervise(fn, max_restarts=3, backoff=0.0, budget_window_s=60.0)
    assert calls == [0]


def test_supervise_poisoned_coordinator_is_fatal():
    from dist_keras_tpu_torch.resilience.coordination import CoordinatorPoisoned

    calls = []

    def fn(attempt, resume_step):
        calls.append(attempt)
        raise CoordinatorPoisoned("op stream desynced")

    with pytest.raises(CoordinatorPoisoned):
        supervise(fn, max_restarts=3, backoff=0.0, budget_window_s=60.0)
    assert calls == [0]  # tested BEFORE the generic RuntimeError path


def test_supervise_crash_loop_gives_up_typed_with_evidence():
    def fn(attempt, resume_step):
        raise OSError(f"boom {attempt}")

    with pytest.raises(CrashLoop) as ei:
        supervise(fn, max_restarts=2, backoff=0.0, budget_window_s=60.0)
    # budget of 2 restarts = 3 attempts; every failure is in evidence
    assert len(ei.value.evidence) == 3
    assert ei.value.reason == "crash_loop"
    assert "boom" in str(ei.value)
    assert isinstance(ei.value.__cause__, OSError)


def test_supervise_deadline_gives_up_typed():
    t = [0.0]

    def fn(attempt, resume_step):
        t[0] += 10.0  # each attempt burns 10 "seconds"
        raise OSError("slow boom")

    with pytest.raises(CrashLoop) as ei:
        supervise(fn, max_restarts=100, backoff=0.0,
                  budget_window_s=1e9, deadline_s=25.0,
                  clock=lambda: t[0], sleep=lambda s: None)
    assert ei.value.reason == "deadline"
    assert t[0] == pytest.approx(30.0)  # gave up at the first overrun


def test_supervise_preempted_clears_flag_and_passes_verified_step(
        tmp_path, flip_one_byte):
    ck = Checkpointer(str(tmp_path), max_to_keep=5)
    # .wait(): both steps must actually commit — an un-waited save(1)
    # can be coalesced away by save(2) (latest-wins), leaving nothing
    # for the supervisor to fall back to
    ck.save(1, _state(1.0)).wait()
    ck.save(2, _state(2.0)).wait()
    flip_one_byte(_payload(ck, 2))  # the latest step rotted on disk
    calls = []

    def fn(attempt, resume_step):
        calls.append((attempt, resume_step))
        if attempt == 0:
            preemption.request()  # the SIGTERM path sets the flag...
            raise Preempted(15, saved_step=2)
        assert not preemption.requested()  # ...cleared before relaunch
        return "resumed"

    assert supervise(fn, ck, max_restarts=2, backoff=0.0,
                     budget_window_s=60.0) == "resumed"
    # the relaunch resumes from the latest VERIFIED step (1), not the
    # corrupt latest (2) — the supervisor never hands out rotted bytes
    assert calls == [(0, 1), (1, 1)]


def test_supervise_probe_failure_is_budgeted_not_fatal(tmp_path):
    """A transient OSError out of the latest_verified_step PROBE (a
    flaky checkpoint dir's listdir) is budgeted and retried exactly
    like the same error out of fn — not an untyped supervisor crash."""
    ck = Checkpointer(str(tmp_path), max_to_keep=3)
    ck.save(1, _state(1.0))
    real = ck.latest_verified_step
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("transient listdir failure")
        return real()

    ck.latest_verified_step = flaky
    runs = []

    def fn(attempt, resume_step):
        runs.append((attempt, resume_step))
        return "done"

    assert supervise(fn, ck, max_restarts=2, backoff=0.0,
                     budget_window_s=60.0) == "done"
    # attempt 0 died in the probe itself; attempt 1 ran fn with the step
    assert runs == [(1, 1)]


def test_supervise_on_restart_hook_sees_error_and_delay():
    seen = []

    def fn(attempt, resume_step):
        if attempt == 0:
            raise OSError("once")
        return attempt

    supervise(fn, max_restarts=1, backoff=0.25, budget_window_s=60.0,
              sleep=lambda s: None,
              on_restart=lambda a, e, d: seen.append((a, type(e), d)))
    assert seen == [(1, OSError, pytest.approx(0.25))]



def test_supervisor_giveup_fires_sink_exactly_once():
    calls = []
    supervisor.add_alert_sink(calls.append)

    def fn(attempt, resume_step):
        raise RuntimeError("always down")

    with pytest.raises(CrashLoop):
        supervise(fn, max_restarts=1, backoff=0.0,
                  budget_window_s=60.0)
    giveups = [c for c in calls if c["kind"] == "supervisor_giveup"]
    assert len(giveups) == 1                # restarts alert NOBODY
    assert giveups[0]["reason"] == "crash_loop"
    assert giveups[0]["error"] == "RuntimeError"


def test_supervisor_fatal_giveup_alerts_once_too():
    calls = []
    supervisor.add_alert_sink(calls.append)

    def fn(attempt, resume_step):
        raise ValueError("config bug")

    with pytest.raises(ValueError):
        supervise(fn, max_restarts=3, backoff=0.0,
                  budget_window_s=60.0)
    assert len(calls) == 1 and calls[0]["reason"] == "fatal"



def test_alert_cmd_webhook_receives_json(tmp_path, monkeypatch):
    out = tmp_path / "alert.json"
    monkeypatch.setenv("DK_ALERT_CMD", f"cat > {out}")
    payload = supervisor.alert("watchdog_alert", rule="flip", rank=1)
    assert payload["kind"] == "watchdog_alert"
    deadline = time.time() + 5
    while not out.exists() and time.time() < deadline:
        time.sleep(0.01)
    doc = json.loads(out.read_text())
    assert doc["kind"] == "watchdog_alert" and doc["rule"] == "flip"
    assert doc["rank"] == 1                 # caller's rank kept


def test_alert_payload_always_names_rank(monkeypatch):
    # the webhook line is the one delivery an operator sees live: it
    # must name the firing host even with the event log off
    assert supervisor.alert("watchdog_alert", rule="r")["rank"] == 0
    monkeypatch.setenv("DK_COORD_RANK", "5")
    assert supervisor.alert("watchdog_alert", rule="r")["rank"] == 5


def test_alert_never_raises(monkeypatch, capsys):
    def bad(payload):
        raise RuntimeError("sink exploded")

    supervisor.add_alert_sink(bad)
    monkeypatch.setenv("DK_ALERT_CMD", "exit 9")
    payload = supervisor.alert("ping", x=1)   # must not raise
    assert payload["x"] == 1
    supervisor.remove_alert_sink(bad)



def test_supervised_trainer_resumes_from_the_verified_step(tmp_path):
    """supervise() around a SingleTrainer preempted by a real SIGTERM at
    epoch 2: exactly two attempts, the relaunch is handed the boundary
    save (the latest verified step) as resume_step, and the supervised
    result is bit-equal to an uninterrupted run."""
    from dist_keras_tpu_torch.data.dataset import Dataset
    from dist_keras_tpu_torch.models import mnist_mlp
    from dist_keras_tpu_torch.trainers import SingleTrainer

    rng = np.random.default_rng(1)
    y = rng.integers(0, 3, 128)
    ds = Dataset({"x": rng.normal(size=(128, 8)).astype(np.float32),
                  "y": np.eye(3, dtype=np.float32)[y]})
    kw = dict(batch_size=16, features_col="x", label_col="y", seed=5,
              num_epoch=4, device="cpu")

    def model():
        return mnist_mlp(hidden=(8,), input_dim=8, num_classes=3)

    ck = Checkpointer(str(tmp_path / "ck"))
    seen = []

    def run(attempt, resume_step):
        seen.append((attempt, resume_step))

        def sigterm_at_2(trainer, epoch, logs):
            if attempt == 0 and epoch == 2:
                os.kill(os.getpid(), signal.SIGTERM)

        t = SingleTrainer(model(), checkpoint_dir=ck.directory,
                          handle_preemption=True, callbacks=[sigterm_at_2],
                          resume=(resume_step if resume_step is not None
                                  else False), **kw)
        return t.train(ds)

    got = supervise(run, ck, max_restarts=2, backoff=0.0,
                    budget_window_s=60.0)
    assert seen == [(0, None), (1, 2 * 128 // 16)]
    want = SingleTrainer(model(), **kw).train(ds)
    for a, b in zip(got.get_weights(), want.get_weights()):
        np.testing.assert_array_equal(a, b)
