"""The trainers' runner telemetry on the port (``trainers/chunking.py``,
``Trainer.record_training_start`` / ``_end``, ``AsyncMerge``) against the
JAX package's: the same event kinds in the same order, the ``perf.phase``
histograms, the ``train.run`` span rooting the run, the ``step.loss``
fault point and the NaN policy, ``report.txt``, the sampler started and
its watchdog quiesced, and ``AsyncMerge``'s ``comm.merge`` point and
``comm_overlap`` / ``comm_blocked`` histograms."""

import os
import signal

import numpy as np
import pytest
import torch

from dist_keras_tpu.data.dataset import Dataset as JDataset
from dist_keras_tpu.models import mnist_mlp as jmlp
from dist_keras_tpu.observability import events as jevents
from dist_keras_tpu.observability import metrics as jmetrics
from dist_keras_tpu.observability import report as jreport
from dist_keras_tpu.parallel.collectives import AsyncMerge as JAsyncMerge
from dist_keras_tpu.resilience import faults as jfaults
from dist_keras_tpu.trainers import ADAG as JADAG
from dist_keras_tpu.trainers import SingleTrainer as JSingle
from dist_keras_tpu_torch.data.dataset import Dataset as TDataset
from dist_keras_tpu_torch.models import mnist_mlp as tmlp
from dist_keras_tpu_torch.observability import events, metrics, report
from dist_keras_tpu_torch.observability import spans, timeseries
from dist_keras_tpu_torch.parallel.collectives import AsyncMerge
from dist_keras_tpu_torch.resilience import faults, preemption
from dist_keras_tpu_torch.resilience.faults import FaultInjected
from dist_keras_tpu_torch.resilience.preemption import Preempted
from dist_keras_tpu_torch.trainers import ADAG, SingleTrainer

ROWS = 512
WIN = dict(num_workers=4, communication_window=4)
COMMON = dict(worker_optimizer="sgd", optimizer_kwargs={"learning_rate": 0.05},
              batch_size=8, num_epoch=2, label_col="label_encoded")


def _cols():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, ROWS)
    return {"features": rng.normal(size=(ROWS, 8)).astype(np.float32),
            "label_encoded": np.eye(2, dtype=np.float32)[y]}


COLS = _cols()
PKGS = {
    "port": (events, metrics, report, faults, TDataset, tmlp,
             {"ADAG": ADAG, "SingleTrainer": SingleTrainer},
             {"device": "cpu"}),
    "jax": (jevents, jmetrics, jreport, jfaults, JDataset, jmlp,
            {"ADAG": JADAG, "SingleTrainer": JSingle}, {}),
}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("DK_OBS_DIR", raising=False)
    monkeypatch.delenv("DK_OBS_SAMPLE_S", raising=False)
    monkeypatch.delenv("DK_FAULTS", raising=False)
    for ev, met, _, flt, *_ in PKGS.values():
        ev.reset()
        met.reset()
        flt.clear()
    spans.reset()
    timeseries.reset()
    yield
    for ev, met, _, flt, *_ in PKGS.values():
        ev.reset()
        met.reset()
        flt.clear()
    spans.reset()
    timeseries.reset()


def _train(pkg, obs_dir, monkeypatch, name="ADAG", **kw):
    """One run of package ``pkg``'s trainer with its event log in
    ``obs_dir``; -> (trainer, the run's events)."""
    ev, met, rep, _, D, mlp, classes, extra = PKGS[pkg]
    monkeypatch.setenv("DK_OBS_DIR", str(obs_dir))
    ev.reset()
    cls = classes[name]
    args = {**COMMON, **(WIN if name == "ADAG" else {}), **extra, **kw}
    t = cls(mlp(hidden=(16,), input_dim=8, num_classes=2), **args)
    try:
        t.train(D(COLS))
    finally:
        ev.reset()
    return t, rep.read_events(str(obs_dir))


def _shape(evs):
    """Kinds in order, with each chunk's position fields and each span's
    name: what a report reads off a training run."""
    out = []
    for e in evs:
        k = e["kind"]
        if k == "chunk":
            out.append((k, e["i"], e["units"], e["units_done"],
                        e["streamed"]))
        elif k.startswith("span_"):
            out.append((k, e["span"]))
        elif k == "epoch_end":
            out.append((k, e["epoch"], e["nonfinite_steps"]))
        else:
            out.append((k,))
    return out


@pytest.mark.parametrize("name,kw", [
    ("ADAG", {}), ("ADAG", {"stream_chunk_windows": 3}),
    ("SingleTrainer", {"stream_chunk_steps": 7}),
    ("ADAG", {"callbacks": [lambda *a: None]})],
    ids=["adag", "adag_streamed", "single_streamed", "adag_callbacks"])
def test_event_kinds_and_order_equal_jax(tmp_path, monkeypatch, name, kw):
    _, tevs = _train("port", tmp_path / "t", monkeypatch, name, **kw)
    _, jevs = _train("jax", tmp_path / "j", monkeypatch, name, **kw)
    assert _shape(tevs) == _shape(jevs)
    assert [e["kind"] for e in tevs][:2] == ["train_start", "span_begin"]
    assert [e["kind"] for e in tevs][-2:] == ["span_end", "train_end"]


def test_train_run_span_roots_the_run(tmp_path, monkeypatch):
    t, evs = _train("port", tmp_path, monkeypatch,
                    stream_chunk_windows=2)
    (end,) = [e for e in evs if e["kind"] == "span_end"]
    assert end["span"] == "train.run" and end["parent_id"] is None
    assert end["start"] == 0 and end["duration_s"] > 0
    stamped = [e for e in evs if e["kind"] in ("chunk", "epoch_end")]
    assert stamped and all(e["trace_id"] == end["trace_id"]
                           and e["span_id"] == end["span_id"]
                           for e in stamped)
    assert all(e["streamed"] for e in evs if e["kind"] == "chunk")


def test_perf_phases_and_transfer_bytes(tmp_path, monkeypatch):
    t, evs = _train("port", tmp_path, monkeypatch, stream_chunk_windows=2,
                    handle_preemption=True)
    snap = metrics.snapshot()
    hists, counters = snap["histograms"], snap["counters"]
    n_chunks = sum(e["kind"] == "chunk" for e in evs)
    for phase in ("data", "step", "comm", "ckpt"):
        assert hists[f"perf.phase.{phase}"]["count"] > 0, phase
    # one "comm" vote a chunk (handle_preemption), one dispatch a chunk
    assert hists["perf.phase.comm"]["count"] == n_chunks
    assert counters["perf.dispatches"] == n_chunks
    # every byte the feed shipped, once; one loss fetch a chunk
    assert counters["perf.h2d_bytes"] == t._last_feed.put_bytes > 0
    assert hists["perf.h2d_s"]["count"] == t._last_feed.put_count
    assert hists["perf.d2h_s"]["count"] == n_chunks
    # (workers, K, W) f32 losses: 4 x 2 x 4 x 4 bytes a chunk
    assert counters["perf.d2h_bytes"] == n_chunks * 4 * 2 * 4 * 4


def test_perf_phases_equal_jax_counts(tmp_path, monkeypatch):
    """The JAX runner's phases are recorded the same number of times; the
    port adds a call's ``shard`` and ``layout`` and each window's
    ``window`` and ``merge``."""
    _train("port", tmp_path / "t", monkeypatch, stream_chunk_windows=2)
    _train("jax", tmp_path / "j", monkeypatch, stream_chunk_windows=2)
    counts = [{k: v["count"] for k, v in m.snapshot()["histograms"].items()
               if k.startswith("perf.phase.") or k.startswith("perf.h2d")
               or k.startswith("perf.d2h")}
              for m in (metrics, jmetrics)]
    own = {f"perf.phase.{k}": counts[0].pop(f"perf.phase.{k}")
           for k in ("shard", "layout", "window", "merge")}
    assert counts[0] == counts[1]
    windows = own["perf.phase.window"]
    assert windows > 1 and own == {"perf.phase.shard": 1,
                                   "perf.phase.layout": 1,
                                   "perf.phase.window": windows,
                                   "perf.phase.merge": windows}
    for key in ("perf.h2d_bytes", "perf.dispatches", "perf.d2h_bytes"):
        assert (metrics.snapshot()["counters"][key]
                == jmetrics.snapshot()["counters"][key]), key


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_step_loss_nan_halts_the_run(tmp_path, monkeypatch, pkg):
    """A NaN planted through ``DK_FAULTS`` at the ``step.loss`` point
    over the second fetched loss array halts the run under
    ``nan_policy="halt"``: the same ledger and events in both packages."""
    ev, met, rep, flt, *_ = PKGS[pkg]
    monkeypatch.setenv("DK_FAULTS", "step.loss@1:action=corrupt")
    flt.load_env(force=True)
    t, evs = _train(pkg, tmp_path, monkeypatch, nan_policy="halt",
                    stream_chunk_windows=1)
    kinds = [e["kind"] for e in evs]
    assert "fault" in kinds and "nan_halt" in kinds
    (halt,) = [e for e in evs if e["kind"] == "nan_halt"]
    # chunk 1's losses are fetched after chunk 2 is dispatched (the
    # depth-2 retire), so the halt lands at the end of window 3
    assert halt["units_done"] == 3
    assert t.nonfinite_steps > 0
    assert np.asarray(t.get_history()).shape[1] < 2 * 4  # cut short
    assert (tmp_path / "report.txt").exists()


def test_step_loss_nan_under_raise_matches_jax(tmp_path, monkeypatch):
    for pkg in ("port", "jax"):
        flt = PKGS[pkg][3]
        flt.clear()
        flt.inject("step.loss", at=0, action="corrupt")
        with pytest.raises(FloatingPointError):
            _train(pkg, tmp_path / pkg, monkeypatch)
        flt.clear()


def test_report_written_on_rank_0_also_for_a_preempted_run(tmp_path,
                                                           monkeypatch):
    t, _ = _train("port", tmp_path / "clean", monkeypatch)
    text = (tmp_path / "clean" / "report.txt").read_text()
    assert "ADAG" in text or "train" in text

    def preempt(trainer, epoch, logs):
        preemption.request(signal.SIGTERM)

    try:
        with pytest.raises(Preempted):
            _train("port", tmp_path / "pre", monkeypatch,
                   handle_preemption=True, callbacks=[preempt],
                   checkpoint_dir=str(tmp_path / "ck"))
    finally:
        preemption.clear()
    assert (tmp_path / "pre" / "report.txt").exists()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_preempted_single_trainer_leaves_a_preempt_flight_dump(
        tmp_path, monkeypatch, pkg):
    """A SingleTrainer preempted under DK_OBS_DIR dumps its flight
    recorder at the agreed boundary (reason ``preempt``, with the signal
    and the units done), beside its events, in both packages alike."""
    import json

    from dist_keras_tpu.resilience import preemption as jpreemption

    pre = preemption if pkg == "port" else jpreemption

    def preempt(trainer, epoch, logs):
        pre.request(signal.SIGTERM)

    obs = tmp_path / pkg
    try:
        with pytest.raises(SystemExit) as err:
            _train(pkg, obs, monkeypatch, "SingleTrainer",
                   handle_preemption=True, callbacks=[preempt],
                   checkpoint_dir=str(tmp_path / f"ck_{pkg}"))
    finally:
        pre.clear()
    assert err.value.code == 128 + signal.SIGTERM
    dumps = sorted(obs.glob("flightrec-rank_0-*-preempt.json"))
    assert len(dumps) == 1, sorted(p.name for p in obs.iterdir())
    doc = json.loads(dumps[0].read_text())
    spb = ROWS // COMMON["batch_size"]
    assert doc["reason"] == "preempt"
    assert doc["fields"] == {"signum": int(signal.SIGTERM),
                             "units_done": spb}
    assert any(r.get("kind") == "preempt" for r in doc["records"])
    assert (obs / "events-rank_0.jsonl").exists()


def test_no_obs_dir_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    t = ADAG(tmlp(hidden=(16,), input_dim=8, num_classes=2), device="cpu",
             **COMMON, **WIN)
    t.train(TDataset(COLS))
    assert os.listdir(tmp_path) == []


def test_sampler_starts_and_watchdog_quiesces(tmp_path, monkeypatch):
    monkeypatch.setenv("DK_OBS_SAMPLE_S", "0.05")
    quiesced = []
    started = []
    real_start = timeseries.maybe_start_sampler

    def spy_start():
        s = real_start()
        started.append(s)
        if s is not None and s.watchdog is not None:
            monkeypatch.setattr(s.watchdog, "quiesce",
                                lambda: quiesced.append(1))
        return s

    monkeypatch.setattr(timeseries, "maybe_start_sampler", spy_start)
    try:
        _train("port", tmp_path, monkeypatch, stream_chunk_windows=2)
        sampler = timeseries.get_sampler()
        assert started and started[0] is sampler and sampler.running
        assert sampler.watchdog is not None and quiesced == [1]
        sampler.tick()
        assert len(timeseries.get("perf.dispatches")) >= 1
    finally:
        timeseries.stop_sampler()


# -- AsyncMerge -------------------------------------------------------------

def _add(a, b):
    return {k: a[k] + b[k] for k in a}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_async_merge_records_overlap_and_blocked(pkg):
    met = PKGS[pkg][1]
    met.reset()
    cls = AsyncMerge if pkg == "port" else JAsyncMerge
    one = {"w": torch.ones(3) if pkg == "port" else np.ones(3, np.float32)}
    m = cls(_add)
    m.submit(one, one)
    m.submit(one, one)          # waits out the first
    got = m.wait()
    assert m.submits == 2 and m.waits == 2 and not m.pending
    np.testing.assert_array_equal(np.asarray(got["w"]), 2 * np.ones(3))
    hists = met.snapshot()["histograms"]
    assert hists["perf.phase.comm_overlap"]["count"] == 2
    assert hists["perf.phase.comm_blocked"]["count"] == 2
    assert m.wait() is got      # nothing in flight: the last result


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_async_merge_comm_merge_fault_point(pkg):
    flt = PKGS[pkg][3]
    cls = AsyncMerge if pkg == "port" else JAsyncMerge
    one = {"w": torch.ones(2) if pkg == "port" else np.ones(2, np.float32)}
    m = cls(_add)
    flt.inject("comm.merge", at=1)
    m.submit(one, one).wait()
    with pytest.raises(FaultInjected if pkg == "port"
                       else jfaults.FaultInjected):
        m.submit(one, one)
    assert m.submits == 1


def test_overlapped_run_records_the_flush(tmp_path, monkeypatch):
    t, _ = _train("port", tmp_path, monkeypatch, comm_overlap=True,
                  stream_chunk_windows=1)
    assert t._overlap and t._streamed
    hists = metrics.snapshot()["histograms"]
    assert hists["perf.phase.comm_overlap"]["count"] >= 1
    assert hists["perf.phase.comm_blocked"]["count"] >= 1
    assert faults.call_count("comm.merge") >= 1
