"""The port's copies of the knob registry and the event log against the
JAX package's ``utils/knobs.py`` and ``observability/events.py``: the
same registry, the same parsing, and event files the JAX report reader
merges as its own."""

import json

import pytest

from dist_keras_tpu.observability import events as jevents
from dist_keras_tpu.observability import report as jreport
from dist_keras_tpu.utils import knobs as jknobs
from dist_keras_tpu_torch.observability import events
from dist_keras_tpu_torch.utils import knobs

SPELLINGS = ["1", "0", "on", "off", "OFF", " No ", "no", "false", "False",
             "true", "yes", "anything", " 0 "]


def test_registry_is_the_jax_registry():
    assert list(knobs.KNOBS) == list(jknobs.KNOBS)
    for name, k in knobs.KNOBS.items():
        j = jknobs.KNOBS[name]
        assert (k.default, k.kind, k.on_error, k.doc) == (
            j.default, j.kind, j.on_error, j.doc), name
    assert knobs.doc_table() == jknobs.doc_table()


@pytest.mark.parametrize("value", SPELLINGS)
def test_bool_spellings_parse_as_jax(value):
    assert knobs._parse_bool(value) == jknobs._parse_bool(value)


@pytest.mark.parametrize("name,value", [
    ("DK_FUSED_BWD", None), ("DK_FUSED_BWD", "1"), ("DK_FUSED_BWD", "off"),
    ("DK_FUSED_BWD", "  "), ("DK_OBS_ROTATE_MB", "0.5"),
    ("DK_OBS_ROTATE_MB", "junk"), ("DK_OBS_ROTATE_KEEP", "7"),
    ("DK_COORD_TIMEOUT_S", "x"), ("DK_OBS_DIR", "/tmp/o"),
])
def test_get_and_raw_read_as_jax(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)
    assert knobs.get(name) == jknobs.get(name)
    assert knobs.raw(name) == jknobs.raw(name)


def test_malformed_raise_knob_raises_in_both(monkeypatch):
    monkeypatch.setenv("DK_FAULTS_RATE", "not-a-rate")
    for mod in (knobs, jknobs):
        with pytest.raises(ValueError, match="DK_FAULTS_RATE"):
            mod.get("DK_FAULTS_RATE")


def test_unregistered_name_raises_key_error():
    for fn in (knobs.raw, knobs.get):
        with pytest.raises(KeyError, match="DK_NOT_A_KNOB"):
            fn("DK_NOT_A_KNOB")


def test_known_events_are_the_jax_vocabulary():
    assert events.KNOWN_EVENTS == jevents.KNOWN_EVENTS
    assert "fused_bwd_rejected" in events.KNOWN_EVENTS


@pytest.fixture
def obs(monkeypatch, tmp_path):
    for name in ("DK_OBS_DIR", "DK_OBS_ROTATE_MB", "DK_COORD_RANK", "RANK"):
        monkeypatch.delenv(name, raising=False)
    events.reset()
    yield tmp_path
    events.reset()


def test_emit_without_obs_dir_writes_nothing(obs):
    events.emit("fused_bwd_rejected", reason="mismatch")
    assert not events.enabled() and events.obs_dir() is None
    assert list(obs.iterdir()) == []


def test_emit_writes_one_json_line_per_event(obs, monkeypatch):
    monkeypatch.setenv("DK_OBS_DIR", str(obs))
    monkeypatch.setenv("DK_COORD_RANK", "3")
    events.reset()
    events.emit("fused_bwd_rejected", reason="mismatch", shape=[1, 2, 3, 4])
    events.emit("fused_bwd_rejected", reason="unverifiable")
    assert events.enabled() and events.rank() == 3
    lines = (obs / "events-rank_3.jsonl").read_text().splitlines()
    recs = [json.loads(ln) for ln in lines]
    assert [r["seq"] for r in recs] == [0, 1]
    for r in recs:
        assert {"t", "seq", "rank", "kind"} <= set(r)
        assert r["rank"] == 3 and r["kind"] == "fused_bwd_rejected"
    assert recs[0]["shape"] == [1, 2, 3, 4]
    # the JAX package's report reader merges the port's files as its own
    merged = jreport.read_events(str(obs))
    assert [r["reason"] for r in merged] == ["mismatch", "unverifiable"]


def test_rank_falls_back_to_the_launchers_rank(obs, monkeypatch):
    monkeypatch.setenv("RANK", "2")
    assert events.EventWriter(str(obs)).rank == 2


def test_rotation_keeps_seq_monotonic(obs):
    w = events.EventWriter(str(obs), rank=0, rotate_bytes=200, rotate_keep=5)
    for i in range(12):
        w.emit("chunk", i=i)
    w.close()
    recs = jreport.read_events(str(obs))
    assert [r["i"] for r in recs] == list(range(12))
    assert len(list(obs.glob("events-rank_0.jsonl*"))) > 1


def test_emit_never_raises_on_a_bad_directory(obs, monkeypatch, capsys):
    blocker = obs / "a_file"
    blocker.write_text("not a directory")
    monkeypatch.setenv("DK_OBS_DIR", str(blocker / "sub"))
    events.reset()
    events.emit("fused_bwd_rejected", reason="mismatch")
    events.emit("fused_bwd_rejected", reason="mismatch")
    assert not events.enabled()
    assert capsys.readouterr().err.count("WARNING") == 1
