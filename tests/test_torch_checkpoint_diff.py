"""The reference's differential-checkpoint checks, held against the
port (``tests/test_diff_ckpt.py``): content-addressed chunk saves into
the shared ``chunks/`` directory restore bit-equal while writing only
what churned, and the chunk GC never collects a chunk that a retained,
quarantined or in-flight step references — through a ``ckpt.gc``
kill."""

import json
import os
import shutil

import numpy as np
import pytest

from dist_keras_tpu_torch.checkpoint import (
    CAS_DIR_NAME,
    CHUNKS_NAME,
    GC_JOURNAL_NAME,
    CheckpointCorrupt,
    Checkpointer,
)
from dist_keras_tpu_torch.resilience import FaultInjected, faults


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    yield
    faults.clear()


@pytest.fixture
def diff_env(monkeypatch):
    """Small chunks + differential saves + synchronous writes (test
    states are tiny; async adds nothing but scheduling noise here)."""
    monkeypatch.setenv("DK_CKPT_CHUNK_MB", "0.0625")  # 64 KB
    monkeypatch.setenv("DK_CKPT_DIFF", "1")
    monkeypatch.setenv("DK_CKPT_ASYNC", "0")


def _state(i=1, churn=0):
    """512 KB float leaf (8 chunks) + a frozen integer leaf (2 chunks)
    + a small pickled tail.  ``churn`` rewrites the first N chunks of
    the float leaf."""
    w = np.arange(65536, dtype=np.float64)
    if churn:
        w = w.copy()
        w[: churn * 8192] += float(i)
    return {"w": w, "frozen": np.arange(16384, dtype=np.int64),
            "i": np.int64(i)}


def _cas(ck):
    return os.path.join(ck.directory, CAS_DIR_NAME)


def _cas_shas(payload):
    """CAS shas referenced by one payload dir's chunks.json."""
    with open(os.path.join(payload, CHUNKS_NAME)) as f:
        meta = json.load(f)
    shas = set()
    for leaf in meta["leaves"]:
        for rel in leaf["files"]:
            head, name = os.path.split(rel)
            assert os.path.basename(head) == "chunks"
            shas.add(name)
    return shas


def test_diff_save_round_trips_and_skips_unchanged(tmp_path, diff_env):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state(1)).wait()
    assert ck.last_diff_stats["skipped"] == 0
    full_bytes = ck.last_diff_stats["bytes_written"]
    payload = tmp_path / "step_00000001"
    # chunk bytes live in the CAS, not the payload dir
    assert not [n for n in os.listdir(payload)
                if n.startswith("chunk_")]
    assert len(os.listdir(_cas(ck))) == 10  # 8 w + 2 frozen
    # one churned chunk: 9 of 10 skipped, bytes written = one chunk
    ck.save(2, _state(2, churn=1)).wait()
    assert ck.last_diff_stats == {
        "chunks": 10, "skipped": 9,
        "bytes_written": 65536,
        "bytes_skipped": full_bytes - 65536}
    step, got = ck.restore()
    assert step == 2
    np.testing.assert_array_equal(got["w"], _state(2, churn=1)["w"])
    np.testing.assert_array_equal(got["frozen"], _state(2)["frozen"])
    assert got["frozen"].dtype == np.int64
    assert ck.verify(1) == "ok" and ck.verify(2) == "ok"


def test_rotted_cas_chunk_convicts_every_referencing_step(
        tmp_path, diff_env):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state(1)).wait()
    ck.save(2, _state(2, churn=1)).wait()
    shared = sorted(_cas_shas(str(tmp_path / "step_00000001"))
                    & _cas_shas(str(tmp_path / "step_00000002")))
    assert shared  # frozen leaf + unchanged w chunks
    tgt = os.path.join(_cas(ck), shared[0])
    with open(tgt, "r+b") as f:
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 0xFF]))
    for step in (1, 2):
        with pytest.raises(CheckpointCorrupt) as ei:
            ck.verify(step)
        assert shared[0] in "; ".join(ei.value.problems)


def test_diff_payload_restores_with_diff_and_chunking_off(
        tmp_path, diff_env, monkeypatch):
    """The CAS references recorded in chunks.json are plain relative
    paths — a reader with every knob at its default follows them
    without knowing the differential layer exists."""
    s = _state(3, churn=2)
    Checkpointer(str(tmp_path)).save(1, s).wait()
    monkeypatch.delenv("DK_CKPT_DIFF")
    monkeypatch.setenv("DK_CKPT_CHUNK_MB", "0")
    step, got = Checkpointer(str(tmp_path)).restore()
    assert step == 1
    np.testing.assert_array_equal(got["w"], s["w"])


def test_diff_off_by_default_keeps_in_payload_chunks(
        tmp_path, monkeypatch):
    monkeypatch.setenv("DK_CKPT_CHUNK_MB", "0.0625")
    monkeypatch.setenv("DK_CKPT_ASYNC", "0")
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state()).wait()
    payload = tmp_path / "step_00000001"
    assert [n for n in os.listdir(payload) if n.startswith("chunk_")]
    assert not os.path.exists(_cas(ck))
    assert ck.last_diff_stats is None


def test_verify_off_disables_diff_with_the_hashing_it_needs(
        tmp_path, diff_env, monkeypatch):
    """DK_CKPT_VERIFY=0 opts out of hashing — and the differential
    path's identities ARE hashes, so it degrades to the plain chunk
    layout instead of silently re-charging the hash cost."""
    monkeypatch.setenv("DK_CKPT_VERIFY", "0")
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state()).wait()
    payload = tmp_path / "step_00000001"
    assert [n for n in os.listdir(payload) if n.startswith("chunk_")]
    assert not os.path.exists(_cas(ck))
    step, got = ck.restore()
    np.testing.assert_array_equal(got["w"], _state()["w"])


def test_ctor_diff_flag_wins_over_knob(tmp_path, monkeypatch):
    monkeypatch.setenv("DK_CKPT_CHUNK_MB", "0.0625")
    monkeypatch.setenv("DK_CKPT_ASYNC", "0")
    ck = Checkpointer(str(tmp_path), diff=True)  # knob unset
    ck.save(1, _state()).wait()
    assert ck.last_diff_stats["chunks"] == 10
    assert os.path.isdir(_cas(ck))


def test_gc_shared_chunk_survives_retention_of_oldest(
        tmp_path, diff_env, monkeypatch):
    monkeypatch.setenv("DK_CKPT_GC_GRACE_S", "0")
    ck = Checkpointer(str(tmp_path), max_to_keep=3)
    for i in range(1, 5):  # step 1 retired by the save of step 4
        ck.save(i, _state(i, churn=1)).wait()
    assert ck.all_steps() == [2, 3, 4]
    # the frozen chunks + unchanged w chunks are shared across ALL
    # retained steps and must survive; step 1's churned chunk is gone
    for step in (2, 3, 4):
        assert ck.verify(step) == "ok"
        _s, got = ck.restore(step=step)
        np.testing.assert_array_equal(got["w"],
                                      _state(step, churn=1)["w"])
    live = set()
    for step in (2, 3, 4):
        live |= _cas_shas(str(tmp_path / f"step_{step:08d}"))
    assert set(os.listdir(_cas(ck))) == live


def test_gc_respects_grace_window(tmp_path, diff_env, monkeypatch):
    monkeypatch.setenv("DK_CKPT_GC_GRACE_S", "3600")
    ck = Checkpointer(str(tmp_path), max_to_keep=1)
    ck.save(1, _state(1)).wait()
    ck.save(2, _state(2, churn=8)).wait()  # every w chunk rewritten
    assert ck.all_steps() == [2]
    # step 1's unique chunks are unreferenced but YOUNG: not collected
    assert len(os.listdir(_cas(ck))) > 10
    monkeypatch.setenv("DK_CKPT_GC_GRACE_S", "0")
    assert ck.gc_chunks(raise_errors=True) == 8
    assert set(os.listdir(_cas(ck))) == _cas_shas(
        str(tmp_path / "step_00000002"))


def test_gc_quarantined_step_pins_its_chunks(
        tmp_path, diff_env, monkeypatch):
    monkeypatch.setenv("DK_CKPT_GC_GRACE_S", "0")
    ck = Checkpointer(str(tmp_path), max_to_keep=2)
    ck.save(1, _state(1)).wait()
    ck.save(2, _state(2, churn=2)).wait()
    pinned = _cas_shas(str(tmp_path / "step_00000002"))
    # rot the payload WITHOUT touching its chunk table: the quarantined
    # evidence must keep pinning the chunks its table references
    tgt = tmp_path / "step_00000002" / "small.pkl"
    raw = bytearray(tgt.read_bytes())
    raw[0] ^= 0xFF
    tgt.write_bytes(bytes(raw))
    step, _got = ck.restore()  # convicts 2, quarantines, falls back
    assert step == 1
    assert (tmp_path / "step_00000002.corrupt").is_dir()
    assert ck.gc_chunks(raise_errors=True) == 0
    assert pinned <= set(os.listdir(_cas(ck)))


def test_gc_kill_mid_sweep_leaves_every_retained_step_restorable(
        tmp_path, diff_env, monkeypatch):
    monkeypatch.setenv("DK_CKPT_GC_GRACE_S", "0")
    ck = Checkpointer(str(tmp_path), max_to_keep=1)
    ck.save(1, _state(1)).wait()
    shutil.rmtree(str(tmp_path / "step_00000001"))  # orphan its chunks
    with faults.armed("ckpt.gc"):
        with pytest.raises(FaultInjected):
            ck.gc_chunks(raise_errors=True)
    journal = os.path.join(_cas(ck), GC_JOURNAL_NAME)
    assert os.path.exists(journal)  # intent durable, nothing deleted
    ck.save(2, _state(2)).wait()  # retained step written after the kill
    assert ck.verify(2) == "ok"
    _s, got = ck.restore()
    np.testing.assert_array_equal(got["w"], _state(2)["w"])
    # the next sweep finishes the job and retires the journal
    ck.gc_chunks(raise_errors=True)
    assert not os.path.exists(journal)
    assert set(os.listdir(_cas(ck))) == _cas_shas(
        str(tmp_path / "step_00000002"))


def test_gc_failure_never_fails_the_save(tmp_path, diff_env,
                                         monkeypatch):
    monkeypatch.setenv("DK_CKPT_GC_GRACE_S", "0")
    ck = Checkpointer(str(tmp_path), max_to_keep=1)
    ck.save(1, _state(1)).wait()
    with faults.armed("ckpt.gc"):
        # retention of step 1 makes its unique chunks candidates; the
        # injected kill inside the sweep is absorbed — the SAVE is
        # already committed and must report success
        ck.save(2, _state(2, churn=8)).wait()
    assert ck.latest_step() == 2
    assert ck.verify(2) == "ok"


def test_all_steps_and_orphan_gc_ignore_non_step_shaped(
        tmp_path, diff_env):
    """The `chunks/` CAS dir, the GC journal, and anything else not
    step-shaped must never read as a step or be swept as orphaned
    staging."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state(1)).wait()
    os.makedirs(str(tmp_path / "step_backup"))  # operator scratch
    with open(str(tmp_path / "step_notes.txt"), "w") as f:
        f.write("ops notes\n")
    journal = os.path.join(_cas(ck), GC_JOURNAL_NAME)
    with open(journal, "w") as f:
        f.write("{}\n")
    assert ck.all_steps() == [1]
    ck.save(2, _state(2)).wait()  # runs _gc_orphans + gc_chunks
    assert os.path.isdir(str(tmp_path / "step_backup"))
    assert os.path.exists(str(tmp_path / "step_notes.txt"))
    assert os.path.isdir(_cas(ck))


def test_truncated_cas_entry_is_rewritten_on_reuse(tmp_path,
                                                   diff_env):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state(1)).wait()
    sha = sorted(_cas_shas(str(tmp_path / "step_00000001")))[0]
    tgt = os.path.join(_cas(ck), sha)
    with open(tgt, "r+b") as f:
        f.truncate(17)
    ck.save(2, _state(2)).wait()  # same content: would-be reuse
    assert os.path.getsize(tgt) > 17  # healed in place, not skipped
    assert ck.verify(2) == "ok"
    _s, got = ck.restore(step=2)
    np.testing.assert_array_equal(got["w"], _state(2)["w"])


def test_gc_journal_recovery_is_grace_exempt_for_untouched(
        tmp_path, diff_env, monkeypatch):
    """A crashed sweep's journaled candidates — verified unreferenced
    and aged when the intent was recorded — finish collection on the
    next sweep even inside a fresh grace window, provided nothing
    touched them since (a touch means a save adopted the chunk)."""
    monkeypatch.setenv("DK_CKPT_GC_GRACE_S", "0")
    ck = Checkpointer(str(tmp_path), max_to_keep=1)
    ck.save(1, _state(1)).wait()
    orphaned = set(os.listdir(_cas(ck)))
    shutil.rmtree(str(tmp_path / "step_00000001"))
    with faults.armed("ckpt.gc"):
        with pytest.raises(FaultInjected):
            ck.gc_chunks(raise_errors=True)
    # the restarted sweep runs under a LONG grace window: without the
    # journal the young-mtime chunks would wait it out
    monkeypatch.setenv("DK_CKPT_GC_GRACE_S", "3600")
    assert ck.gc_chunks(raise_errors=True) == len(orphaned)
    assert not os.path.exists(os.path.join(_cas(ck), GC_JOURNAL_NAME))
    assert os.listdir(_cas(ck)) == []

