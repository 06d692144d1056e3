"""The reference's own checkpoint checks, held against the port's
``checkpoint.Checkpointer``: commits and kills (``tests/
test_resilience.py``), integrity manifests, bit flips, truncation,
quarantine and the verified-restore cascade (``tests/
test_self_healing.py``), and the chunked format with the async writer
(``tests/test_async_ckpt.py``).  States are numpy trees on the CPU;
``tests/test_torch_checkpoint_torch.py`` holds the tensor snapshot."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from dist_keras_tpu_torch.checkpoint import (
    CHUNKS_NAME,
    MANIFEST_NAME,
    AsyncSaveHandle,
    CheckpointCorrupt,
    Checkpointer,
    SaveSuperseded,
    build_manifest,
    verify_manifest,
)
from dist_keras_tpu_torch.resilience import (
    FaultInjected,
    Preempted,
    faults,
    preemption,
)


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    preemption.clear()
    yield
    faults.clear()
    preemption.clear()
    preemption.restore()


# -- commits and kills (tests/test_resilience.py) ---------------------------
def _ckptr(tmp_path, **kw):
    from dist_keras_tpu_torch.checkpoint import Checkpointer

    ck = Checkpointer(str(tmp_path / "ck"), **kw)
    ck._retry.sleep = lambda s: None  # tests never wall-sleep
    return ck


def test_checkpoint_kill_mid_write_leaves_previous_step_restorable(
        tmp_path):
    """The acceptance scenario: a save killed between write and commit
    leaves only a tmp orphan; a fresh Checkpointer GCs it and restores
    the previous committed step bit-exactly."""
    ck = _ckptr(tmp_path)
    state1 = {"a": np.arange(4.0), "b": np.int32(3)}
    ck.save(1, state1).wait()
    with faults.armed("checkpoint.save"):
        with pytest.raises(FaultInjected):
            # async (the default): the injected kill surfaces on the
            # handle — wait() is the durability barrier
            ck.save(2, {"a": np.arange(4.0) * 2, "b": np.int32(9)}).wait()
    names = sorted(os.listdir(ck.directory))
    assert any(n.startswith("step_00000002") for n in names)  # orphan tmp
    assert "step_00000002" not in names                       # no commit

    ck2 = _ckptr(tmp_path)  # "restarted process"
    assert ck2.all_steps() == [1]  # the orphan is ignored, not a step
    step, restored = ck2.restore(template=state1)
    assert step == 1
    np.testing.assert_array_equal(restored["a"], state1["a"])
    np.testing.assert_array_equal(restored["b"], state1["b"])
    # the orphan tmp is garbage-collected by the writer's NEXT
    # successful commit (never by a read-only query — see the
    # concurrent-reader test below)
    ck2.save(3, state1).wait()
    assert not any("tmp" in n for n in os.listdir(ck2.directory))
    assert ck2.all_steps() == [1, 3]


def test_checkpoint_save_retries_transient_oserror(tmp_path):
    ck = _ckptr(tmp_path)
    faults.inject("checkpoint.save", at=0, times=2, exc=OSError)
    ck.save(5, {"a": np.ones(3)})  # two failures absorbed, third commits
    assert ck.all_steps() == [5]
    _, restored = ck.restore(template={"a": np.ones(3)})
    np.testing.assert_array_equal(restored["a"], np.ones(3))


def test_checkpoint_save_gives_up_after_budget(tmp_path):
    ck = _ckptr(tmp_path)
    faults.inject("checkpoint.save", at=0, times=99, exc=OSError)
    with pytest.raises(OSError):
        ck.save(5, {"a": np.ones(3)}).wait()
    ck2 = _ckptr(tmp_path)
    assert ck2.all_steps() == []  # nothing half-committed


def test_checkpoint_overwrite_same_step_is_atomic(tmp_path):
    ck = _ckptr(tmp_path)
    ck.save(3, {"a": np.zeros(2)})
    ck.save(3, {"a": np.full(2, 7.0)})  # force-overwrite via rename
    assert ck.all_steps() == [3]
    _, restored = ck.restore(template={"a": np.zeros(2)})
    np.testing.assert_array_equal(restored["a"], np.full(2, 7.0))


def test_checkpoint_overwrite_kill_mid_swap_keeps_old_version(tmp_path):
    """A kill between retiring step_N to step_N.old and committing the
    new step_N must not lose the committed version: all_steps() rolls
    the .old back."""
    ck = _ckptr(tmp_path)
    ck.save(3, {"a": np.zeros(2)}).wait()
    with faults.armed("checkpoint.commit"):
        with pytest.raises(FaultInjected):
            ck.save(3, {"a": np.full(2, 7.0)}).wait()
    names = sorted(os.listdir(ck.directory))
    assert "step_00000003" not in names        # mid-swap state on disk
    assert "step_00000003.old" in names

    ck2 = _ckptr(tmp_path)  # restart
    assert ck2.all_steps() == [3]              # rolled back
    _, restored = ck2.restore(template={"a": np.zeros(2)})
    np.testing.assert_array_equal(restored["a"], np.zeros(2))  # OLD data


def test_checkpoint_reader_never_deletes_writer_staging(tmp_path):
    """A read-only poller (second Checkpointer on the same directory)
    must not GC another process's in-progress tmp dir."""
    ck = _ckptr(tmp_path)
    ck.save(1, {"a": np.zeros(2)}).wait()
    staging = os.path.join(ck.directory, "step_00000002.tmp")
    os.makedirs(staging)  # a concurrent writer mid-save
    reader = _ckptr(tmp_path)
    assert reader.all_steps() == [1]
    assert reader.latest_step() == 1
    assert os.path.isdir(staging)  # untouched by the read-only queries


def test_checkpoint_retention_still_prunes(tmp_path):
    ck = _ckptr(tmp_path, max_to_keep=2)
    for s in (1, 2, 3, 4):
        # waited per save: rapid UNwaited saves legitimately coalesce
        # latest-wins under DK_CKPT_ASYNC (tests/test_async_ckpt.py)
        ck.save(s, {"a": np.float32(s)}).wait()
    assert ck.all_steps() == [3, 4]



# -- manifests, quarantine, the verified fallback (tests/test_self_healing.py)
def _payload(ck, step):
    # drain the async writer first: these tests poke the committed
    # bytes directly, and with DK_CKPT_ASYNC (default on) a just-issued
    # save may still be streaming out of the background thread
    ck.wait_until_finished()
    return os.path.join(ck.directory, f"step_{step:08d}")


def test_save_writes_manifest_that_verifies_ok(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=3)
    ck.save(1, _state())
    manifest_path = os.path.join(_payload(ck, 1), MANIFEST_NAME)
    assert os.path.exists(manifest_path)
    with open(manifest_path) as f:
        manifest = json.load(f)
    assert manifest["format"] == 1 and manifest["files"]
    # every listed entry carries bytes + sha256
    for entry in manifest["files"].values():
        assert entry["bytes"] > 0 and len(entry["sha256"]) == 64
    assert ck.verify(1) == "ok"
    assert verify_manifest(_payload(ck, 1)) == ("ok", [])


def test_manifest_tree_digest_covers_membership(tmp_path):
    (tmp_path / "a.bin").write_bytes(b"aaaa")
    (tmp_path / "b.bin").write_bytes(b"bbbb")
    m1 = build_manifest(str(tmp_path))
    # same bytes, one file renamed: per-file hashes overlap but the
    # tree digest must differ (membership is part of integrity)
    os.rename(tmp_path / "b.bin", tmp_path / "c.bin")
    m2 = build_manifest(str(tmp_path))
    assert m1["tree_sha256"] != m2["tree_sha256"]


def test_verify_detects_bit_flip(tmp_path, flip_one_byte):
    ck = Checkpointer(str(tmp_path), max_to_keep=3)
    ck.save(1, _state())
    bad = flip_one_byte(_payload(ck, 1))
    with pytest.raises(CheckpointCorrupt) as ei:
        ck.verify(1)
    # the typed error names the rotted file and the step
    assert os.path.basename(bad) in str(ei.value)
    assert ei.value.step == 1 and ei.value.problems


def test_verify_detects_truncation_by_size(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=3)
    ck.save(1, _state())
    files = [f for f in os.listdir(_payload(ck, 1)) if f != MANIFEST_NAME]
    tgt = os.path.join(_payload(ck, 1), files[0])
    with open(tgt, "r+b") as f:
        f.truncate(max(os.path.getsize(tgt) - 1, 0))
    with pytest.raises(CheckpointCorrupt) as ei:
        ck.verify(1)
    assert "bytes" in "; ".join(ei.value.problems)


def test_verify_detects_missing_and_unlisted_files(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=3)
    ck.save(1, _state())
    files = sorted(f for f in os.listdir(_payload(ck, 1))
                   if f != MANIFEST_NAME)
    os.remove(os.path.join(_payload(ck, 1), files[0]))
    with open(os.path.join(_payload(ck, 1), "stray.bin"), "wb") as f:
        f.write(b"not in the manifest")
    status, problems = verify_manifest(_payload(ck, 1))
    assert status == "corrupt"
    joined = "; ".join(problems)
    assert "listed but missing" in joined
    assert "present but not in manifest" in joined


def test_rotted_manifest_is_itself_corrupt(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=3)
    ck.save(1, _state())
    with open(os.path.join(_payload(ck, 1), MANIFEST_NAME), "w") as f:
        f.write('{"files": {"torn')
    with pytest.raises(CheckpointCorrupt, match="manifest unreadable"):
        ck.verify(1)


def test_wrong_shape_manifest_is_typed_corrupt(tmp_path):
    """Valid JSON of the wrong SHAPE (a torn rewrite) stays a typed
    corruption verdict — leaked untyped out of the comparison walk,
    supervise() would read the TypeError as a fatal config error
    instead of healing around the step."""
    ck = Checkpointer(str(tmp_path), max_to_keep=3)
    ck.save(1, _state())
    mpath = os.path.join(_payload(ck, 1), MANIFEST_NAME)
    for rotted in ('{"files": ["a.bin"]}',
                   '{"files": {"a.bin": "xx"}}',
                   '{"files": 3}'):
        with open(mpath, "w") as f:
            f.write(rotted)
        status, problems = verify_manifest(_payload(ck, 1))
        assert status == "corrupt", rotted
        assert "manifest unreadable" in problems[0]


def test_legacy_checkpoint_is_soft_unverifiable(tmp_path):
    """A pre-manifest checkpoint (old runs) must keep restoring: verify
    reports a SOFT "unverifiable", never a corruption verdict."""
    ck = Checkpointer(str(tmp_path), max_to_keep=3)
    state = _state()
    ck.save(1, state)
    os.remove(os.path.join(_payload(ck, 1), MANIFEST_NAME))
    assert ck.verify(1) == "unverifiable"
    step, restored = ck.restore()
    assert step == 1
    np.testing.assert_array_equal(restored["w"], state["w"])


def test_verify_env_optout_skips_manifest_write(tmp_path, monkeypatch):
    monkeypatch.setenv("DK_CKPT_VERIFY", "0")
    ck = Checkpointer(str(tmp_path), max_to_keep=3)
    ck.save(1, _state())
    assert not os.path.exists(os.path.join(_payload(ck, 1), MANIFEST_NAME))
    # no manifest = legacy semantics: soft unverifiable, restore works
    assert ck.verify(1) == "unverifiable"
    assert ck.restore()[0] == 1


def test_restore_falls_back_past_corrupt_latest_and_quarantines(
        tmp_path, flip_one_byte):
    ck = Checkpointer(str(tmp_path), max_to_keep=5)
    s1, s2, s3 = _state(1.0), _state(3.0), _state(7.0)
    ck.save(1, s1).wait()   # waited: back-to-back UNwaited saves would
    ck.save(2, s2).wait()   # coalesce latest-wins (by design) and this
    ck.save(3, s3).wait()   # test needs all three steps on disk
    flip_one_byte(_payload(ck, 3))
    step, restored = ck.restore()
    assert step == 2
    np.testing.assert_array_equal(restored["w"], s2["w"])
    # the bad step is quarantined as evidence, not deleted...
    assert os.path.isdir(str(tmp_path / "step_00000003.corrupt"))
    # ...and no reader ever counts it again
    assert ck.latest_step() == 2
    assert ck.all_steps() == [1, 2]


def test_restore_cascades_past_two_corrupt_steps(tmp_path, flip_one_byte):
    ck = Checkpointer(str(tmp_path), max_to_keep=5)
    s1 = _state(1.0)
    ck.save(1, s1).wait()
    ck.save(2, _state(3.0)).wait()
    ck.save(3, _state(7.0)).wait()
    flip_one_byte(_payload(ck, 3))
    flip_one_byte(_payload(ck, 2))
    step, restored = ck.restore()
    assert step == 1
    np.testing.assert_array_equal(restored["w"], s1["w"])


def test_restore_with_no_intact_fallback_raises_typed(
        tmp_path, flip_one_byte):
    ck = Checkpointer(str(tmp_path), max_to_keep=3)
    ck.save(1, _state())
    flip_one_byte(_payload(ck, 1))
    with pytest.raises(CheckpointCorrupt):
        ck.restore()


def test_multihost_restore_refuses_per_rank_fallback(
        tmp_path, flip_one_byte):
    """Two-phase mode: a rank whose payload rotted gets the TYPED
    verdict, never a silent per-rank fallback — this rank restoring
    step 2 while its peer (whose payload hashes clean) restores step 4
    would diverge the cluster.  Nothing is quarantined either (the
    peer's restore of the same promoted step is legitimate); the
    supervisor restarts the pod from the read-only
    ``latest_verified_step`` probe instead."""
    def _mh(rank):
        ck = Checkpointer(str(tmp_path), rank=rank, world=2)
        ck._retry.sleep = lambda s: None
        return ck

    def _st(rank, step):
        return {"w": np.arange(16.0) + 10 * rank + step}

    for step in (2, 4):
        _mh(1).save(step, _st(1, step)).wait()
        _mh(0).save(step, _st(0, step)).wait()  # leader promotes
    flip_one_byte(str(tmp_path / "step_00000004" / "host_1"))

    with pytest.raises(CheckpointCorrupt) as ei:
        _mh(1).restore(template=_st(1, 4))
    assert "does not fall back per-rank" in "; ".join(ei.value.problems)
    # the step stays promoted and unquarantined: rank 0's replica is
    # clean, and its restore of the SAME step must keep succeeding
    assert os.path.isdir(str(tmp_path / "step_00000004"))
    assert not os.path.isdir(str(tmp_path / "step_00000004.corrupt"))
    step, got = _mh(0).restore(template=_st(0, 4))
    assert step == 4
    np.testing.assert_array_equal(got["w"], _st(0, 4)["w"])
    # the pod-restart probe names the common earlier verified step
    assert _mh(1).latest_verified_step() == 2


def test_two_phase_optout_multihost_restore_also_refuses_fallback(
        tmp_path, monkeypatch, flip_one_byte):
    """DK_CKPT_TWO_PHASE=0 (per-host LOCAL checkpoint dirs): one
    host's local copy rotting must get the same typed verdict as the
    two-phase pod — this rank quietly resuming from step 2 while the
    peers (whose local copies hash clean) resume from step 4 would
    diverge the cluster just the same."""
    monkeypatch.setenv("DK_CKPT_TWO_PHASE", "0")
    ck = Checkpointer(str(tmp_path), rank=1, world=2, max_to_keep=5)
    ck.save(2, _state(2.0))
    ck.save(4, _state(4.0))
    flip_one_byte(_payload(ck, 4))
    with pytest.raises(CheckpointCorrupt) as ei:
        ck.restore()
    assert "does not fall back per-rank" in "; ".join(ei.value.problems)
    # nothing quarantined; the probe names the common earlier step
    assert os.path.isdir(_payload(ck, 4))
    assert not os.path.isdir(_payload(ck, 4) + ".corrupt")
    assert ck.latest_verified_step() == 2


def test_restore_verify_false_loads_rotted_manifest_payload(tmp_path):
    """verify=False restores whatever pickle can read — the manifest is
    not consulted (the bit flipped here lands in the manifest itself so
    the payload stays loadable)."""
    ck = Checkpointer(str(tmp_path), max_to_keep=3)
    ck.save(1, _state())
    with open(os.path.join(_payload(ck, 1), MANIFEST_NAME), "a") as f:
        f.write(" ")  # manifest no longer matches its own tree digest?
    # a whitespace append keeps valid JSON; rot a listed hash instead
    mpath = os.path.join(_payload(ck, 1), MANIFEST_NAME)
    with open(mpath) as f:
        manifest = json.load(f)
    rel = next(iter(manifest["files"]))
    manifest["files"][rel]["sha256"] = "0" * 64
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    # verify=False bypasses the manifest entirely: pickle reads fine
    assert ck.restore(step=1, verify=False)[0] == 1
    # the default verified restore condemns it (and, with no fallback
    # left, quarantines + re-raises the typed error)
    with pytest.raises(CheckpointCorrupt):
        ck.restore()
    assert not os.path.isdir(_payload(ck, 1))
    assert os.path.isdir(str(tmp_path / "step_00000001.corrupt"))


def test_latest_verified_step_skips_corrupt_read_only(
        tmp_path, flip_one_byte):
    ck = Checkpointer(str(tmp_path), max_to_keep=5)
    # .wait() between back-to-back saves: without the durability
    # barrier the async writer may still hold step 1 in its pending
    # slot when save(2) arrives, and single-host latest-wins coalescing
    # (by design) drops step 1 entirely — see
    # test_async_back_to_back_saves_coalesce_latest_wins
    ck.save(1, _state(1.0)).wait()
    ck.save(2, _state(2.0)).wait()
    flip_one_byte(_payload(ck, 2))
    assert ck.latest_verified_step() == 1
    # STRICTLY read-only: the corrupt step was skipped, not quarantined
    assert os.path.isdir(_payload(ck, 2))
    assert ck.latest_step() == 2


def test_latest_verified_step_empty_dir_is_none(tmp_path):
    assert Checkpointer(str(tmp_path)).latest_verified_step() is None


def test_async_back_to_back_saves_coalesce_latest_wins(
        tmp_path, monkeypatch):
    """Pins the root cause of the (fixed) flaky latest-verified-step
    tests: two un-waited single-host saves race by design — if the
    writer has not yet dequeued save(N) when save(N+1) arrives, N is
    coalesced away TYPED (``SaveSuperseded``) and never touches disk.
    ``.wait()`` is the durability barrier; the coalescing itself is the
    documented latest-wins contract, not a bug."""
    import threading

    from dist_keras_tpu_torch.checkpoint import SaveSuperseded

    ck = Checkpointer(str(tmp_path), max_to_keep=5)
    gate = threading.Event()
    real = Checkpointer._save_sync

    def gated(self, step, state, rank, world, shard_specs=None):
        gate.wait(timeout=30)
        return real(self, step, state, rank, world, shard_specs)

    monkeypatch.setattr(Checkpointer, "_save_sync", gated)
    h1 = ck.save(1, _state(1.0))
    # park until the writer thread has dequeued step 1 (it is now
    # blocked inside the gated _save_sync), so step 2 deterministically
    # lands in the pending slot and step 3 deterministically coalesces
    # it — the exact interleaving the flaky tests hit by accident
    for _ in range(200):
        with ck._async_cv:
            taken = ck._async_pending is None
        if taken:
            break
        import time as _t

        _t.sleep(0.01)
    assert taken, "writer never dequeued the first save"
    h2 = ck.save(2, _state(2.0))
    h3 = ck.save(3, _state(3.0))
    gate.set()
    assert h1.wait(timeout_s=30) == 1
    assert h3.wait(timeout_s=30) == 3
    with pytest.raises(SaveSuperseded):
        h2.wait(timeout_s=30)
    assert h2.status == "superseded"
    # step 2 never reached disk; 1 and 3 are committed and verifiable
    assert ck.all_steps() == [1, 3]
    assert ck.latest_verified_step() == 3


def test_retention_eventually_retires_quarantined_evidence(
        tmp_path, flip_one_byte):
    ck = Checkpointer(str(tmp_path), max_to_keep=2)
    ck.save(1, _state(1.0)).wait()
    ck.save(2, _state(2.0)).wait()
    flip_one_byte(_payload(ck, 2))
    with pytest.raises(CheckpointCorrupt):
        ck.verify(2)
    assert ck._quarantine(2)
    quarantined = str(tmp_path / "step_00000002.corrupt")
    assert os.path.isdir(quarantined)
    # quarantine survives saves while its step is on the live horizon
    ck.save(3, _state(3.0)).wait()
    assert os.path.isdir(quarantined)
    # ...and is retired once retention moves past it
    ck.save(4, _state(4.0)).wait()
    ck.save(5, _state(5.0)).wait()
    assert not os.path.isdir(quarantined)



# -- the chunked format and the async writer (tests/test_async_ckpt.py)
def _state(scale=1.0, n=2 ** 16):
    return {"w": np.arange(n, dtype=np.float64) * scale,
            "b": np.ones(4, dtype=np.float32),
            "step": np.int64(3)}


def _chunked(monkeypatch, mb="0.25"):
    """Small chunks so the test states actually shard into files."""
    monkeypatch.setenv("DK_CKPT_CHUNK_MB", mb)


def test_chunked_save_round_trips_bit_equal(tmp_path, monkeypatch):
    _chunked(monkeypatch)
    ck = Checkpointer(str(tmp_path))
    s = _state()
    ck.save(1, s).wait()
    names = sorted(os.listdir(os.path.join(str(tmp_path),
                                           "step_00000001")))
    # the 512 KB leaf sharded into 0.25 MB chunk files, small leaves
    # pickled, everything signed by the manifest
    assert CHUNKS_NAME in names and "small.pkl" in names
    assert MANIFEST_NAME in names
    chunks = [n for n in names if n.startswith("chunk_")]
    assert len(chunks) == 2
    step, got = ck.restore()
    assert step == 1
    np.testing.assert_array_equal(got["w"], s["w"])
    np.testing.assert_array_equal(got["b"], s["b"])
    assert got["b"].dtype == np.float32 and int(got["step"]) == 3


def test_manifest_is_one_pass_and_covers_every_chunk(tmp_path,
                                                     monkeypatch):
    """The streaming writer's manifest (hashes computed as bytes were
    written) must be byte-for-byte what a re-hashing walk computes —
    and carry one entry per chunk file."""
    from dist_keras_tpu_torch.checkpoint import build_manifest

    _chunked(monkeypatch)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state()).wait()
    payload = os.path.join(str(tmp_path), "step_00000001")
    with open(os.path.join(payload, MANIFEST_NAME)) as f:
        written = json.load(f)
    rebuilt = build_manifest(payload)
    assert written == rebuilt
    assert any(rel.startswith("chunk_") for rel in written["files"])


def test_single_rotted_chunk_convicts_the_step(tmp_path, monkeypatch):
    """Per-chunk manifest entries: flipping ONE chunk file's byte is a
    typed CheckpointCorrupt naming that chunk — what the serving
    watcher's verify probe and the reshard pre-gather check read."""
    _chunked(monkeypatch)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state()).wait()
    payload = tmp_path / "step_00000001"
    tgt = sorted(p for p in payload.iterdir()
                 if p.name.startswith("chunk_"))[1]
    raw = bytearray(tgt.read_bytes())
    raw[7] ^= 0xFF
    tgt.write_bytes(bytes(raw))
    with pytest.raises(CheckpointCorrupt) as ei:
        ck.verify(1)
    assert tgt.name in "; ".join(ei.value.problems)


def test_chunked_to_unchunked_and_back_compat_both_directions(
        tmp_path, monkeypatch):
    """A chunked checkpoint restores with chunking/async OFF, and a
    legacy (un-chunked) checkpoint restores with them ON — the reader
    understands every format regardless of the current knobs."""
    s = _state()
    # chunked+async write...
    _chunked(monkeypatch)
    Checkpointer(str(tmp_path / "a")).save(1, s).wait()
    # ...read back fully legacy-configured
    monkeypatch.setenv("DK_CKPT_CHUNK_MB", "0")
    monkeypatch.setenv("DK_CKPT_ASYNC", "0")
    step, got = Checkpointer(str(tmp_path / "a")).restore()
    assert step == 1
    np.testing.assert_array_equal(got["w"], s["w"])
    # legacy (orbax-or-pickle) write...
    Checkpointer(str(tmp_path / "b")).save(2, s, ).wait()
    assert not os.path.exists(
        str(tmp_path / "b" / "step_00000002" / CHUNKS_NAME))
    # ...read back with the async/chunked pipeline ON
    monkeypatch.setenv("DK_CKPT_CHUNK_MB", "64")
    monkeypatch.setenv("DK_CKPT_ASYNC", "1")
    step, got = Checkpointer(str(tmp_path / "b")).restore(template=s)
    assert step == 2
    np.testing.assert_array_equal(got["w"], s["w"])


def test_rotted_chunk_metadata_is_typed_even_with_verify_off(
        tmp_path, monkeypatch):
    """A missing small.pkl / torn chunks.json must convict TYPED under
    verify=False too — callers of the escape hatch branch on
    CheckpointCorrupt, never on raw FileNotFoundError/UnpicklingError."""
    _chunked(monkeypatch)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state()).wait()
    payload = tmp_path / "step_00000001"
    (payload / "small.pkl").write_bytes(b"not a pickle")
    with pytest.raises(CheckpointCorrupt, match="metadata unreadable"):
        ck.restore(step=1, verify=False)
    os.remove(payload / "small.pkl")
    with pytest.raises(CheckpointCorrupt, match="metadata unreadable"):
        ck.restore(step=1, verify=False)
    # a PADDED chunk (extra trailing bytes) is convicted, not silently
    # truncated into the neighbouring chunk's span
    ck.save(2, _state()).wait()
    p2 = tmp_path / "step_00000002"
    tgt = sorted(p for p in p2.iterdir()
                 if p.name.startswith("chunk_"))[0]
    tgt.write_bytes(tgt.read_bytes() + b"xx")
    with pytest.raises(CheckpointCorrupt):
        ck.restore(step=2, verify=False)


def test_truncated_chunk_is_typed_even_with_verify_off(tmp_path,
                                                       monkeypatch):
    """The verify=False escape hatch must still die TYPED on a short
    chunk, not hand back a silently-wrong array."""
    _chunked(monkeypatch)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state()).wait()
    payload = tmp_path / "step_00000001"
    tgt = sorted(p for p in payload.iterdir()
                 if p.name.startswith("chunk_"))[0]
    tgt.write_bytes(tgt.read_bytes()[:-16])
    with pytest.raises(CheckpointCorrupt):
        ck.restore(step=1, verify=False)


def test_verify_optout_skips_chunked_hashing_entirely(tmp_path,
                                                      monkeypatch):
    """DK_CKPT_VERIFY=0 must skip the HASHING, not just the manifest
    file — hashing multi-GB chunks to discard the digests would keep
    charging the integrity cost the knob documents as opted out."""
    import hashlib

    _chunked(monkeypatch)
    monkeypatch.setenv("DK_CKPT_VERIFY", "0")
    real = hashlib.sha256

    def boom(*a, **k):
        raise AssertionError("hashed despite DK_CKPT_VERIFY=0")

    monkeypatch.setattr(hashlib, "sha256", boom)
    ck = Checkpointer(str(tmp_path))
    s = _state()
    ck.save(1, s).wait(timeout_s=30)
    monkeypatch.setattr(hashlib, "sha256", real)
    assert not os.path.exists(
        str(tmp_path / "step_00000001" / MANIFEST_NAME))
    assert ck.verify(1) == "unverifiable"
    step, got = ck.restore()
    assert step == 1
    np.testing.assert_array_equal(got["w"], s["w"])


def test_chunked_save_handles_bfloat16_leaves(tmp_path, monkeypatch):
    """A bf16 leaf is streamed as its raw 16-bit words and recorded by
    NAME (``"bfloat16"``, as the reference records it), and the reader
    hands back a real ``torch.bfloat16`` tensor, bit for bit."""
    _chunked(monkeypatch, mb="0.001")
    ck = Checkpointer(str(tmp_path))
    w = torch.arange(4096, dtype=torch.float32).to(torch.bfloat16)
    ck.save(1, {"w": w, "f": np.float64(2.5)}).wait(timeout_s=30)
    assert ck.verify(1) == "ok"
    with open(tmp_path / "step_00000001" / CHUNKS_NAME) as f:
        meta = json.load(f)
    assert meta["leaves"][0]["dtype"] == "bfloat16"
    step, got = ck.restore()
    assert step == 1
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))


def test_async_save_returns_pending_handle_then_promotes(tmp_path):
    ck = Checkpointer(str(tmp_path))
    h = ck.save(1, _state())
    assert isinstance(h, AsyncSaveHandle)
    assert h.wait(timeout_s=30) == 1
    assert h.status == "committed" and h.done()
    assert ck.verify(1) == "ok"


def test_sync_mode_returns_resolved_handle(tmp_path, monkeypatch):
    monkeypatch.setenv("DK_CKPT_ASYNC", "0")
    ck = Checkpointer(str(tmp_path))
    h = ck.save(1, _state())
    assert h.done() and h.status == "committed"
    assert h.wait(timeout_s=0) == 1
    assert ck.latest_step() == 1


def test_read_queries_join_the_inflight_write(tmp_path):
    """save -> immediate read on the SAME Checkpointer behaves like the
    synchronous pipeline (the read side joins the writer)."""
    ck = Checkpointer(str(tmp_path))
    s = _state()
    ck.save(1, s)
    assert ck.latest_step() == 1          # no sleep, no wait()
    step, got = ck.restore()
    assert step == 1
    np.testing.assert_array_equal(got["w"], s["w"])
    assert ck.latest_verified_step() == 1


def test_rapid_saves_coalesce_latest_wins_with_typed_handle(tmp_path):
    """Unwaited back-to-back saves: at most one in flight + one
    pending; a superseded pending save resolves with the typed
    SaveSuperseded, and the LAST save always lands."""
    ck = Checkpointer(str(tmp_path), max_to_keep=10)
    # hold the writer on the first save so the queue actually forms
    gate = threading.Event()
    orig = ck._write_payload

    def slow(tmp, state, shard_specs=None):
        gate.wait(10)
        return orig(tmp, state, shard_specs)

    ck._write_payload = slow
    h1 = ck.save(1, _state(1.0))
    time.sleep(0.05)        # let the writer pick up save 1
    h2 = ck.save(2, _state(2.0))   # pending
    h3 = ck.save(3, _state(3.0))   # supersedes 2
    gate.set()
    assert h1.wait(timeout_s=30) == 1
    assert h3.wait(timeout_s=30) == 3
    with pytest.raises(SaveSuperseded):
        h2.wait(timeout_s=30)
    assert h2.status == "superseded"
    assert ck.all_steps() == [1, 3]   # 2 never even staged


def test_background_write_failure_is_typed_on_handle_and_next_save(
        tmp_path):
    """A mid-async-write fault resolves the handle with the error and
    re-raises at the NEXT save — the loop learns its checkpoints
    stopped landing at the next boundary, never silently."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state(1.0)).wait()
    faults.inject("ckpt.write", at=0, times=1)
    h = ck.save(2, _state(2.0))
    with pytest.raises(FaultInjected):
        h.wait(timeout_s=30)
    assert h.status == "error"
    # no torn promoted step; the previous step still restores
    assert ck.all_steps() == [1]
    assert ck.restore()[0] == 1
    # the stored error surfaces at the next boundary save, once
    with pytest.raises(FaultInjected):
        ck.save(3, _state(3.0))
    assert ck.save(3, _state(3.0)).wait(timeout_s=30) == 3


def test_crash_mid_async_write_never_leaves_torn_promoted_step(
        tmp_path, monkeypatch):
    """The chaos invariant, deterministically: kill the writer between
    the first chunk file and the manifest — staging is torn, but NO
    promoted step exists, latest stays put and verifies."""
    _chunked(monkeypatch)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state(1.0)).wait()
    faults.inject("ckpt.write", at=0, times=99)
    with pytest.raises(FaultInjected):
        ck.save(2, _state(2.0)).wait(timeout_s=30)
    names = os.listdir(str(tmp_path))
    assert "step_00000002" not in names
    assert any(n.startswith("step_00000002") for n in names)  # staging
    ck2 = Checkpointer(str(tmp_path))  # "restarted process"
    assert ck2.latest_verified_step() == 1
    assert ck2.verify(1) == "ok"
    step, got = ck2.restore()
    assert step == 1
    np.testing.assert_array_equal(got["w"], _state(1.0)["w"])


def test_ckpt_snapshot_fault_fires_on_caller_thread(tmp_path):
    ck = Checkpointer(str(tmp_path))
    faults.inject("ckpt.snapshot", at=0, times=1)
    with pytest.raises(FaultInjected):
        ck.save(1, _state())   # raises from save() itself, no handle
    assert ck.all_steps() == []


def test_wait_deadline_is_a_typed_timeout(tmp_path):
    ck = Checkpointer(str(tmp_path))
    gate = threading.Event()
    orig = ck._write_payload

    def slow(tmp, state, shard_specs=None):
        gate.wait(10)
        return orig(tmp, state, shard_specs)

    ck._write_payload = slow
    h = ck.save(1, _state())
    with pytest.raises(TimeoutError):
        h.wait(timeout_s=0.05)
    assert ck.wait_until_finished(timeout_s=0.05,
                                  raise_errors=False) is False
    gate.set()
    assert h.wait(timeout_s=30) == 1
    assert ck.wait_until_finished(timeout_s=30) is True


def test_snapshot_decouples_from_caller_mutations(tmp_path):
    """The boundary snapshot COPIES host-numpy leaves: mutating the
    array after save() returns must not tear the written bytes."""
    ck = Checkpointer(str(tmp_path))
    gate = threading.Event()
    orig = ck._write_payload

    def slow(tmp, state, shard_specs=None):
        gate.wait(10)
        return orig(tmp, state, shard_specs)

    ck._write_payload = slow
    w = np.arange(1024, dtype=np.float64)
    want = w.copy()
    h = ck.save(1, {"w": w})
    w[:] = -1.0          # the training loop moves on and mutates
    gate.set()
    h.wait(timeout_s=30)
    _, got = ck.restore()
    np.testing.assert_array_equal(got["w"], want)


def test_save_stall_and_write_metrics_split(tmp_path):
    from dist_keras_tpu_torch.observability import metrics

    h0 = metrics.snapshot()["histograms"]
    base_stall = h0.get("ckpt.save_stall_s", {}).get("count", 0)
    base_write = h0.get("ckpt.write_s", {}).get("count", 0)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state()).wait(timeout_s=30)
    h1 = metrics.snapshot()["histograms"]
    assert h1["ckpt.save_stall_s"]["count"] == base_stall + 1
    assert h1["ckpt.write_s"]["count"] == base_write + 1


def test_async_events_emitted(tmp_path, monkeypatch):
    from dist_keras_tpu_torch.observability import events

    obs = tmp_path / "obs"
    monkeypatch.setenv("DK_OBS_DIR", str(obs))
    events.reset()
    try:
        ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=10)
        gate = threading.Event()
        orig = ck._write_payload

        def slow(tmp, state, shard_specs=None):
            gate.wait(10)
            return orig(tmp, state, shard_specs)

        ck._write_payload = slow
        ck.save(1, _state(1.0))
        time.sleep(0.05)
        ck.save(2, _state(2.0))
        h3 = ck.save(3, _state(3.0))   # coalesces 2 away
        gate.set()
        h3.wait(timeout_s=30)
        ck.wait_until_finished(timeout_s=30)
    finally:
        events.reset()
        monkeypatch.delenv("DK_OBS_DIR")
        events.reset()
    lines = [json.loads(ln) for ln in
             (obs / "events-rank_0.jsonl").read_text().splitlines()]
    kinds = [ln["kind"] for ln in lines]
    assert kinds.count("ckpt_async_enqueue") == 3
    co = [ln for ln in lines if ln["kind"] == "ckpt_async_coalesced"]
    assert len(co) == 1 and co[0]["step"] == 2 and co[0]["by"] == 3
    saved = [ln["step"] for ln in lines if ln["kind"] == "ckpt_save"]
    assert saved == [1, 3]


def test_pod_saves_backpressure_instead_of_coalescing(tmp_path):
    """world > 1 two-phase: coalescing is FORBIDDEN — one host
    skipping step S latest-wins while its peers stage it would strand
    the leader's marker wait.  The queue stays depth-1 and save()
    blocks until the pending slot frees; every step's marker lands."""
    ck = Checkpointer(str(tmp_path), rank=1, world=2, max_to_keep=10)
    gate = threading.Event()
    orig = ck._write_payload

    def slow(tmp, state, shard_specs=None):
        gate.wait(10)
        return orig(tmp, state, shard_specs)

    ck._write_payload = slow
    ck.save(1, _state(1.0))
    time.sleep(0.05)          # writer picks up save 1 (held at gate)
    h2 = ck.save(2, _state(2.0))   # pending slot
    done = []

    def third():
        done.append(ck.save(3, _state(3.0)))

    t = threading.Thread(target=third)
    t.start()
    time.sleep(0.2)
    assert not done            # backpressured, NOT coalescing 2 away
    gate.set()
    t.join(timeout=30)
    assert done
    ck.wait_until_finished(timeout_s=30)
    assert h2.status == "committed"    # step 2 was never superseded
    # every step's phase-1 marker landed in the staging dir
    for s in (1, 2, 3):
        stage = os.path.join(str(tmp_path), f"step_{s:08d}.mh")
        assert os.path.exists(os.path.join(stage, "host-1.ok")), s


def test_two_phase_optout_pod_also_backpressures(tmp_path,
                                                 monkeypatch):
    """DK_CKPT_TWO_PHASE=0 (per-host LOCAL dirs) must backpressure
    too: per-host latest-wins coalescing would punch holes in one
    host's promoted-step sequence, and a relaunch would silently
    resume ranks from different steps."""
    monkeypatch.setenv("DK_CKPT_TWO_PHASE", "0")
    ck = Checkpointer(str(tmp_path), rank=1, world=2, max_to_keep=10)
    gate = threading.Event()
    orig = ck._write_payload

    def slow(tmp, state, shard_specs=None):
        gate.wait(10)
        return orig(tmp, state, shard_specs)

    ck._write_payload = slow
    ck.save(1, _state(1.0))
    time.sleep(0.05)
    h2 = ck.save(2, _state(2.0))   # pending — must NOT be coalesced
    done = []
    t = threading.Thread(
        target=lambda: done.append(ck.save(3, _state(3.0))))
    t.start()
    time.sleep(0.2)
    assert not done
    gate.set()
    t.join(timeout=30)
    ck.wait_until_finished(timeout_s=30)
    assert h2.status == "committed"
    assert ck.all_steps() == [1, 2, 3]   # no holes in the sequence


def test_wrong_shape_chunk_metadata_is_typed(tmp_path, monkeypatch):
    """Valid JSON of the wrong SHAPE in chunks.json (rotted key, leaf
    missing 'files', garbage dtype) convicts typed, even under
    verify=False — never a bare KeyError/TypeError."""
    _chunked(monkeypatch)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state()).wait()
    cpath = tmp_path / "step_00000001" / CHUNKS_NAME
    for rotted in ('{"format": 1, "lewves": []}',
                   '{"format": 1, "leaves": [{"index": 0}]}',
                   '{"format": 1, "leaves": [{"index": 0, "dtype": '
                   '"nonsense", "shape": [4], "files": []}]}',
                   '{"format": 1, "leaves": 3}'):
        cpath.write_text(rotted)
        with pytest.raises(CheckpointCorrupt,
                           match="metadata unreadable"):
            ck.restore(step=1, verify=False)
    # well-formed but EMPTY leaves table while small.pkl still holds a
    # _ChunkRef: typed too (a bare KeyError here would misroute the
    # supervisor's retryable/fatal classification)
    cpath.write_text('{"format": 1, "leaves": []}')
    with pytest.raises(CheckpointCorrupt, match="no leaf entry"):
        ck.restore(step=1, verify=False)


def test_idle_writer_retires_and_restarts_on_demand(tmp_path):
    """The writer thread parks with no job pinned (the snapshot must
    not stay resident in its frame) and retires after its idle window;
    a later save restarts it transparently."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state(1.0)).wait(timeout_s=30)
    t = ck._async_thread
    assert t is not None and t.is_alive()
    # the parked frame must not pin the job tuple (released before the
    # condition wait) — inspect the writer frame's locals directly
    import sys
    time.sleep(0.1)
    frames = sys._current_frames()
    frame = frames.get(t.ident)
    seen = {}
    while frame is not None:
        if frame.f_code.co_name == "_writer_loop":
            seen = dict(frame.f_locals)
            break
        frame = frame.f_back
    assert seen.get("job") is None and seen.get("state") is None
    # a new save on the same (or a restarted) writer still lands
    assert ck.save(2, _state(2.0)).wait(timeout_s=30) == 2


def _tiny_trainer(ckdir, **kw):
    from dist_keras_tpu_torch.data import Dataset
    from dist_keras_tpu_torch.models import mnist_mlp
    from dist_keras_tpu_torch.trainers import SingleTrainer
    from dist_keras_tpu_torch.utils.misc import one_hot

    rng = np.random.default_rng(0)
    n = 256
    y = rng.integers(0, 2, n)
    ds = Dataset({"features": rng.normal(size=(n, 16))
                  .astype(np.float32),
                  "label": y, "label_encoded": one_hot(y, 2)})
    t = SingleTrainer(
        mnist_mlp(hidden=(8,), input_dim=16, num_classes=2),
        batch_size=32, label_col="label_encoded", seed=0,
        checkpoint_dir=ckdir, device="cpu", **kw)
    return t, ds


def test_preempt_mid_async_save_waits_and_verifies(tmp_path):
    """SIGTERM at a chunk boundary: Preempted.saved_step must name a
    step that is PROMOTED and VERIFIED even though the cadence saves
    run through the background writer."""
    from dist_keras_tpu_torch.resilience.preemption import Preempted

    ckdir = str(tmp_path / "ck")
    t, ds = _tiny_trainer(ckdir, num_epoch=40, checkpoint_every=1,
                          handle_preemption=True)

    fired = []

    def cb(trainer, epoch, logs):
        if epoch >= 2 and not fired:
            fired.append(epoch)
            preemption.request()

    t.callbacks = [cb]
    with pytest.raises(Preempted) as ei:
        t.train(ds)
    saved = ei.value.saved_step
    assert saved is not None and saved > 0
    ck = Checkpointer(ckdir)
    assert ck.wait_until_finished(timeout_s=1) is True  # drained
    assert ck.latest_step() == saved
    assert ck.verify(saved) == "ok"
    # the relaunch resumes from exactly that step
    t2, _ = _tiny_trainer(ckdir, num_epoch=40, checkpoint_every=1,
                          resume=saved)
    t2.train(ds)
    assert t2.metrics[-1]["epoch"] == 40


def test_train_end_drains_inflight_saves(tmp_path):
    """A completed train() must leave its final boundary save promoted
    (the end-of-run drain), with no background writer still running."""
    ckdir = str(tmp_path / "ck")
    t, ds = _tiny_trainer(ckdir, num_epoch=6, checkpoint_every=2)
    t.train(ds)
    spe = 256 // 32
    ck = Checkpointer(ckdir)
    assert ck.wait_until_finished(timeout_s=1) is True
    assert ck.latest_step() == 6 * spe
    assert ck.verify(6 * spe) == "ok"

