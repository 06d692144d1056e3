"""The remote checkpoint tier and the elastic restore, held against the
port with the reference's own checks (``tests/test_diff_ckpt.py``'s
store and mirror tests, ``tests/test_elastic.py``'s resharding tests):
the store backends round-trip, a push killed mid-stream leaves no
``COMPLETE`` marker, restore heals from the remote tier, and a step
written by N hosts restores resharded on M."""

import json
import os
import shutil

import numpy as np
import pytest

from dist_keras_tpu_torch.checkpoint import (
    CAS_DIR_NAME,
    CHUNKS_NAME,
    CheckpointCorrupt,
    Checkpointer,
)
from dist_keras_tpu_torch.resilience import FaultInjected, elastic, faults
from dist_keras_tpu_torch.resilience import store as ckstore


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


def test_local_dir_store_round_trip(tmp_path):
    s = ckstore.LocalDirStore(str(tmp_path / "store"))
    s.put_bytes("chunks/abc", b"hello")
    s.put_bytes("steps/step_00000001/manifest.json", b"{}")
    assert s.get_bytes("chunks/abc") == b"hello"
    assert s.exists("chunks/abc") and not s.exists("chunks/def")
    assert s.list("steps/") == ["steps/step_00000001/manifest.json"]
    s.delete("chunks/abc")
    assert not s.exists("chunks/abc")
    s.delete("chunks/abc")  # idempotent
    with pytest.raises(FileNotFoundError):
        s.get_bytes("chunks/abc")
    with pytest.raises(ckstore.StoreError):
        s.put_bytes("../escape", b"x")


def test_http_store_round_trip_against_object_store_server(tmp_path):
    with ckstore.ObjectStoreServer(str(tmp_path / "remote")) as srv:
        s = ckstore.HTTPStore(srv.url)
        s.put_bytes("chunks/abc", b"\x00\x01payload")
        assert s.exists("chunks/abc") and not s.exists("chunks/nope")
        assert s.get_bytes("chunks/abc") == b"\x00\x01payload"
        s.put_bytes("steps/step_00000003/COMPLETE", b"{}")
        assert s.list("steps/") == ["steps/step_00000003/COMPLETE"]
        assert ckstore.remote_steps(s) == [3]
        with pytest.raises(FileNotFoundError):
            s.get_bytes("chunks/nope")
        s.delete("chunks/abc")
        assert not s.exists("chunks/abc")


def test_store_from_url_dispatch(tmp_path):
    assert isinstance(ckstore.store_from_url("http://127.0.0.1:1"),
                      ckstore.HTTPStore)
    assert isinstance(
        ckstore.store_from_url(f"file://{tmp_path}/a"),
        ckstore.LocalDirStore)
    assert isinstance(ckstore.store_from_url(str(tmp_path / "b")),
                      ckstore.LocalDirStore)
    with pytest.raises(ValueError, match="https"):
        ckstore.store_from_url("https://bucket")
    assert ckstore.store_from_env() is None  # knob unset


@pytest.fixture
def remote(tmp_path, monkeypatch):
    """A LocalDirStore remote wired through DK_CKPT_REMOTE."""
    root = str(tmp_path / "remote")
    monkeypatch.setenv("DK_CKPT_REMOTE", root)
    monkeypatch.setenv("DK_CKPT_REMOTE_PUSH", "0")  # explicit pushes
    return ckstore.LocalDirStore(root)


def test_push_fetch_round_trip_bit_equal(tmp_path, diff_env, remote):
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(1, _state(1)).wait()
    ck.save(2, _state(2, churn=2)).wait()
    up = ckstore.CheckpointUploader(ck)
    assert up.poll_once() == 2
    assert ckstore.remote_steps(remote) == [1, 2]
    assert up.poll_once() == 0  # idempotent: nothing new
    # the machine dies with its disk
    shutil.rmtree(ck.directory)
    fresh = Checkpointer(str(tmp_path / "fresh"))
    step, got = fresh.restore()
    assert step == 2
    np.testing.assert_array_equal(got["w"], _state(2, churn=2)["w"])
    assert fresh.verify(2) == "ok"


def test_push_killed_mid_stream_leaves_no_complete_marker(
        tmp_path, diff_env, remote):
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(1, _state(1)).wait()
    up = ckstore.CheckpointUploader(ck)
    with faults.armed("ckpt.push", at=2):
        with pytest.raises(FaultInjected):
            up.poll_once()
    assert ckstore.remote_steps(remote) == []  # invisible remotely
    # the next poll re-pushes idempotently (already-up chunks reused)
    assert up.poll_once() == 1
    assert ckstore.remote_steps(remote) == [1]


def test_pull_transient_absorbed_and_kill_typed(tmp_path, diff_env,
                                                remote):
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(1, _state(1)).wait()
    ckstore.CheckpointUploader(ck).poll_once()
    shutil.rmtree(ck.directory)
    with faults.armed("ckpt.pull", exc=OSError):
        fresh = Checkpointer(str(tmp_path / "f1"))
        step, _got = fresh.restore()  # retry surface absorbs it
        assert step == 1
    with faults.armed("ckpt.pull", times=5):
        fresh2 = Checkpointer(str(tmp_path / "f2"))
        with pytest.raises((FaultInjected, FileNotFoundError)):
            fresh2.restore()


def test_restore_remote_heals_corrupt_local(tmp_path, diff_env,
                                            remote, flip_one_byte):
    ck = Checkpointer(str(tmp_path / "ck"))
    s = _state(5, churn=3)
    ck.save(1, s).wait()
    ckstore.CheckpointUploader(ck).poll_once()
    flip_one_byte(str(tmp_path / "ck" / "step_00000001"))
    step, got = ck.restore()
    assert step == 1  # ZERO cadences lost: the clean remote copy wins
    np.testing.assert_array_equal(got["w"], s["w"])
    # the rotted copy was quarantined, the healed one re-promoted
    assert (tmp_path / "ck" / "step_00000001.corrupt").is_dir()
    assert ck.verify(1) == "ok"


def test_restore_heals_rotted_cas_chunk_from_remote(tmp_path,
                                                    diff_env, remote):
    """Chunk bytes live in the CAS, so CAS rot is the dominant
    corruption surface — the remote heal must re-hash an existing
    local CAS entry before trusting it and re-download the clean
    bytes (review finding: a bare exists-check kept the rotted chunk
    and the 'healed' step re-convicted forever)."""
    ck = Checkpointer(str(tmp_path / "ck"))
    s = _state(4, churn=2)
    ck.save(1, s).wait()
    ckstore.CheckpointUploader(ck).poll_once()
    sha = sorted(_cas_shas(str(tmp_path / "ck" / "step_00000001")))[0]
    tgt = os.path.join(_cas(ck), sha)
    with open(tgt, "r+b") as f:
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 0xFF]))
    step, got = ck.restore()
    assert step == 1
    np.testing.assert_array_equal(got["w"], s["w"])
    assert ck.verify(1) == "ok"  # the CAS entry itself was replaced


def test_repushed_step_after_local_divergence(tmp_path, diff_env,
                                              remote):
    """A step number re-saved with DIFFERENT bytes (the run fell back
    and overtook itself) must re-mirror over the stale remote copy —
    the content-aware push skip (review finding: a bare
    COMPLETE-marker check froze the stale copy forever, and the heal
    path could resurrect parameters the run walked away from)."""
    ck = Checkpointer(str(tmp_path / "ck"))
    old = _state(1)
    ck.save(1, old).wait()
    ckstore.CheckpointUploader(ck).poll_once()
    new = _state(1, churn=4)
    ck.save(1, new).wait()  # journaled-swap overwrite, same step
    up2 = ckstore.CheckpointUploader(ck)  # a RESTARTED process
    assert up2.poll_once() == 1  # marker exists but content differs
    shutil.rmtree(ck.directory)
    step, got = Checkpointer(str(tmp_path / "fresh")).restore()
    assert step == 1
    np.testing.assert_array_equal(got["w"], new["w"])


def test_mirror_works_for_plain_unchunked_payloads(tmp_path,
                                                   monkeypatch,
                                                   remote):
    """The remote tier does not require the differential layer: a
    legacy pickle/orbax payload mirrors as plain per-step files."""
    monkeypatch.setenv("DK_CKPT_CHUNK_MB", "0")
    monkeypatch.setenv("DK_CKPT_ASYNC", "0")
    ck = Checkpointer(str(tmp_path / "ck"))
    s = {"w": np.arange(128, dtype=np.float32), "i": np.int64(7)}
    ck.save(1, s).wait()
    ckstore.CheckpointUploader(ck).poll_once()
    shutil.rmtree(ck.directory)
    step, got = Checkpointer(str(tmp_path / "fresh")).restore(
        template=s)
    assert step == 1
    np.testing.assert_array_equal(got["w"], s["w"])


def test_wiped_host_reshards_world2_to_world1_from_remote(
        tmp_path, diff_env, remote):
    from dist_keras_tpu_torch.resilience import elastic

    ckdir = str(tmp_path / "ck")
    full = np.arange(65536, dtype=np.float64) * 1.5
    specs = {"w": 0, "i": None}
    cks = [Checkpointer(ckdir, rank=r, world=2, commit_timeout_s=10)
           for r in (0, 1)]
    for r in (1, 0):  # leader last: its save promotes
        shard = {"w": elastic.split_leaf(full, 0, 2, r),
                 "i": np.int64(3)}
        cks[r].save(3, shard, shard_specs=specs).wait(timeout_s=30)
    assert ckstore.CheckpointUploader(cks[0]).poll_once() == 1
    shutil.rmtree(ckdir)
    fresh = Checkpointer(str(tmp_path / "fresh"), rank=0, world=1)
    step, got = fresh.restore()
    assert step == 3
    np.testing.assert_array_equal(
        np.asarray(got["w"], dtype=np.float64), full)
    assert int(got["i"]) == 3


def test_uploader_background_thread_and_auto_arm(tmp_path, diff_env,
                                                 monkeypatch):
    import time

    root = str(tmp_path / "remote")
    monkeypatch.setenv("DK_CKPT_REMOTE", root)
    monkeypatch.setenv("DK_CKPT_REMOTE_POLL_S", "0.05")
    ck = Checkpointer(str(tmp_path / "ck"))
    try:
        ck.save(1, _state(1)).wait()  # save() arms the uploader
        assert ck._uploader is not None
        store = ckstore.LocalDirStore(root)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if ckstore.remote_steps(store) == [1]:
                break
            time.sleep(0.02)
        assert ckstore.remote_steps(store) == [1]
    finally:
        ck.stop_uploader()
    assert ck._uploader is None


def test_uploader_push_off_keeps_tier_read_only(tmp_path, diff_env,
                                                monkeypatch):
    monkeypatch.setenv("DK_CKPT_REMOTE", str(tmp_path / "remote"))
    monkeypatch.setenv("DK_CKPT_REMOTE_PUSH", "0")
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(1, _state(1)).wait()
    assert ck._uploader is None
    assert ck.remote_steps() == []



# -- elastic restore (tests/test_elastic.py)


def _global_state():
    """FSDP-shaped state: a sharded weight + its sharded optimizer
    moment, a replicated bias (too small / indivisible to shard) and a
    replicated scalar counter."""
    return {
        "params": {
            "w": np.arange(8 * 16, dtype=np.float64).reshape(8, 16),
            "b": np.array([1.0, 2.0, 3.0]),
        },
        "opt": {"mu": np.arange(8 * 16, dtype=np.float64)
                .reshape(8, 16) * 0.5},
        "step": np.int64(11),
    }


_DIMS = {"params": {"w": 0, "b": None}, "opt": {"mu": 0}, "step": None}


def _local(state, world, rank):
    return {
        "params": {
            "w": elastic.split_leaf(state["params"]["w"], 0, world,
                                    rank),
            "b": state["params"]["b"],
        },
        "opt": {"mu": elastic.split_leaf(state["opt"]["mu"], 0, world,
                                         rank)},
        "step": state["step"],
    }


def _save_world(directory, state, world, specs=_DIMS, step=5):
    """A world-N two-phase save of ``state``'s per-rank shards: every
    non-leader publishes its payload + marker first, the leader's save
    then finds all markers present and promotes."""
    for rank in list(range(1, world)) + [0]:
        # waited per rank: the restore below uses a FRESH Checkpointer,
        # so the async default's join-on-read can't cover it — and the
        # leader's promote needs every marker down first anyway
        Checkpointer(directory, rank=rank, world=world,
                     max_to_keep=10).save(
            step, _local(state, world, rank),
            shard_specs=specs).wait(timeout_s=60)


def _assert_tree_equal(got, want):
    assert np.array_equal(np.asarray(got["params"]["w"]),
                          np.asarray(want["params"]["w"]))
    assert np.array_equal(np.asarray(got["params"]["b"]),
                          np.asarray(want["params"]["b"]))
    assert np.array_equal(np.asarray(got["opt"]["mu"]),
                          np.asarray(want["opt"]["mu"]))
    assert int(got["step"]) == int(want["step"])


def test_split_gather_roundtrip_even_and_uneven():
    for n, world in [(12, 4), (10, 4), (7, 2), (5, 5)]:
        leaf = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
        shards = [elastic.split_leaf(leaf, 0, world, r)
                  for r in range(world)]
        assert np.array_equal(elastic.gather_leaf(shards, 0), leaf)
    # replicated: gather takes the leader's copy, split is identity
    leaf = np.arange(6.0)
    assert np.array_equal(elastic.split_leaf(leaf, None, 4, 2), leaf)
    assert np.array_equal(
        elastic.gather_leaf([leaf, leaf * 0 + 9], None), leaf)


def test_split_leaf_rejects_bad_dim():
    with pytest.raises(ValueError, match="cannot split"):
        elastic.split_leaf(np.arange(4.0), 1, 2, 0)


def test_choose_surviving_hosts_evidence_rule():
    hosts = ["h0", "h1", "h2"]
    # no repeat offender -> no resize
    assert elastic.choose_surviving_hosts(
        hosts, {"h1"}, set()) == (None, ())
    # h1 dead at the last wave AND again now -> dropped
    assert elastic.choose_surviving_hosts(
        hosts, {"h1"}, {"h1"}) == (["h0", "h2"], ("h1",))
    # a host dead now but NOT at the last wave survives the drop
    assert elastic.choose_surviving_hosts(
        hosts, {"h0", "h1"}, {"h1"}) == (["h0", "h2"], ("h1",))
    # every host a repeat offender -> giving up is the budget's job
    assert elastic.choose_surviving_hosts(
        hosts, set(hosts), set(hosts)) == (None, ())
    # min_world floor
    assert elastic.choose_surviving_hosts(
        hosts, {"h1", "h2"}, {"h1", "h2"}, min_world=2) == (None, ())
    assert elastic.choose_surviving_hosts(
        hosts, {"h2"}, {"h2"}, min_world=2) == (["h0", "h1"], ("h2",))


@pytest.mark.parametrize("n,m", [(2, 1), (1, 2), (4, 2), (2, 4)])
def test_reshard_roundtrip_bit_equal(tmp_path, n, m):
    g = _global_state()
    _save_world(str(tmp_path), g, n)
    for rank in range(m):
        ck = Checkpointer(str(tmp_path), rank=rank, world=m)
        step, st = ck.restore(template=_local(g, m, rank))
        assert step == 5
        _assert_tree_equal(st, _local(g, m, rank))
    # the M=1 view IS the single-host reference: a world-1 save of the
    # same global state restores bit-identically
    ref_dir = str(tmp_path / "ref")
    Checkpointer(ref_dir, rank=0, world=1).save(
        5, _local(g, 1, 0), shard_specs=_DIMS).wait(timeout_s=60)
    _step, ref = Checkpointer(ref_dir, rank=0, world=1).restore()
    _step, got = Checkpointer(str(tmp_path), rank=0, world=1).restore()
    _assert_tree_equal(got, ref)


def test_reshard_emits_attribution(tmp_path, monkeypatch):
    """The resize lands in the event log: one reshard_restore (saved
    world -> world, leaves, bytes) and the uniform ckpt_restore."""
    from dist_keras_tpu_torch.observability import events

    g = _global_state()
    _save_world(str(tmp_path / "ck"), g, 2)
    obs = tmp_path / "obs"
    monkeypatch.setenv("DK_OBS_DIR", str(obs))
    events.reset()
    try:
        Checkpointer(str(tmp_path / "ck"), rank=0, world=1).restore()
    finally:
        events.reset()
    monkeypatch.delenv("DK_OBS_DIR")
    recs = [json.loads(line) for line in
            (obs / "events-rank_0.jsonl").read_text().splitlines()]
    [row] = [r for r in recs if r["kind"] == "reshard_restore"]
    assert row["saved_world"] == 2 and row["world"] == 1
    assert row["n_sharded"] == 2 and row["bytes_in"] > 0
    assert [r["step"] for r in recs if r["kind"] == "ckpt_restore"] == [5]


def test_elastic_opt_out_keeps_pre_elastic_semantics(tmp_path):
    """``restore(elastic=False)`` (or ``DK_ELASTIC=0``): a world-1
    reader of a world-2 step reads the leader replica — rank 0's SHARD
    for sharded leaves, NOT the gathered global state."""
    g = _global_state()
    _save_world(str(tmp_path), g, 2)
    _step, st = Checkpointer(str(tmp_path), rank=0, world=1).restore(
        elastic=False)
    assert np.array_equal(np.asarray(st["params"]["w"]),
                          _local(g, 2, 0)["params"]["w"])


def test_saved_world_and_payload_paths(tmp_path):
    g = _global_state()
    _save_world(str(tmp_path), g, 2)
    ck = Checkpointer(str(tmp_path), rank=0, world=2)
    assert ck.saved_world() == 2
    paths = ck.host_payload_paths(5)
    assert [os.path.basename(p) for p in paths] == ["host_0", "host_1"]
    single = str(tmp_path / "one")
    Checkpointer(single, rank=0, world=1).save(
        5, _local(g, 1, 0)).wait(timeout_s=60)
    one = Checkpointer(single, rank=0, world=1)
    assert one.saved_world() == 1
    assert one.host_payload_paths(5) == [
        os.path.join(single, "step_00000005")]
    # a payload deleted from within the writing world is typed corrupt
    import shutil

    shutil.rmtree(paths[1])
    with pytest.raises(CheckpointCorrupt, match="host_1"):
        ck.host_payload_paths(5)


def _flip_byte(payload_dir):
    import glob

    files = [f for f in glob.glob(os.path.join(payload_dir, "**"),
                                  recursive=True)
             if os.path.isfile(f)
             and not f.endswith("manifest.json")]
    tgt = max(files, key=os.path.getsize)
    with open(tgt, "r+b") as f:
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 0xFF]))
    return tgt


def test_corrupt_shard_during_reshard_is_typed(tmp_path):
    g = _global_state()
    _save_world(str(tmp_path), g, 2)
    tgt = _flip_byte(str(tmp_path / "step_00000005" / "host_1"))
    ck = Checkpointer(str(tmp_path), rank=0, world=1)
    with pytest.raises(CheckpointCorrupt) as ei:
        ck.restore()
    # the error names the rotted file, and points at host_1's payload
    assert os.path.basename(tgt) in str(ei.value)
    assert "host_1" in ei.value.path
    # the reader NEVER quarantines someone else's directory
    assert not os.path.exists(str(tmp_path / "step_00000005.corrupt"))
    # verify-all probes the same verdict read-only
    with pytest.raises(CheckpointCorrupt):
        ck.verify(5, all_hosts=True)


def test_world1_reshard_falls_back_past_corrupt_step(tmp_path):
    """Supervised elastic recovery must not crash-loop on one rotted
    payload: the world-1 probe (`latest_verified_step`) judges EVERY
    payload a reshard would read, and `restore()` falls back to the
    previous promoted step — without quarantining (reader
    semantics)."""
    g = _global_state()
    older = _global_state()
    older["step"] = np.int64(3)
    _save_world(str(tmp_path), older, 2, step=3)
    _save_world(str(tmp_path), g, 2, step=5)
    _flip_byte(str(tmp_path / "step_00000005" / "host_1"))
    ck = Checkpointer(str(tmp_path), rank=0, world=1)
    # the probe skips step 5: this rank's view of it (host_0) hashes
    # clean, but the reshard would read host_1 too
    assert ck.latest_verified_step() == 3
    step, st = ck.restore()
    assert step == 3
    _assert_tree_equal(st, older)
    assert not os.path.exists(str(tmp_path / "step_00000005.corrupt"))
    # a stray non-numeric host_* sibling must not crash any reader
    os.makedirs(str(tmp_path / "step_00000003" / "host_0.tmp"))
    assert ck.saved_world(3) == 2
    assert ck.latest_verified_step() == 3


def test_reshard_fault_points_fire(tmp_path):
    from dist_keras_tpu_torch.resilience import faults

    g = _global_state()
    _save_world(str(tmp_path), g, 2)
    ck = Checkpointer(str(tmp_path), rank=0, world=1)
    faults.inject("reshard.load", at=1)
    try:
        with pytest.raises(faults.FaultInjected):
            ck.restore()
    finally:
        faults.clear()
    faults.inject("reshard.scatter", at=0)
    try:
        with pytest.raises(faults.FaultInjected):
            ck.restore()
    finally:
        faults.clear()
    step, _st = ck.restore()  # cleared: the bytes were never touched
    assert step == 5

