"""Cluster consensus and the two-phase commit, held against the port
with the reference's own checks (``tests/test_coordination.py``):
FileCoordinator consensus, typed deadlines (``BarrierTimeout``, and
``PeerLost`` only with heartbeat evidence), poisoning, the two-phase
checkpoint commit with every fault point, the coordinated boundary loop
— and the real thing, two processes sharing a directory."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from dist_keras_tpu_torch.resilience import coordination, faults, preemption
from dist_keras_tpu_torch.resilience.coordination import (
    BarrierTimeout,
    FileCoordinator,
    Heartbeat,
    LocalCoordinator,
    PeerLost,
    dead_peers,
)
from dist_keras_tpu_torch.resilience.preemption import Preempted

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    preemption.clear()
    coordination.reset()
    yield
    faults.clear()
    preemption.clear()
    preemption.restore()
    coordination.reset()


def _pair(tmp_path, fn, timeout=20.0):
    """Drive the SAME op sequence on two FileCoordinator ranks from two
    threads; returns (rank0 results, rank1 results)."""
    cs = [FileCoordinator(str(tmp_path), rank=r, world=2,
                          heartbeat=False) for r in (0, 1)]
    out, errs = {}, {}

    def run(r):
        try:
            out[r] = fn(cs[r], r)
        except BaseException as e:  # surfaced below, not swallowed
            errs[r] = e

    ts = [threading.Thread(target=run, args=(r,)) for r in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), "rendezvous deadlocked"
    if errs:
        raise next(iter(errs.values()))
    return out[0], out[1]


def test_local_coordinator_is_trivial():
    c = LocalCoordinator()
    assert c.world == 1 and c.rank == 0
    assert c.any_flag(False) is False
    assert c.any_flag(True) is True
    assert c.all_ok(True) is True
    assert c.all_ok(False) is False
    assert c.agree_min(7) == 7
    assert c.agree_max(7) == 7
    assert c.barrier() == 1


def test_coordination_primitives_are_fault_points():
    c = LocalCoordinator()
    with faults.armed("coord.flag"):
        with pytest.raises(faults.FaultInjected):
            c.any_flag(False)
    with faults.armed("coord.agree"):
        with pytest.raises(faults.FaultInjected):
            c.agree_min(1)
    with faults.armed("coord.barrier"):
        with pytest.raises(faults.FaultInjected):
            c.barrier()


def test_file_coordinator_consensus_matrix(tmp_path):
    """any_flag = OR, all_ok = AND, agree_min/max = min/max, barrier
    returns the participant count — identical verdict on every rank."""
    def ops(c, r):
        return (c.any_flag(r == 0, timeout_s=15),   # one flagged -> True
                c.any_flag(False, timeout_s=15),    # none flagged -> False
                c.all_ok(True, timeout_s=15),       # all ok -> True
                c.all_ok(r == 1, timeout_s=15),     # one failed -> False
                c.agree_min(3 if r == 0 else 9, timeout_s=15),
                c.agree_max(3 if r == 0 else 9, timeout_s=15),
                c.barrier(timeout_s=15))

    r0, r1 = _pair(tmp_path, ops)
    assert r0 == r1 == (True, False, True, False, 3, 9, 2)


def test_file_coordinator_timeout_is_typed_not_a_hang(tmp_path):
    """Rank 1 never shows up and there is no liveness info: the verdict
    is BarrierTimeout naming the missing rank — never an infinite
    wait."""
    c = FileCoordinator(str(tmp_path), rank=0, world=2, heartbeat=False)
    t0 = time.monotonic()
    with pytest.raises(BarrierTimeout, match=r"\[1\]"):
        c.any_flag(True, timeout_s=0.3)
    assert time.monotonic() - t0 < 5.0


def test_never_started_peer_is_a_timeout_not_a_death(tmp_path):
    """A rank with NO liveness trace (never beat — maybe still
    importing jax) is absence of evidence: the verdict stays
    BarrierTimeout even though rank 0's own heartbeat created the hb
    directory.  PeerLost is reserved for beat-then-went-dark."""
    c = FileCoordinator(str(tmp_path), rank=0, world=2,
                        heartbeat_interval_s=0.05, stale_after_s=60.0)
    try:
        with pytest.raises(BarrierTimeout, match=r"\[1\]"):
            c.barrier(timeout_s=0.3)
    finally:
        c.close()


def test_stale_peer_surfaces_early_not_at_the_deadline(tmp_path):
    """A peer that once BEAT and went dark is provably lost: the wait
    raises PeerLost within ~a probe interval, NOT after the full
    deadline (here 60s — the test finishing fast IS the assertion)."""
    c = FileCoordinator(str(tmp_path), rank=0, world=2,
                        heartbeat_interval_s=0.05, stale_after_s=0.2)
    try:
        # rank 1 lived once, then went dark (backdated heartbeat)
        Heartbeat(str(tmp_path), rank=1).beat_once()
        old = time.time() - 60
        os.utime(os.path.join(str(tmp_path), "hb", "rank_1"),
                 (old, old))
        t0 = time.monotonic()
        with pytest.raises(PeerLost) as ei:
            c.agree_min(5, timeout_s=60.0)
        assert ei.value.ranks == (1,)
        assert time.monotonic() - t0 < 10.0  # early, not the deadline
    finally:
        c.close()


def test_heartbeat_fault_silences_the_host(tmp_path):
    """An armed "job.heartbeat" raise stops the beat thread — the host
    goes dark at a deterministic beat count and dead_peers reports
    it."""
    hb = Heartbeat(str(tmp_path), rank=0, interval_s=0.01)
    faults.inject("job.heartbeat", at=1, times=999)
    hb.start()  # beat #0 lands; beat #1 raises inside the thread
    try:
        assert dead_peers(str(tmp_path), 1, stale_after_s=60) == []
        time.sleep(0.4)
        assert dead_peers(str(tmp_path), 1, stale_after_s=0.2) == [0]
    finally:
        hb.stop()


def test_heartbeat_survives_transient_write_errors(tmp_path):
    """A transient liveness-file error (NFS blip) must NOT silence a
    healthy host permanently — only the injected FaultInjected death
    does.  One missed beat hides inside the stale window."""
    hb = Heartbeat(str(tmp_path), rank=0, interval_s=0.01)
    faults.inject("job.heartbeat", at=1, times=1, exc=OSError)
    hb.start()
    try:
        time.sleep(0.3)  # the OSError beat passes, later beats land
        assert dead_peers(str(tmp_path), 1, stale_after_s=0.15) == []
    finally:
        hb.stop()


def test_timed_out_coordinator_is_poisoned(tmp_path):
    """After a collective timeout this process's position in the op
    stream is unknowable: the next collective must refuse with an
    actionable error, not silently match op N's answers to op N+1."""
    c = FileCoordinator(str(tmp_path), rank=0, world=2, heartbeat=False)
    with pytest.raises(BarrierTimeout):
        c.any_flag(True, timeout_s=0.2)
    with pytest.raises(RuntimeError, match="poisoned"):
        c.agree_min(1, timeout_s=0.2)


def test_dead_peers_without_liveness_info_is_empty(tmp_path):
    # no hb dir at all = absence of evidence, not evidence of death
    assert dead_peers(str(tmp_path), 4, stale_after_s=0.0) == []


def test_env_selected_file_coordinator(tmp_path, monkeypatch):
    monkeypatch.setenv("DK_COORD_DIR", str(tmp_path))
    monkeypatch.setenv("DK_COORD_RANK", "0")
    monkeypatch.setenv("DK_COORD_WORLD", "1")
    monkeypatch.setenv("DK_COORD_SESSION", "attempt3")
    coordination.reset()
    c = coordination.get_coordinator()
    assert isinstance(c, FileCoordinator)
    assert (c.rank, c.world) == (0, 1)
    # incarnation isolation: everything lives under the session subdir
    assert c.directory == str(tmp_path / "attempt3")
    assert coordination.rank() == 0 and coordination.world() == 1
    assert c.any_flag(True) is True  # world 1: immediate
    assert coordination.get_coordinator() is c  # cached (op counter!)


def _ckptr(tmp_path, rank, world, **kw):
    from dist_keras_tpu_torch.checkpoint import Checkpointer

    ck = Checkpointer(str(tmp_path / "ck"), rank=rank, world=world, **kw)
    ck._retry.sleep = lambda s: None
    return ck


def _state(rank, step):
    return {"a": np.arange(4.0) + 10 * rank + step, "r": np.int32(rank)}


def test_two_phase_commit_promotes_only_when_all_markers_land(tmp_path):
    """Phase 1 alone (a non-leader's save) publishes data + marker but
    NO step: latest_step stays empty until the leader, finding every
    marker, promotes the staging directory."""
    ck1 = _ckptr(tmp_path, rank=1, world=2)
    # .wait(): async saves (the default) resolve the non-leader handle
    # at marker publish, the leader handle at promotion — these tests
    # inspect the staging layout between those instants
    ck1.save(5, _state(1, 5)).wait()
    # staged, marked — but invisible to every reader
    stage = os.path.join(ck1.directory, "step_00000005.mh")
    assert os.path.isdir(os.path.join(stage, "host_1"))
    assert os.path.exists(os.path.join(stage, "host-1.ok"))
    assert ck1.all_steps() == []
    assert ck1.latest_step() is None

    ck0 = _ckptr(tmp_path, rank=0, world=2)
    ck0.save(5, _state(0, 5)).wait()  # leader: all markers -> promote
    assert not os.path.exists(stage)
    assert ck0.all_steps() == [5]
    # each rank restores ITS OWN payload from the promoted step
    for rank, ck in ((0, ck0), (1, ck1)):
        step, got = ck.restore(template=_state(rank, 5))
        assert step == 5
        np.testing.assert_array_equal(got["a"], _state(rank, 5)["a"])
        assert int(got["r"]) == rank


def test_torn_commit_is_invisible_and_resume_falls_back(tmp_path):
    """The acceptance scenario: a save killed between the last marker
    landing and the leader's promotion rename ("coord.commit") leaves a
    staging dir NO reader counts; resume falls back to the last fully
    committed step on every rank."""
    ck0 = _ckptr(tmp_path, rank=0, world=2)
    ck1 = _ckptr(tmp_path, rank=1, world=2)
    ck1.save(2, _state(1, 2)).wait()
    ck0.save(2, _state(0, 2)).wait()  # step 2 fully committed
    ck1.save(4, _state(1, 4)).wait()
    with faults.armed("coord.commit"):
        with pytest.raises(faults.FaultInjected):
            # dies at the promotion instant (surfaced by the wait)
            ck0.save(4, _state(0, 4)).wait()
    # torn: all data + markers staged, nothing promoted
    assert os.path.isdir(os.path.join(ck0.directory, "step_00000004.mh"))
    for ck, rank in ((_ckptr(tmp_path, rank=0, world=2), 0),
                     (_ckptr(tmp_path, rank=1, world=2), 1)):
        assert ck.all_steps() == [2]      # the torn step does NOT count
        assert ck.latest_step() == 2
        step, got = ck.restore(template=_state(rank, 2))
        assert step == 2                  # fell back, bit-exact
        np.testing.assert_array_equal(got["a"], _state(rank, 2)["a"])

    # the retried save at the same step supersedes the torn staging
    # (each rank retracts its own stale marker before rewriting)
    ck1b = _ckptr(tmp_path, rank=1, world=2)
    ck1b.save(4, _state(1, 4)).wait()
    ck0b = _ckptr(tmp_path, rank=0, world=2)
    ck0b.save(4, _state(0, 4)).wait()
    assert ck0b.all_steps() == [2, 4]
    step, got = ck0b.restore(template=_state(0, 4))
    assert step == 4


def test_leader_times_out_typed_when_marker_never_lands(tmp_path):
    """A host whose marker never lands and about which there is NO
    liveness evidence: the leader's promotion wait raises a typed
    BarrierTimeout naming the missing rank — PeerLost is reserved for
    heartbeat-proven deaths, and neither is ever an indefinite hang."""
    ck0 = _ckptr(tmp_path, rank=0, world=2, commit_timeout_s=0.3)
    t0 = time.monotonic()
    with pytest.raises(BarrierTimeout, match=r"\[1\]"):
        ck0.save(7, _state(0, 7)).wait()
    assert time.monotonic() - t0 < 5.0
    assert ck0.all_steps() == []  # nothing half-committed


def test_leader_peer_lost_with_heartbeat_evidence(tmp_path, monkeypatch):
    """Same missing marker, but liveness files PROVE rank 1 died (beat
    once, went stale): the verdict upgrades to PeerLost naming it,
    raised early — not at the deadline."""
    monkeypatch.setenv("DK_COORD_DIR", str(tmp_path / "coord"))
    monkeypatch.setenv("DK_COORD_RANK", "0")
    monkeypatch.setenv("DK_COORD_WORLD", "2")
    monkeypatch.setenv("DK_COORD_STALE_S", "0.2")
    coordination.reset()
    Heartbeat(str(tmp_path / "coord"), rank=1).beat_once()
    old = time.time() - 60
    os.utime(os.path.join(str(tmp_path / "coord"), "hb", "rank_1"),
             (old, old))
    ck0 = _ckptr(tmp_path, rank=0, world=2, commit_timeout_s=30.0)
    t0 = time.monotonic()
    with pytest.raises(PeerLost) as ei:
        ck0.save(7, _state(0, 7)).wait()
    assert ei.value.ranks == (1,)
    assert time.monotonic() - t0 < 10.0  # early, not the 30s deadline


def test_mid_write_kill_on_one_host_never_commits(tmp_path):
    """checkpoint.save armed on a non-leader: its payload write dies
    BEFORE the marker, so the cluster can never promote the step — the
    leader gets a typed timeout, readers see nothing."""
    ck1 = _ckptr(tmp_path, rank=1, world=2)
    with faults.armed("checkpoint.save"):
        with pytest.raises(faults.FaultInjected):
            ck1.save(3, _state(1, 3)).wait()
    stage = os.path.join(ck1.directory, "step_00000003.mh")
    assert not os.path.exists(os.path.join(stage, "host-1.ok"))
    ck0 = _ckptr(tmp_path, rank=0, world=2, commit_timeout_s=0.3)
    with pytest.raises(BarrierTimeout):  # no liveness evidence here
        ck0.save(3, _state(0, 3)).wait()
    assert ck0.all_steps() == []


def test_missing_own_payload_in_committed_step_is_an_error(tmp_path):
    """A committed step missing THIS rank's payload is corrupt:
    restoring another host's state (per-host optimizer slots, staleness
    counters) would silently diverge the run.  A rank beyond the
    writing world (larger-world resume) takes the elastic resharding
    path — which convicts the missing payload typed; only the
    pre-elastic opt-out still reads the leader's replica."""
    import shutil

    from dist_keras_tpu_torch.checkpoint import CheckpointCorrupt

    ck1 = _ckptr(tmp_path, rank=1, world=2)
    ck0 = _ckptr(tmp_path, rank=0, world=2)
    ck1.save(4, _state(1, 4)).wait()
    ck0.save(4, _state(0, 4)).wait()
    shutil.rmtree(os.path.join(ck0.directory, "step_00000004",
                               "host_1"))
    with pytest.raises(RuntimeError, match="host_1"):
        ck1.restore(template=_state(1, 4))
    # rank 0's own payload still restores
    step, got = ck0.restore(template=_state(0, 4))
    assert step == 4
    # a rank beyond the writing world reshards (round 13) — a deleted
    # payload is typed corrupt there too, never a silent leader copy
    ck5 = _ckptr(tmp_path, rank=5, world=6)
    with pytest.raises(CheckpointCorrupt, match="host_1"):
        ck5.restore(template=_state(0, 4))
    # the pre-elastic leader-replica fallback stays reachable
    step, got = ck5.restore(template=_state(0, 4), elastic=False)
    assert int(got["r"]) == 0


def test_multihost_gc_is_leader_only(tmp_path):
    """Two hosts must not race a third's in-flight rename: only rank 0
    sweeps orphans (and prunes retention) in multi-host mode."""
    ck0 = _ckptr(tmp_path, rank=0, world=2)
    orphan = os.path.join(ck0.directory, "step_00000009.tmp")
    os.makedirs(orphan)
    ck1 = _ckptr(tmp_path, rank=1, world=2)
    ck1._gc_orphans()
    assert os.path.isdir(orphan)  # non-leader: hands off
    ck0._gc_orphans()
    assert not os.path.exists(orphan)  # leader sweeps

    # single-host GC behavior is unchanged (regression guard)
    ck = _ckptr(tmp_path, rank=0, world=1)
    os.makedirs(orphan)
    ck._gc_orphans()
    assert not os.path.exists(orphan)


def test_leader_gc_spares_a_peers_newer_inflight_staging(tmp_path):
    """The leader's post-promote sweep must not destroy a fast peer's
    in-flight phase-1 staging for a NEWER step (saves outside the
    lockstepped boundary loop are not synchronized); staging provably
    superseded (older than the step being committed) is still swept."""
    ck1 = _ckptr(tmp_path, rank=1, world=2)
    ck0 = _ckptr(tmp_path, rank=0, world=2)
    # a torn OLD staging (step 1) and a peer's in-flight NEWER one
    # (step 9, data + marker already landed, leader not there yet)
    os.makedirs(os.path.join(ck0.directory, "step_00000001.mh"))
    ck1.save(9, _state(1, 9)).wait()
    newer = os.path.join(ck0.directory, "step_00000009.mh")
    assert os.path.isdir(newer)
    # the cluster commits step 5
    ck1.save(5, _state(1, 5)).wait()
    ck0.save(5, _state(0, 5)).wait()
    assert ck0.all_steps() == [5]
    assert not os.path.exists(
        os.path.join(ck0.directory, "step_00000001.mh"))  # swept
    assert os.path.exists(os.path.join(newer, "host-1.ok"))  # spared
    # and the spared staging completes into a real commit
    ck0.save(9, _state(0, 9)).wait()
    assert ck0.all_steps() == [5, 9]


def test_coord_env_identity_is_required_not_defaulted(
        tmp_path, monkeypatch):
    """DK_COORD_DIR without DK_COORD_WORLD must be an actionable error
    everywhere — a silent world=1 would turn the two-phase commit OFF
    on the very directory the operator configured for it."""
    monkeypatch.setenv("DK_COORD_DIR", str(tmp_path))
    monkeypatch.delenv("DK_COORD_RANK", raising=False)
    monkeypatch.delenv("DK_COORD_WORLD", raising=False)
    with pytest.raises(ValueError, match="DK_COORD_RANK"):
        coordination.rank()
    with pytest.raises(ValueError, match="DK_COORD_WORLD"):
        coordination.world()


def test_single_host_save_layout_unchanged(tmp_path):
    """world=1 keeps the round-6 layout byte-for-byte: no host_ subdir,
    no markers — old checkpoints stay readable, new ones stay readable
    by old code."""
    ck = _ckptr(tmp_path, rank=0, world=1)
    ck.save(1, {"a": np.ones(3)}).wait()
    names = sorted(os.listdir(os.path.join(ck.directory,
                                           "step_00000001")))
    assert not any(n.startswith("host") for n in names)


class _FakeTrainer:
    handle_preemption = True
    nan_policy = None
    nonfinite_steps = 0
    callbacks = []

    def __init__(self, ckdir):
        from dist_keras_tpu_torch.checkpoint import Checkpointer

        # explicit world=1: the two-phase protocol is exercised above;
        # here the subject is the LOOP's consensus choreography
        self._ck = Checkpointer(ckdir, rank=0, world=1)

    def _checkpointer_or_none(self):
        return self._ck

    def record_training_start(self):
        pass

    def record_training_end(self):
        pass

    def _emit_epoch_end(self, *a):
        pass


def _run_plan(tmp_path, coord, request_at=None):
    from dist_keras_tpu_torch.trainers.chunking import ChunkRunner

    tr = _FakeTrainer(str(tmp_path / "ck"))
    runner = ChunkRunner(tr, plan=[2, 2, 2], start=0, total=6,
                        per_epoch=2, samples_per_unit=1, cadence=None)

    def dispatch(i, K, units_done, data):
        if request_at is not None and i == request_at:
            preemption.request(signal.SIGTERM)
        return np.zeros((1, K), np.float32)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(coordination, "get_coordinator", lambda: coord)
        with pytest.raises(Preempted) as ei:
            runner.run(dispatch, sync_ref=lambda: (),
                       state_fn=lambda: {"x": np.float32(1)})
    return tr, ei.value


def test_peer_preemption_is_adopted_at_the_boundary(tmp_path):
    """Only a PEER saw the SIGTERM (the vote returns True while the
    local flag is clear): this host still drains, saves the agreed
    step, barriers, and exits Preempted — the coordinated pod exit."""
    # scripted verdicts: boundary-0 sig vote True (the peer's flag);
    # the subsequent halt vote echoes the local False
    coord = _ScriptedCoordinator([True])
    tr, p = _run_plan(tmp_path, coord)
    assert p.code == 128 + signal.SIGTERM  # adopted signum
    assert p.saved_step == 0               # first boundary: unit 0
    assert tr._ck.all_steps() == [0]
    assert ("agree_min", 0) in coord.calls
    # the pre-exit barrier came AFTER the vote and the agreement
    assert coord.calls[-1][0] == "barrier"


def test_local_preemption_votes_and_saves_agreed_step(tmp_path):
    """The locally-signalled host goes through the same choreography:
    vote -> agree_min(units_done) -> boundary save -> barrier ->
    Preempted, with the save step the cluster minimum."""
    coord = _ScriptedCoordinator([])  # echo local verdicts
    tr, p = _run_plan(tmp_path, coord, request_at=0)
    # signal during chunk 0 -> noticed at the NEXT boundary (units=2)
    assert p.saved_step == 2
    assert tr._ck.all_steps() == [2]
    votes = [c for c in coord.calls if c[0] == "any_flag"]
    # boundary-0 sig vote, boundary-0 halt vote, boundary-1 sig vote
    assert votes[0] == ("any_flag", False)
    assert ("any_flag", True) in votes[1:]  # the sig vote that carried
    assert ("agree_min", 2) in coord.calls
    assert coord.calls[-1][0] == "barrier"


def test_uncoordinated_single_process_path_unchanged(tmp_path):
    """world=1 (the real LocalCoordinator): same per-process semantics
    as round 6 — boundary save + Preempted, no consensus cost beyond
    the fault-point lookups."""
    tr, p = _run_plan(tmp_path, LocalCoordinator(), request_at=1)
    assert p.code == 143
    assert p.saved_step == 4
    assert tr._ck.all_steps() == [4]


def test_coord_flag_fault_aborts_the_boundary_vote(tmp_path):
    """An armed coord.flag makes the boundary vote itself the failure —
    typed, at an exact call count, instead of a wedged pod."""
    from dist_keras_tpu_torch.trainers.chunking import ChunkRunner

    tr = _FakeTrainer(str(tmp_path / "ck"))
    runner = ChunkRunner(tr, plan=[2, 2], start=0, total=4, per_epoch=2,
                        samples_per_unit=1, cadence=None)
    faults.inject("coord.flag", at=1)  # second boundary's vote dies
    with pytest.raises(faults.FaultInjected):
        runner.run(lambda i, K, u, d: np.zeros((1, K), np.float32),
                   sync_ref=lambda: (),
                   state_fn=lambda: {"x": np.float32(1)})


class _ScriptedCoordinator(coordination.Coordinator):
    """world=2 stand-in with pre-scripted any_flag verdicts (popped per
    call; falls back to the local flag when exhausted)."""

    def __init__(self, responses):
        self.world = 2
        self.rank = 0
        self.responses = list(responses)
        self.calls = []

    def any_flag(self, flag, timeout_s=None):
        self.calls.append(("any_flag", bool(flag)))
        if self.responses:
            return bool(self.responses.pop(0))
        return bool(flag)

    def agree_min(self, value, timeout_s=None):
        self.calls.append(("agree_min", value))
        return value

    def barrier(self, tag="dk_coord_barrier", timeout_s=None):
        self.calls.append(("barrier", tag))
        return self.world


def test_peer_halt_verdict_halts_this_host_too(tmp_path):
    """The NaN halt verdict is CLUSTER-wide: a peer that halted (vote
    True at the boundary) halts this host as well, and neither persists
    a checkpoint — an uncoordinated break would strand the peer's next
    vote until the deadline."""
    from dist_keras_tpu_torch.trainers.chunking import ChunkRunner

    tr = _FakeTrainer(str(tmp_path / "ck"))
    tr.nan_policy = "halt"
    # call order: top sig-vote (False), boundary halt-vote (True=peer)
    coord = _ScriptedCoordinator([False, True])
    runner = ChunkRunner(tr, plan=[2, 2, 2], start=0, total=6,
                        per_epoch=2, samples_per_unit=1, cadence=None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(coordination, "get_coordinator", lambda: coord)
        losses = runner.run(
            lambda i, K, u, d: np.zeros((1, K), np.float32),
            sync_ref=lambda: (), state_fn=lambda: {"x": np.float32(1)})
    assert len(losses) == 1          # halted at the first boundary
    assert tr._ck.all_steps() == []  # nobody persisted diverged state
    assert ("any_flag", False) in coord.calls  # the boundary vote ran


def test_two_phase_opt_out_keeps_per_host_independent_saves(
        tmp_path, monkeypatch):
    """DK_CKPT_TWO_PHASE=0: a pod whose checkpoint_dir is per-host
    LOCAL scratch keeps the round-6 independent atomic save (markers
    can't rendezvous across different machines' disks) — including its
    own GC and retention."""
    monkeypatch.setenv("DK_CKPT_TWO_PHASE", "0")
    ck1 = _ckptr(tmp_path, rank=1, world=2)
    ck1.save(5, _state(1, 5)).wait()
    assert ck1.all_steps() == [5]  # committed alone, no marker wait
    names = os.listdir(os.path.join(ck1.directory, "step_00000005"))
    assert not any(n.startswith("host") for n in names)  # old layout
    step, got = ck1.restore(template=_state(1, 5))
    assert step == 5
    orphan = os.path.join(ck1.directory, "step_00000001.tmp")
    os.makedirs(orphan)
    ck1.save(6, _state(1, 6)).wait()  # non-leader still sweeps ITS dir
    assert not os.path.exists(orphan)


def test_session_root_expands_home(monkeypatch):
    monkeypatch.delenv("DK_COORD_SESSION", raising=False)
    assert coordination._session_root("~/x") == os.path.expanduser("~/x")


def test_file_coordinator_requires_explicit_rank(tmp_path, monkeypatch):
    """DK_COORD_DIR without DK_COORD_RANK must be an actionable error,
    not a KeyError (and never a silent rank-0 default — two self-
    declared leaders would corrupt the commit protocol)."""
    monkeypatch.delenv("DK_COORD_RANK", raising=False)
    with pytest.raises(ValueError, match="DK_COORD_RANK"):
        FileCoordinator(str(tmp_path))


def _in_thread(fn):
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:
            box["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(10)
    return box


def test_install_off_main_thread_raises_clear_error():
    box = _in_thread(lambda: preemption.install())
    assert isinstance(box.get("error"), RuntimeError)
    assert "main thread" in str(box["error"]).lower()
    assert "strict=False" in str(box["error"])


def test_install_off_main_thread_nonstrict_degrades_to_false():
    box = _in_thread(lambda: preemption.install(strict=False))
    assert box.get("value") is False
    # and the trainer loop (which passes strict=False) still trains
    # without a graceful window — no handlers were touched
    assert signal.getsignal(signal.SIGTERM) != preemption._handler


def test_install_on_main_thread_still_works():
    try:
        assert preemption.install() is True
        assert signal.getsignal(signal.SIGTERM) is preemption._handler
    finally:
        preemption.restore()


def test_env_faults_accept_coordination_exception_types(monkeypatch):
    monkeypatch.setenv("DK_FAULTS",
                       "x.peer@0:exc=PeerLost;y.bar@0:exc=BarrierTimeout")
    faults.load_env(force=True)
    with pytest.raises(PeerLost):
        faults.fault_point("x.peer")
    with pytest.raises(BarrierTimeout):
        faults.fault_point("y.bar")



# ---------------------------------------------------------------------------
# the port's own: no JaxCoordinator, and two real processes
# ---------------------------------------------------------------------------
def test_rank_and_world_without_coordination_env(monkeypatch):
    for var in ("DK_COORD_DIR", "DK_COORD_RANK", "DK_COORD_WORLD"):
        monkeypatch.delenv(var, raising=False)
    assert (coordination.rank(), coordination.world()) == (0, 1)
    assert isinstance(coordination.get_coordinator(), LocalCoordinator)


def test_a_process_group_without_coord_dir_picks_the_group_coordinator(
        monkeypatch):
    """Where the reference picks its JaxCoordinator — a multi-process
    group and no DK_COORD_DIR — the port picks its GroupCoordinator,
    and rank() / world() read the group; DK_COORD_DIR still wins."""
    from dist_keras_tpu_torch.comm import backend as comm

    for var in ("DK_COORD_DIR", "DK_COORD_RANK", "DK_COORD_WORLD"):
        monkeypatch.delenv(var, raising=False)
    group = comm._Group(rank=1, world=3, local_rank=1, local_world=3,
                        backend="gloo", device=None, cpu_group=None,
                        devices=[])
    monkeypatch.setattr(comm, "_group", group)
    coordination.reset()
    try:
        c = coordination.get_coordinator()
        assert isinstance(c, coordination.GroupCoordinator)
        assert (c.rank, c.world) == (1, 3)
        assert (coordination.rank(), coordination.world()) == (1, 3)
    finally:
        coordination.reset()
    monkeypatch.setattr(comm, "_group", None)
    with pytest.raises(ValueError, match="process group"):
        coordination.GroupCoordinator()


_HOST = r"""
import json, os, sys
sys.path.insert(0, %REPO%)
import numpy as np
from dist_keras_tpu_torch.checkpoint import Checkpointer
from dist_keras_tpu_torch.resilience import coordination

rank = int(os.environ["DK_COORD_RANK"])
coord = coordination.get_coordinator()      # heartbeats from here on
ck = Checkpointer(%CKPT%, commit_timeout_s=30.0)
out = {"rank": rank, "world": coord.world}
coord.barrier("start")
state = {"w": np.arange(64, dtype=np.float32) + rank, "r": np.int32(rank)}
ck.save(1, state).wait(timeout_s=30)        # both hosts: step 1 promotes
coord.barrier("saved_1")
if rank == 1:
    coord.close()                           # this host dies: no step 2
    os._exit(9)
try:
    ck.save(2, state).wait(timeout_s=40)
    out["step2"] = "committed"
except Exception as e:
    out["step2"] = type(e).__name__
    out["ranks"] = list(getattr(e, "ranks", ()))
out["steps"] = ck.all_steps()
step, got = ck.restore()
out["restored"] = [int(step), float(got["w"][0]), int(got["r"])]
print(json.dumps(out), flush=True)
"""


def test_two_process_two_phase_commit_and_peer_lost(tmp_path):
    """Two processes share a checkpoint directory through the
    FileCoordinator: step 1 commits two-phase (each rank restores its
    own payload); then rank 1 dies before staging step 2, and the
    leader's marker wait raises PeerLost naming rank 1 from its stale
    heartbeat — early, never a hang — leaving step 1 the committed
    one."""
    script = (_HOST.replace("%REPO%", repr(REPO))
              .replace("%CKPT%", repr(str(tmp_path / "ck"))))
    path = tmp_path / "host.py"
    path.write_text(script)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DK_", "JAX_"))}
    env.update(DK_COORD_DIR=str(tmp_path / "coord"), DK_COORD_WORLD="2",
               DK_COORD_STALE_S="1.0", DK_COORD_TIMEOUT_S="30")
    procs = [subprocess.Popen(
        [sys.executable, str(path)], env=dict(env, DK_COORD_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in (0, 1)]
    t0 = time.monotonic()
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            p.kill()
    assert procs[1].returncode == 9, outs[1][1][-2000:]
    assert procs[0].returncode == 0, outs[0][1][-2000:]
    got = json.loads(outs[0][0].splitlines()[-1])
    assert got["world"] == 2
    assert got["step2"] == "PeerLost" and got["ranks"] == [1]
    assert got["steps"] == [1]
    assert got["restored"] == [1, 0.0, 0]
    assert time.monotonic() - t0 < 60   # the 30 s deadline was not needed
    # the leader promoted step 1 with BOTH payloads: rank 1's restores
    from dist_keras_tpu_torch.checkpoint import Checkpointer

    step, got1 = Checkpointer(str(tmp_path / "ck"), rank=1,
                              world=2).restore()
    assert step == 1 and int(got1["r"]) == 1
    np.testing.assert_array_equal(got1["w"],
                                  np.arange(64, dtype=np.float32) + 1)
