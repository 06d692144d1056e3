"""One rank per card, on the CPU: the bring-up composing a host's
identity (``JAX_*``) with its cards' (``LOCAL_RANK`` /
``LOCAL_WORLD_SIZE``), the hosts' local worlds checked through the
rendezvous store, the backend rule over the ranks' card keys (the card
UUIDs faked through ``comm.backend._card_uuid``), the per-card fan-out
``python -m dist_keras_tpu_torch.launch.local`` (its children's
environment, TERM forwarding, the first non-zero exit code, a real gloo
group of its children) and ``reduce_stats``' ``device_seconds`` on a
gloo run.

The JAX package brings up one process per host that drives every
device; its ``comm.initialize`` reads the same ``JAX_*`` variables
(``tests/test_torch_launch.py`` holds the Job's environment equal to
the JAX package's), so the composed world is the JAX world's device
count: hosts x devices a host."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch.distributed as dist

from dist_keras_tpu_torch.comm import backend as comm
from dist_keras_tpu_torch.launch import local

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120
ENV_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
            "LOCAL_RANK", "LOCAL_WORLD_SIZE", "WORLD_SIZE", "RANK",
            "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV_VARS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.mark.parametrize("hosts,host,local_world,local_rank", [
    (1, 0, 4, 0), (1, 0, 4, 3), (2, 0, 2, 1), (2, 1, 2, 0), (2, 1, 2, 1),
    (4, 3, 1, 0), (3, 2, 8, 5)])
def test_the_jax_and_local_variables_compose(clean_env, hosts, host,
                                             local_world, local_rank):
    """world = hosts x local world, rank = host x local world + local
    rank, met at the Job's coordinator (``host:port`` -> ``tcp://``)."""
    clean_env.setenv("JAX_COORDINATOR_ADDRESS", "h0:8476")
    clean_env.setenv("JAX_NUM_PROCESSES", str(hosts))
    clean_env.setenv("JAX_PROCESS_ID", str(host))
    clean_env.setenv("LOCAL_WORLD_SIZE", str(local_world))
    clean_env.setenv("LOCAL_RANK", str(local_rank))
    assert comm._rendezvous_from(None, None, None) == (
        "tcp://h0:8476", hosts * local_world,
        host * local_world + local_rank)
    assert comm._composed() == (host, hosts, local_rank, local_world)


@pytest.mark.parametrize("env,want", [
    ({"JAX_COORDINATOR_ADDRESS": "h0:1", "JAX_NUM_PROCESSES": "2",
      "JAX_PROCESS_ID": "1"}, ("tcp://h0:1", 2, 1)),
    ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2", "WORLD_SIZE": "2",
      "RANK": "1", "MASTER_ADDR": "a", "MASTER_PORT": "1"},
     ("env://", 2, 1)),
    ({"LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}, None)],
    ids=["jax_alone", "torchrun_alone", "local_alone"])
def test_either_set_alone_reads_as_before(clean_env, env, want):
    """The ``JAX_*`` variables alone (one process a host) and the
    torchrun ones alone keep their meaning; ``LOCAL_*`` alone asks for
    no group."""
    for k, v in env.items():
        clean_env.setenv(k, v)
    assert comm._rendezvous_from(None, None, None) == want


def test_a_local_rank_outside_its_world_is_refused(clean_env):
    clean_env.setenv("LOCAL_RANK", "2")
    clean_env.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="LOCAL_RANK=2 outside"):
        comm._local_slot()


def _fan_out_stores(tmp_path, slots):
    """Each (host, hosts, local rank, local world) of ``slots`` meets at
    one file rendezvous on a thread; -> {slot: "ok" or the error}."""
    url = f"file://{tmp_path / 'rdv'}"
    got = {}

    def one(slot):
        host, hosts, lr, lw = slot
        try:
            comm._fan_out_store(url, host * lw + lr, hosts * lw, slot, 30.0)
            got[slot] = "ok"
        except ValueError as e:
            got[slot] = str(e)

    threads = [threading.Thread(target=one, args=(s,)) for s in slots]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    return got


def test_hosts_that_agree_on_their_local_world_meet(tmp_path):
    slots = [(h, 2, lr, 2) for h in range(2) for lr in range(2)]
    assert _fan_out_stores(tmp_path, slots) == {s: "ok" for s in slots}


def test_unequal_local_worlds_are_a_value_error_naming_the_hosts(tmp_path):
    """Host 0 runs two ranks, host 1 one: every rank refuses, naming each
    host's count, instead of waiting for ranks that never come."""
    slots = [(0, 2, 0, 2), (0, 2, 1, 2), (1, 2, 0, 1)]
    got = _fan_out_stores(tmp_path, slots)
    assert set(got) == set(slots)
    for msg in got.values():
        assert "host 0 2, host 1 1" in msg and "--nproc-per-host" in msg


@pytest.mark.parametrize("uuids,want", [
    (("GPU-a", "GPU-a"), "gloo"), (("GPU-a", "GPU-b"), "nccl"),
    (("GPU-a", "GPU-b", "GPU-a", "GPU-c"), "gloo"),
    (("GPU-a", "GPU-b", "GPU-c", "GPU-d"), "nccl"), ((None, "GPU-b"), "gloo")],
    ids=["two_emulated_hosts_one_card", "two_cards", "four_ranks_three_cards",
         "four_cards", "a_rank_on_the_cpu"])
def test_the_backend_rule_reads_every_ranks_card(monkeypatch, uuids, want):
    """Each rank publishes its card's key (host name and UUID) through
    the store; two ranks on one physical card (two emulated hosts, each
    with a local world of 1) get gloo, as a rank without a card does."""
    store = dist.HashStore()
    monkeypatch.setattr(comm, "_card_uuid", lambda index: uuids[index])
    world = len(uuids)
    keys = {}

    def one(rank):
        index = None if uuids[rank] is None else rank
        keys[rank] = comm._card_keys(store, rank, world, index, 30.0)

    threads = [threading.Thread(target=one, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert len({tuple(k) for k in keys.values()}) == 1
    assert comm.select_backend(keys[0]) == want
    assert comm.select_backend(keys[0], on_cpu=True) == "gloo"


def test_child_environments(clean_env):
    """LOCAL_* per child, the JAX_* variables unchanged, and under
    DK_COORD_DIR the children's coordination identity: global rank and
    world, a directory of their own."""
    env = {"JAX_COORDINATOR_ADDRESS": "h0:1", "JAX_NUM_PROCESSES": "2",
           "JAX_PROCESS_ID": "1", "DK_COORD_DIR": "/c", "DK_COORD_RANK": "1",
           "DK_COORD_WORLD": "2", "DK_COORD_SESSION": "3"}
    envs = local.child_envs(2, env)
    assert [(e["LOCAL_RANK"], e["LOCAL_WORLD_SIZE"]) for e in envs] == [
        ("0", "2"), ("1", "2")]
    assert all(e[k] == env[k] for e in envs for k in (
        "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
        "DK_COORD_SESSION"))
    assert [(e["DK_COORD_DIR"], e["DK_COORD_RANK"], e["DK_COORD_WORLD"])
            for e in envs] == [("/c/ranks", "2", "4"), ("/c/ranks", "3", "4")]
    alone = local.child_envs(1, {})
    assert alone[0]["JAX_NUM_PROCESSES"] == "1"
    assert alone[0]["JAX_COORDINATOR_ADDRESS"].startswith("127.0.0.1:")
    assert "DK_COORD_DIR" not in alone[0]


CHILD = r'''
import json, os, signal, sys, time
out = sys.argv[1]
mode = sys.argv[2]
lr = int(os.environ["LOCAL_RANK"])
terms = []
signal.signal(signal.SIGTERM, lambda s, f: terms.append(s))
def record(**kw):
    rec = {k: os.environ.get(k) for k in (
        "LOCAL_RANK", "LOCAL_WORLD_SIZE", "JAX_PROCESS_ID",
        "JAX_NUM_PROCESSES")}
    rec.update(kw, terms=len(terms))
    with open(os.path.join(out, f"child_{lr}.json"), "w") as f:
        json.dump(rec, f)
if mode == "group":
    sys.path.insert(0, os.environ["DK_TEST_ROOT"])
    import torch
    torch.set_num_threads(1)
    from dist_keras_tpu_torch import comm
    from dist_keras_tpu_torch.parallel import collectives
    comm.initialize(device="cpu")
    g = comm.group_info()
    s = collectives.tree_psum({"w": torch.ones(1, 3)})["w"].tolist()
    stats = collectives.reduce_stats()
    record(rank=g.rank, world=g.world, local=[g.local_rank, g.local_world],
           backend=g.backend, sum=s, stats=stats)
    comm.shutdown()
    sys.exit(0)
open(os.path.join(out, f"ready_{lr}"), "w").close()
if mode == "fail" and lr == 1:
    record()
    sys.exit(3)
t0 = time.time()
while not terms and time.time() - t0 < 60:
    time.sleep(0.01)
time.sleep(0.2)
record()
sys.exit(0)
'''


def _fan_out(tmp_path, mode, send_term=False):
    """``python -m dist_keras_tpu_torch.launch.local --nproc-per-host 2``
    on the CHILD program; -> (rc, [child records])."""
    (tmp_path / "child.py").write_text(CHILD)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DK_", "JAX_")) and k not in ENV_VARS}
    env.update(PYTHONPATH=REPO, DK_TEST_ROOT=REPO, DK_COORD_TIMEOUT_S="60")
    p = subprocess.Popen(
        [sys.executable, "-m", "dist_keras_tpu_torch.launch.local",
         "--nproc-per-host", "2", str(tmp_path / "child.py"), str(tmp_path),
         mode], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        if send_term:
            t0 = time.time()
            while not all((tmp_path / f"ready_{i}").exists() for i in (0, 1)):
                assert p.poll() is None and time.time() - t0 < TIMEOUT_S
                time.sleep(0.02)
            p.send_signal(signal.SIGTERM)
        out = p.communicate(timeout=TIMEOUT_S)[0]
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    recs = [json.loads((tmp_path / f"child_{i}.json").read_text())
            for i in (0, 1) if (tmp_path / f"child_{i}.json").exists()]
    return p.returncode, recs, out


def test_the_fan_out_returns_the_first_nonzero_code_and_terms_the_rest(
        tmp_path):
    rc, recs, out = _fan_out(tmp_path, "fail")
    assert rc == 3, out
    assert [(r["LOCAL_RANK"], r["LOCAL_WORLD_SIZE"]) for r in recs] == [
        ("0", "2"), ("1", "2")]
    assert [r["JAX_NUM_PROCESSES"] for r in recs] == ["1", "1"]
    assert recs[0]["terms"] == 1 and recs[1]["terms"] == 0


def test_the_fan_out_forwards_term_once_to_every_child(tmp_path):
    rc, recs, out = _fan_out(tmp_path, "term", send_term=True)
    assert rc == 0, out
    assert [r["terms"] for r in recs] == [1, 1]


def test_the_fan_out_children_form_one_gloo_group(tmp_path):
    """Run alone, the fan-out is one host of two ranks: the children meet
    at a free local port, compose rank and world, sum across the group,
    and ``reduce_stats`` carries ``device_seconds`` (on gloo the host's
    wall of the calls, the value ``seconds`` holds)."""
    rc, recs, out = _fan_out(tmp_path, "group")
    assert rc == 0, out
    assert [(r["rank"], r["world"], r["local"], r["backend"]) for r in recs] \
        == [(0, 2, [0, 2], "gloo"), (1, 2, [1, 2], "gloo")]
    for r in recs:
        assert r["sum"] == [2.0, 2.0, 2.0]
        st = r["stats"]
        assert st["calls"] == 1 and st["bytes"] == 12
        assert st["device_seconds"] >= 0.0
        assert st["device_seconds"] == pytest.approx(st["seconds"])


@pytest.mark.parametrize("env,want", [
    ({"JAX_PROCESS_ID": "1", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, 3),
    ({"JAX_PROCESS_ID": "1"}, 1),
    ({"JAX_PROCESS_ID": "1", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2",
      "DK_COORD_RANK": "5"}, 5)],
    ids=["fan_out_rank", "one_process_a_host", "coordination_rank_wins"])
def test_the_event_log_names_a_fan_out_rank_by_its_global_rank(
        clean_env, env, want):
    """Without ``DK_COORD_RANK`` the event log's rank composes the host's
    id with the card's, as ``comm.initialize`` does, so one host's ranks
    never share an ``events-rank_*`` file."""
    from dist_keras_tpu_torch.observability import events

    clean_env.delenv("DK_COORD_RANK", raising=False)
    for k, v in env.items():
        clean_env.setenv(k, v)
    assert events._default_rank() == want
