"""The port's parameter server and client (``dist_keras_tpu_torch/ps/
server.py``, ``client.py``) over real HTTP on loopback, and the wire and
checkpoints shared with the JAX package.

The cross-package tests are the strongest check that the protocol is the
same: the JAX client against the port's server and the port's client
against the JAX server give the verdicts of an all-JAX run of the same
calls, with centers bit-equal, and a center either package's server
checkpointed resumes in the other's bit for bit.  Every server binds
``port=0`` and is closed in ``finally``; every RPC and drain has a
timeout.
"""

import http.client
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dist_keras_tpu.ps import PSClient as JClient
from dist_keras_tpu.ps import PSServer as JServer
from dist_keras_tpu.ps import StaleCommit as JStale
from dist_keras_tpu.ps import PSError as JPSError
from dist_keras_tpu_torch.models import mnist_mlp
from dist_keras_tpu_torch.ps import (
    PSClient,
    PSError,
    PSServer,
    PSUnavailable,
    StaleCommit,
)
from dist_keras_tpu_torch.resilience import faults
from dist_keras_tpu_torch.resilience.faults import FaultInjected
from dist_keras_tpu_torch.utils.bridge import params_to_numpy

DRAIN_S = 60.0


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"dense": {"w": rng.normal(size=(6, 4)).astype(np.float32),
                      "b": rng.normal(size=(4,)).astype(np.float32)},
            "seed_state": np.array([1, 2], dtype=np.uint32)}


def _delta(seed):
    rng = np.random.default_rng(seed)
    return {"dense": {"w": rng.normal(size=(6, 4)).astype(np.float32),
                      "b": rng.normal(size=(4,)).astype(np.float32)},
            "seed_state": np.zeros((), np.int32)}


def _addr(srv):
    return f"{srv.address[0]}:{srv.address[1]}"


def _client(srv, cls=PSClient, **kw):
    kw.setdefault("attempts", 2)
    kw.setdefault("backoff", 0.01)
    kw.setdefault("rpc_timeout_s", 30.0)
    return cls(_addr(srv), **kw)


@pytest.fixture()
def ps_server(tmp_path):
    srv = PSServer(params=_params(0), port=0, window=4,
                   ckpt_dir=str(tmp_path / "ck"), ckpt_every_commits=2,
                   lease_s=30.0)
    srv.start()
    try:
        yield srv
    finally:
        srv.close()


def test_http_join_pull_commit_round_trip(ps_server):
    c = _client(ps_server)
    joined = c.join(rank=7)
    assert joined["window"] == 4 and joined["version"] == 0
    wid = joined["wid"]
    c2 = _client(ps_server)
    j2 = c2.join()
    resp = c.commit(wid, joined["version"], _delta(1))
    assert resp["version"] == 1 and resp["staleness"] == 0
    pulled = c.pull(wid)
    assert pulled["version"] == 1
    np.testing.assert_array_equal(pulled["center"]["dense"]["w"],
                                  resp["center"]["dense"]["w"])
    r2 = c2.commit(j2["wid"], j2["version"], _delta(2))
    assert r2["staleness"] == 1 and r2["scale"] == pytest.approx(0.5)


def test_http_over_cap_maps_to_409_stale_commit():
    srv = PSServer(params=_params(0), port=0, staleness_cap=0)
    srv.start()
    try:
        c = _client(srv)
        j = c.join()
        c.commit(j["wid"], j["version"], _delta(1))
        with pytest.raises(StaleCommit) as ei:
            c.commit(j["wid"], j["version"], _delta(2))
        assert ei.value.staleness == 1 and ei.value.cap == 0
    finally:
        srv.close()


def test_structurally_foreign_delta_is_typed_400(ps_server):
    c = _client(ps_server)
    j = c.join()
    bad = {"dense": {"w": np.zeros((2, 2), np.float32)}}
    with pytest.raises(PSError) as ei:
        c.commit(j["wid"], j["version"], bad)
    assert "400" in str(ei.value)
    assert not isinstance(ei.value, PSUnavailable)
    assert c.pull(j["wid"])["version"] == 0


def test_corrupt_pickle_body_is_typed_400(ps_server):
    conn = http.client.HTTPConnection(*ps_server.address, timeout=10)
    try:
        conn.request("POST", "/pull", body=b"\x80notpickle",
                     headers={"Content-Type": "application/octet-stream"})
        r = conn.getresponse()
        r.read()
        assert r.status == 400
    finally:
        conn.close()
    assert _client(ps_server).pull()["version"] == 0


def test_zero_window_rejected_everywhere():
    from dist_keras_tpu_torch.ps import PSWorkerTrainer

    with pytest.raises(ValueError, match="window"):
        PSServer(params=_params(0), port=0, window=0)
    with pytest.raises(ValueError, match="communication_window"):
        PSWorkerTrainer(mnist_mlp(hidden=(4,), input_dim=8, num_classes=2),
                        server_addr="127.0.0.1:1", communication_window=0,
                        device="cpu")


def test_drain_stops_admission_typed_and_promotes_final_step(ps_server):
    c = _client(ps_server)
    j = c.join()
    for i in range(3):
        ver = c.commit(j["wid"], c.pull(j["wid"])["version"],
                       _delta(i))["version"]
    step = ps_server.drain(timeout_s=DRAIN_S)
    assert step == ver == 3
    with pytest.raises(PSUnavailable):
        c.pull(j["wid"])
    with pytest.raises(PSUnavailable):
        c.commit(j["wid"], ver, _delta(9))


def test_server_restart_resumes_latest_promoted_verified_step(tmp_path):
    ck = str(tmp_path / "ck")
    srv = PSServer(params=_params(0), port=0, ckpt_dir=ck,
                   ckpt_every_commits=1)
    srv.start()
    try:
        c = _client(srv)
        j = c.join()
        version = j["version"]
        for i in range(3):
            resp = c.commit(j["wid"], version, _delta(i))
            version = resp["version"]
        assert srv.drain(timeout_s=DRAIN_S) == 3
    finally:
        srv.close()
    srv2 = PSServer(port=0, ckpt_dir=ck)
    try:
        assert srv2.restored_step == 3 and srv2.center.clock == 3
        _, center = srv2.center.state()
        np.testing.assert_array_equal(center["dense"]["w"],
                                      resp["center"]["dense"]["w"])
        assert center["seed_state"].dtype == np.uint32
        assert srv2.center.commit("survivor", 10, _delta(7))["staleness"] == 0
    finally:
        srv2.close()


def test_cold_start_without_params_or_checkpoint_is_actionable(tmp_path):
    with pytest.raises(ValueError, match="initial params"):
        PSServer(params=None, port=0, ckpt_dir=str(tmp_path / "empty"))


def test_center_restart_restores_bit_equal_from_differential_save(
        tmp_path, monkeypatch):
    monkeypatch.setenv("DK_CKPT_CHUNK_MB", "0.0625")  # 64 KB chunks
    monkeypatch.setenv("DK_CKPT_ASYNC", "0")
    params = {"dense": {"w": np.arange(65536, dtype=np.float32)},
              "rng": np.arange(16384, dtype=np.uint32)}
    ck = str(tmp_path / "ck")
    srv = PSServer(params=params, port=0, ckpt_dir=ck,
                   ckpt_every_commits=1)
    try:
        delta = {"dense": {"w": np.full(65536, 0.5, np.float32)},
                 "rng": np.zeros((), np.int32)}
        info = srv.center.commit("w0", 0, delta)
        assert srv.checkpoint_now(timeout_s=DRAIN_S) == info["version"]
        full = srv._ckptr.last_diff_stats
        assert full["chunks"] == 5 and full["skipped"] == 0
        info = srv.center.commit("w0", info["version"], delta)
        assert srv.checkpoint_now(timeout_s=DRAIN_S) == info["version"] == 2
        diffed = srv._ckptr.last_diff_stats
        assert diffed["skipped"] == 1
        assert diffed["bytes_skipped"] == params["rng"].nbytes
        _, live = srv.center.state()
    finally:
        srv.close()
    srv2 = PSServer(port=0, ckpt_dir=ck)
    try:
        assert srv2.restored_step == 2 and srv2.center.clock == 2
        _, restored = srv2.center.state()
        np.testing.assert_array_equal(restored["dense"]["w"],
                                      live["dense"]["w"])
        np.testing.assert_array_equal(restored["rng"], live["rng"])
        assert restored["rng"].dtype == np.uint32
    finally:
        srv2.close()


def test_healthz_metricsz(ps_server):
    base = "http://%s:%d" % ps_server.address
    with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
        assert json.loads(r.read())["status"] == "serving"
    c = _client(ps_server)
    j = c.join()
    c.commit(j["wid"], 0, _delta(1))
    with urllib.request.urlopen(base + "/metricsz", timeout=10) as r:
        doc = json.loads(r.read())
    assert doc["ps"]["clock"] == 1 and doc["ps"]["workers"] == 1
    assert doc["registry"]["counters"]["ps.commits"] >= 1
    with urllib.request.urlopen(base + "/metricsz?format=prometheus",
                                timeout=10) as r:
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    assert "# TYPE dk_ps_commits_total counter" in text
    assert any(line.startswith("dk_ps_server_clock") and
               line.endswith(" 1") for line in text.splitlines())
    ps_server.drain(timeout_s=DRAIN_S)
    with pytest.raises((urllib.error.URLError, OSError)):
        urllib.request.urlopen(base + "/healthz", timeout=10)


def test_unreachable_server_typed_after_retries():
    c = PSClient("127.0.0.1:1", attempts=2, backoff=0.0)
    with pytest.raises(PSUnavailable):
        c.pull()


def test_fault_points_absorbed_or_typed(ps_server):
    c = _client(ps_server, attempts=3)
    j = c.join()
    with faults.armed("ps.pull", exc=OSError):
        assert c.pull(j["wid"])["version"] == 0
    with faults.armed("ps.commit"):
        with pytest.raises(FaultInjected):
            c.commit(j["wid"], 0, _delta(1))
    with faults.armed("ps.join"):
        with pytest.raises(FaultInjected):
            c.join()
    assert c.commit(j["wid"], 0, _delta(1))["version"] == 1


def test_malformed_addr_and_missing_addr_actionable(monkeypatch):
    monkeypatch.delenv("DK_PS_ADDR", raising=False)
    with pytest.raises(ValueError, match="DK_PS_ADDR"):
        PSClient()
    with pytest.raises(ValueError, match="host:port"):
        PSClient("no-port-here")
    monkeypatch.setenv("DK_PS_ADDR", "10.1.2.3:7447")
    c = PSClient()
    assert (c.host, c.port) == ("10.1.2.3", 7447)


def test_reaper_host_drop_evidence(tmp_path, monkeypatch):
    coord = tmp_path / "coord"
    hb = coord / "hb"
    hb.mkdir(parents=True)
    (hb / "rank_1").write_text("beat")
    old = time.time() - 3600
    os.utime(hb / "rank_1", (old, old))
    monkeypatch.setenv("DK_COORD_DIR", str(coord))
    monkeypatch.setenv("DK_COORD_WORLD", "2")
    srv = PSServer(params=_params(0), port=0, lease_s=3600.0)
    try:
        srv.center.join(wid="wdead", rank=1, now=0.0)
        srv.center.join(wid="wlive", rank=0, now=0.0)
        dead = srv._reap_once(now=1.0)
        assert ("wdead", 1, "host_drop") in dead
        assert srv.center.stats()["workers"] == 1
    finally:
        srv.close()


def test_port_model_params_become_numpy_at_the_door():
    """``PSServer(params=...)`` takes a port model's torch params (with
    the init-order keys); the center and the wire hold numpy, bit for
    bit, and a JAX-shaped delta (sorted keys) applies by key."""
    m = mnist_mlp(hidden=(16,), input_dim=8, num_classes=2)
    assert all(isinstance(v, torch.Tensor) for p in m.params
               for v in p.values())
    srv = PSServer(params=m.params, port=0)
    srv.start()
    try:
        c = _client(srv)
        j = c.join()
        want = params_to_numpy(m.params)
        for got, ref in zip(j["center"], want):
            assert list(got) == list(ref) == ["kernel", "bias"]
            for k in ref:
                assert type(got[k]) is np.ndarray
                np.testing.assert_array_equal(got[k], ref[k])
        delta = [{"bias": np.ones_like(p["bias"]),
                  "kernel": np.ones_like(p["kernel"])} for p in want]
        resp = c.commit(j["wid"], 0, delta)
        np.testing.assert_array_equal(resp["center"][1]["bias"],
                                      want[1]["bias"] + np.float32(1.0))
    finally:
        srv.close()


# ---------------------------------------------------------------------
# the wire and checkpoints shared with the JAX package
# ---------------------------------------------------------------------

def _script(srv, client_cls, stale_cls, error_cls):
    """One seeded script of calls -> (verdicts, final center): two
    joins, a fresh commit, a stale-by-1 commit, a pull, an over-cap
    commit (cap 1), a foreign delta, and a commit_id replay through
    the client's own retry of a response-lost commit."""
    a, b = _client(srv, client_cls), _client(srv, client_cls)
    out = []
    ja, jb = a.join(rank=1), b.join(rank=2)
    out.append(("join", ja["wid"], ja["version"], ja["window"],
                jb["wid"], jb["version"], jb["rejoined"]))
    r = a.commit(ja["wid"], ja["version"], _delta(1), rank=1)
    out.append(("commit", r["version"], r["staleness"], r["scale"],
                r["rejoined"], r["duplicate"]))
    r = b.commit(jb["wid"], jb["version"], _delta(2), rank=2)
    out.append(("commit", r["version"], r["staleness"], r["scale"],
                r["rejoined"], r["duplicate"]))
    p = a.pull(ja["wid"])
    out.append(("pull", p["version"]))
    try:
        b.commit(jb["wid"], 0, _delta(3))
        out.append(("stale", "applied"))
    except stale_cls as e:
        out.append(("stale", e.staleness, e.cap, e.wid))
    try:
        b.commit(jb["wid"], p["version"],
                 {"dense": {"w": np.zeros((2, 2), np.float32)}})
        out.append(("foreign", "applied"))
    except error_cls as e:
        out.append(("foreign", "400" in str(e)))
    r = a.commit(ja["wid"], p["version"], _delta(4))
    out.append(("commit", r["version"], r["staleness"], r["scale"],
                r["rejoined"], r["duplicate"]))
    final = a.pull()
    return out, final["version"], final["center"]


_SIDES = {"jax": (JClient, JServer, JStale, JPSError),
          "port": (PSClient, PSServer, StaleCommit, PSError)}


def _run(client_side, server_side):
    client_cls, _, stale_cls, error_cls = _SIDES[client_side]
    server_cls = _SIDES[server_side][1]
    srv = server_cls(params=_params(0), port=0, window=5, staleness_cap=1,
                     lease_s=60.0)
    srv.start()
    try:
        return _script(srv, client_cls, stale_cls, error_cls)
    finally:
        srv.close()


@pytest.mark.parametrize("client_side,server_side",
                         [("jax", "port"), ("port", "jax"),
                          ("port", "port")])
def test_wire_is_the_jax_wire(client_side, server_side):
    want, want_clock, want_center = _run("jax", "jax")
    got, clock, center = _run(client_side, server_side)
    assert got == want
    assert [v[0] for v in got] == ["join", "commit", "commit", "pull",
                                   "stale", "foreign", "commit"]
    assert got[2][2] == 1 and got[4][1:3] == (2, 1) and got[5] == (
        "foreign", True)
    assert clock == want_clock == 3
    for k in ("w", "b"):
        assert type(center["dense"][k]) is np.ndarray
        np.testing.assert_array_equal(center["dense"][k],
                                      want_center["dense"][k])
    np.testing.assert_array_equal(center["seed_state"],
                                  want_center["seed_state"])


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_center_checkpoint_resumes_across_packages(tmp_path, writer,
                                                   reader):
    """A center one package's server checkpointed and drained resumes in
    the other's with its clock and center bit-equal."""
    ck = str(tmp_path / "ck")
    srv = _SIDES[writer][1](params=_params(0), port=0, ckpt_dir=ck,
                            ckpt_every_commits=2)
    srv.start()
    try:
        c = _client(srv, _SIDES[writer][0])
        j = c.join()
        version = j["version"]
        for i in range(5):
            version = c.commit(j["wid"], version, _delta(i))["version"]
        assert srv.drain(timeout_s=DRAIN_S) == 5
        drained_clock, drained = srv.center.state()
    finally:
        srv.close()
    srv2 = _SIDES[reader][1](port=0, ckpt_dir=ck)
    try:
        assert srv2.restored_step == 5
        clock, center = srv2.center.state()
        assert clock == drained_clock == 5
        for k in ("w", "b"):
            np.testing.assert_array_equal(center["dense"][k],
                                          drained["dense"][k])
        np.testing.assert_array_equal(center["seed_state"],
                                      drained["seed_state"])
        assert center["seed_state"].dtype == np.uint32
        # and the resumed server keeps serving the wire
        srv2.start()
        c = _client(srv2, _SIDES[writer][0])
        assert c.commit(c.join()["wid"], 5, _delta(9))["version"] == 6
    finally:
        srv2.close()


def test_restore_without_template_hands_back_numpy(tmp_path):
    """``Checkpointer.restore(step)`` with no template, on a step the JAX
    ``PSServer`` wrote, hands back the numpy center and the ``np.int64``
    clock."""
    from dist_keras_tpu_torch.checkpoint import Checkpointer

    ck = str(tmp_path / "ck")
    srv = JServer(params=_params(0), port=0, ckpt_dir=ck)
    try:
        srv.center.commit("w", 0, _delta(1))
        assert srv.checkpoint_now(timeout_s=DRAIN_S) == 1
        _, want = srv.center.state()
    finally:
        srv.close()
    step, state = Checkpointer(ck, rank=0, world=1).restore(step=1)
    assert step == 1
    assert isinstance(state["clock"], np.int64) or (
        isinstance(state["clock"], np.ndarray)
        and state["clock"].dtype == np.int64)
    assert int(state["clock"]) == 1
    assert type(state["center"]["dense"]["w"]) is np.ndarray
    np.testing.assert_array_equal(state["center"]["dense"]["w"],
                                  want["dense"]["w"])
