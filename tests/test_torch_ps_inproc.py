"""The port's in-process PS pair (``dist_keras_tpu_torch/ps/inproc.py``)
against the JAX package's on one seeded script: joins, a fresh and a
stale-scaled commit, an over-cap refusal, a partition that heals, an
idempotent replay, a lapse by the reaper, and a drain and resume.  Both
give the same verdicts, the same center bit for bit and the same event
stream (timestamps aside)."""

import json

import numpy as np
import pytest

from dist_keras_tpu.observability import events as jevents
from dist_keras_tpu.ps import InProcPSClient as JClient
from dist_keras_tpu.ps import InProcPSServer as JServer
from dist_keras_tpu.ps import PSUnavailable as JUnavailable
from dist_keras_tpu.ps import StaleCommit as JStale
from dist_keras_tpu_torch.observability import events
from dist_keras_tpu_torch.ps import (
    InProcPSClient,
    InProcPSServer,
    PSUnavailable,
    StaleCommit,
)

_SIDES = {"jax": (JServer, JClient, JStale, JUnavailable, jevents),
          "port": (InProcPSServer, InProcPSClient, StaleCommit,
                   PSUnavailable, events)}
_STAMPS = ("t", "seq", "pid", "host", "wall", "mono")


def _params():
    rng = np.random.default_rng(0)
    return [{"kernel": rng.normal(size=(5, 3)).astype(np.float32),
             "bias": np.zeros(3, np.float32)},
            {"kernel": rng.normal(size=(3, 2)).astype(np.float32),
             "bias": np.zeros(2, np.float32)}]


def _delta(seed):
    rng = np.random.default_rng(seed)
    return [{k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in p.items()} for p in _params()]


def _script(side):
    server_cls, client_cls, stale_cls, unavailable, _ = _SIDES[side]
    srv = server_cls(_params(), window=3, lease_s=10.0, staleness_cap=1)
    part = [False]
    kw = dict(attempts=2, backoff=0.0, sleep=lambda s: None)
    a = client_cls(srv, seed=1, **kw)
    b = client_cls(srv, seed=2, partitioned=lambda: part[0], **kw)
    out = []
    ja = a.join(rank=1)
    out.append(("join", ja["wid"], ja["version"], ja["window"],
                ja["rejoined"], ja["lease_s"]))
    r = a.commit(ja["wid"], 0, _delta(1), rank=1)
    out.append(("commit", r["version"], r["staleness"], r["scale"],
                r["rejoined"], r["duplicate"]))
    jb = b.join(rank=2)
    out.append(("join", jb["wid"], jb["version"]))
    r = b.commit(jb["wid"], 0, _delta(2))
    out.append(("commit", r["version"], r["staleness"], r["scale"]))
    try:
        a.commit(ja["wid"], 0, _delta(3))
    except stale_cls as e:
        out.append(("stale", e.staleness, e.cap, e.wid))
    part[0] = True
    try:
        b.pull(jb["wid"])
    except unavailable as e:
        out.append(("partition", type(e).__name__))
    part[0] = False
    out.append(("healed", b.pull(jb["wid"])["version"]))
    first = srv.commit(ja["wid"], 2, _delta(4), commit_id="x:0")
    again = srv.commit(ja["wid"], 2, _delta(4), commit_id="x:0")
    out.append(("replay", first["duplicate"], again["duplicate"],
                again["version"], again["staleness"]))
    out.append(("reap", srv.reap(now=1e12)))
    srv.drain()
    try:
        a.pull(ja["wid"])
    except unavailable as e:
        out.append(("drained", type(e).__name__))
    srv.resume()
    final = a.pull()
    out.append(("resumed", final["version"]))
    return out, final["center"]


def _run(side, obs_dir, monkeypatch):
    mod = _SIDES[side][4]
    monkeypatch.setenv("DK_OBS_DIR", str(obs_dir))
    mod.reset()
    try:
        out, center = _script(side)
    finally:
        mod.reset()
        monkeypatch.delenv("DK_OBS_DIR")
    evs = []
    for line in (obs_dir / "events-rank_0.jsonl").read_text().splitlines():
        rec = json.loads(line)
        evs.append({k: v for k, v in rec.items() if k not in _STAMPS})
    return out, center, evs


def test_inproc_pair_matches_the_jax_pair(tmp_path, monkeypatch):
    want, want_center, want_evs = _run("jax", tmp_path / "j", monkeypatch)
    got, center, evs = _run("port", tmp_path / "p", monkeypatch)
    assert got == want
    assert [v[0] for v in got] == [
        "join", "commit", "join", "commit", "stale", "partition",
        "healed", "replay", "reap", "drained", "resumed"]
    assert got[3][2:] == (1, 0.5) and got[4][1:3] == (2, 1)
    assert got[7][1:3] == (False, True)
    assert sorted(w for w, _ in got[8][1]) == ["w0", "w1"]
    for c, w in zip(center, want_center):
        assert list(c) == list(w)
        for k in w:
            assert type(c[k]) is np.ndarray
            np.testing.assert_array_equal(c[k], w[k])
    assert evs == want_evs
    kinds = [e["kind"] for e in evs]
    for kind in ("ps_worker_join", "ps_commit", "ps_stale_scaled",
                 "ps_pull", "ps_worker_lapse"):
        assert kind in kinds, kind


def test_inproc_zero_window_refused():
    with pytest.raises(ValueError, match="window"):
        InProcPSServer(_params(), window=0)
