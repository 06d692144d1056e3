"""The port's serving router (``dist_keras_tpu_torch/serving/router.py``)
on the CPU, against the JAX package's: the same seeded script of probe,
forward, sweep and pick outcomes through both ``BackendPool``s gives the
same picks, live sets and ``route_evict`` / ``route_readmit`` events; the
cases of ``tests/test_router.py`` (pool policy, the typed 503s, the
sibling retry, blind backends, drain, blue/green, ``resize``) over port
engines on ``device="cpu"``; a port ``RouterServer`` over two port
``ServingServer``s answering ``/predict`` and ``/generate`` (batched and
streamed, equal to the JAX engines on bridged weights) with one stitched
trace per request; and the wire in both directions — a port router in
front of JAX backends and a JAX router in front of port backends, the
deadline and priority headers and the ``traceparent`` forwarded."""

import json
import os
import re
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from dist_keras_tpu.models import mnist_mlp as jax_mnist_mlp
from dist_keras_tpu.models.transformer import Transformer as JaxTransformer
from dist_keras_tpu.models.transformer import transformer_config
from dist_keras_tpu.observability import events as jax_events
from dist_keras_tpu.observability import report as jax_report
from dist_keras_tpu.observability import spans as jax_spans
from dist_keras_tpu.resilience import world as jax_world
from dist_keras_tpu.serving import DecodeEngine as JaxDecodeEngine
from dist_keras_tpu.serving import RouterServer as JaxRouterServer
from dist_keras_tpu.serving import ServingEngine as JaxServingEngine
from dist_keras_tpu.serving import ServingServer as JaxServingServer
from dist_keras_tpu.serving import router as jax_router
from dist_keras_tpu_torch.models import mnist_mlp
from dist_keras_tpu_torch.models.transformer import Transformer
from dist_keras_tpu_torch.observability import events, flight, spans
from dist_keras_tpu_torch.observability import trace_export
from dist_keras_tpu_torch.resilience import faults, world
from dist_keras_tpu_torch.serving import (
    BackendPool,
    BlueGreenEngine,
    DecodeEngine,
    Overloaded,
    RouterServer,
    ServingEngine,
    ServingServer,
    default_route_port,
)
from dist_keras_tpu_torch.serving import router
from dist_keras_tpu_torch.utils.pytree import tree_map

VOCAB = 16
CFG = dict(input_dim=VOCAB, seq_len=32, d_model=16, n_heads=2, n_layers=2,
           n_classes=VOCAB)
LADDERS = dict(prefill_ladder=(4, 8), decode_ladder=(1, 4), page_size=4)
TOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _model():
    return mnist_mlp(hidden=(8,), input_dim=4, num_classes=3)


def _rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 4)) \
        .astype(np.float32)


def _engine(**kw):
    kw.setdefault("replicas", 1)
    kw.setdefault("batch_ladder", (1, 8))
    kw.setdefault("max_latency_s", 0.001)
    kw.setdefault("max_queue", 1024)
    eng = ServingEngine(_model(), device="cpu", **kw)
    for r in (1, 8):
        eng.predict(_rows(r), timeout_s=120)
    return eng


def _free_port():
    """A port that is (momentarily) free — nothing listens on it."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _call(addr, path, body=None, headers=None, timeout=60):
    """-> (status, headers, text) of one request, HTTP errors included."""
    host, port = (addr.rsplit(":", 1) if isinstance(addr, str) else addr)
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://{host}:{port}{path}", data=data,
        headers={"Content-Type": "application/json", **(headers or {})},
        method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def _stream_tokens(text):
    recs = [json.loads(x) for x in text.splitlines() if x.strip()]
    return [r["token"] for r in recs if "token" in r], recs[-1]


# -- BackendPool against the JAX package's, op for op -------------------
class _Clock:
    """A hand-advanced clock for a package's ``world`` seam."""

    def __init__(self, base):
        self.t = 1000.0
        self.base = base

    def make(self):
        clock = self

        class W(self.base):
            def time(self):
                return clock.t

            def monotonic(self):
                return clock.t

            def sleep(self, seconds):
                clock.t += seconds

        return W()


def _script(seed, n=400):
    rng = np.random.default_rng(seed)
    addrs = ["a:1", "b:1", "c:1"]
    ops = []
    for _ in range(n):
        kind = rng.choice(["probe", "probe", "forward", "sweep", "pick",
                           "tick"])
        a = addrs[rng.integers(len(addrs))]
        if kind == "probe":
            ok = bool(rng.random() < 0.6)
            depth = (None if rng.random() < 0.2
                     else int(rng.integers(0, 9)))
            ops.append(("probe", a, ok, depth))
        elif kind == "forward":
            ops.append(("forward", a, bool(rng.random() < 0.5)))
        elif kind == "pick":
            k = int(rng.integers(0, 3))
            ops.append(("pick", tuple(sorted(rng.choice(
                addrs, size=k, replace=False).tolist()))))
        elif kind == "tick":
            ops.append(("tick", float(rng.choice([0.1, 0.5, 2.0]))))
        else:
            ops.append(("sweep",))
    return addrs, ops


def _run_pool(pool_cls, world_mod, events_mod, addrs, ops, monkeypatch):
    clock = _Clock(world_mod.World)
    seen = []
    monkeypatch.setattr(events_mod, "emit",
                        lambda kind, **f: seen.append((kind, f)))
    trace = []
    with world_mod.use(clock.make()):
        pool = pool_cls(addrs, fail_threshold=3, stale_s=3.0,
                        readmit_checks=2)
        for op in ops:
            if op[0] == "probe":
                pool.note_probe(op[1], op[2], depth=op[3])
            elif op[0] == "forward":
                pool.note_forward(op[1], op[2])
            elif op[0] == "sweep":
                pool.sweep()
            elif op[0] == "tick":
                clock.t += op[1]
            else:
                trace.append(("pick", pool.pick(exclude=op[1])))
            trace.append(("live", pool.live_count(),
                          tuple(b["live"] for b in pool.snapshot())))
        return (trace, seen, pool.snapshot(), pool.evictions,
                pool.readmissions)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pool_matches_jax_pool_on_a_seeded_script(seed, monkeypatch):
    addrs, ops = _script(seed)
    got = _run_pool(BackendPool, world, events, addrs, ops, monkeypatch)
    want = _run_pool(jax_router.BackendPool, jax_world, jax_events, addrs,
                     ops, monkeypatch)
    assert got == want
    kinds = {k for k, _ in got[1]}
    assert kinds == {"route_evict", "route_readmit"}
    reasons = {f["reason"] for _, f in got[1]}
    assert {"consecutive_failures", "healed"} <= reasons


# -- BackendPool policy (tests/test_router.py) -------------------------
def test_pool_needs_backends():
    with pytest.raises(ValueError):
        BackendPool([])


def test_pool_pick_least_loaded_when_all_depths_known():
    pool = BackendPool(["a:1", "b:1", "c:1"])
    pool.note_probe("a:1", True, depth=5)
    pool.note_probe("b:1", True, depth=1)
    pool.note_probe("c:1", True, depth=9)
    assert all(pool.pick() == "b:1" for _ in range(4))


def test_pool_blind_candidate_degrades_pick_to_round_robin():
    pool = BackendPool(["a:1", "b:1"])
    pool.note_probe("a:1", True, depth=0)
    pool.note_probe("b:1", True, depth=None)
    picked = {pool.pick() for _ in range(6)}
    assert picked == {"a:1", "b:1"}


def test_pool_evicts_on_consecutive_failures_and_readmits():
    pool = BackendPool(["a:1", "b:1"], fail_threshold=3,
                       stale_s=60.0, readmit_checks=2)
    for _ in range(2):
        pool.note_probe("a:1", False)
    assert pool.live_count() == 2
    pool.note_probe("a:1", False)
    assert pool.live_count() == 1
    snap = {b["addr"]: b for b in pool.snapshot()}
    assert snap["a:1"]["evicted_reason"] == "consecutive_failures"
    assert pool.pick() == "b:1"
    pool.note_probe("a:1", True, depth=0)
    pool.sweep()
    assert pool.live_count() == 1
    pool.note_probe("a:1", True, depth=0)
    pool.sweep()
    assert pool.live_count() == 2
    assert pool.evictions == 1 and pool.readmissions == 1


def test_pool_failure_resets_heal_streak():
    pool = BackendPool(["a:1", "b:1"], fail_threshold=1,
                       stale_s=60.0, readmit_checks=2)
    pool.note_probe("a:1", False)
    pool.note_probe("a:1", True, depth=0)
    pool.note_probe("a:1", False)
    pool.note_probe("a:1", True, depth=0)
    pool.sweep()
    assert pool.live_count() == 1


def test_pool_stale_health_eviction():
    clock = _Clock(world.World)
    with world.use(clock.make()):
        pool = BackendPool(["a:1"], fail_threshold=99, stale_s=0.05)
        clock.t += 0.12
        pool.sweep()
    snap = pool.snapshot()[0]
    assert not snap["live"]
    assert snap["evicted_reason"] == "stale_health"


def test_pool_heartbeat_evidence_evicts_and_blocks_readmit(tmp_path):
    coord = str(tmp_path)
    hb = os.path.join(coord, "hb")
    os.makedirs(hb)
    now = time.time()
    for r, age in ((0, 0.0), (1, 60.0)):
        p = os.path.join(hb, f"rank_{r}")
        with open(p, "w"):
            pass
        os.utime(p, (now - age, now - age))
    pool = BackendPool(["a:1", "b:1"], fail_threshold=99, stale_s=5.0,
                       readmit_checks=1, coord_dir=coord, world_size=2)
    pool.note_probe("a:1", True, depth=0)
    pool.note_probe("b:1", True, depth=0)
    pool.sweep()
    snap = {b["addr"]: b for b in pool.snapshot()}
    assert snap["a:1"]["live"]
    assert not snap["b:1"]["live"]
    assert snap["b:1"]["evicted_reason"] == "heartbeat_dead"
    pool.note_probe("b:1", True, depth=0)
    pool.sweep()
    assert not {b["addr"]: b for b in pool.snapshot()}["b:1"]["live"]
    os.utime(os.path.join(hb, "rank_1"), (now, now))
    pool.note_probe("b:1", True, depth=0)
    pool.sweep()
    assert {b["addr"]: b for b in pool.snapshot()}["b:1"]["live"]


def test_pool_pick_exclude_and_exhaustion():
    pool = BackendPool(["a:1", "b:1"])
    assert pool.pick(exclude=("a:1",)) == "b:1"
    assert pool.pick(exclude=("a:1", "b:1")) is None


def test_default_route_port_reads_knob(monkeypatch):
    monkeypatch.delenv("DK_ROUTE_PORT", raising=False)
    assert default_route_port(fallback=1234) == 1234
    monkeypatch.setenv("DK_ROUTE_PORT", "8123")
    assert default_route_port() == 8123
    monkeypatch.setenv("DK_ROUTE_PORT", "nonsense")
    assert default_route_port(fallback=7) == 7


# -- router HTTP edge cases (tests/test_router.py) ----------------------
def test_router_all_backends_dead_is_typed_503_never_a_hang():
    backends = [f"127.0.0.1:{_free_port()}", f"127.0.0.1:{_free_port()}"]
    srv = RouterServer(backends, port=0, probe_s=30.0,
                       forward_timeout_s=2.0, fail_threshold=2,
                       stale_s=60.0, readmit_checks=2)
    addr = srv.start()
    try:
        t0 = time.monotonic()
        seen = []
        for _ in range(3):
            code, headers, text = _call(addr, "/predict",
                                        {"rows": _rows(1).tolist()})
            assert code == 503 and headers.get("Retry-After") is not None
            seen.append(json.loads(text)["error"])
        assert time.monotonic() - t0 < 20.0
        assert set(seen) <= {"backends_unavailable", "no_backends"}
        assert seen[-1] == "no_backends"
        assert srv.pool.live_count() == 0
    finally:
        srv.close()


class _AbruptCloser:
    """A listener that accepts a connection and slams it shut — a
    backend SIGKILLed mid-request, as the router sees it."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.addr = "127.0.0.1:%d" % self.sock.getsockname()[1]
        self.hits = 0
        self._stop = False
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self.hits += 1
            conn.close()

    def close(self):
        self._stop = True
        try:
            self.sock.close()
        except OSError:
            pass


def test_router_midrequest_death_retried_on_sibling_exactly_once():
    dead = _AbruptCloser()
    eng = _engine()
    alive = ServingServer(eng, port=0)
    alive.start()
    alive_addr = "%s:%d" % alive.address
    srv = RouterServer([dead.addr, alive_addr], port=0, probe_s=30.0,
                       forward_timeout_s=10.0, fail_threshold=5,
                       stale_s=60.0, readmit_checks=2)
    picks = []
    real_pick = srv.pool.pick

    def pick_dead_first(exclude=()):
        picks.append(set(exclude))
        if not exclude:
            return dead.addr
        return real_pick(exclude=exclude)

    srv.pool.pick = pick_dead_first
    try:
        body = json.dumps({"rows": _rows(1).tolist()}).encode()
        code, payload, _, _ = srv.forward(body)
        assert code == 200
        assert len(json.loads(payload.decode())["predictions"]) == 1
        assert picks == [set(), {dead.addr}]
        assert dead.hits == 1
        assert eng.stats()["completed"] >= 1
    finally:
        srv.close()
        alive.close()
        dead.close()


def test_router_forward_exhaustion_is_typed_503():
    d1, d2 = _AbruptCloser(), _AbruptCloser()
    srv = RouterServer([d1.addr, d2.addr], port=0, probe_s=30.0,
                       forward_timeout_s=5.0, fail_threshold=9,
                       stale_s=60.0, readmit_checks=2)
    try:
        code, payload, _, retry_after = srv.forward(b"{}")
        assert code == 503 and retry_after is not None
        assert json.loads(payload.decode())["error"] \
            == "backends_unavailable"
        assert d1.hits + d2.hits == 2
    finally:
        srv.close()
        d1.close()
        d2.close()


class _WeirdMetricsBackend:
    """Healthy /healthz, garbage /metricsz."""

    def __init__(self, metrics_body=b"%% not json %%"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        outer = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                body = (b'{"status": "serving"}'
                        if self.path.startswith("/healthz")
                        else outer.metrics_body)
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.metrics_body = metrics_body
        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.srv.daemon_threads = True
        self.addr = "127.0.0.1:%d" % self.srv.server_address[1]
        threading.Thread(target=self.srv.serve_forever,
                         daemon=True).start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def test_router_malformed_metricsz_degrades_to_round_robin():
    weird = _WeirdMetricsBackend()
    eng = _engine()
    alive = ServingServer(eng, port=0)
    alive.start()
    alive_addr = "%s:%d" % alive.address
    srv = RouterServer([weird.addr, alive_addr], port=0, probe_s=30.0,
                       fail_threshold=3, stale_s=60.0)
    try:
        assert srv._probe_backend(weird.addr) == (True, None)
        healthy, depth = srv._probe_backend(alive_addr)
        assert healthy is True and isinstance(depth, int)
        srv.probe_once()
        snap = {b["addr"]: b for b in srv.pool.snapshot()}
        assert snap[weird.addr]["live"]
        assert snap[weird.addr]["depth"] is None
        assert {srv.pool.pick() for _ in range(6)} == {weird.addr,
                                                       alive_addr}
    finally:
        srv.close()
        alive.close()
        weird.close()


def test_router_non_numeric_depth_is_blind_not_evicted():
    weird = _WeirdMetricsBackend(metrics_body=json.dumps(
        {"engine": {"outstanding": True}}).encode())
    srv = RouterServer([weird.addr], port=0, probe_s=30.0)
    try:
        assert srv._probe_backend(weird.addr) == (True, None)
    finally:
        srv.close()
        weird.close()


def test_router_draining_rejects_typed_and_healthz_flips():
    eng = _engine()
    backend = ServingServer(eng, port=0)
    backend.start()
    srv = RouterServer(["%s:%d" % backend.address], port=0, probe_s=30.0)
    addr = srv.start()
    try:
        code, _, text = _call(addr, "/healthz")
        assert code == 200 and json.loads(text)["status"] == "routing"
        srv.drain()
        try:
            code, headers, _ = _call(addr, "/predict",
                                     {"rows": _rows(1).tolist()},
                                     timeout=10)
        except OSError:
            pass   # the listener closed: connection refused
        else:
            assert code == 503 and headers.get("Retry-After") is not None
    finally:
        srv.close()
        backend.close()


@pytest.mark.parametrize("path", ["/statusz", "/tracez", "/metricsz",
                                  "/metricsz?format=prometheus"])
def test_router_introspection_routes_answer_200(path):
    eng = _engine()
    backend = ServingServer(eng, port=0)
    backend.start()
    srv = RouterServer(["%s:%d" % backend.address], port=0, probe_s=30.0)
    addr = srv.start()
    try:
        code, _, text = _call(addr, path)
        assert code == 200
        if path == "/statusz":
            assert "router" in json.loads(text)
        elif path == "/metricsz":
            assert json.loads(text)["router"][0]["live"]
        elif "prometheus" in path:
            assert "dk_route_pool_live{rank=\"0\"} 1" in text.splitlines()
        else:
            assert "n" in json.loads(text)
    finally:
        srv.close()
        backend.close()


# -- blue/green cutover and resize (tests/test_router.py) ---------------
def _apply(model, rows):
    import torch

    with torch.no_grad():
        return model.apply(model.params, torch.from_numpy(rows)).numpy()


def test_bluegreen_cutover_inflight_drains_on_old_params():
    models = []

    def make_engine():
        m = _model()
        models.append(m)
        return ServingEngine(m, replicas=1, batch_ladder=(1, 8),
                             max_latency_s=0.001, max_queue=4096,
                             device="cpu")

    bg = BlueGreenEngine(make_engine)
    try:
        for r in (1, 8):
            bg.predict(_rows(r), timeout_s=120)
        rows = _rows(16, seed=3)
        old_want = _apply(models[0], rows)
        futs = [bg.submit(r) for r in rows]
        state = {"params": tree_map(lambda a: a.detach() * 0.5,
                                    models[0].params)}
        bg.set_params(state, step=1)
        got = np.stack([f.result(timeout=60) for f in futs])
        assert np.allclose(got, old_want, atol=TOL)
        new_pred = bg.predict(rows[:4], timeout_s=60)
        assert not np.allclose(new_pred, old_want[:4])
        assert bg.cutovers == 1
        assert bg.stats()["active_engine"] == 1
    finally:
        bg.close()


def test_bluegreen_second_cutover_flips_back_and_resize_fans():
    models = []

    def make_engine():
        m = _model()
        models.append(m)
        return ServingEngine(m, replicas=1, batch_ladder=(1, 8),
                             max_latency_s=0.001, max_queue=256,
                             device="cpu")

    bg = BlueGreenEngine(make_engine)
    try:
        bg.predict(_rows(1), timeout_s=120)
        state = {"params": models[0].params}
        bg.set_params(state, step=1)
        bg.set_params(state, step=2)
        assert bg.cutovers == 2
        assert bg.stats()["active_engine"] == 0
        bg.resize(2)
        assert bg.active.stats()["replicas"] == 2
        assert bg.standby.stats()["replicas"] == 2
        st = bg.stats()
        assert st["replicas"] == 2 and "standby_outstanding" in st
    finally:
        bg.close()


def test_engine_resize_grow_and_shrink_keeps_serving():
    eng = _engine(replicas=1)
    try:
        eng.resize(3)
        assert eng.stats()["replicas"] == 3
        assert eng.predict(_rows(20), timeout_s=120).shape == (20, 3)
        eng.resize(1)
        assert eng.stats()["replicas"] == 1
        assert eng.predict(_rows(9, seed=2), timeout_s=120).shape == (9, 3)
        with pytest.raises(ValueError):
            eng.resize(0)
    finally:
        eng.close()


def test_engine_resize_under_load_loses_nothing():
    eng = _engine(replicas=2, max_queue=4096)
    try:
        rows = _rows(64, seed=5)
        futs = [eng.submit(rows[i % 64]) for i in range(200)]
        eng.resize(4)
        futs += [eng.submit(rows[i % 64]) for i in range(200)]
        eng.resize(1)
        futs += [eng.submit(rows[i % 64]) for i in range(100)]
        assert len([f.result(timeout=120) for f in futs]) == 500
        st = eng.stats()
        assert st["completed"] >= 500 and st["replicas"] == 1
    finally:
        eng.close()


def test_engine_resize_rejected_after_drain():
    eng = _engine(replicas=1)
    eng.drain(timeout_s=60)
    with pytest.raises(Overloaded):
        eng.resize(2)
    eng.close()


# -- the fabric: routers over backends of both packages -----------------
@pytest.fixture(scope="module")
def models():
    """Bridged pairs: the MLP behind /predict, the transformer behind
    /generate; each package's answer for a few requests."""
    jmlp = jax_mnist_mlp(hidden=(8,), input_dim=4, num_classes=3)
    tmlp = mnist_mlp(hidden=(8,), input_dim=4, num_classes=3)
    tmlp.set_weights(jmlp.get_weights())
    jtf = JaxTransformer(transformer_config(**CFG), seed=0)
    ttf = Transformer(transformer_config(**CFG),
                      params=jax.tree.map(np.asarray, jtf.params),
                      device="cpu")
    return jmlp, tmlp, jtf, ttf


def _backends(pkg, models, shed=False):
    """Two backends of package ``pkg`` ("jax" or "torch"): /predict and
    /generate on one engine pair per server (a decode server with a zero
    KV watermark sheds every batch-priority admission)."""
    jmlp, tmlp, jtf, ttf = models
    kw = dict(shed_watermark=0.0) if shed else {}
    if pkg == "jax":
        pe = JaxServingEngine(jmlp, replicas=1, batch_ladder=(1, 4))
        de = JaxDecodeEngine(jtf, replicas=1, num_pages=64, **LADDERS,
                             **kw)
        cls = JaxServingServer
    else:
        pe = ServingEngine(tmlp, replicas=1, batch_ladder=(1, 4),
                           device="cpu")
        de = DecodeEngine(ttf, replicas=1, num_pages=64, device="cpu",
                          **LADDERS, **kw)
        cls = ServingServer
    servers = [cls(pe, port=0), cls(de, port=0)]
    for s in servers:
        s.start()
    return servers


def _router(pkg, addrs):
    cls = JaxRouterServer if pkg == "jax" else RouterServer
    srv = cls(addrs, port=0, probe_s=30.0, fail_threshold=99,
              stale_s=600.0)
    return srv, srv.start()


@pytest.fixture()
def traced(tmp_path, monkeypatch):
    """Both packages' event logs in one directory: the router's package
    writes as rank 7, the backends' as rank 0 (one package in one
    process has one rank: 7 for both)."""
    monkeypatch.setenv("DK_OBS_DIR", str(tmp_path))

    def arm(backend_mod, router_mod):
        for mod, rank in ((backend_mod, "0"), (router_mod, "7")):
            monkeypatch.setenv("DK_COORD_RANK", rank)
            mod.reset()
            assert mod.enabled()
        monkeypatch.delenv("DK_COORD_RANK")

    yield tmp_path, arm
    monkeypatch.delenv("DK_OBS_DIR")
    for mod in (events, jax_events):
        mod.reset()
    flight.reset()
    spans.reset()
    jax_spans.reset()


def _want_generate(ttf, prompt, n):
    eng = DecodeEngine(ttf, replicas=1, device="cpu", **LADDERS)
    try:
        return eng.generate(prompt, max_new_tokens=n,
                            timeout_s=120)["generated"]
    finally:
        eng.close()


@pytest.mark.parametrize("router_pkg,backend_pkg", [
    ("torch", "torch"), ("torch", "jax"), ("jax", "torch")])
def test_fabric_wire_predict_generate_headers_and_trace(
        models, traced, router_pkg, backend_pkg):
    jmlp, tmlp, jtf, ttf = models
    obs, arm = traced
    router_ev = events if router_pkg == "torch" else jax_events
    backend_ev = events if backend_pkg == "torch" else jax_events
    arm(backend_ev, router_ev)
    backend_rank = 7 if backend_ev is router_ev else 0
    servers = _backends(backend_pkg, models, shed=True)
    pred_addr, gen_addr = ["%s:%d" % s.address for s in servers]
    prompt = [1, 2, 3]
    want_tokens = _want_generate(ttf, prompt, 5)
    traces = {}
    try:
        for path, addr in (("/predict", pred_addr),
                           ("/generate", gen_addr)):
            srv, raddr = _router(router_pkg, [addr])
            try:
                trace = (("a" if path == "/predict" else "b") * 32)
                tp = {"traceparent": f"00-{trace}-{'c' * 16}-01"}
                if path == "/predict":
                    rows = _rows(3)
                    code, headers, text = _call(
                        raddr, path, {"rows": rows.tolist()}, headers=tp)
                    assert code == 200
                    assert np.allclose(json.loads(text)["predictions"],
                                       _apply(tmlp, rows), atol=TOL)
                else:
                    code, headers, text = _call(
                        raddr, path, {"tokens": prompt,
                                      "max_new_tokens": 5}, headers=tp)
                    assert code == 200
                    assert json.loads(text)["generated"] == want_tokens
                    code, _, text = _call(
                        raddr, path, {"tokens": prompt, "max_new_tokens": 5,
                                      "stream": True})
                    toks, last = _stream_tokens(text)
                    assert code == 200 and toks == want_tokens
                    assert last["done"] and last["finish"] == "length"
                    # the hop headers reach the backend's admission
                    eng = servers[1].engine
                    for hdr, key in (({"x-dk-deadline-s": "1e-9"},
                                      "deadline_infeasible"),
                                     ({"x-dk-priority": "batch"}, "shed")):
                        before = eng.stats()[key]
                        code, _, _ = _call(raddr, path,
                                           {"tokens": prompt,
                                            "max_new_tokens": 2},
                                           headers=hdr)
                        assert code in (503, 504)
                        assert eng.stats()[key] > before, key
                assert headers["traceparent"].split("-")[1] == trace
                traces[path] = trace
            finally:
                srv.close()
    finally:
        for s in servers:
            s.close()
    router_ev.reset()
    backend_ev.reset()
    recs = jax_report.read_events(str(obs))
    for path, trace in traces.items():
        fwd = [r for r in recs if r.get("kind") == "span_end"
               and r.get("span") == "route.forward"
               and r.get("trace_id") == trace]
        assert len(fwd) == 1 and fwd[0]["rank"] == 7
        assert fwd[0]["parent_id"] == "c" * 16
        name = "serve.request" if path == "/predict" else "serve.generate"
        srv_spans = [r for r in recs if r.get("kind") == "span_end"
                     and r.get("span") == name
                     and r.get("trace_id") == trace]
        assert len(srv_spans) == 1
        assert srv_spans[0]["rank"] == backend_rank
        assert srv_spans[0]["parent_id"] == fwd[0]["span_id"]
    ct = trace_export.connected_traces(recs)
    assert ct[traces["/predict"]]["cross_thread"] >= 1


def test_router_over_two_port_backends_spreads_and_survives_a_death(
        models):
    """Two /predict backends behind one port router: requests land on
    both; one backend's listener stops and every later answer is 200 or
    a typed 503 with Retry-After; the pool evicts it on data-path
    evidence and re-admits a server restarted on the same port."""
    _, tmlp, _, _ = models
    engines = [ServingEngine(tmlp, replicas=1, batch_ladder=(1, 4),
                             device="cpu") for _ in range(2)]
    servers = [ServingServer(e, port=0) for e in engines]
    for s in servers:
        s.start()
    addrs = ["%s:%d" % s.address for s in servers]
    srv = RouterServer(addrs, port=0, probe_s=0.05, fail_threshold=2,
                       stale_s=1.0, readmit_checks=2)
    raddr = srv.start()
    restarted = None
    try:
        rows = _rows(4)
        for _ in range(12):
            code, _, _ = _call(raddr, "/predict", {"rows": rows.tolist()})
            assert code == 200
        assert all(e.stats()["completed"] >= 1 for e in engines)
        servers[0]._stop_listener()
        for _ in range(12):
            code, headers, _ = _call(raddr, "/predict",
                                     {"rows": rows.tolist()})
            assert code == 200 or (code == 503 and headers.get(
                "Retry-After") is not None)
        deadline = time.monotonic() + 30
        while srv.pool.live_count() != 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert srv.pool.live_count() == 1
        port = int(addrs[0].rsplit(":", 1)[1])
        restarted = ServingServer(engines[0], port=port)
        restarted.start()
        while srv.pool.live_count() != 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert srv.pool.live_count() == 2
        assert srv.pool.evictions >= 1 and srv.pool.readmissions >= 1
    finally:
        srv.close()
        for s in servers[1:] + ([restarted] if restarted else []):
            s.close()
        for e in engines:
            if e.running:
                e.close()


# -- /generate through the router: hedging and stream loss --------------
class _StallBackend:
    """Accepts and reads the request, then never answers — a wedged
    host, as the router sees it."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.addr = "127.0.0.1:%d" % self.sock.getsockname()[1]
        self.hits = 0
        self._conns = []
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self.hits += 1
            self._conns.append(conn)

    def close(self):
        for c in self._conns:
            c.close()
        self.sock.close()


class _DyingStreamBackend:
    """Answers /generate with two NDJSON token lines, then dies without
    the terminating chunk — a backend crash mid-stream."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.addr = "127.0.0.1:%d" % self.sock.getsockname()[1]
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            try:
                self._serve(conn)
            except OSError:
                pass

    def _serve(self, conn):
        data = b""
        while b"\r\n\r\n" not in data:
            got = conn.recv(65536)
            if not got:
                return
            data += got
        head, _, rest = data.partition(b"\r\n\r\n")
        if head.startswith(b"GET"):    # health probe: stay in rotation
            body = b'{"ok": true}'
            conn.sendall(b"HTTP/1.1 200 OK\r\n"
                         b"Content-Type: application/json\r\n"
                         + b"Content-Length: %d\r\n\r\n" % len(body)
                         + body)
            conn.close()
            return
        need = int(re.search(rb"content-length:\s*(\d+)", head,
                             re.I).group(1))
        while len(rest) < need:
            rest += conn.recv(65536)
        out = (b"HTTP/1.1 200 OK\r\n"
               b"Content-Type: application/x-ndjson\r\n"
               b"Transfer-Encoding: chunked\r\n\r\n")
        for ln in (b'{"i": 0, "token": 1}\n', b'{"i": 1, "token": 2}\n'):
            out += b"%x\r\n" % len(ln) + ln + b"\r\n"
        conn.sendall(out)
        time.sleep(0.05)
        conn.close()

    def close(self):
        self.sock.close()


def _decode_server(ttf, **kw):
    eng = DecodeEngine(ttf, replicas=1, device="cpu", num_pages=64,
                       **LADDERS, **kw)
    srv = ServingServer(eng, port=0)
    srv.start()
    return eng, srv, "%s:%d" % srv.address


def _hedging_router(addrs, primary, **kw):
    """A router whose tail estimate is fed (>= 20 fast samples) and whose
    first pick is ``primary``."""
    srv = RouterServer(addrs, port=0, probe_s=30.0, **kw)
    for _ in range(400):
        srv._m_forward.observe(0.005)
    real_pick = srv.pool.pick
    srv.pool.pick = (lambda exclude=(): primary if not exclude
                     else real_pick(exclude=exclude))
    return srv


def test_router_hedged_generate_first_wins(models):
    from dist_keras_tpu_torch.observability import metrics

    ttf = models[3]
    eng, srv, addr = _decode_server(ttf)
    stall = _StallBackend()
    router = _hedging_router([stall.addr, addr], stall.addr,
                             forward_timeout_s=60.0)
    hedges, wins = (metrics.counter("route.hedges"),
                    metrics.counter("route.hedge_wins"))
    h0, w0 = hedges.value, wins.value
    try:
        body = json.dumps({"tokens": [3, 1, 4],
                           "max_new_tokens": 5}).encode()
        code, payload, _, _ = router.forward_generate(body)
        assert code == 200
        doc = json.loads(payload.decode())
        assert doc["generated"] == _want_generate(ttf, [3, 1, 4], 5)
        assert doc["tokens"] == [3, 1, 4] + doc["generated"]
        assert doc["finish"] == "length"
        assert (hedges.value, wins.value) == (h0 + 1, w0 + 1)
        assert stall.hits == 1
        eng.assert_no_leaks()
    finally:
        router.close()
        srv.close()
        stall.close()


def test_router_hedge_denied_without_budget(models):
    from dist_keras_tpu_torch.observability import metrics

    eng, srv, addr = _decode_server(models[3])
    stall = _StallBackend()
    router = _hedging_router([stall.addr, addr], stall.addr,
                             forward_timeout_s=3.0)
    router._hedge_budget.ratio = 0.0
    router._hedge_budget._tokens = 0.0
    denied = metrics.counter("route.hedge_denied")
    d0 = denied.value
    try:
        body = json.dumps({"tokens": [1, 2], "max_new_tokens": 2}).encode()
        code, _, _, retry = router.forward_generate(body)
        assert code == 503 and retry is not None
        assert denied.value == d0 + 1
    finally:
        router.close()
        srv.close()
        stall.close()


@pytest.mark.filterwarnings(
    "error::pytest.PytestUnhandledThreadExceptionWarning")
def test_hedge_loser_on_a_live_backend_is_cancelled(models):
    """Both arms reach real decode backends; the primary decodes slowly,
    the hedge wins, and closing the loser's socket cancels its
    generation: its slot and KV pages come back."""
    ttf = models[3]
    slow_eng, slow_srv, slow_addr = _decode_server(ttf)
    fast_eng, fast_srv, fast_addr = _decode_server(ttf)
    real = slow_eng._decode_fn

    def slow(*a, **kw):
        time.sleep(0.05)
        return real(*a, **kw)

    slow_eng._decode_fn = slow
    router = _hedging_router([slow_addr, fast_addr], slow_addr,
                             forward_timeout_s=60.0)
    try:
        body = json.dumps({"tokens": [3, 1], "max_new_tokens": 24}).encode()
        code, payload, _, _ = router.forward_generate(body)
        assert code == 200
        doc = json.loads(payload.decode())
        assert doc["generated"] == _want_generate(ttf, [3, 1], 24)
        deadline = time.monotonic() + 30
        while ((slow_eng.stats()["outstanding"]
                or slow_eng.kv_stats()["used_pages"])
               and time.monotonic() < deadline):
            time.sleep(0.02)
        st = slow_eng.stats()
        assert st["outstanding"] == 0 and st["cancelled"] == 1
        assert slow_eng.kv_stats()["used_pages"] == 0
        assert fast_eng.kv_stats()["used_pages"] == 0
        slow_eng.assert_no_leaks()
    finally:
        router.close()
        slow_srv.close()
        fast_srv.close()


def test_router_stream_backend_death_typed_final_record():
    from dist_keras_tpu_torch.observability import metrics

    dying = _DyingStreamBackend()
    router = RouterServer([dying.addr], port=0, probe_s=30.0,
                          forward_timeout_s=30.0)
    raddr = router.start()
    errs = metrics.counter("route.stream_errors")
    v0 = errs.value
    try:
        code, _, text = _call(raddr, "/generate",
                              {"tokens": [1, 2], "stream": True})
        assert code == 200
        toks, last = _stream_tokens(text)
        assert toks == [1, 2]
        assert last["error"] == "backend_stream_lost"
        assert last["retryable"] is True
        assert errs.value == v0 + 1
    finally:
        router.close()
        dying.close()


def test_hedged_generate_keeps_the_callers_trace(models, tmp_path,
                                                  monkeypatch):
    """Both hedged attempts carry the ``traceparent`` of the router's
    ``route.forward`` hop, so the winner's ``serve.generate`` stitches
    into the caller's trace (the JAX package's copy reads the context
    on the attempt threads, which have none)."""
    monkeypatch.setenv("DK_OBS_DIR", str(tmp_path))
    events.reset()
    ttf = models[3]
    eng, srv, addr = _decode_server(ttf)
    stall = _StallBackend()
    router = _hedging_router([stall.addr, addr], stall.addr,
                             forward_timeout_s=60.0)
    raddr = router.start()
    trace = "d" * 32
    try:
        code, _, text = _call(raddr, "/generate",
                              {"tokens": [3, 1, 4], "max_new_tokens": 5},
                              headers={"traceparent":
                                       f"00-{trace}-{'e' * 16}-01"})
        assert code == 200
        assert json.loads(text)["generated"] == \
            _want_generate(ttf, [3, 1, 4], 5)
    finally:
        router.close()
        srv.close()
        stall.close()
        events.reset()
    recs = jax_report.read_events(str(tmp_path))
    ends = {r["span"]: r for r in recs if r.get("kind") == "span_end"
            and r.get("trace_id") == trace}
    assert ends["serve.generate"]["parent_id"] == \
        ends["route.forward"]["span_id"]
    assert ends["route.forward"]["parent_id"] == "e" * 16
