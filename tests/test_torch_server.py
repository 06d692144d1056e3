"""The port's HTTP front end on the CPU: ``POST /generate`` batched and
streamed (tokens equal to the JAX full-forward oracle on bridged
weights), the typed mapping (400 / 503 with Retry-After / 504 with the
generation cancelled / 404), ``GET /healthz``, and drain; ``POST
/predict`` against a ``ServingEngine`` (predictions equal to the JAX
model's), ``GET /metricsz``, the ``serve.*`` error mapping, a shape
mismatch as 400, the signal drain through ``resilience.preemption``;
``deadline_s`` / ``priority`` from the body and from the
``x-dk-deadline-s`` / ``x-dk-priority`` headers reaching admission
(deadline_infeasible and shed_batch as typed 503s, expiry finishing
``"deadline"``), a client disconnect mid-stream, the ``traceparent``
echo, and ``/statusz``, ``/tracez`` and ``/metricsz?format=prometheus``
answering with the JAX server's document shapes."""

import json
import signal
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
from test_decode import _oracle_generate

from dist_keras_tpu.models import mnist_mlp as jax_mnist_mlp
from dist_keras_tpu.models.transformer import Transformer as JaxTransformer
from dist_keras_tpu.models.transformer import transformer_config
from dist_keras_tpu_torch.models import mnist_mlp
from dist_keras_tpu_torch.models.transformer import Transformer
from dist_keras_tpu_torch.observability import events as obs_events
from dist_keras_tpu_torch.resilience import faults, preemption
from dist_keras_tpu_torch.serving import (
    DecodeEngine,
    Overloaded,
    ServingEngine,
    ServingServer,
    default_port,
)

VOCAB = 16
CFG = dict(input_dim=VOCAB, seq_len=32, d_model=16, n_heads=2, n_layers=2,
           n_classes=VOCAB)


def _models():
    jm = JaxTransformer(transformer_config(**CFG), seed=0)
    params = jax.tree.map(np.asarray, jm.params)
    return jm, Transformer(transformer_config(**CFG), params=params,
                           device="cpu")


def _server(model, timeout_s=60.0, **kw):
    eng = DecodeEngine(model, device="cpu", prefill_ladder=(4, 8),
                       decode_ladder=(1, 4), page_size=4, **kw)
    srv = ServingServer(eng, port=0, request_timeout_s=timeout_s)
    return srv, srv.start()


def _call(addr, path, body=None, raw=None, headers=None):
    host, port = addr
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(
        f"http://{host}:{port}{path}", data=data,
        headers={"Content-Type": "application/json", **(headers or {})},
        method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


@pytest.fixture(scope="module")
def served():
    jm, tm = _models()
    srv, addr = _server(tm, num_pages=64)
    yield jm, srv, addr
    srv.close()


def test_generate_batched_matches_oracle(served):
    jm, _, addr = served
    code, _, text = _call(addr, "/generate",
                          {"tokens": [3, 1, 4], "max_new_tokens": 6})
    assert code == 200
    doc = json.loads(text)
    assert doc["generated"] == _oracle_generate(jm.params, jm.cfg,
                                                [3, 1, 4], 6)
    assert doc["finish"] == "length" and doc["ttft_s"] is not None
    # a bare token list is the same request
    code, _, text = _call(addr, "/generate", [3, 1, 4])
    assert code == 200 and json.loads(text)["prompt_len"] == 3


def test_generate_streamed_ndjson_matches_oracle(served):
    jm, _, addr = served
    code, headers, text = _call(addr, "/generate", {
        "tokens": [2, 7, 1, 8], "max_new_tokens": 5, "stream": True})
    assert code == 200
    assert headers["Content-Type"] == "application/x-ndjson"
    lines = [json.loads(x) for x in text.splitlines() if x.strip()]
    assert [x["i"] for x in lines[:-1]] == list(range(5))
    assert [x["token"] for x in lines[:-1]] == _oracle_generate(
        jm.params, jm.cfg, [2, 7, 1, 8], 5)
    assert lines[-1]["done"] is True and lines[-1]["finish"] == "length"


def test_stream_ends_when_the_generation_resolves(served, monkeypatch):
    """A stream's last record follows its last token at once: the
    generation's resolution ends the handler's loop, not its poll (set
    to 30 s here, which the request must not wait out)."""
    from dist_keras_tpu_torch.serving import server as server_mod

    jm, _, addr = served
    monkeypatch.setattr(server_mod, "_STREAM_POLL_S", 30.0)
    t0 = time.monotonic()
    code, _, text = _call(addr, "/generate", {
        "tokens": [5, 3], "max_new_tokens": 4, "stream": True})
    assert time.monotonic() - t0 < 10.0
    lines = [json.loads(x) for x in text.splitlines() if x.strip()]
    assert code == 200 and lines[-1]["done"] is True
    assert [x["token"] for x in lines[:-1]] == _oracle_generate(
        jm.params, jm.cfg, [5, 3], 4)


@pytest.mark.parametrize("raw", [
    b"{not json",
    json.dumps({"tokens": []}).encode(),
    json.dumps({"tokens": [0, VOCAB]}).encode(),
    json.dumps({"tokens": [1, 2], "max_new_tokens": 0}).encode(),
    json.dumps({"tokens": ["a"]}).encode(),
    json.dumps({"no_tokens": 1}).encode(),
])
def test_malformed_prompts_are_400(served, raw):
    _, _, addr = served
    code, _, text = _call(addr, "/generate", raw=raw)
    assert code == 400
    assert json.loads(text)["error"] == "bad_request"


def test_healthz_and_unknown_paths(served):
    _, _, addr = served
    code, _, text = _call(addr, "/healthz")
    assert code == 200 and json.loads(text)["status"] == "serving"
    # a decode backend has no /predict: typed 501, not a 404 or a 500
    code, _, text = _call(addr, "/predict", {"rows": [[1.0]]})
    assert code == 501 and json.loads(text)["error"] == "not_implemented"
    code, _, text = _call(addr, "/metricsz")
    assert code == 200 and "counters" in json.loads(text)["registry"]
    assert _call(addr, "/nope")[0] == 404
    assert _call(addr, "/nope", {"rows": [[1.0]]})[0] == 404


def test_kv_exhausted_is_503_with_retry_after():
    _, tm = _models()
    srv, addr = _server(tm, num_pages=1)
    try:
        code, headers, text = _call(addr, "/generate", {
            "tokens": [1, 2, 3], "max_new_tokens": 6})   # needs 3 pages
        assert code == 503 and headers["Retry-After"] == "1"
        doc = json.loads(text)
        assert doc["error"] == "overloaded"
        assert doc["reason"] == "kv_exhausted"
    finally:
        srv.close()


def test_timeout_is_504_and_cancels_the_generation():
    _, tm = _models()
    srv, addr = _server(tm, timeout_s=0.2, num_pages=16)
    eng = srv.engine
    real = eng._decode_fn

    def slow(*a, **kw):
        time.sleep(0.1)
        return real(*a, **kw)

    eng._decode_fn = slow
    try:
        code, _, text = _call(addr, "/generate", {
            "tokens": [1, 2], "max_new_tokens": 10})
        assert code == 504 and json.loads(text)["error"] == "timeout"
        deadline = time.monotonic() + 60
        while eng.stats()["outstanding"] and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.stats()["cancelled"] == 1
        eng.assert_no_leaks()
    finally:
        srv.close()


def test_drain_then_503_and_socket_closed():
    _, tm = _models()
    srv, addr = _server(tm, num_pages=16)
    try:
        assert _call(addr, "/generate", {"tokens": [1], "max_new_tokens": 2}
                     )[0] == 200
        out = srv.drain(timeout_s=60)
        assert out["delivered"] == 1
        with pytest.raises(urllib.error.URLError):
            _call(addr, "/healthz")
        assert srv.engine.kv_stats()["used_pages"] == 0
    finally:
        srv.close()


# -- POST /predict against a ServingEngine -----------------------------
def _mlp_pair():
    jm = jax_mnist_mlp(hidden=(8,), input_dim=4, num_classes=3)
    tm = mnist_mlp(hidden=(8,), input_dim=4, num_classes=3)
    tm.set_weights(jm.get_weights())
    return jm, tm


def _rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 4)) \
        .astype(np.float32)


@pytest.fixture()
def predict_served():
    faults.clear()
    jm, tm = _mlp_pair()
    eng = ServingEngine(tm, replicas=1, batch_ladder=(1, 4, 16),
                        max_latency_s=0.002, max_queue=256, device="cpu")
    srv = ServingServer(eng, port=0)
    addr = srv.start()
    yield jm, eng, srv, addr
    srv.close()
    faults.clear()


def test_predict_health_metrics(predict_served):
    jm, eng, _, addr = predict_served
    rows = _rows(5)
    code, _, text = _call(addr, "/predict", {"rows": rows.tolist()})
    doc = json.loads(text)
    assert code == 200 and doc["n"] == 5
    assert np.allclose(np.asarray(doc["predictions"]),
                       np.asarray(jm.apply(jm.params, rows)), atol=1e-5)
    code, _, text = _call(addr, "/predict", rows[:2].tolist())  # bare list
    assert code == 200 and json.loads(text)["n"] == 2
    code, _, text = _call(addr, "/healthz")
    assert code == 200 and json.loads(text)["status"] == "serving"
    code, _, text = _call(addr, "/metricsz")
    doc = json.loads(text)
    assert code == 200 and doc["engine"]["completed"] >= 7
    assert doc["registry"]["counters"]["serve.completed"] >= 7


def test_predict_error_mapping(predict_served):
    _, _, _, addr = predict_served
    assert _call(addr, "/predict", {"rows": []})[0] == 400
    assert _call(addr, "/predict", {"wrong": 1})[0] == 400
    assert _call(addr, "/predict", raw=b"{nope")[0] == 400
    assert _call(addr, "/nope")[0] == 404
    for point in ("serve.predict", "serve.enqueue"):
        with faults.armed(point):
            code, _, text = _call(addr, "/predict",
                                  {"rows": _rows(1).tolist()})
        assert code == 500 and json.loads(text)["error"] == "FaultInjected"
    # a decode-only route against a predict engine is a typed 501
    code, _, text = _call(addr, "/generate", {"tokens": [1, 2]})
    assert code == 501 and json.loads(text)["error"] == "not_implemented"


def test_predict_shape_mismatch_is_400(predict_served):
    _, _, _, addr = predict_served
    assert _call(addr, "/predict", {"rows": _rows(2).tolist()})[0] == 200
    code, _, text = _call(addr, "/predict", {"rows": [[0.0] * 9]})
    assert code == 400 and json.loads(text)["error"] == "bad_request"
    assert _call(addr, "/predict", {"rows": _rows(2).tolist()})[0] == 200


def test_predict_overload_is_503_with_retry_after():
    _, tm = _mlp_pair()
    eng = ServingEngine(tm, replicas=1, batch_ladder=(1,),
                        max_latency_s=10.0, max_queue=1, device="cpu")
    srv = ServingServer(eng, port=0)
    addr = srv.start()
    try:
        code, headers, text = _call(addr, "/predict",
                                    {"rows": _rows(4).tolist()})
        doc = json.loads(text)
        assert code == 503 and headers["Retry-After"] == "1"
        assert (doc["reason"], doc["capacity"]) == ("queue_full", 1)
    finally:
        srv.close()


def test_predict_drain_rejects_then_closes(predict_served):
    _, eng, srv, addr = predict_served
    assert _call(addr, "/predict", {"rows": _rows(3).tolist()})[0] == 200
    out = srv.drain(timeout_s=60)
    assert out["delivered"] == 3
    with pytest.raises(OSError):
        _call(addr, "/healthz")
    assert eng.draining
    with pytest.raises(Overloaded):
        eng.submit(_rows(1)[0])


def test_signal_drain_via_preemption(predict_served):
    _, eng, srv, addr = predict_served
    assert _call(addr, "/predict", {"rows": _rows(2).tolist()})[0] == 200
    preemption.clear()
    try:
        srv.install_signal_drain(poll_s=0.01)
        preemption.request(signal.SIGTERM)  # a simulated delivery
        deadline = time.monotonic() + 30
        while srv.preempted_signum is None \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.preempted_signum == signal.SIGTERM
        deadline = time.monotonic() + 30
        while eng.running and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.draining and not eng.running
        with pytest.raises(Overloaded):
            eng.submit(_rows(1)[0])
    finally:
        preemption.clear()
        preemption.restore()


def test_run_forever_exits_128_plus_signum_after_a_signal_drain():
    # serving on the calling thread: the signal drain stops the listener,
    # and run_forever re-raises the preemption (exit code 128 + signum)
    _, tm = _mlp_pair()
    eng = ServingEngine(tm, replicas=1, batch_ladder=(1, 4),
                        max_latency_s=0.002, device="cpu")
    srv = ServingServer(eng, port=0)
    preemption.clear()
    answered = []

    def client():
        deadline = time.monotonic() + 30
        while not srv._serving and time.monotonic() < deadline:
            time.sleep(0.01)
        answered.append(_call(srv.address, "/predict",
                              {"rows": _rows(2).tolist()})[0])
        preemption.request(signal.SIGTERM)

    t = threading.Thread(target=client)
    try:
        srv.install_signal_drain(poll_s=0.01)
        t.start()
        with pytest.raises(preemption.Preempted) as ei:
            srv.run_forever()
        assert ei.value.exit_code == 128 + signal.SIGTERM
        assert answered == [200]
        assert not eng.running
    finally:
        t.join(timeout=30)
        preemption.clear()
        preemption.restore()
        srv.close()


def test_server_close_without_start_returns():
    _, tm = _mlp_pair()
    eng = ServingEngine(tm, replicas=1, batch_ladder=(1,), device="cpu")
    srv = ServingServer(eng, port=0)
    t0 = time.monotonic()
    srv.close()  # never started: must not block in shutdown()
    assert time.monotonic() - t0 < 5.0
    assert not eng.running


def test_default_port(monkeypatch):
    monkeypatch.delenv("DK_SERVE_PORT", raising=False)
    assert default_port() == 8000
    monkeypatch.setenv("DK_SERVE_PORT", "9100")
    assert default_port() == 9100
    monkeypatch.setenv("DK_SERVE_PORT", "junk")
    assert default_port(fallback=7) == 7


def _doc_shape(path, text):
    """What a route's body must share with the JAX server's: the
    top-level keys of a JSON document, or the engine gauges' names of a
    Prometheus scrape."""
    if "prometheus" in path:
        return sorted(line.split()[2] for line in text.splitlines()
                      if line.startswith("# TYPE dk_serve_engine_"))
    return sorted(json.loads(text))


@pytest.mark.parametrize("path", ["/statusz", "/tracez",
                                  "/metricsz?format=prometheus"])
def test_unported_routes_are_501_naming_item_18(predict_served, path):
    """Once 501s naming ROADMAP item 18; each route now answers 200 with
    the JAX server's document shape."""
    from dist_keras_tpu.serving import ServingEngine as JaxServingEngine
    from dist_keras_tpu.serving import ServingServer as JaxServingServer

    jm, _, _, addr = predict_served
    jsrv = JaxServingServer(JaxServingEngine(jm, replicas=1,
                                             batch_ladder=(1, 4, 16)),
                            port=0)
    jaddr = jsrv.start()
    try:
        for a in (addr, jaddr):
            assert _call(a, "/predict", {"rows": _rows(2).tolist()})[0] \
                == 200
        code, headers, text = _call(addr, path)
        jcode, jheaders, jtext = _call(jaddr, path)
    finally:
        jsrv.close()
    assert code == jcode == 200
    assert headers["Content-Type"] == jheaders["Content-Type"]
    assert _doc_shape(path, text) == _doc_shape(path, jtext)
    if path == "/statusz":
        doc, jdoc = json.loads(text), json.loads(jtext)
        assert set(doc["build"]) - set(jdoc["build"]) == \
            {"torch", "cuda", "device"}
        # the port's engine stats add the devices its replicas run on
        assert set(doc["engine"]) - set(jdoc["engine"]) == {"devices"}
    if "prometheus" in path:
        assert "dk_serve_engine_completed" in text


# -- traceparent -------------------------------------------------------
@pytest.mark.parametrize("route", ["/predict", "/generate"])
def test_traceparent_is_continued_and_echoed(route, tmp_path, monkeypatch):
    monkeypatch.setenv("DK_OBS_DIR", str(tmp_path))
    obs_events.reset()
    if route == "/predict":
        _, tm = _mlp_pair()
        eng = ServingEngine(tm, replicas=1, batch_ladder=(1, 4),
                            max_latency_s=0.002, device="cpu")
        body, name = {"rows": _rows(2).tolist()}, "serve.request"
    else:
        eng = DecodeEngine(_models()[1], device="cpu",
                           prefill_ladder=(4, 8), decode_ladder=(1, 4),
                           page_size=4)
        body, name = {"tokens": [1, 2], "max_new_tokens": 2}, \
            "serve.generate"
    srv = ServingServer(eng, port=0)
    addr = srv.start()
    trace, parent = "1" * 32, "2" * 16
    try:
        code, headers, _ = _call(
            addr, route, body,
            headers={"traceparent": f"00-{trace}-{parent}-01"})
        assert code == 200
        code2, headers2, _ = _call(addr, route, body,
                                   headers={"traceparent": "junk"})
        assert code2 == 200
    finally:
        srv.close()
        obs_events.reset()
    recs = [json.loads(x) for x in
            (tmp_path / "events-rank_0.jsonl").read_text().splitlines()]
    begins = [r for r in recs if r["kind"] == "span_begin"
              and r["span"] == name]
    assert begins[0]["trace_id"] == trace
    assert begins[0]["parent_id"] == parent
    assert headers["traceparent"] == \
        f"00-{trace}-{begins[0]['span_id']}-01"
    # a malformed header degrades to a fresh root trace, never a 4xx
    assert begins[1]["trace_id"] != trace and begins[1]["parent_id"] is None
    assert headers2["traceparent"].split("-")[1] == begins[1]["trace_id"]
    if route == "/predict":
        ends = {r["span"] for r in recs if r["kind"] == "span_end"
                and r["trace_id"] == trace}
        assert {"serve.queue_wait", "serve.batch", "serve.exec",
                "serve.request"} <= ends


# -- F1: deadline_s / priority reach admission -------------------------
@pytest.fixture()
def shedding():
    """A decode server whose KV watermark is 0, so every batch-priority
    admission sheds; its EWMAs are warmed by one request."""
    _, tm = _models()
    srv, addr = _server(tm, num_pages=64, shed_watermark=0.0)
    assert _call(addr, "/generate", {"tokens": [1, 2],
                                     "max_new_tokens": 2})[0] == 200
    yield srv, addr
    srv.close()


@pytest.mark.parametrize("body,headers,reason", [
    ({"deadline_s": 1e-9}, {}, "deadline_infeasible"),
    ({}, {"x-dk-deadline-s": "1e-9"}, "deadline_infeasible"),
    ({"priority": "batch"}, {}, "shed_batch"),
    ({}, {"x-dk-priority": "batch"}, "shed_batch"),
], ids=["deadline-body", "deadline-header", "priority-body",
        "priority-header"])
def test_deadline_and_priority_reach_admission(shedding, body, headers,
                                               reason):
    srv, addr = shedding
    code, hdrs, text = _call(addr, "/generate",
                             {"tokens": [1, 2], "max_new_tokens": 8,
                              **body}, headers=headers)
    doc = json.loads(text)
    assert code == 503 and hdrs["Retry-After"] == "1"
    assert doc["error"] == "overloaded" and doc["reason"] == reason
    st = srv.engine.stats()
    key = "shed" if reason == "shed_batch" else "deadline_infeasible"
    assert st[key] == 1


def test_body_fields_win_over_headers(shedding):
    srv, addr = shedding
    code, _, text = _call(
        addr, "/generate",
        {"tokens": [1, 2], "max_new_tokens": 2, "deadline_s": 300.0,
         "priority": "interactive"},
        headers={"x-dk-deadline-s": "1e-9", "x-dk-priority": "batch"})
    assert code == 200 and len(json.loads(text)["generated"]) == 2
    st = srv.engine.stats()
    assert st["shed"] == 0 and st["deadline_infeasible"] == 0


@pytest.mark.parametrize("body,headers", [
    ({"priority": "bogus"}, {}),
    ({}, {"x-dk-priority": "bulk"}),
    ({"deadline_s": "soon"}, {}),
    ({}, {"x-dk-deadline-s": "soon"}),
    ({"deadline_s": 0}, {}),
    ({"deadline_s": -1}, {}),
], ids=["priority-body", "priority-header", "deadline-body",
        "deadline-header", "deadline-zero", "deadline-negative"])
def test_malformed_deadline_or_priority_is_400(served, body, headers):
    _, _, addr = served
    code, _, text = _call(addr, "/generate",
                          {"tokens": [1, 2], **body}, headers=headers)
    assert code == 400 and json.loads(text)["error"] == "bad_request"


@pytest.mark.parametrize("via", ["body", "header"])
def test_deadline_expiry_finishes_deadline(via):
    # a fresh engine (no EWMAs: the door admits) whose steps are slowed
    # past the deadline: the reply is 200 with finish "deadline" and the
    # tokens so far, and the pages are back
    _, tm = _models()
    srv, addr = _server(tm, num_pages=16)
    eng = srv.engine
    real = eng._decode_fn

    def slow(*a, **kw):
        time.sleep(0.15)
        return real(*a, **kw)

    eng._decode_fn = slow
    body = {"tokens": [1, 2], "max_new_tokens": 10}
    headers = {}
    if via == "body":
        body["deadline_s"] = 0.3
    else:
        headers["x-dk-deadline-s"] = "0.3"
    try:
        code, _, text = _call(addr, "/generate", body, headers=headers)
        doc = json.loads(text)
        assert code == 200 and doc["finish"] == "deadline"
        assert 1 <= len(doc["generated"]) < 10
        st = eng.stats()
        assert st["deadline_expired"] == 1 and st["cancelled"] == 0
        assert eng.kv_stats()["used_pages"] == 0
        eng.assert_no_leaks()
    finally:
        srv.close()


def test_client_disconnect_mid_stream_reclaims_pages():
    _, tm = _models()
    srv, (host, port) = _server(tm, num_pages=64)
    eng = srv.engine
    real = eng._decode_fn

    def slow(*a, **kw):
        time.sleep(0.02)
        return real(*a, **kw)

    eng._decode_fn = slow
    try:
        body = json.dumps({"tokens": [3, 1], "max_new_tokens": 28,
                           "stream": True}).encode()
        s = socket.create_connection((host, port), timeout=30)
        s.sendall(b"POST /generate HTTP/1.1\r\n"
                  b"Host: x\r\nContent-Type: application/json\r\n"
                  + b"Content-Length: %d\r\n\r\n" % len(body) + body)
        buf = b""
        while b'"token"' not in buf:
            buf += s.recv(4096)
        s.close()                           # mid-stream disconnect
        deadline = time.monotonic() + 60
        while eng.stats()["outstanding"] and time.monotonic() < deadline:
            time.sleep(0.01)
        st = eng.stats()
        assert st["outstanding"] == 0 and st["cancelled"] >= 1
        eng.assert_no_leaks()
        assert eng.self_check() == 0
    finally:
        srv.close()
