"""The survivability half of the port's ``DecodeEngine`` on the CPU, case
for case against the JAX package's decode tests: the ``decode.*`` fault
points typed, a step fault absorbed in place, a seeded chaos sweep with
zero leaked pages, ``kill_replica`` racing prefill and mid-decode, a
step fault past the retry, ``resize`` under load and churn — every doc
token-equal to the JAX ``DecodeEngine``'s undisturbed greedy doc on the
same bridged weights — the recover fault, the last-replica refusal, a
full survivor, deadlines at the door and mid-decode, brownout shedding,
the cancel races, ``self_check`` and the ``DK_SLO`` refusal."""

import time

import jax
import numpy as np
import pytest

from dist_keras_tpu.models.transformer import Transformer as JaxTransformer
from dist_keras_tpu.models.transformer import transformer_config
from dist_keras_tpu.serving import DecodeEngine as JaxDecodeEngine
from dist_keras_tpu_torch.models.transformer import Transformer
from dist_keras_tpu_torch.observability import metrics
from dist_keras_tpu_torch.resilience import faults
from dist_keras_tpu_torch.resilience.faults import FaultInjected
from dist_keras_tpu_torch.serving import DecodeEngine, Overloaded

VOCAB = 16
CFG = dict(input_dim=VOCAB, seq_len=32, d_model=16, n_heads=2, n_layers=2,
           n_classes=VOCAB)
LADDERS = dict(prefill_ladder=(4, 8), decode_ladder=(1, 4), page_size=4)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


@pytest.fixture(scope="module")
def ref():
    """The bridged pair, and the JAX engine's undisturbed greedy docs
    (memoised per prompt and length)."""
    jm = JaxTransformer(transformer_config(**CFG), seed=0)
    tm = Transformer(transformer_config(**CFG),
                     params=jax.tree.map(np.asarray, jm.params),
                     device="cpu")
    jeng = JaxDecodeEngine(jm, replicas=1, **LADDERS)
    memo = {}

    def want(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            memo[key] = jeng.generate(list(prompt), max_new_tokens=n,
                                      timeout_s=300)["generated"]
        return memo[key]

    yield tm, want
    jeng.close(drain=True)


def _engine(model, **kw):
    kw.setdefault("replicas", 1)
    return DecodeEngine(model, device="cpu", **{**LADDERS, **kw})


@pytest.fixture(scope="module")
def engine(ref):
    tm, _ = ref
    eng = _engine(tm, max_new_default=8)
    yield eng
    eng.close(drain=True)


# -- decode.* faults: typed failures, zero leaked pages ----------------
def test_fault_points_typed(engine):
    with faults.armed("decode.admit"):
        with pytest.raises(FaultInjected):
            engine.submit_generate([1, 2], max_new_tokens=4)
    with faults.armed("decode.kv_alloc"):
        with pytest.raises(FaultInjected):
            engine.submit_generate([1, 2], max_new_tokens=4)
    # one step fault is absorbed by the in-place retry; past the retry
    # a single-replica engine has no survivor, so it lands TYPED
    with faults.armed("decode.step", times=2):
        g = engine.submit_generate([1, 2], max_new_tokens=6)
        with pytest.raises(FaultInjected):
            g.result(timeout=300)
    doc = engine.generate([1, 2], max_new_tokens=2, timeout_s=300)
    assert len(doc["generated"]) == 2
    engine.assert_no_leaks()


def test_step_fault_absorbed_by_retry(ref, engine):
    _, want = ref
    with faults.armed("decode.step", times=1):
        doc = engine.generate([2, 4, 6], max_new_tokens=4, timeout_s=300)
    assert doc["generated"] == want([2, 4, 6], 4)
    assert doc["recoveries"] == 0
    engine.assert_no_leaks()


def test_seeded_chaos_sweep_zero_leaks(ref):
    tm, _ = ref
    eng = _engine(tm, num_pages=24, max_queue=32)
    rng = np.random.default_rng(7)
    points = ("decode.admit", "decode.kv_alloc", "decode.step")
    typed = 0
    try:
        for trial in range(9):
            faults.inject(points[trial % 3],
                          at=int(rng.integers(0, 3)), times=1)
            gens = []
            for _ in range(3):
                try:
                    gens.append(eng.submit_generate(
                        [int(rng.integers(0, VOCAB)), 1],
                        max_new_tokens=int(rng.integers(2, 7))))
                except (FaultInjected, Overloaded):
                    typed += 1
            for g in gens:
                try:
                    g.result(timeout=300)
                except (FaultInjected, Overloaded):
                    typed += 1
            faults.clear()
        assert typed >= 1, "chaos never fired"
        eng.drain(timeout_s=300)
        eng.assert_no_leaks()
    finally:
        eng.close(drain=False)


def test_chaos_schedule_sweep_with_two_replicas(ref):
    # the seeded schedule (the reference's, point for point) over the
    # decode points with a short horizon: every future lands — a doc
    # equal to the undisturbed one, or a typed error — and no page leaks
    tm, want = ref
    eng = _engine(tm, replicas=2, num_pages=24, max_queue=32)
    pts = ("decode.admit", "decode.kv_alloc", "decode.step",
           "decode.recover")
    try:
        for seed in range(3):
            for spec in faults.chaos_schedule(seed, rate=0.5, horizon=4,
                                              points=pts):
                faults.inject(spec.point, at=spec.at, exc=spec.exc)
            prompts = [[seed + 1, 2], [3, seed + 4, 5]]
            for p in prompts:
                try:
                    doc = eng.generate(p, max_new_tokens=4, timeout_s=300)
                except (FaultInjected, OSError, Overloaded):
                    continue
                assert doc["generated"] == want(p, 4)
            faults.clear()
            if eng.stats()["replicas"] < 2:
                eng.resize(2)
        eng.drain(timeout_s=300)
        eng.assert_no_leaks()
    finally:
        eng.close(drain=False)


# -- survivability: quarantine + sequence-level recovery ---------------
def test_kill_replica_racing_prefill_token_equal(ref):
    tm, want = ref
    eng = _engine(tm, replicas=2, num_pages=32)
    try:
        prompt = [3, 1, 4, 1]
        seen = []
        g = eng.submit_generate(prompt, max_new_tokens=6,
                                on_token=seen.append)
        eng.kill_replica(0)      # the first admission lands on replica 0
        doc = g.result(timeout=300)
        assert doc["generated"] == want(prompt, 6)
        assert seen == doc["generated"]   # streaming resumed: no dup/skip
        st = eng.stats()
        assert st["quarantines"] == 1
        assert st["replicas_dead"] == 1 and st["replicas"] == 1
        eng.assert_no_leaks()
        assert eng.self_check() == 0
    finally:
        eng.close(drain=True)


def test_kill_replica_mid_decode_token_equal(ref):
    tm, want = ref
    eng = _engine(tm, replicas=2, num_pages=32)
    try:
        prompt = [2, 7, 1]
        seen = []

        def on_token(t):
            seen.append(t)
            if len(seen) == 2:
                eng.kill_replica(0)

        g = eng.submit_generate(prompt, max_new_tokens=6,
                                on_token=on_token)
        doc = g.result(timeout=300)
        assert doc["generated"] == want(prompt, 6)
        assert seen == doc["generated"]
        assert doc["recoveries"] == 1 and doc["finish"] == "length"
        st = eng.stats()
        assert st["quarantines"] == 1 and st["recovered"] == 1
        eng.assert_no_leaks()
    finally:
        eng.close(drain=True)


def test_replay_runs_prefill_then_teacher_forced_steps(ref, monkeypatch):
    # whitebox: after the kill, the survivor's prefill sees only the
    # prompt and its decode steps are fed the tokens already delivered
    tm, want = ref
    eng = _engine(tm, replicas=2, num_pages=32)
    fed = []
    real = eng._decode_fn

    def spy(params, kp, vp, tokens, positions, *rest):
        fed.append((tokens[0].item(), positions[0].item()))
        return real(params, kp, vp, tokens, positions, *rest)

    monkeypatch.setattr(eng, "_decode_fn", spy)
    try:
        prompt = [5, 6, 7]
        seen = []

        def on_token(t):
            seen.append(t)
            if len(seen) == 3:
                eng.kill_replica(0)

        doc = eng.submit_generate(prompt, max_new_tokens=5,
                                  on_token=on_token).result(timeout=300)
        toks = prompt + want(prompt, 5)
        assert doc["tokens"] == toks
        # the undisturbed steps, then the replay re-feeding positions
        # 3.. from the canonical tokens, then the rest
        replayed = [p for _, p in fed]
        assert replayed.count(3) == 2 and replayed.count(4) == 2
        assert all(t == toks[p] for t, p in fed)
    finally:
        eng.close(drain=True)


def test_step_fault_past_retry_quarantines_and_recovers(ref):
    tm, want = ref
    eng = _engine(tm, replicas=2, num_pages=32)
    try:
        prompt = [5, 3]
        with faults.armed("decode.step", times=2):
            doc = eng.generate(prompt, max_new_tokens=5, timeout_s=300)
        assert doc["generated"] == want(prompt, 5)
        assert doc["recoveries"] == 1
        st = eng.stats()
        assert st["quarantines"] == 1 and st["recovered"] == 1
        assert st["errors"] == 0
        eng.assert_no_leaks()
    finally:
        eng.close(drain=True)


def test_recover_fault_fails_orphans_typed(ref):
    tm, _ = ref
    eng = _engine(tm, replicas=2, num_pages=32)
    try:
        g = eng.submit_generate([1, 2], max_new_tokens=6)
        with faults.armed("decode.recover"):
            eng.kill_replica(0)
            with pytest.raises(FaultInjected):
                g.result(timeout=300)
        eng.assert_no_leaks()
        assert eng.stats()["errors"] == 1
    finally:
        eng.close(drain=True)


def test_kill_last_live_replica_refused(ref):
    tm, _ = ref
    eng = _engine(tm, replicas=2, num_pages=32)
    try:
        eng.kill_replica(1)
        deadline = time.monotonic() + 60
        while (eng.stats()["replicas_dead"] < 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
        with pytest.raises(ValueError, match="last live"):
            eng.kill_replica(0)   # whole-pod loss is out of scope
        with pytest.raises(ValueError, match="no such live"):
            eng.kill_replica(1)   # already dead
        with pytest.raises(ValueError, match="no such live"):
            eng.kill_replica(7)
        doc = eng.generate([1, 2], max_new_tokens=2, timeout_s=300)
        assert len(doc["generated"]) == 2
    finally:
        eng.close(drain=True)


def test_churn_many_sequences_zero_lost(ref):
    tm, want = ref
    eng = _engine(tm, replicas=3, num_pages=48, max_queue=64)
    try:
        rng = np.random.default_rng(11)
        prompts = [rng.integers(0, VOCAB, size=int(n)).tolist()
                   for n in rng.integers(2, 6, size=6)]
        gens = [eng.submit_generate(p, max_new_tokens=5) for p in prompts]
        eng.kill_replica(0)
        for p, g in zip(prompts, gens):
            assert g.result(timeout=300)["generated"] == want(p, 5)
        st = eng.stats()
        assert st["quarantines"] == 1
        assert st["completed"] == 6 and st["errors"] == 0
        eng.assert_no_leaks()
        assert eng.self_check() == 0
    finally:
        eng.close(drain=True)


def test_kill_with_full_survivor_orphans_wait_not_fail(ref):
    tm, want = ref
    # 8 pages/replica; each sequence reserves 4 (2 prompt + 14 new = 16
    # tokens): two sequences fill a replica exactly
    eng = _engine(tm, replicas=2, num_pages=8, max_queue=64)
    try:
        prompts = [[1, 2], [3, 4], [5, 6], [7, 8]]
        gens = [eng.submit_generate(p, max_new_tokens=14) for p in prompts]
        eng.kill_replica(0)
        for p, g in zip(prompts, gens):
            assert g.result(timeout=300)["generated"] == want(p, 14)
        st = eng.stats()
        assert st["quarantines"] == 1 and st["recovered"] == 2
        assert st["completed"] == 4 and st["errors"] == 0
        assert st["orphans_pending"] == 0
        eng.assert_no_leaks()
        assert eng.self_check() == 0
    finally:
        eng.close(drain=True)


def test_resize_under_load_token_equal(ref):
    tm, want = ref
    eng = _engine(tm, replicas=1, num_pages=32, max_queue=64)
    try:
        assert eng.resize(3) == 3
        prompts = [[1, 3], [2, 4, 6], [7], [5, 5, 5, 5]]
        gens = [eng.submit_generate(p, max_new_tokens=6) for p in prompts]
        assert eng.resize(1) == 1   # retirees finish what they hold
        for p, g in zip(prompts, gens):
            assert g.result(timeout=300)["generated"] == want(p, 6)
        st = eng.stats()
        assert st["replicas"] == 1 and st["errors"] == 0
        assert len(eng.kv_stats()["replicas"]) == 1
        doc = eng.generate([1, 3], max_new_tokens=6, timeout_s=300)
        assert doc["generated"] == want([1, 3], 6)
        with pytest.raises(ValueError):
            eng.resize(0)
        eng.assert_no_leaks()
    finally:
        eng.close(drain=True)
    with pytest.raises(Overloaded):
        eng.resize(2)


# -- deadlines + shedding ----------------------------------------------
def test_deadline_infeasible_rejected_at_door(engine):
    # warm the prefill/step EWMAs so feasibility has an estimate
    engine.generate([1, 2], max_new_tokens=2, timeout_s=300)
    with pytest.raises(Overloaded) as ei:
        engine.submit_generate([1, 2], max_new_tokens=8, deadline_s=1e-6)
    assert ei.value.reason == "deadline_infeasible"
    assert engine.stats()["deadline_infeasible"] >= 1
    for bad in (0, -1.0, float("nan")):
        with pytest.raises(ValueError):
            engine.submit_generate([1, 2], deadline_s=bad)


def test_deadline_expiry_frees_slot_mid_decode(ref):
    # fresh engine: no EWMAs yet, so the door admits; the token callback
    # stalls past the deadline and the scheduler retires the sequence
    # between steps with the tokens produced so far
    tm, want = ref
    eng = _engine(tm, num_pages=32)
    try:
        g = eng.submit_generate([1, 2], max_new_tokens=8, deadline_s=0.2,
                                on_token=lambda _t: time.sleep(0.4))
        doc = g.result(timeout=300)
        assert doc["finish"] == "deadline"
        assert 1 <= len(doc["generated"]) < 8
        assert doc["generated"] == want([1, 2], 8)[:len(doc["generated"])]
        st = eng.stats()
        assert st["deadline_expired"] == 1 and st["completed"] == 0
        assert eng.kv_stats()["used_pages"] == 0
        eng.assert_no_leaks()
    finally:
        eng.close(drain=True)


def test_brownout_sheds_batch_keeps_interactive(ref):
    # watermark 0: every batch admission sheds, interactive sails
    # through — and sheds land on their own meter, not rejected
    tm, _ = ref
    eng = _engine(tm, num_pages=32, shed_watermark=0.0)
    try:
        shed0 = metrics.counter("decode.shed").value
        with pytest.raises(Overloaded) as ei:
            eng.submit_generate([1, 2], max_new_tokens=2, priority="batch")
        assert ei.value.reason == "shed_batch"
        doc = eng.generate([1, 2], max_new_tokens=2, timeout_s=300)
        assert len(doc["generated"]) == 2
        st = eng.stats()
        assert st["shed"] == 1 and st["rejected"] == 0
        assert metrics.counter("decode.shed").value == shed0 + 1
        with pytest.raises(ValueError):
            eng.submit_generate([1, 2], priority="bulk")
    finally:
        eng.close(drain=True)


def test_watermark_sheds_batch_only_above_it(ref):
    tm, _ = ref
    # 8 pages; one 16-token interactive sequence holds 4 = 50%
    eng = _engine(tm, num_pages=8, shed_watermark=0.5)
    try:
        g = eng.submit_generate([1, 2], max_new_tokens=14)
        with pytest.raises(Overloaded) as ei:
            eng.submit_generate([3, 4], max_new_tokens=2, priority="batch")
        assert ei.value.reason == "shed_batch"
        h = eng.submit_generate([3, 4], max_new_tokens=2)  # interactive
        g.result(timeout=300)
        h.result(timeout=300)
        doc = eng.submit_generate([3, 4], max_new_tokens=2,
                                  priority="batch").result(timeout=300)
        assert len(doc["generated"]) == 2     # idle pool: admitted
    finally:
        eng.close(drain=True)


def test_batch_admits_below_watermark(engine):
    doc = engine.generate([4, 2], max_new_tokens=3, timeout_s=300)
    g = engine.submit_generate([4, 2], max_new_tokens=3, priority="batch")
    assert g.result(timeout=300)["generated"] == doc["generated"]


def test_slo_knob_is_refused_naming_item_18(ref, monkeypatch):
    tm, _ = ref
    monkeypatch.setenv("DK_SLO", "1")
    with pytest.raises(NotImplementedError, match="item 18"):
        _engine(tm)


# -- KV-leak regression: races + the periodic self-check ---------------
def test_cancel_after_completion_returns_false(engine):
    g = engine.submit_generate([1, 2], max_new_tokens=2)
    g.result(timeout=300)
    assert g.cancel() is False    # finished: nothing left to cancel
    engine.assert_no_leaks()


def test_cancel_race_with_sequence_done_never_leaks(ref):
    tm, _ = ref
    eng = _engine(tm, num_pages=32)
    try:
        for _ in range(8):
            g = eng.submit_generate([1, 2], max_new_tokens=1)
            g.cancel()
            try:
                doc = g.result(timeout=300)
            except Overloaded:
                doc = None
            if doc is not None:
                assert doc["finish"] in ("cancelled", "length", "eos")
        deadline = time.monotonic() + 60
        while eng.stats()["outstanding"] and time.monotonic() < deadline:
            time.sleep(0.01)
        eng.assert_no_leaks()
        assert eng.self_check() == 0
    finally:
        eng.close(drain=True)


def test_self_check_reclaims_and_counts_unowned_pages(ref):
    tm, _ = ref
    eng = _engine(tm, num_pages=32)
    try:
        eng._replicas[0].cache.alloc("ghost", 4)   # a planted leak
        assert eng.self_check() == 1               # one 4-token page
        assert eng.stats()["kv_leaked"] == 1
        eng.assert_no_leaks()
        assert eng.self_check() == 0               # idempotent
    finally:
        eng.close(drain=True)


def test_periodic_self_check_runs_from_the_scheduler(ref):
    tm, _ = ref
    eng = _engine(tm, num_pages=32, self_check_interval_s=0.0)
    try:
        eng._replicas[0].cache.alloc("ghost", 8)
        eng.generate([1, 2], max_new_tokens=2, timeout_s=300)
        deadline = time.monotonic() + 60
        while eng.stats()["kv_leaked"] < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.stats()["kv_leaked"] == 2
        eng.assert_no_leaks()
    finally:
        eng.close(drain=True)


# -- drain / stats contract --------------------------------------------
def test_drain_reports_and_closes_admission(ref):
    tm, _ = ref
    eng = _engine(tm, num_pages=32)
    gens = [eng.submit_generate([1, 2], max_new_tokens=4)
            for _ in range(3)]
    out = eng.drain(timeout_s=300)
    assert out["delivered"] == 3
    for g in gens:
        assert g.result(timeout=5)["finish"] == "length"
    with pytest.raises(Overloaded):
        eng.submit_generate([1, 2], max_new_tokens=2)
    eng.close(drain=False)


def test_stats_shape_and_ttft(engine):
    engine.generate([1, 2, 3], max_new_tokens=3, timeout_s=300)
    st = engine.stats()
    assert st["retrace_bound"] == len(st["prefill_ladder"]) + \
        len(st["decode_ladder"])
    assert st["retrace_count"] <= st["retrace_bound"]
    assert st["ttft_s"]["count"] >= 1 and st["step_s"]["count"] >= 1
    assert st["kv"]["used_pages"] == 0
    for key in ("quarantines", "recovered", "shed", "deadline_expired",
                "deadline_infeasible", "kv_leaked", "orphans_pending",
                "replicas_dead"):
        assert key in st
