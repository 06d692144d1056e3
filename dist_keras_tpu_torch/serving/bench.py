"""Offered-load serving benchmark — sustained QPS + latency percentiles.

A port of the JAX package's ``serving/bench.py`` over the port's
``mnist_mlp``, ``Transformer``, ``ServingEngine`` and ``DecodeEngine``.
Every function takes ``device=`` like every port entry point: the card
by default (raising without one), ``device="cpu"`` for the plain
PyTorch path.  The records carry exactly the JAX package's keys.

Offers a FIXED request rate at the engine (a paced scheduler thread
submits; completion callbacks stamp per-request latency) and reports
what the engine actually sustained: achieved QPS, p50/p99/max latency,
rejections, fill ratio, and the retrace bound.  Offered-load (rather
than closed-loop) measurement is what serving SLOs are written against:
a closed loop self-throttles to the server's speed and hides queueing
delay entirely.

CLI: ``python -m dist_keras_tpu_torch.serving.bench [--qps N]
[--seconds S] [--device cpu]`` prints one JSON record on the last stdout
line.  ``--decode`` switches to the decode-serving measurement
(paced open-loop generation requests against a
:class:`~.decode.DecodeEngine`): tokens/sec, time-to-first-token
p50/p99, and KV-page occupancy.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def run_serving_benchmark(offered_qps=400.0, duration_s=4.0,
                          feature_dim=32, hidden=(64,), num_classes=10,
                          batch_ladder=(1, 8, 32, 64), replicas=1,
                          max_latency_s=0.005, max_queue=4096,
                          warmup=True, seed=0, device=None):
    """Run one offered-load measurement; -> JSON-ready record dict."""
    # imports deferred so `--help` never touches torch
    from dist_keras_tpu_torch.models import mnist_mlp
    from dist_keras_tpu_torch.serving.engine import Overloaded, ServingEngine
    model = mnist_mlp(hidden=tuple(hidden), input_dim=int(feature_dim),
                      num_classes=int(num_classes))
    engine = ServingEngine(model, replicas=replicas,
                           batch_ladder=batch_ladder,
                           max_latency_s=max_latency_s,
                           max_queue=max_queue, device=device)
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(256, int(feature_dim))).astype(np.float32)

    if warmup:
        # pre-compile every rung so the measurement window holds zero
        # compiles (a production engine warms the ladder at deploy time
        # the same way)
        for rung in engine.batch_ladder:
            engine.predict(rows[:rung], timeout_s=120)

    latencies = []
    lat_lock = threading.Lock()
    rejected = [0]
    submitted = [0]

    def _submit_one(i):
        t0 = time.monotonic()

        def _done(fut):
            if fut.exception() is None:
                with lat_lock:
                    latencies.append(time.monotonic() - t0)
        try:
            fut = engine.submit(rows[i % len(rows)])
        except Overloaded:
            rejected[0] += 1
        else:
            submitted[0] += 1
            fut.add_done_callback(_done)

    interval = 1.0 / float(offered_qps)
    t_start = time.monotonic()
    next_t = t_start
    i = 0
    while True:
        now = time.monotonic()
        if now - t_start >= duration_s:
            break
        if now < next_t:
            time.sleep(min(next_t - now, 0.005))
            continue
        # catch up without sleeping when the scheduler fell behind —
        # the offered load stays the load, not "what we got around to"
        _submit_one(i)
        i += 1
        next_t += interval
    # deliver the tail before reading the clocks
    engine.drain(timeout_s=60)
    wall = time.monotonic() - t_start
    stats = engine.stats()
    record = {
        "offered_qps": float(offered_qps),
        "duration_s": round(wall, 3),
        "submitted": submitted[0],
        "completed": len(latencies),
        "rejected": rejected[0],
        "achieved_qps": round(len(latencies) / wall, 1) if wall else None,
        "p50_ms": (round(_percentile(latencies, 50) * 1e3, 3)
                   if latencies else None),
        "p99_ms": (round(_percentile(latencies, 99) * 1e3, 3)
                   if latencies else None),
        "max_ms": (round(max(latencies) * 1e3, 3) if latencies else None),
        "mean_fill_ratio": (round(stats["fill_ratio"]["mean"], 4)
                            if stats["fill_ratio"]["mean"] is not None
                            else None),
        "batches": stats["batches"],
        "replicas": stats["replicas"],
        "batch_ladder": stats["batch_ladder"],
        "retrace_count": stats["retrace_count"],
        "retrace_bound": stats["retrace_bound"],
        "errors": stats["errors"],
    }
    return record


def run_decode_benchmark(offered_rps=40.0, duration_s=4.0, vocab=64,
                         seq_len=64, d_model=32, n_heads=2, n_layers=2,
                         prefill_ladder=(8, 16), decode_ladder=(1, 4, 8),
                         page_size=8, max_new=12, replicas=1,
                         max_queue=4096, warmup=True, seed=0,
                         device=None):
    """One paced open-loop decode-serving measurement; -> JSON-ready
    record: tokens/sec sustained, TTFT p50/p99 (the ``generate_ttft``
    SLO's distribution), sequence latency p50/p99, KV-page occupancy
    (live + peak), rejections by kind, and the prefill+decode retrace
    bound.  Offered-load for the same reason as the predict bench: a
    closed loop would self-throttle to the engine's speed and hide the
    admission queue entirely."""
    from dist_keras_tpu_torch.models.transformer import (
        Transformer,
        transformer_config,
    )
    from dist_keras_tpu_torch.serving.decode import DecodeEngine
    from dist_keras_tpu_torch.serving.engine import Overloaded

    cfg = transformer_config(input_dim=int(vocab), seq_len=int(seq_len),
                             d_model=int(d_model), n_heads=int(n_heads),
                             n_layers=int(n_layers),
                             n_classes=int(vocab))
    engine = DecodeEngine(Transformer(cfg, device=device),
                          replicas=int(replicas),
                          prefill_ladder=tuple(prefill_ladder),
                          decode_ladder=tuple(decode_ladder),
                          page_size=int(page_size),
                          max_queue=int(max_queue), device=device)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, size=n).tolist()
               for n in rng.integers(2, prefill_ladder[-1] + 1,
                                     size=64)]

    if warmup:
        # warm every prefill rung and the decode ladder's small rungs
        # so the measurement window holds zero compiles
        for rung in engine.prefill_ladder:
            engine.generate(list(range(1, min(rung, vocab - 1) + 1))
                            [:rung], max_new_tokens=2, timeout_s=300)

    ttfts = []
    seq_lats = []
    tokens_done = [0]
    lat_lock = threading.Lock()
    rejected = {"kv_exhausted": 0, "queue_full": 0}
    submitted = [0]

    def _submit_one(i):
        t0 = time.monotonic()

        def _done(fut):
            if fut.exception() is None:
                doc = fut.result()  # dklint: ignore[unbounded-wait] done-callbacks run only after resolution
                with lat_lock:
                    seq_lats.append(time.monotonic() - t0)
                    if doc["ttft_s"] is not None:
                        ttfts.append(doc["ttft_s"])
                    tokens_done[0] += len(doc["generated"])
        try:
            gen = engine.submit_generate(prompts[i % len(prompts)],
                                         max_new_tokens=max_new)
        except Overloaded as e:
            rejected[e.reason] = rejected.get(e.reason, 0) + 1
        else:
            submitted[0] += 1
            gen.future.add_done_callback(_done)

    interval = 1.0 / float(offered_rps)
    t_start = time.monotonic()
    next_t = t_start
    occupancy_peak = 0.0
    i = 0
    while True:
        now = time.monotonic()
        if now - t_start >= duration_s:
            break
        if now < next_t:
            time.sleep(min(next_t - now, 0.005))
            continue
        _submit_one(i)
        if i % 8 == 0:
            occupancy_peak = max(occupancy_peak,
                                 engine.kv_stats()["occupancy"])
        i += 1
        next_t += interval
    engine.drain(timeout_s=120)
    wall = time.monotonic() - t_start
    stats = engine.stats()
    kv = stats["kv"]
    return {
        "mode": "decode",
        "offered_rps": float(offered_rps),
        "duration_s": round(wall, 3),
        "submitted": submitted[0],
        "completed": len(seq_lats),
        "rejected": int(sum(rejected.values())),
        "rejected_kv": rejected.get("kv_exhausted", 0),
        "tokens": tokens_done[0],
        "tokens_per_s": (round(tokens_done[0] / wall, 1)
                         if wall else None),
        "ttft_p50_ms": (round(_percentile(ttfts, 50) * 1e3, 3)
                        if ttfts else None),
        "ttft_p99_ms": (round(_percentile(ttfts, 99) * 1e3, 3)
                        if ttfts else None),
        "seq_p50_ms": (round(_percentile(seq_lats, 50) * 1e3, 3)
                       if seq_lats else None),
        "seq_p99_ms": (round(_percentile(seq_lats, 99) * 1e3, 3)
                       if seq_lats else None),
        "kv_occupancy_peak": round(max(
            occupancy_peak, kv["peak_pages"] / kv["num_pages"]
            if kv["num_pages"] else 0.0), 4),
        "kv_pages": kv["num_pages"],
        "replicas": stats["replicas"],
        "prefill_ladder": stats["prefill_ladder"],
        "decode_ladder": stats["decode_ladder"],
        "retrace_count": stats["retrace_count"],
        "retrace_bound": stats["retrace_bound"],
        "errors": stats["errors"],
    }


def run_survivability_benchmark(offered_rps=60.0, duration_s=4.0,
                                vocab=64, seq_len=64, d_model=32,
                                n_heads=2, n_layers=2,
                                prefill_ladder=(8, 16),
                                decode_ladder=(1, 4, 8), page_size=8,
                                max_new=12, replicas=2,
                                max_queue=4096, batch_every=3,
                                seed=0, device=None):
    """Decode survivability under pressure: paced open-loop generation
    against a multi-replica engine at roughly 2x the single-replica
    comfortable rate (every ``batch_every``-th request
    ``priority="batch"``), with replica 0 KILLED a third of the way
    in.  -> JSON-ready record: the recovered-sequence latency tax
    (recovered p50 vs undisturbed p50 — replay is not free, and this
    row says what it costs), interactive sequence-latency p99 across
    the kill, the brownout shed rate for batch work, and the
    survivability ledger (quarantines, recoveries, zero errors, zero
    leaked pages)."""
    from dist_keras_tpu_torch.models.transformer import (
        Transformer,
        transformer_config,
    )
    from dist_keras_tpu_torch.serving.decode import DecodeEngine
    from dist_keras_tpu_torch.serving.engine import Overloaded

    cfg = transformer_config(input_dim=int(vocab), seq_len=int(seq_len),
                             d_model=int(d_model), n_heads=int(n_heads),
                             n_layers=int(n_layers),
                             n_classes=int(vocab))
    engine = DecodeEngine(Transformer(cfg, device=device),
                          replicas=max(2, int(replicas)),
                          prefill_ladder=tuple(prefill_ladder),
                          decode_ladder=tuple(decode_ladder),
                          page_size=int(page_size),
                          max_queue=int(max_queue), device=device)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, size=n).tolist()
               for n in rng.integers(2, prefill_ladder[-1] + 1,
                                     size=64)]
    for rung in engine.prefill_ladder:  # zero compiles in the window
        engine.generate(list(range(1, min(rung, vocab - 1) + 1))
                        [:rung], max_new_tokens=2, timeout_s=300)

    lat_lock = threading.Lock()
    undisturbed, recovered = [], []
    interactive = []
    rejected = {"kv_exhausted": 0, "queue_full": 0}
    shed = [0]
    batch_offered = [0]
    submitted = [0]

    def _submit_one(i):
        t0 = time.monotonic()
        prio = "batch" if i % int(batch_every) == 0 else "interactive"

        def _done(fut):
            if fut.exception() is None:
                doc = fut.result()  # dklint: ignore[unbounded-wait] done-callbacks run only after resolution
                lat = time.monotonic() - t0
                with lat_lock:
                    (recovered if doc.get("recoveries")
                     else undisturbed).append(lat)
                    if prio == "interactive":
                        interactive.append(lat)
        if prio == "batch":
            batch_offered[0] += 1
        try:
            gen = engine.submit_generate(prompts[i % len(prompts)],
                                         max_new_tokens=max_new,
                                         priority=prio)
        except Overloaded as e:
            if e.reason == "shed_batch":
                shed[0] += 1
            else:
                rejected[e.reason] = rejected.get(e.reason, 0) + 1
        else:
            submitted[0] += 1
            gen.future.add_done_callback(_done)

    # dklint: thread-root=bench.kill_timer
    killer = threading.Timer(float(duration_s) / 3.0,
                             lambda: engine.kill_replica(0))
    killer.daemon = True
    killer.start()
    interval = 1.0 / float(offered_rps)
    t_start = time.monotonic()
    next_t = t_start
    i = 0
    while True:
        now = time.monotonic()
        if now - t_start >= duration_s:
            break
        if now < next_t:
            time.sleep(min(next_t - now, 0.005))
            continue
        _submit_one(i)
        i += 1
        next_t += interval
    killer.cancel()
    engine.drain(timeout_s=120)
    wall = time.monotonic() - t_start
    stats = engine.stats()
    leaked = engine.self_check()
    und_p50 = (_percentile(undisturbed, 50) * 1e3
               if undisturbed else None)
    rec_p50 = (_percentile(recovered, 50) * 1e3
               if recovered else None)
    return {
        "mode": "decode_survivability",
        "offered_rps": float(offered_rps),
        "duration_s": round(wall, 3),
        "submitted": submitted[0],
        "completed": len(undisturbed) + len(recovered),
        "recovered": len(recovered),
        "quarantines": stats["quarantines"],
        "errors": stats["errors"],
        "rejected": int(sum(rejected.values())),
        "shed": shed[0],
        "shed_rate": (round(shed[0] / batch_offered[0], 4)
                      if batch_offered[0] else None),
        "undisturbed_p50_ms": (round(und_p50, 3)
                               if und_p50 is not None else None),
        "recovered_p50_ms": (round(rec_p50, 3)
                             if rec_p50 is not None else None),
        "recovery_tax": (round(rec_p50 / und_p50, 3)
                         if rec_p50 is not None and und_p50
                         else None),
        "interactive_p99_ms": (
            round(_percentile(interactive, 99) * 1e3, 3)
            if interactive else None),
        "kv_leaked_pages": leaked + stats["kv_leaked"],
        "replicas": stats["replicas"],
        "replicas_dead": stats["replicas_dead"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--qps", type=float, default=400.0)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--feature-dim", type=int, default=32)
    ap.add_argument("--decode", action="store_true",
                    help="measure decode serving (tokens/sec + TTFT) "
                         "instead of fixed-shape predict")
    ap.add_argument("--survivability", action="store_true",
                    help="measure decode survivability: replica kill "
                         "mid-load, recovery latency tax, brownout "
                         "shed rate")
    ap.add_argument("--rps", type=float, default=40.0,
                    help="offered generation requests/sec (--decode)")
    ap.add_argument("--max-new", type=int, default=12,
                    help="tokens generated per request (--decode)")
    ap.add_argument("--device", default=None,
                    help="where the engine runs (default: the card)")
    args = ap.parse_args(argv)
    if args.survivability:
        record = run_survivability_benchmark(
            offered_rps=args.rps if args.rps != 40.0 else 60.0,
            duration_s=args.seconds,
            max_new=args.max_new, device=args.device)
    elif args.decode:
        record = run_decode_benchmark(offered_rps=args.rps,
                                      duration_s=args.seconds,
                                      replicas=args.replicas,
                                      max_new=args.max_new,
                                      device=args.device)
    else:
        record = run_serving_benchmark(offered_qps=args.qps,
                                       duration_s=args.seconds,
                                       replicas=args.replicas,
                                       feature_dim=args.feature_dim,
                                       device=args.device)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
