"""The port's ``ReplicaAutoscaler`` (``dist_keras_tpu_torch/serving/
autoscale.py``) against the JAX package's: the router gate's autoscale
script (``gates.py``'s ramp, cooldown, noise, a second ramp into the
ceiling, calm hysteresis, the floor) over a real engine of each package,
and seeded ``serve.pending`` rings (with ``slo.breaching()`` forced on
some ticks and a latency p99 breach), give the same tick-by-tick resize
sequence; and the autoscaler cases of ``tests/test_router.py``."""

import numpy as np
import pytest

from dist_keras_tpu.models import mnist_mlp as jax_mnist_mlp
from dist_keras_tpu.observability import metrics as jax_metrics
from dist_keras_tpu.observability import slo as jax_slo
from dist_keras_tpu.observability import timeseries as jax_timeseries
from dist_keras_tpu.serving import ReplicaAutoscaler as JaxAutoscaler
from dist_keras_tpu.serving import ServingEngine as JaxServingEngine
from dist_keras_tpu_torch.models import mnist_mlp
from dist_keras_tpu_torch.observability import metrics, slo, timeseries
from dist_keras_tpu_torch.serving import ReplicaAutoscaler, ServingEngine

# gates.py's router gate, autoscale mode: the ring values fed before
# each tick, in order
GATE_RING = ((1.0, 3.0, 6.0, 9.0, 10.0)
             + (3.0, 7.0, 2.5, 6.0, 3.5, 7.5)
             + (8.0, 9.0, 10.0, 11.0, 12.0)
             + (1.0, 1.0, 0.0, 1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
             + (0.0, 0.0, 0.0, 0.0))
# (action, replicas) after each tick: the JAX package's run of the script
GATE_TICKS = ([(None, 1)] * 3 + [("up", 2)] + [(None, 2)] * 8
              + [("up", 3)] + [(None, 3)] * 5 + [("down", 2)]
              + [(None, 2)] * 3 + [("down", 1)] + [(None, 1)] * 6)
GATE_KW = dict(floor=1, ceiling=3, depth_high=8.0, samples=4,
               clear_checks=3, cooldown_checks=1, step=1)
PKGS = {
    "jax": (JaxAutoscaler, jax_timeseries, jax_metrics, jax_slo),
    "torch": (ReplicaAutoscaler, timeseries, metrics, slo),
}


@pytest.fixture(autouse=True)
def _fresh_rings():
    for _, ts, m, _ in PKGS.values():
        ts.reset()
        m.histogram("serve.predict_s").reset()
    yield
    for _, ts, m, _ in PKGS.values():
        ts.reset()
        m.histogram("serve.predict_s").reset()


def _rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 4)) \
        .astype(np.float32)


def _engine(pkg):
    if pkg == "jax":
        eng = JaxServingEngine(jax_mnist_mlp(hidden=(8,), input_dim=4,
                                             num_classes=3),
                               replicas=1, batch_ladder=(1, 8),
                               max_latency_s=0.001, max_queue=1024)
    else:
        eng = ServingEngine(mnist_mlp(hidden=(8,), input_dim=4,
                                      num_classes=3),
                            replicas=1, batch_ladder=(1, 8),
                            max_latency_s=0.001, max_queue=1024,
                            device="cpu")
    for r in (1, 8):
        eng.predict(_rows(r), timeout_s=120)
    return eng


class _Engine:
    """Replica count bookkeeping only: what the autoscaler reads and
    drives."""

    def __init__(self):
        self.n = 1

    def resize(self, n):
        self.n = n
        return n

    def stats(self):
        return {"replicas": self.n}


def _drive(pkg, engine, ring, firing=None, p99_at=None, **kw):
    """-> [(action, replicas)] per tick over ``ring``; ``firing[i]``
    forces ``slo.breaching()`` on tick i, ``p99_at`` pins a fat
    ``serve.predict_s`` p99 from that tick on."""
    cls, ts_mod, m_mod, slo_mod = PKGS[pkg]
    real = slo_mod.breaching
    verdict = []
    slo_mod.breaching = lambda: list(verdict)
    try:
        a = cls(engine, **kw)
        ts = ts_mod.series("serve.pending")
        out = []
        for i, v in enumerate(ring):
            ts.append(float(v))
            verdict[:] = (["serve_latency"]
                          if firing is not None and firing[i] else [])
            if p99_at is not None and i == p99_at:
                for _ in range(20):
                    m_mod.histogram("serve.predict_s").observe(5.0)
            out.append((a.tick(), engine.stats()["replicas"]))
        return out, a.resizes
    finally:
        slo_mod.breaching = real


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_gate_script_ticks(pkg):
    eng = _engine(pkg)
    try:
        got, resizes = _drive(pkg, eng, GATE_RING, **GATE_KW)
        assert eng.predict(_rows(4), timeout_s=60).shape == (4, 3)
    finally:
        eng.close()
    assert got == GATE_TICKS and resizes == 4


@pytest.mark.parametrize("seed", range(6))
def test_seeded_rings_match_the_jax_autoscaler(seed):
    rng = np.random.default_rng(seed)
    ring = np.concatenate([
        rng.integers(0, 4, size=20),                  # calm
        np.cumsum(rng.integers(0, 4, size=15)),       # a ramp
        rng.uniform(0, 12, size=30),                  # noise
        np.cumsum(rng.integers(1, 3, size=10)) + 8,   # a steep ramp
        rng.integers(0, 2, size=40)]).round(2)        # calm again
    firing = rng.random(ring.size) < 0.05
    kw = dict(floor=1, ceiling=int(rng.integers(2, 6)),
              depth_high=float(rng.uniform(4, 10)),
              samples=int(rng.integers(3, 6)),
              clear_checks=int(rng.integers(1, 5)),
              cooldown_checks=int(rng.integers(0, 3)),
              step=int(rng.integers(1, 3)), p99_high_s=1.0)
    p99_at = int(rng.integers(60, 100)) if seed % 2 else None
    runs = {pkg: _drive(pkg, _Engine(), ring, firing=firing,
                        p99_at=p99_at, **kw) for pkg in PKGS}
    assert runs["torch"] == runs["jax"]
    assert {a for a, _ in runs["torch"][0]} >= {"up", "down"}


# -- the autoscaler cases of tests/test_router.py -----------------------
def test_autoscaler_validates_bounds():
    eng = _engine("torch")
    try:
        with pytest.raises(ValueError):
            ReplicaAutoscaler(eng, floor=0, ceiling=2)
        with pytest.raises(ValueError):
            ReplicaAutoscaler(eng, floor=3, ceiling=2)
    finally:
        eng.close()


def test_autoscaler_holds_still_without_samples():
    eng = _engine("torch")
    try:
        a = ReplicaAutoscaler(eng, floor=1, ceiling=3, depth_high=8,
                              samples=4)
        assert a.tick() is None
        assert eng.stats()["replicas"] == 1
    finally:
        eng.close()


def test_autoscaler_ramp_actuates_noise_holds_calm_descends():
    eng = _engine("torch")
    try:
        a = ReplicaAutoscaler(eng, floor=1, ceiling=3, depth_high=8.0,
                              samples=4, clear_checks=3,
                              cooldown_checks=1, step=1)
        ts = timeseries.series("serve.pending")
        for v in (1.0, 3.0, 6.0):
            ts.append(v)
            assert a.tick() is None
        ts.append(9.0)
        assert a.tick() == "up"
        assert eng.stats()["replicas"] == 2
        ts.append(10.0)
        assert a.tick() is None
        for v in (3.0, 7.0, 2.5, 6.0):
            ts.append(v)
            assert a.tick() is None
        assert eng.stats()["replicas"] == 2
        downs = []
        for v in (1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0):
            ts.append(v)
            downs.append(a.tick())
        assert downs.count("down") == 1
        assert eng.stats()["replicas"] == 1
        assert a.resizes == 2
    finally:
        eng.close()


def test_autoscaler_ceiling_pins_and_p99_breach_scales():
    eng = _engine("torch")
    try:
        for _ in range(20):
            metrics.histogram("serve.predict_s").observe(5.0)
        a = ReplicaAutoscaler(eng, floor=1, ceiling=2, depth_high=1e9,
                              p99_high_s=0.5, samples=4,
                              cooldown_checks=0)
        assert a.tick() == "up"
        assert eng.stats()["replicas"] == 2
        assert a.tick() is None
        assert eng.stats()["replicas"] == 2
    finally:
        eng.close()
