"""The port's ``PSWorkerTrainer`` (``dist_keras_tpu_torch/ps/worker.py``)
against the JAX package's, on the CPU.

One worker makes staleness 0 at every commit, so the run is
deterministic: the port's worker against the port's server and against
the JAX server, from the JAX model's initial weights, gives the JAX
worker's ``commit_log`` exactly, its loss history within 1e-5 (relative)
and its final center within 1e-5 (absolute) — sgd in f32, no dropout,
window 4, 2 epochs of 32 batches on the blobs set of ``gates.py``.
What the port's worker sends is numpy, never a tensor.  The rest ports
the reference's worker tests (``tests/test_ps.py``): two threads with
real staleness, the over-cap re-pull, the late joiner, compression.
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from dist_keras_tpu.models import mnist_mlp as jmnist_mlp
from dist_keras_tpu.ps import PSServer as JServer
from dist_keras_tpu.ps import PSWorkerTrainer as JWorker
from dist_keras_tpu_torch.data import (
    AccuracyEvaluator,
    Dataset,
    LabelIndexTransformer,
    ModelPredictor,
)
from dist_keras_tpu_torch.models import mnist_mlp
from dist_keras_tpu_torch.observability import metrics
from dist_keras_tpu_torch.ps import PSClient, PSServer, PSWorkerTrainer
from dist_keras_tpu_torch.utils.bridge import params_to_numpy
from dist_keras_tpu_torch.utils.pytree import tree_leaves

ROOT = Path(__file__).resolve().parent.parent
JOIN_S = 300
ARCH = dict(hidden=(16,), input_dim=8, num_classes=2)


def _blobs_columns():
    """The blobs set of ``gates.py``'s PS gate (512 rows, 8 features)."""
    rng = np.random.default_rng(0)
    n, d = 512, 8
    y = rng.integers(0, 2, size=n)
    centers = np.stack([np.full(d, -1.0), np.full(d, 1.0)])
    x = (centers[y] + rng.normal(size=(n, d))).astype(np.float32)
    return {"features": x, "label": y,
            "label_encoded": np.eye(2, dtype=np.float32)[y]}


@pytest.fixture(scope="module")
def blobs():
    return Dataset(_blobs_columns())


def _models():
    jm = jmnist_mlp(seed=0, **ARCH)
    tm = mnist_mlp(**ARCH)
    tm.set_weights(jm.get_weights())
    return jm, tm


COMMON = dict(communication_window=4, worker_optimizer="sgd",
              optimizer_kwargs={"learning_rate": 0.05}, batch_size=16,
              num_epoch=2, label_col="label_encoded")


def _worker(srv, seed=0, model=None, **kw):
    args = {**COMMON, **kw}
    return PSWorkerTrainer(
        model if model is not None else mnist_mlp(**ARCH),
        server_addr=f"{srv.address[0]}:{srv.address[1]}", seed=seed,
        device="cpu", **args)


def _accuracy(model, ds):
    pred = ModelPredictor(model, features_col="features",
                          device="cpu").predict(ds)
    idx = LabelIndexTransformer(input_col="prediction").transform(pred)
    return AccuracyEvaluator(prediction_col="prediction_index",
                             label_col="label").evaluate(idx)


class _NumpyOnlyClient(PSClient):
    """The real client, refusing any commit whose delta holds anything
    but numpy arrays: a tensor must never reach the wire."""

    def commit(self, wid, version, delta, **kw):
        bad = [type(a).__name__ for a in tree_leaves(delta)
               if type(a) is not np.ndarray]
        assert not bad, f"non-numpy leaves on the wire: {bad}"
        return super().commit(wid, version, delta, **kw)


def _phase_counts():
    hists = metrics.snapshot()["histograms"]
    return {p: hists.get(f"perf.phase.{p}", {"count": 0})["count"]
            for p in ("ps_steps", "ps_delta", "ps_encode", "ps_commit",
                      "ps_merge")}


def _center_by_key(center):
    """{(layer, key): array} — the JAX package sorts each layer's keys,
    the port keeps init's order, so compare by key."""
    return {(i, k): np.asarray(v) for i, p in enumerate(center)
            for k, v in p.items()}


@pytest.mark.parametrize("server_side", ["port", "jax"])
def test_one_worker_matches_the_jax_worker(blobs, server_side):
    jm, tm = _models()
    cols = _blobs_columns()
    from dist_keras_tpu.data import Dataset as JDataset

    jsrv = JServer(params=jm.params, port=0, window=4)
    jsrv.start()
    try:
        jt = JWorker(jm, server_addr=f"{jsrv.address[0]}:"
                     f"{jsrv.address[1]}", seed=0, **COMMON)
        jt.train(JDataset(cols))
        _, jcenter = jsrv.center.state()
    finally:
        jsrv.close()
    srv = (PSServer(params=tm.params, port=0, window=4)
           if server_side == "port"
           else JServer(params=jm.params, port=0, window=4))
    srv.start()
    try:
        addr = f"{srv.address[0]}:{srv.address[1]}"
        t = _worker(srv, model=tm, client=_NumpyOnlyClient(addr))
        assert t.device.type == "cpu"
        before = _phase_counts()
        out = t.train(blobs)
        after = _phase_counts()
        _, center = srv.center.state()
    finally:
        srv.close()
    assert len(t.commit_log) == len(jt.commit_log) == 16
    assert t.commit_log == jt.commit_log
    assert all(s == 0 for _, s, _ in t.commit_log)
    th, jh = np.asarray(t.get_history()), np.asarray(jt.get_history())
    assert th.shape == jh.shape == (64,)
    np.testing.assert_allclose(th, jh, rtol=1e-5)
    assert th[-8:].mean() < th[:8].mean()
    got, want = _center_by_key(center), _center_by_key(jcenter)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0)
    # the returned model is the final center
    for k, v in _center_by_key(params_to_numpy(out.params)).items():
        np.testing.assert_array_equal(v, got[k])
    assert t.commit_bytes["raw"] == t.commit_bytes["wire"] == 16 * sum(
        a.nbytes for a in want.values())
    assert [m["epoch"] for m in t.metrics] == [1, 2]
    # every window's wall lands in the perf.phase.ps_* histograms
    assert {p: after[p] - before[p] for p in after} == {
        p: 16 for p in after}


def test_two_workers_learn_with_real_staleness(blobs):
    srv = PSServer(params=mnist_mlp(**ARCH).params, port=0, window=4)
    srv.start()
    try:
        trainers = [_worker(srv, seed=i) for i in range(2)]
        models, errs = {}, []

        def run(i):
            try:
                models[i] = trainers[i].train(blobs)
            # the thread must record, not swallow: the assert re-raises
            except Exception as e:  # noqa: BLE001 - test harness
                errs.append(e)

        ths = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=JOIN_S)
        assert not any(th.is_alive() for th in ths)
        assert not errs, errs
        for m in models.values():
            assert _accuracy(m, blobs) > 0.9
        st = srv.center.stats()
        assert st["workers"] == 2
        assert st["clock"] == sum(w["commits"]
                                  for w in st["per_worker"].values())
        assert any(s > 0 for t in trainers for _, s, _ in t.commit_log)
        _, center = srv.center.state()
        final = mnist_mlp(**ARCH)
        final.set_params([{k: torch.from_numpy(v) for k, v in p.items()}
                          for p in center])
        assert _accuracy(final, blobs) > 0.9
    finally:
        srv.close()


class _RivalClient(PSClient):
    """Before every odd commit of the worker, a rival commits a zero
    delta first — the worker's version is then stale by exactly 1."""

    def __init__(self, addr):
        super().__init__(addr, attempts=2, backoff=0.01)
        self._n = 0
        self._rival = None

    def commit(self, wid, version, delta, **kw):
        self._n += 1
        if self._n % 2 == 1:
            if self._rival is None:
                self._rival = super().join()["wid"]
            fresh = super().pull(self._rival)
            zero = [{k: np.zeros_like(v) for k, v in p.items()}
                    for p in delta]
            super().commit(self._rival, fresh["version"], zero)
        return super().commit(wid, version, delta, **kw)


def test_worker_over_cap_re_pulls_and_completes(blobs):
    srv = PSServer(params=mnist_mlp(**ARCH).params, port=0, window=4,
                   staleness_cap=0)
    srv.start()
    try:
        t = _worker(srv, num_epoch=1, client=_RivalClient(
            f"{srv.address[0]}:{srv.address[1]}"))
        model = t.train(blobs)
        assert t.stale_rejections == 4
        assert len(t.commit_log) == 4
        assert all(s == 0 for _, s, _ in t.commit_log)
        assert model is not None
    finally:
        srv.close()


def test_late_joiner_pulls_and_goes(blobs):
    srv = PSServer(params=mnist_mlp(**ARCH).params, port=0, window=4)
    srv.start()
    try:
        _worker(srv, num_epoch=1).train(blobs)
        clock_before = srv.center.clock
        assert clock_before == 8
        late = _worker(srv, seed=1, num_epoch=1)
        late.train(blobs)
        assert late.commit_log[0][0] - 1 >= clock_before
        assert late.commit_log[0][1] == 0
    finally:
        srv.close()


def test_int8_compression_ratio_and_the_center_still_learns(
        blobs, monkeypatch):
    monkeypatch.setenv("DK_PS_COMPRESS", "int8")
    srv = PSServer(params=mnist_mlp(**ARCH).params, port=0, window=4)
    srv.start()
    try:
        t = _worker(srv, num_epoch=3)
        t.train(blobs)
        ratio = t.commit_bytes["raw"] / t.commit_bytes["wire"]
        assert ratio >= 2.0, t.commit_bytes
        _, center = srv.center.state()
        final = mnist_mlp(**ARCH)
        final.set_params([{k: torch.from_numpy(v) for k, v in p.items()}
                          for p in center])
        assert _accuracy(final, blobs) > 0.9
    finally:
        srv.close()
    with pytest.raises(ValueError, match="malformed DK_PS_COMPRESS"):
        PSWorkerTrainer(mnist_mlp(**ARCH), compress="int3", device="cpu")


def test_ps_worker_takes_coord_world_and_the_rest_refuse(monkeypatch):
    from dist_keras_tpu_torch.trainers import ADAG, SingleTrainer

    monkeypatch.setenv("DK_COORD_WORLD", "2")
    monkeypatch.setenv("DK_COORD_RANK", "1")
    t = PSWorkerTrainer(mnist_mlp(**ARCH), server_addr="127.0.0.1:1",
                        device="cpu")
    assert t._coord_rank() == 1
    with pytest.raises(NotImplementedError, match="12b"):
        SingleTrainer(mnist_mlp(**ARCH), device="cpu")
    with pytest.raises(NotImplementedError, match="12b"):
        ADAG(mnist_mlp(**ARCH), num_workers=2, device="cpu")


def test_ps_worker_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PSWorkerTrainer(mnist_mlp(**ARCH), server_addr="127.0.0.1:1")
    assert PSWorkerTrainer(mnist_mlp(**ARCH), server_addr="127.0.0.1:1",
                           device="cpu").device.type == "cpu"


def test_ps_package_import_is_worker_lazy():
    code = (
        "import sys\n"
        "import dist_keras_tpu_torch.ps\n"
        "assert 'dist_keras_tpu_torch.ps.worker' not in sys.modules\n"
        "assert 'dist_keras_tpu_torch.trainers.base' not in sys.modules\n"
        "from dist_keras_tpu_torch.ps import PSWorkerTrainer\n"
        "assert 'dist_keras_tpu_torch.ps.worker' in sys.modules\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in\n"
        "            ('jax', 'dist_keras_tpu')]\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-500:]
