"""The port's workers across processes against the JAX package, on the CPU.

Each rank is a fresh ``python`` subprocess that imports only the port
(no jax, as on the card's host) and brings up a gloo
``torch.distributed`` group through a ``file://`` rendezvous under
``tmp_path`` (no TCP port, so parallel test workers cannot collide).
The JAX reference runs in the pytest process on ``conftest.py``'s 8
virtual CPU devices; the weights cross through ``utils/bridge.py``.

- Parity (``tests/test_multihost.py``'s config: ``mnist_mlp(hidden=(16,),
  input_dim=8, num_classes=2)``, 8 workers, window 4, sgd 0.05, batch 16,
  2 epochs, seed 0, its blobs): two ranks x 4 workers train DOWNPOUR,
  ADAG, AEASGD, EAMSGD, DynSGD, AveragingTrainer and EnsembleTrainer
  (``num_models=8``) in one launch; every rank's final weights equal
  each other and the JAX single-process 8-device run's within
  ``atol=1e-5`` (the JAX test's tolerance), the history has the JAX
  shape.  AEASGD and EAMSGD keep the reference's rho=5.0: on this run
  both packages stay finite (a NaN would never compare as a match).
  The same launch trains the four windowed trainers overlapped
  (``comm_overlap=True``: each window's async all-reduce waited at the
  next boundary), held to the port's one-process overlapped run.
- Three uneven ranks (2 / 2 / 4 workers) of ADAG against the same JAX
  run, plus the unit checks that need real processes (``fetch_global``
  over uneven leading sizes, the group coordinator's consensus, the
  cross-rank reductions, a disagreeing ``DK_COORD_WORLD``, the
  ``comm.init`` and ``barrier`` events in the run report per rank), in
  one launch.
- ``barrier``'s deadline and poisoning with a rank that never arrives,
  under a 2 s ``DK_COORD_TIMEOUT_S``.
- Coordinated preemption, the JAX package's
  ``test_two_process_coordinated_preemption_and_bit_equal_resume`` on
  synthetic data: two ``SingleTrainer`` ranks under ``DK_COORD_DIR``,
  then ADAG over 2 ranks x 2 workers voting through the group
  coordinator; a SIGTERM to rank 0 at epoch 2, both exit 143 at one
  agreed step with a ``preempt`` flight dump each, and the resumed pair
  is bit-equal to the uninterrupted one.

Every launch has its own ``communicate(timeout=...)`` and every group a
timeout (``DK_COORD_TIMEOUT_S``), so no test can hang the suite.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 240     # each launch's communicate()
GROUP_TIMEOUT_S = "60"     # each group's DK_COORD_TIMEOUT_S

ARCH = dict(hidden=(16,), input_dim=8, num_classes=2)
COMMON = dict(worker_optimizer="sgd", optimizer_kwargs={"learning_rate": 0.05},
              batch_size=16, num_epoch=2, label_col="label_encoded", seed=0)
TRAINERS = {
    "DOWNPOUR": dict(num_workers=8, communication_window=4),
    "ADAG": dict(num_workers=8, communication_window=4),
    "AEASGD": dict(num_workers=8, communication_window=4),
    "EAMSGD": dict(num_workers=8, communication_window=4),
    "DynSGD": dict(num_workers=8, communication_window=4),
    "AveragingTrainer": dict(num_workers=8),
    "EnsembleTrainer": dict(num_models=8),
}
# the windowed trainers overlapped (DK_COMM_OVERLAP): across ranks each
# window's all-reduce is in flight until the next window's boundary
OVERLAPPED = {f"{n}+overlap": dict(TRAINERS[n], cls=n, comm_overlap=True)
              for n in ("DOWNPOUR", "ADAG", "AEASGD", "EAMSGD")}

_RANK = r'''
import json, os, signal, sys, time
rank, world, job = int(sys.argv[1]), int(sys.argv[2]), json.loads(sys.argv[3])
os.environ["DK_COORD_TIMEOUT_S"] = job.get("timeout", "60")
for k, v in job.get("env", {}).items():
    os.environ[k] = v.replace("{rank}", str(rank))
if job.get("group", True):
    os.environ["JAX_COORDINATOR_ADDRESS"] = "file://" + job["rdv"]
    os.environ["JAX_NUM_PROCESSES"] = str(world)
    os.environ["JAX_PROCESS_ID"] = str(rank)
sys.path.insert(0, job["repo"])
import numpy as np
import torch
torch.set_num_threads(1)
from dist_keras_tpu_torch import comm
from dist_keras_tpu_torch import trainers as tt
from dist_keras_tpu_torch.data.dataset import Dataset
from dist_keras_tpu_torch.models import mnist_mlp
from dist_keras_tpu_torch.utils.bridge import params_from_jax, params_to_numpy
comm.initialize(device="cpu")
assert "jax" not in sys.modules and "dist_keras_tpu" not in sys.modules
out = job["out"]

def blobs():
    rng = np.random.default_rng(0)
    n, d = 512, 8
    y = rng.integers(0, 2, size=n)
    centers = np.stack([np.full(d, -1.0), np.full(d, 1.0)])
    x = centers[y] + rng.normal(size=(n, d)).astype(np.float32)
    return Dataset({"features": x.astype(np.float32),
                    "label_encoded": np.eye(2, dtype=np.float32)[y],
                    "label": y})

def start_model():
    w = np.load(job["weights"])
    layers = sorted({int(k.split("/")[0]) for k in w.files})
    tree = [{k.split("/")[1]: w[k] for k in w.files
             if int(k.split("/")[0]) == i} for i in layers]
    m = mnist_mlp(**job["arch"])
    m.set_params(params_from_jax(tree, "cpu"))
    return m

def flat(prefix, model):
    return {f"{prefix}{i}/{k}": v for i, layer in
            enumerate(params_to_numpy(model.params)) for k, v in layer.items()}

def train(name, kw):
    kw = dict(kw)
    t = getattr(tt, kw.pop("cls", name))(start_model(), device="cpu",
                                         **job["common"], **kw)
    got = t.train(blobs())
    arrays = {}
    for j, m in enumerate(got if isinstance(got, list) else [got]):
        arrays.update(flat(f"m{j}/", m))
    arrays["history"] = np.asarray(t.get_history())
    np.savez(os.path.join(out, f"{name}_{rank}.npz"), **arrays)
    return t

for name, kw in job.get("trainers", {}).items():
    t = train(name, kw)
    print("TRAINED", name, t.mesh.lo, t.mesh.hi, flush=True)

if job.get("units"):
    from dist_keras_tpu_torch.parallel import collectives
    from dist_keras_tpu_torch.resilience import coordination
    res = {}
    # uneven leading sizes: rank r contributes r + 1 rows
    x = {"a": torch.full((rank + 1, 2), float(rank)),
         "n": torch.tensor(rank), "h": torch.ones(rank + 1, dtype=torch.bfloat16)}
    g = comm.fetch_global(x)
    res["a"] = g["a"].tolist()
    res["n"] = g["n"].tolist()
    res["h"] = list(g["h"].shape)
    c = coordination.get_coordinator()
    res["coord"] = type(c).__name__
    res["ids"] = [coordination.rank(), coordination.world()]
    res["any"] = c.any_flag(rank == world - 1)
    res["all"] = c.all_ok(rank != 0)
    res["min"] = c.agree_min(10 + rank)
    res["barrier"] = comm.barrier("units")
    stacked = {"w": torch.full((rank + 1, 3), float(rank + 1)),
               "c": torch.full((rank + 1,), rank, dtype=torch.int32)}
    res["psum"] = collectives.tree_psum(stacked)["w"].tolist()
    total = world * (world + 1) // 2
    res["pmean"] = collectives.tree_pmean({"w": stacked["w"]},
                                          total=total)["w"].tolist()
    sync = collectives.tree_pmean_sync(stacked, total=total)
    try:
        collectives.tree_pmean(stacked)
        res["no_total"] = None
    except ValueError as e:
        res["no_total"] = str(e)
    res["sync"] = [sync["w"].tolist(), sync["c"].item()]
    os.environ["DK_COORD_WORLD"] = str(world + 1)
    try:
        tt.ADAG(mnist_mlp(**job["arch"]), num_workers=8, device="cpu")
        res["disagree"] = None
    except ValueError as e:
        res["disagree"] = str(e)
    del os.environ["DK_COORD_WORLD"]
    print("UNITS " + json.dumps(res), flush=True)

if job.get("barrier_deadline"):
    from dist_keras_tpu_torch.resilience import coordination
    if rank == 1:
        time.sleep(6)          # never arrives within the deadline
        os._exit(0)
    t0 = time.perf_counter()
    try:
        comm.barrier("late")
        verdict = "returned"
    except (coordination.BarrierTimeout, coordination.PeerLost) as e:
        verdict = type(e).__name__
    waited = time.perf_counter() - t0
    try:
        comm.barrier("again")
        again = "returned"
    except coordination.CoordinatorPoisoned:
        again = "CoordinatorPoisoned"
    print("BARRIER " + json.dumps([verdict, waited, again]), flush=True)
    os._exit(0)

if job.get("run"):
    # SingleTrainer / ADAG with checkpoints; SIGTERM to rank 0 at epoch 2
    spec = job["run"]
    rng = np.random.default_rng(1)
    y = rng.integers(0, 10, 256)
    x = (np.eye(10, 64)[y] + 0.3 * rng.normal(size=(256, 64))).astype(np.float32)
    ds = Dataset({"features": x, "label_encoded": np.eye(10, dtype=np.float32)[y]})
    from dist_keras_tpu_torch.models import layers, model as tmodel
    m = tmodel.Sequential([layers.Dense(16, activation="relu"), layers.Dense(10)])
    m.build((64,), seed=0)
    mode = spec["mode"]

    def kill_cb(trainer, epoch, logs):
        if mode == "preempt" and rank == 0 and epoch == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    extra = dict(checkpoint_dir=spec["ckpt"], checkpoint_every=2,
                 max_checkpoints=10, handle_preemption=True,
                 resume=(mode == "resume"), callbacks=[kill_cb]) \
        if mode != "full" else {}
    t = getattr(tt, spec["trainer"])(
        m, loss="categorical_crossentropy", worker_optimizer="adam",
        batch_size=16, label_col="label_encoded", seed=3, num_epoch=4,
        device="cpu", **spec.get("kw", {}), **extra)
    got = t.train(ds)
    np.savez(os.path.join(out, f"{spec['trainer']}_{mode}_{rank}.npz"),
             **flat("", got))
print("DONE", rank, flush=True)
comm.shutdown()
'''


def _launch(tmp_path, tag, world, job, env=None):
    """Start ``world`` ranks of the rank program on ``job``; ->
    [(returncode, output)] per rank."""
    d = tmp_path / tag
    d.mkdir()
    script = tmp_path / "rank.py"
    if not script.exists():
        script.write_text(_RANK)
    job = dict(job, repo=REPO, rdv=str(d / "rdv"), out=str(d))
    job.setdefault("timeout", GROUP_TIMEOUT_S)
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("JAX_", "XLA_", "DK_"))
            and k not in ("PYTHONPATH", "WORLD_SIZE", "RANK", "MASTER_ADDR",
                          "MASTER_PORT", "LOCAL_RANK")}
    base["PYTHONPATH"] = REPO
    base.update(env or {})
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), json.dumps(job)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=base,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LAUNCH_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _ok(results):
    for r, (rc, o) in enumerate(results):
        assert rc == 0, f"rank {r} rc={rc}:\n{o[-4000:]}"


def _line(output, prefix):
    (line,) = [ln for ln in output.splitlines() if ln.startswith(prefix)]
    return json.loads(line[len(prefix):])


# ---------------------------------------------------------------------------
# the JAX reference: one process, 8 virtual devices
# ---------------------------------------------------------------------------
def _jax_blobs():
    from dist_keras_tpu.data import Dataset
    from dist_keras_tpu.utils.misc import one_hot

    rng = np.random.default_rng(0)
    n, d = 512, 8
    y = rng.integers(0, 2, size=n)
    centers = np.stack([np.full(d, -1.0), np.full(d, 1.0)])
    x = centers[y] + rng.normal(size=(n, d)).astype(np.float32)
    return Dataset({"features": x.astype(np.float32),
                    "label_encoded": one_hot(y, 2), "label": y})


def _torch_blobs():
    """The same blobs as the port's Dataset (the rank program's)."""
    from dist_keras_tpu_torch.data.dataset import Dataset

    rng = np.random.default_rng(0)
    n, d = 512, 8
    y = rng.integers(0, 2, size=n)
    centers = np.stack([np.full(d, -1.0), np.full(d, 1.0)])
    x = centers[y] + rng.normal(size=(n, d)).astype(np.float32)
    return Dataset({"features": x.astype(np.float32),
                    "label_encoded": np.eye(2, dtype=np.float32)[y],
                    "label": y})


def _by_key(params, prefix=""):
    """A params tree (list of layer dicts) -> {"<prefix><i>/<key>": array}
    (the JAX package sorts each layer's keys, the port keeps init's
    order: compare by key)."""
    return {f"{prefix}{i}/{k}": np.asarray(v) for i, layer in
            enumerate(params) for k, v in layer.items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """-> (weights npz path, {trainer: (final weights by key, history
    shape)}) of the JAX runs from one set of initial weights."""
    import jax

    from dist_keras_tpu import trainers as jt
    from dist_keras_tpu.models import mnist_mlp as jmlp

    assert jax.device_count() == 8
    d = tmp_path_factory.mktemp("jax_ref")
    start = jmlp(**ARCH)
    init = jax.tree.map(np.asarray, start.params)
    wpath = str(d / "init.npz")
    np.savez(wpath, **_by_key(init))
    ref = {}
    for name, kw in TRAINERS.items():
        m = jmlp(**ARCH)
        m.params = jax.tree.map(np.array, init)
        t = getattr(jt, name)(m, **COMMON, **kw)
        got = t.train(_jax_blobs())
        models = got if isinstance(got, list) else [got]
        final = {}
        for j, jm in enumerate(models):
            final.update(_by_key(jax.tree.map(np.asarray, jm.params),
                                 f"m{j}/"))
        ref[name] = (final, np.asarray(t.get_history()).shape)
    return wpath, ref


@pytest.fixture(scope="module")
def two_ranks(reference, tmp_path_factory):
    """One launch of two ranks x 4 workers training every trainer in
    turn; -> the launch's directory."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    results = _launch(tmp, "parity", 2, dict(
        trainers={**TRAINERS, **OVERLAPPED}, weights=reference[0],
        arch=ARCH, common=COMMON))
    _ok(results)
    return tmp / "parity", results


@pytest.mark.parametrize("name", list(TRAINERS))
def test_two_ranks_of_four_workers_match_the_jax_run(two_ranks, reference,
                                                     name):
    out, results = two_ranks
    want, hist_shape = reference[1][name]
    ranks = [np.load(out / f"{name}_{r}.npz") for r in (0, 1)]
    # each rank stacked its contiguous half of the 8 slots
    slots = 8 if name != "EnsembleTrainer" else 2
    for r, (_, o) in enumerate(results):
        assert f"TRAINED {name} {r * slots // 2} {(r + 1) * slots // 2}" in o
    for got in ranks:
        assert got["history"].shape == hist_shape
        assert np.all(np.isfinite(got["history"]))
        assert set(want) <= set(got.files)
        for k, w in want.items():
            assert np.all(np.isfinite(got[k])), k
            np.testing.assert_allclose(got[k], w, atol=1e-5, err_msg=k)
    for k in want:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    np.testing.assert_array_equal(ranks[0]["history"], ranks[1]["history"])


@pytest.mark.parametrize("name", list(OVERLAPPED))
def test_two_ranks_overlapped_match_the_one_process_overlapped_run(
        two_ranks, reference, name):
    """The overlapped split run (each window's async all-reduce waited
    at the next boundary) against the same trainer overlapped in one
    process of the port, 8 workers stacked, from the same weights."""
    import torch

    from dist_keras_tpu_torch import trainers as tt
    from dist_keras_tpu_torch.models import mnist_mlp as tmlp
    from dist_keras_tpu_torch.utils.bridge import (
        params_from_jax,
        params_to_numpy,
    )

    out, results = two_ranks
    w = np.load(reference[0])
    layers = sorted({int(k.split("/")[0]) for k in w.files})
    start = tmlp(**ARCH)
    start.set_params(params_from_jax([
        {k.split("/")[1]: w[k] for k in w.files if int(k.split("/")[0]) == i}
        for i in layers], "cpu"))
    kw = dict(OVERLAPPED[name])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t = getattr(tt, kw.pop("cls"))(start, device="cpu", **COMMON, **kw)
        one = t.train(_torch_blobs())
    finally:
        torch.set_num_threads(threads)
    want = _by_key(params_to_numpy(one.params), "m0/")
    ranks = [np.load(out / f"{name}_{r}.npz") for r in (0, 1)]
    for r, (_, o) in enumerate(results):
        assert f"TRAINED {name} {r * 4} {(r + 1) * 4}" in o
    for got in ranks:
        assert got["history"].shape == np.asarray(t.get_history()).shape
        for k, v in want.items():
            assert np.all(np.isfinite(got[k])), k
            np.testing.assert_allclose(got[k], v, atol=1e-5, err_msg=k)
    for k in want:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    # the overlap changes the algebra (one window stale): the run differs
    # from the blocked one, which the split blocked run matched above
    blocked = np.load(out / f"{OVERLAPPED[name]['cls']}_0.npz")
    assert any(not np.allclose(blocked[k], want[k], atol=1e-5)
               for k in want)


def test_three_uneven_ranks_and_the_group_units(reference, tmp_path):
    """ADAG over 3 ranks of 2 / 2 / 4 workers against the JAX run; in the
    same launch the checks that need real processes."""
    obs = tmp_path / "obs"
    results = _launch(tmp_path, "three", 3, dict(
        trainers={"ADAG": TRAINERS["ADAG"]}, weights=reference[0],
        arch=ARCH, common=COMMON, units=True,
        env={"DK_OBS_DIR": str(obs)}))
    _ok(results)
    # every rank's log: the bring-up (a coord event, op comm.init) and
    # the barrier, read by the run report per rank and op
    from dist_keras_tpu_torch.observability import report

    evs = report.read_events(str(obs))
    s = report.summarize(evs)
    assert sorted(s["ranks"]) == [0, 1, 2]
    assert s["coord"]["comm.init"]["count"] == 3
    assert s["coord"]["comm.barrier(units)"]["count"] == 3
    inits = [e for e in evs if e["kind"] == "coord"
             and e["op"] == "comm.init"]
    assert sorted(e["rank"] for e in inits) == [0, 1, 2]
    assert {(e["backend"], e["device"], e["world"]) for e in inits} \
        == {("gloo", "cpu", 3)}
    want, hist_shape = reference[1]["ADAG"]
    for r, (lo, hi) in enumerate([(0, 2), (2, 4), (4, 8)]):
        assert f"TRAINED ADAG {lo} {hi}" in results[r][1]
        got = np.load(tmp_path / "three" / f"ADAG_{r}.npz")
        assert got["history"].shape == hist_shape
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, atol=1e-5, err_msg=k)
    for r, (_, o) in enumerate(results):
        u = _line(o, "UNITS ")
        assert u["a"] == [[0.0, 0.0], [1.0, 1.0], [1.0, 1.0],
                          [2.0, 2.0], [2.0, 2.0], [2.0, 2.0]]
        assert u["n"] == [0, 1, 2] and u["h"] == [6]
        assert u["coord"] == "GroupCoordinator" and u["ids"] == [r, 3]
        assert (u["any"], u["all"], u["min"]) == (True, False, 10)
        assert u["barrier"] == 3
        # rows: rank r holds r + 1 workers of value r + 1 -> 1 + 4 + 9
        assert u["psum"] == [14.0] * 3
        assert u["pmean"] == pytest.approx([14.0 / 6] * 3)
        assert u["sync"][0] == pytest.approx([14.0 / 6] * 3)
        assert u["sync"][1] == 2
        assert "pass total=" in u["no_total"]
        assert "DK_COORD_WORLD=4 disagrees" in u["disagree"]


def test_barrier_deadline_and_poisoning(tmp_path):
    """A rank that never arrives: the barrier gives up typed within the
    2 s DK_COORD_TIMEOUT_S, and every later barrier is poisoned."""
    results = _launch(tmp_path, "late", 2, dict(barrier_deadline=True,
                                                 timeout="2"))
    _ok(results)
    verdict, waited, again = _line(results[0][1], "BARRIER ")
    assert verdict in ("BarrierTimeout", "PeerLost")
    assert 1.5 < waited < 6.0
    assert again == "CoordinatorPoisoned"


# ---------------------------------------------------------------------------
# coordinated preemption: SingleTrainer under DK_COORD_DIR, ADAG 2 x 2
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("trainer", ["SingleTrainer", "ADAG"])
def test_two_rank_preemption_and_bit_equal_resume(tmp_path, trainer):
    ck = str(tmp_path / "ck")
    kw = {"num_workers": 4, "communication_window": 2} \
        if trainer == "ADAG" else {}
    # Single: plain processes voting through a shared directory; ADAG:
    # a gloo group (workers split 2 + 2) voting through the group
    group = trainer == "ADAG"

    def job(mode):
        env = {"DK_OBS_DIR": str(tmp_path / f"obs_{mode}")}
        if not group:
            env.update(DK_COORD_DIR=str(tmp_path / "coord"),
                       DK_COORD_RANK="{rank}", DK_COORD_WORLD="2",
                       DK_COORD_SESSION=mode)
        return dict(group=group, env=env,
                    run=dict(trainer=trainer, mode=mode, ckpt=ck, kw=kw))

    full = _launch(tmp_path, "full", 2, job("full"))
    _ok(full)
    pre = _launch(tmp_path, "preempt", 2, job("preempt"))
    for r, (rc, o) in enumerate(pre):
        assert rc == 128 + signal.SIGTERM, f"rank {r} rc={rc}:\n{o[-4000:]}"
    from dist_keras_tpu_torch.checkpoint import Checkpointer

    # units: SingleTrainer steps (16 an epoch), ADAG windows (2 an epoch)
    per_epoch = 16 if trainer == "SingleTrainer" else 2
    assert Checkpointer(ck, rank=0, world=2).all_steps() == [2 * per_epoch]
    obs = tmp_path / "obs_preempt"
    for r in (0, 1):
        (dump,) = obs.glob(f"flightrec-rank_{r}-*-preempt.json")
        doc = json.loads(dump.read_text())
        assert doc["fields"]["units_done"] == 2 * per_epoch
    res = _launch(tmp_path, "resume", 2, job("resume"))
    _ok(res)
    for r in (0, 1):
        want = np.load(tmp_path / "full" / f"{trainer}_full_{r}.npz")
        got = np.load(tmp_path / "resume" / f"{trainer}_resume_{r}.npz")
        assert set(got.files) == set(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# one worker a rank: four ranks x 1 worker, the JAX package's worker_mesh(4)
# ---------------------------------------------------------------------------
FOUR = {"ADAG": dict(num_workers=4, communication_window=4),
        "ADAG+overlap": dict(num_workers=4, communication_window=4,
                             cls="ADAG", comm_overlap=True)}


@pytest.fixture(scope="module")
def four_ranks(reference, tmp_path_factory):
    """One launch of four ranks x 1 worker training ADAG blocked and
    overlapped; -> (the launch's directory, its results)."""
    tmp = tmp_path_factory.mktemp("four_ranks")
    results = _launch(tmp, "four", 4, dict(
        trainers=FOUR, weights=reference[0], arch=ARCH, common=COMMON))
    _ok(results)
    return tmp / "four", results


@pytest.mark.parametrize("name", list(FOUR))
def test_four_ranks_of_one_worker_match_the_jax_four_device_run(
        four_ranks, reference, name):
    """ADAG over 4 gloo ranks, one worker each (the stacked dim is 1 on
    every rank), against the JAX package's 4-worker run on 4 virtual
    devices from the same weights (``comm_overlap`` as in the split run:
    each window's all-reduce in flight until the next boundary), within
    the JAX test's 1e-5."""
    import jax

    from dist_keras_tpu import trainers as jt
    from dist_keras_tpu.models import mnist_mlp as jmlp

    out, results = four_ranks
    kw = dict(FOUR[name])
    cls = kw.pop("cls", name)
    w = np.load(reference[0])
    layers = sorted({int(k.split("/")[0]) for k in w.files})
    m = jmlp(**ARCH)
    m.params = [{k.split("/")[1]: np.array(w[k]) for k in w.files
                 if int(k.split("/")[0]) == i} for i in layers]
    t = getattr(jt, cls)(m, **COMMON, **kw)
    want = _by_key(jax.tree.map(np.asarray, t.train(_jax_blobs()).params),
                   "m0/")
    ranks = [np.load(out / f"{name}_{r}.npz") for r in range(4)]
    for r, (_, o) in enumerate(results):
        assert f"TRAINED {name} {r} {r + 1}" in o
    for got in ranks:
        assert got["history"].shape == np.asarray(t.get_history()).shape
        for k, v in want.items():
            assert np.all(np.isfinite(got[k])), k
            np.testing.assert_allclose(got[k], v, atol=1e-5, err_msg=k)
    for k in want:
        for got in ranks[1:]:
            np.testing.assert_array_equal(ranks[0][k], got[k], err_msg=k)
