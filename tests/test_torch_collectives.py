"""The port's collectives over the stacked worker dimension against the
JAX package's inside ``shard_map`` on ``conftest.py``'s virtual devices
(one worker per device): exact for integers, 1e-6 for floats.  Then
``AsyncMerge``'s one-in-flight bound and counters, the worker layout and
the communication backend's single-process path and its reading of the
launch environment (the cross-process half runs in
``test_torch_multiprocess.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dist_keras_tpu.parallel import collectives as jc
from dist_keras_tpu.parallel.mesh import WORKER_AXIS as JAXIS
from dist_keras_tpu.parallel.mesh import worker_mesh as jmesh
from dist_keras_tpu.utils.jax_compat import shard_map
from dist_keras_tpu_torch.comm import backend as comm
from dist_keras_tpu_torch.parallel import collectives as tc
from dist_keras_tpu_torch.parallel import mesh as tmesh
from dist_keras_tpu_torch.utils.pytree import tree_add, tree_merge_floats


def _tree(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(n, 3, 2)).astype(np.float32),
            "b": rng.normal(size=(n, 5)).astype(np.float32),
            "count": rng.integers(0, 50, size=(n, 2)).astype(np.int32)}


def _jax(fn, tree, n, out_spec):
    """``fn`` on each worker's slot inside shard_map over n devices."""
    def body(t):
        t = jax.tree.map(lambda a: a[0], t)
        t = jc.tree_pvary(t)
        return jax.tree.map(lambda a: a[None], fn(t))

    out = jax.jit(shard_map(body, mesh=jmesh(n), in_specs=(P(JAXIS),),
                            out_specs=out_spec))(
        jax.tree.map(jnp.asarray, tree))
    return jax.tree.map(np.asarray, out)


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _check(got, want):
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", ["tree_psum", "tree_pmean",
                                  "tree_pmean_sync"])
def test_reductions_match_jax(name, n):
    tree = _tree(n)
    if name == "tree_pmean":   # lax.pmean of an integer leaf is a float
        tree.pop("count")
    want = _jax(getattr(jc, name), tree, n, P())
    got = getattr(tc, name)(_torch(tree))
    _check(got, {k: v[0] for k, v in want.items()})


@pytest.mark.parametrize("n", [2, 4])
def test_all_gather_matches_jax(n):
    tree = _tree(n)
    want = _jax(jc.tree_all_gather, tree, n, P(JAXIS))
    got = tc.tree_all_gather(_torch(tree))
    for i in range(n):   # every worker's view is the whole stack
        _check(got, {k: v[i] for k, v in want.items()})


@pytest.mark.parametrize("perm", [
    [(0, 1), (1, 2), (2, 3), (3, 0)],   # a ring: roll by one
    [(0, 3), (3, 0)],                   # a swap; slots 1 and 2 get zeros
    [(1, 0), (2, 1), (3, 2)],           # a shift without wrap
], ids=["ring", "swap", "shift"])
def test_ppermute_matches_jax(perm):
    tree = _tree(4)
    want = _jax(lambda t: jc.tree_ppermute(t, perm), tree, 4, P(JAXIS))
    got = tc.tree_ppermute(_torch(tree), perm)
    _check(got, want)


def test_ppermute_ring_is_a_roll():
    x = torch.arange(12.0).reshape(4, 3)
    got = tc.tree_ppermute(x, [(i, (i + 1) % 4) for i in range(4)])
    assert torch.equal(got, torch.roll(x, 1, 0))
    with pytest.raises(ValueError, match="repeats"):
        tc.tree_ppermute(x, [(0, 1), (2, 1)])
    with pytest.raises(ValueError, match="outside"):
        tc.tree_ppermute(x, [(0, 4)])


def test_pmean_sync_handles_zero_size_leaves():
    tree = {"w": torch.stack([torch.full((4,), 1.0), torch.full((4,), 3.0)]),
            "empty": torch.zeros((2, 0)),
            "rng": torch.full((2, 2), 5, dtype=torch.int32)}
    out = tc.tree_pmean_sync(tree)
    assert torch.equal(out["w"], torch.full((4,), 2.0))
    assert out["empty"].shape == (0,)
    assert out["rng"].dtype == torch.int32
    assert out["rng"].tolist() == [5, 5]
    assert tc.axis_size(tree) == 2


# -- AsyncMerge --------------------------------------------------------------

def test_async_merge_submit_wait_roundtrip():
    am = tc.AsyncMerge(lambda c, d: tree_add(c, d))
    c = {"w": torch.ones(8), "b": torch.zeros(4)}
    d = {"w": torch.full((8,), 2.0), "b": torch.ones(4)}
    assert not am.pending
    am.submit(c, d)
    assert am.pending
    out = am.wait()
    assert not am.pending
    assert torch.equal(out["w"], torch.full((8,), 3.0))
    assert torch.equal(out["b"], torch.ones(4))
    # wait with nothing in flight returns the last result again
    assert am.wait() is out
    assert am.submits == 1 and am.waits == 1


def test_async_merge_keeps_one_merge_in_flight():
    am = tc.AsyncMerge(lambda c, d: tree_add(c, d))
    one = {"w": torch.ones(4)}
    am.submit({"w": torch.zeros(4)}, one)
    # a second submit retires the first (at most one in flight)
    am.submit(am._inflight, one)
    assert am.waits == 1 and am.pending
    out = am.wait()
    assert torch.equal(out["w"], torch.full((4,), 2.0))
    assert am.submits == 2 and am.waits == 2


def test_async_merge_waits_a_pending_reduce_through_its_work_alone(
        monkeypatch):
    """A merge returning a PendingReduce (the cross-rank async
    all-reduce) is waited through the collective's Work alone: no CUDA
    event is recorded or synchronized behind the work queued after it."""
    from dist_keras_tpu_torch.utils.pytree import tree_leaves

    class Work:
        waited = 0

        def wait(self):
            Work.waited += 1

    def no_event(tree):
        raise AssertionError("an event behind a PendingReduce")

    monkeypatch.setattr(tc, "_card_event", no_event)
    tree = {"a": torch.zeros(2), "b": torch.zeros(3)}
    leaves = tree_leaves(tree)
    flat = torch.arange(5.0)
    am = tc.AsyncMerge(lambda t: tc.PendingReduce(
        t, list(leaves), [(Work(), flat, [0, 1])]))
    am.submit(tree)
    assert am.pending and Work.waited == 0
    out = am.wait()
    assert Work.waited == 1 and not am.pending and am.waits == 1
    assert out["a"].tolist() == [0.0, 1.0]
    assert out["b"].tolist() == [2.0, 3.0, 4.0]


def test_async_merge_mixed_dtype_and_zero_size_leaves():
    am = tc.AsyncMerge(lambda c, p: tree_merge_floats(tree_add(c, p), c))
    c = {"f32": torch.ones(4), "bf16": torch.ones(4, dtype=torch.bfloat16),
         "rng": torch.tensor([3, 7], dtype=torch.int32),
         "empty": torch.zeros(0)}
    p = {"f32": torch.full((4,), 0.5),
         "bf16": torch.full((4,), 0.5, dtype=torch.bfloat16),
         "rng": torch.tensor([9, 9], dtype=torch.int32),
         "empty": torch.zeros(0)}
    out = am.submit(c, p).wait()
    assert out["f32"].dtype == torch.float32
    assert out["bf16"].dtype == torch.bfloat16
    assert torch.equal(out["f32"], torch.full((4,), 1.5))
    assert out["rng"].tolist() == [3, 7]
    assert out["empty"].shape == (0,)


# -- the worker layout and the backend --------------------------------------

def test_worker_mesh_describes_stacked_slots():
    m = tmesh.worker_mesh(12, "cpu")
    assert m.shape == {"workers": 12} and m.size == 12
    assert m.axis_names == (tmesh.WORKER_AXIS,) == ("workers",)
    assert m.device == torch.device("cpu")
    with pytest.raises(ValueError):
        tmesh.worker_mesh(0, "cpu")


def test_backend_is_single_process(monkeypatch):
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                 "JAX_PROCESS_ID", "WORLD_SIZE", "MASTER_ADDR", "RANK"):
        monkeypatch.delenv(name, raising=False)
    comm.initialize()
    assert comm.group_info() is None
    assert comm.num_processes() == 1 and comm.process_index() == 0
    assert not comm.is_multi_host()
    assert comm.local_data_slice(10) == (0, 10)
    assert comm.local_data_slice(10, process=1, count=3) == (3, 6)
    assert comm.barrier() == 1
    assert comm.global_devices() == comm.local_devices()
    out = comm.fetch_global({"a": torch.arange(3), "b": [torch.ones(2)]})
    assert isinstance(out["a"], np.ndarray) and out["a"].tolist() == [0, 1, 2]
    # a group needs a rendezvous and this process's id: asking without
    # them is an actionable error, not a lone process
    with pytest.raises(ValueError, match="process_id"):
        comm.initialize(coordinator_address="h:1")
    with pytest.raises(ValueError, match="coordinator"):
        comm.initialize(num_processes=2)
    comm.initialize(num_processes=1)
    assert comm.group_info() is None


@pytest.mark.parametrize("env,want", [
    ({"JAX_COORDINATOR_ADDRESS": "h:1234", "JAX_NUM_PROCESSES": "4",
      "JAX_PROCESS_ID": "2"}, ("tcp://h:1234", 4, 2)),
    ({"JAX_COORDINATOR_ADDRESS": "file:///tmp/rdv", "JAX_NUM_PROCESSES": "2",
      "JAX_PROCESS_ID": "1"}, ("file:///tmp/rdv", 2, 1)),
    ({"JAX_NUM_PROCESSES": "1"}, None),
    ({"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500", "WORLD_SIZE": "4",
      "RANK": "3"}, ("env://", 4, 3))],
    ids=["jax_tcp", "jax_file", "jax_one_process", "torchrun"])
def test_backend_reads_the_multi_host_environment(monkeypatch, env, want):
    """``launch.Job``'s JAX_* variables (host:port -> a tcp://
    rendezvous, a URL as it is) and torchrun's are the group's
    rendezvous; one process is the single-process no-op."""
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                 "JAX_PROCESS_ID", "WORLD_SIZE", "MASTER_ADDR", "RANK"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert comm._rendezvous_from(None, None, None) == want


@pytest.mark.parametrize("env,missing", [
    ({"WORLD_SIZE": "2"}, "MASTER_ADDR, MASTER_PORT, RANK"),
    ({"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500", "WORLD_SIZE": "2"},
     "RANK"),
    ({"MASTER_ADDR": "10.0.0.1", "WORLD_SIZE": "4", "RANK": "3"},
     "MASTER_PORT"),
    ({"RANK": "1"}, "MASTER_ADDR, MASTER_PORT, WORLD_SIZE")],
    ids=["world_alone", "no_rank", "no_port", "rank_alone"])
def test_backend_refuses_a_partial_torchrun_environment(monkeypatch, env,
                                                        missing):
    """A torchrun world of several processes (or a rank past 0) without
    the rest of its rendezvous is an actionable ValueError naming what
    is missing, never a lone process training on its own."""
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                 "JAX_PROCESS_ID", "WORLD_SIZE", "MASTER_ADDR",
                 "MASTER_PORT", "RANK"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=f"without {missing}:"):
        comm._rendezvous_from(None, None, None)
    with pytest.raises(ValueError, match="torchrun"):
        comm.initialize()
    assert comm.group_info() is None


@pytest.mark.parametrize("local_world,cards,on_cpu,want", [
    (1, 0, False, "gloo"), (2, 0, False, "gloo"), (1, 1, False, "nccl"),
    (2, 1, False, "gloo"), (2, 2, False, "nccl"), (4, 8, False, "nccl"),
    (8, 4, False, "gloo"), (1, 1, True, "gloo"), (2, 2, True, "gloo")])
def test_backend_selection_rule(local_world, cards, on_cpu, want):
    """NCCL only when each rank on the host has a card of its own; gloo
    on the CPU and when ranks share a card (NCCL refuses two ranks on
    one device).  ``local_world`` ranks take the ``cards`` of one host
    round-robin, as ``initialize`` deals them; the rule reads the
    ranks' card keys."""
    keys = [f"host/card-{r % cards}" if cards else None
            for r in range(local_world)]
    assert comm.select_backend(keys, on_cpu) == want


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("workers", range(1, 10))
def test_local_worker_range_deals_every_worker_once(workers, world):
    """The trainers' worker range is ``local_data_slice`` over the
    workers: contiguous, in rank order, the last rank taking the
    remainder; a rank left with none raises naming the counts."""
    got, empty = [], 0
    for rank in range(world):
        lo, hi = comm.local_data_slice(workers, process=rank, count=world)
        if hi <= lo:
            empty += 1
            with pytest.raises(ValueError, match=f"num_workers={workers}"):
                tmesh.worker_mesh(workers, "cpu", rank=rank, world=world)
            continue
        m = tmesh.worker_mesh(workers, "cpu", rank=rank, world=world)
        assert (m.lo, m.hi, m.num_local) == (lo, hi, hi - lo)
        assert hi - lo == (workers // world if rank < world - 1
                           else workers - (world - 1) * (workers // world))
        got.extend(range(lo, hi))
    assert got == list(range(workers))
    assert empty == (world - 1 if workers < world else 0)
