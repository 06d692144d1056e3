"""The port's collectives over the stacked worker dimension against the
JAX package's inside ``shard_map`` on ``conftest.py``'s virtual devices
(one worker per device): exact for integers, 1e-6 for floats.  Then
``AsyncMerge``'s one-in-flight bound and counters, the worker layout and
the single-process communication backend."""

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
                 "JAX_PROCESS_ID", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    comm.initialize()
    assert comm.num_processes() == 1 and comm.process_index() == 0
    assert not comm.is_multi_host()
    assert comm.local_data_slice(10) == (0, 10)
    assert comm.local_data_slice(10, process=1, count=3) == (3, 6)
    assert comm.barrier() == 1
    out = comm.fetch_global({"a": torch.arange(3), "b": [torch.ones(2)]})
    assert isinstance(out["a"], np.ndarray) and out["a"].tolist() == [0, 1, 2]
    with pytest.raises(NotImplementedError, match="item 12b"):
        comm.initialize(coordinator_address="h:1")
    with pytest.raises(NotImplementedError, match="item 12b"):
        comm.initialize(num_processes=2)
    comm.initialize(num_processes=1)


@pytest.mark.parametrize("env", [
    {"JAX_COORDINATOR_ADDRESS": "h:1234"}, {"JAX_NUM_PROCESSES": "2"},
    {"JAX_PROCESS_ID": "1"}, {"WORLD_SIZE": "4"}],
    ids=lambda e: next(iter(e)))
def test_backend_refuses_the_multi_host_environment(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match="item 12b"):
        comm.initialize()
