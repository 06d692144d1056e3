"""Checkpoints across the two packages (CPU).

- a step the JAX ``Checkpointer`` wrote — chunked and ``state.pkl``;
  f32, int32 and uint32 leaves, an optax optimizer state — restores in
  the port bit-equal, its optax state unpickled into placeholders with
  no optax import, and ``utils/bridge.opt_state_from_optax`` gives the
  port's layout for every optimizer of the registry;
- one port optimizer step from that state equals one reference step
  from it (same gradients; each update leaf within 1e-6 of its largest
  entry: f32 rounding of ``sqrt``/division orders, which a momentum
  trace's cancellation leaves visible only next to zero);
- a port-written step passes the reference's ``verify_manifest`` and
  ``Checkpointer.verify``;
- a reference two-host step reshards onto one host in the port;
- what the port cannot read is refused typed: a reference bf16 leaf
  pickled into ``small.pkl``, an orbax-format step, and any pickled
  class outside the restricted unpickler's allow-list."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_keras_tpu import checkpoint as jckpt
from dist_keras_tpu.ops.optimizers import get_optimizer as jopt
from dist_keras_tpu_torch import checkpoint as tckpt
from dist_keras_tpu_torch.ops.optimizers import get_optimizer as topt
from dist_keras_tpu_torch.utils.bridge import (
    opt_state_from_optax,
    params_from_jax,
)

REGISTRY = [
    ("sgd", {}), ("sgd", {"momentum": 0.9}), ("sgd", {"warmup_steps": 3}),
    ("sgd", {"momentum": 0.9, "warmup_steps": 3}), ("adam", {}),
    ("nadam", {}), ("adamw", {}), ("adagrad", {}),
    ("adagrad", {"warmup_steps": 2}), ("rmsprop", {}),
    ("rmsprop", {"momentum": 0.9}), ("adadelta", {})]


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return [{"kernel": rng.normal(size=(24, 40)).astype(np.float32),
             "bias": rng.normal(size=(40,)).astype(np.float32)},
            {"kernel": rng.normal(size=(40, 5)).astype(np.float32),
             "bias": np.zeros(5, np.float32)}]


def _grads(seed):
    return jax.tree.map(
        lambda p: np.random.default_rng(seed).normal(
            size=p.shape).astype(np.float32), _params())


def _reference_state(name, kw, steps=3):
    """The reference optimizer's state after ``steps`` updates, with
    numpy leaves."""
    tx = jopt(name, **kw)
    params = jax.tree.map(jnp.asarray, _params())
    state = tx.init(params)
    for i in range(steps):
        upd, state = tx.update(jax.tree.map(jnp.asarray, _grads(i)),
                               state, params)
        params = jax.tree.map(lambda p, u: p + u, params, upd)
    return (jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, state))


def _jax_save(directory, step, state, fmt, monkeypatch):
    if fmt == "chunked":
        monkeypatch.setenv("DK_CKPT_CHUNK_MB", "0.001")
    else:
        monkeypatch.setenv("DK_CKPT_CHUNK_MB", "0")
    ck = jckpt.Checkpointer(directory)
    if fmt == "state.pkl":
        ck._ckpt = None   # the reference's writer without orbax
    ck.save(step, state).wait(timeout_s=60)
    monkeypatch.delenv("DK_CKPT_CHUNK_MB")
    return ck


def _assert_tree_equal(got, want):
    gl, _ = tckpt._flatten(got)
    wl, _ = tckpt._flatten(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (p, g), (_, w) in zip(gl, wl):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == np.asarray(w).dtype, p
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=p)


@pytest.mark.parametrize("fmt", ["chunked", "state.pkl"])
def test_a_reference_step_restores_bit_equal(tmp_path, monkeypatch, fmt):
    params, opt = _reference_state("adam", {})
    state = {"params": params, "opt_state": opt,
             "ids": np.arange(3000, dtype=np.int32),
             "rng": np.asarray(jax.random.PRNGKey(7)),
             "u": np.arange(2000, dtype=np.uint32) * np.uint32(77777),
             "t_units": np.zeros((), np.int32)}
    _jax_save(str(tmp_path), 4, state, fmt, monkeypatch)
    payload = tmp_path / "step_00000004"
    assert (payload / ("chunks.json" if fmt == "chunked"
                       else "state.pkl")).exists()
    ck = tckpt.Checkpointer(str(tmp_path))
    assert ck.verify(4) == "ok"
    step, got = ck.restore()
    assert step == 4
    # optax's NamedTuples came back as placeholders, by name and field
    s0, s1 = got["opt_state"]
    assert isinstance(s0, tckpt.OptaxState)
    assert (s0.type_name, s0._fields) == ("ScaleByAdamState",
                                          ("count", "mu", "nu"))
    assert s1.type_name == "EmptyState"
    _assert_tree_equal(got, state)
    assert "optax" not in repr(type(s0).__module__)


@pytest.mark.parametrize("name,kw", REGISTRY,
                         ids=[f"{n}{'-' + '-'.join(k) if k else ''}"
                              for n, k in REGISTRY])
def test_optax_state_converts_and_steps_like_the_reference(
        tmp_path, monkeypatch, name, kw):
    """Through the reference's checkpoint: the restored optax state
    converts to the port's layout (the same tree the port's own init
    builds) and one more step from it equals one reference step."""
    params, opt = _reference_state(name, kw)
    _jax_save(str(tmp_path), 1, {"params": params, "opt_state": opt},
              "chunked", monkeypatch)
    _, got = tckpt.Checkpointer(str(tmp_path)).restore()
    t_state = opt_state_from_optax(name, got["opt_state"])
    t_params = params_from_jax(got["params"], "cpu")
    ttx = topt(name, **kw)
    like = ttx.init(t_params)
    assert (tckpt._treedef_str(tckpt._flatten(t_state)[1])
            == tckpt._treedef_str(tckpt._flatten(like)[1]))
    # one step each, from the same state with the same gradients
    g = _grads(11)
    jtx = jopt(name, **kw)
    j_upd, j_state = jtx.update(jax.tree.map(jnp.asarray, g),
                                jax.tree.map(jnp.asarray, opt),
                                jax.tree.map(jnp.asarray, params))
    t_upd, t_new = ttx.update(params_from_jax(g, "cpu"), t_state, t_params)
    for a, b in zip(jax.tree.leaves(j_upd),
                    [x for _, x in tckpt._flatten(t_upd)[0]]):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-6 * float(np.abs(a).max()))
    # the new states agree too, read through the same conversion
    want = opt_state_from_optax(name, jax.tree.map(np.asarray, j_state))
    got_l, want_l = (tckpt._flatten(t)[0] for t in (t_new, want))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (p, b), (_, a) in zip(got_l, want_l):
        a = a.numpy()
        assert b.dtype == torch.from_numpy(a).dtype, p
        np.testing.assert_allclose(b.numpy(), a, rtol=0, err_msg=p,
                                   atol=1e-6 * float(np.abs(a).max()))


def test_opt_state_from_optax_refuses_a_foreign_chain():
    _, opt = _reference_state("adam", {})
    with pytest.raises(ValueError, match="not what the registry's 'sgd'"):
        opt_state_from_optax("sgd", opt)
    with pytest.raises(ValueError, match="no optax conversion"):
        opt_state_from_optax("lion", opt)


@pytest.mark.parametrize("env", [
    {"DK_CKPT_CHUNK_MB": "0.001"}, {"DK_CKPT_CHUNK_MB": "0"},
    {"DK_CKPT_CHUNK_MB": "0.001", "DK_CKPT_DIFF": "1"}],
    ids=["chunked", "state.pkl", "differential"])
def test_a_port_step_passes_the_reference_manifest_check(
        tmp_path, monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    state = {"w": torch.randn(64, 33), "h": torch.ones(900).to(
        torch.bfloat16), "i": torch.arange(500, dtype=torch.int64),
        "g": torch.Generator().manual_seed(1).get_state(),
        "n": np.arange(7, dtype=np.uint32), "s": 3}
    ck = tckpt.Checkpointer(str(tmp_path))
    ck.save(9, state).wait(timeout_s=60)
    payload = str(tmp_path / "step_00000009")
    assert jckpt.verify_manifest(payload) == ("ok", [])
    assert jckpt.Checkpointer(str(tmp_path)).verify(9) == "ok"
    _, got = ck.restore()
    assert torch.equal(got["h"].view(torch.int16),
                       state["h"].view(torch.int16))
    np.testing.assert_array_equal(got["w"], state["w"].numpy())
    np.testing.assert_array_equal(got["g"], state["g"].numpy())


def test_a_reference_two_host_step_reshards_onto_one_host(tmp_path):
    """The reference's world-2 two-phase save with shard specs: the port
    (world 1) gathers the shards by the keystr paths of
    shard_meta.json, bit-equal to the global state."""
    from dist_keras_tpu.resilience import elastic as jel

    full = {"params": [{"kernel": np.arange(96, dtype=np.float32)
                        .reshape(12, 8), "bias": np.arange(8.0)}],
            "opt": (np.arange(12 * 8, dtype=np.float64).reshape(12, 8),),
            "step": np.int64(4)}
    specs = {"params": [{"kernel": 0, "bias": None}], "opt": (0,),
             "step": None}
    for rank in (1, 0):
        local = {"params": [{"kernel": jel.split_leaf(
            full["params"][0]["kernel"], 0, 2, rank),
            "bias": full["params"][0]["bias"]}],
            "opt": (jel.split_leaf(full["opt"][0], 0, 2, rank),),
            "step": full["step"]}
        jckpt.Checkpointer(str(tmp_path), rank=rank, world=2).save(
            6, local, shard_specs=specs).wait(timeout_s=60)
    ck = tckpt.Checkpointer(str(tmp_path), rank=0, world=1)
    assert ck.saved_world(6) == 2
    step, got = ck.restore()
    assert step == 6
    _assert_tree_equal(got, full)
    # and the same payload resharded for a port world of 3, rank 2
    _, third = tckpt.Checkpointer(str(tmp_path), rank=2, world=3).restore()
    np.testing.assert_array_equal(third["params"][0]["kernel"],
                                  full["params"][0]["kernel"][8:])


def test_a_reference_bf16_leaf_in_small_pkl_is_refused_naming_it(
        tmp_path, monkeypatch):
    import ml_dtypes

    _jax_save(str(tmp_path), 2, {"big": np.arange(4096, dtype=np.float32),
                                 "tiny": {"b": np.ones(
                                     3, ml_dtypes.bfloat16)}},
              "chunked", monkeypatch)
    ck = tckpt.Checkpointer(str(tmp_path))
    assert ck.verify(2) == "ok"   # the bytes are fine: only the format
    with pytest.raises(tckpt.CheckpointFormatError,
                       match=r"\['tiny'\]\['b'\] is a bfloat16"):
        ck.restore()


def test_a_reference_bf16_chunked_leaf_restores_as_torch_bf16(
        tmp_path, monkeypatch):
    import ml_dtypes

    w = np.linspace(-3, 3, 5000, dtype=np.float32).astype(
        ml_dtypes.bfloat16)
    _jax_save(str(tmp_path), 3, {"w": w}, "chunked", monkeypatch)
    _, got = tckpt.Checkpointer(str(tmp_path)).restore()
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["w"].view(torch.int16).numpy(), w.view(np.int16))


def test_an_orbax_step_is_refused_typed(tmp_path, monkeypatch):
    if not jckpt._HAVE_ORBAX:
        pytest.skip("orbax is not installed: the reference cannot write "
                    "an orbax-format step here")
    monkeypatch.setenv("DK_CKPT_CHUNK_MB", "0")
    jckpt.Checkpointer(str(tmp_path)).save(
        1, {"w": np.arange(10.0)}).wait(timeout_s=60)
    with pytest.raises(tckpt.CheckpointFormatError, match="orbax"):
        tckpt.Checkpointer(str(tmp_path)).restore(verify=False)


class _Evil:
    def __reduce__(self):
        return (os.getcwd, ())


def test_the_unpickler_refuses_classes_outside_its_allow_list(tmp_path):
    ck = tckpt.Checkpointer(str(tmp_path))
    ck.save(1, {"w": np.arange(3)}).wait(timeout_s=60)
    payload = tmp_path / "step_00000001"
    (payload / "small.pkl").write_bytes(pickle.dumps({"w": _Evil()}))
    with pytest.raises(tckpt.CheckpointFormatError, match="getcwd"):
        ck.restore(verify=False)
