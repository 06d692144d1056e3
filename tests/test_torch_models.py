"""The port's Sequential and zoo against the JAX package's (CPU, f32).

- the four zoo models' forward (``training=False``) on the reference's
  weights: 1e-5 relative to the largest logit (same math, different
  BLAS / conv kernels);
- a JAX ``serialize_model`` dict deserializes in the port into a model
  computing the same function (same bound), and back;
- ``to_json`` is the JAX package's, string for string."""

import json
import sys

import jax
import numpy as np
import pytest
import torch

from dist_keras_tpu.models import layers as jl
from dist_keras_tpu.models import model as jmodel
from dist_keras_tpu.models import zoo as jz
from dist_keras_tpu.utils import serialization as jser
from dist_keras_tpu_torch.models import layers as tl
from dist_keras_tpu_torch.models import model as tmodel
from dist_keras_tpu_torch.models import zoo as tz
from dist_keras_tpu_torch.utils import serialization as tser
from dist_keras_tpu_torch.utils.bridge import params_from_jax, params_to_numpy

TOL = 1e-5
ZOO = [("mnist_mlp", (784,)), ("mnist_cnn", (28, 28, 1)),
       ("higgs_mlp", (28,)), ("cifar10_convnet", (32, 32, 3))]


@pytest.fixture(scope="module", params=ZOO, ids=[z[0] for z in ZOO])
def zoo_pair(request):
    name, shape = request.param
    return getattr(jz, name)(), getattr(tz, name)(), shape


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max()) / float(
        np.abs(want).max())
    assert err <= tol, f"relative error {err:.3g} > {tol}"


def test_zoo_forward_matches_jax(zoo_pair):
    jm, tm, shape = zoo_pair
    tm.set_params(params_from_jax(jm.params, "cpu"))
    x = np.random.default_rng(0).random((3, *shape), dtype=np.float32)
    want = jm.apply(jm.params, x, training=False)
    with torch.no_grad():
        got = tm.apply(tm.params, torch.from_numpy(x), training=False)
        called = tm(x, device="cpu")
    _close(got.numpy(), want)
    assert torch.equal(got, called)
    np.testing.assert_array_equal(tm.predict(x, device="cpu"), got.numpy())
    # other batch sizes take other BLAS blockings: equal up to rounding
    _close(tm.predict(x, batch_size=2, device="cpu"), got.numpy(), 1e-6)


def test_zoo_json_and_weights_match_jax(zoo_pair):
    jm, tm, shape = zoo_pair
    assert tm.to_json() == jm.to_json()
    assert tm.count_params == jm.count_params
    assert tm.input_shape == tuple(jm.input_shape) == shape
    assert tm.output_shape == tuple(jm.output_shape)
    assert [w.shape for w in tm.get_weights()] == [
        w.shape for w in jm.get_weights()]
    assert all(w.dtype == np.float32 for w in tm.get_weights())


def test_jax_serialized_model_deserializes_in_the_port(zoo_pair):
    jm, _, shape = zoo_pair
    d = jser.serialize_model(jm)
    tm = tser.deserialize_model(d)
    assert isinstance(tm, tmodel.Sequential)
    x = np.random.default_rng(1).random((2, *shape), dtype=np.float32)
    _close(tm.predict(x, device="cpu"), jm.predict(x))
    # and back: the port's dict deserializes in the JAX package
    back = jser.deserialize_model(tser.serialize_model(tm))
    for a, b in zip(back.get_weights(), jm.get_weights()):
        np.testing.assert_array_equal(a, b)


def test_set_weights_round_trip_and_errors():
    m = tz.mnist_mlp(hidden=(8,), input_dim=6)
    w = [np.full_like(a, i) for i, a in enumerate(m.get_weights())]
    m.set_weights(w)
    for a, b in zip(m.get_weights(), w):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        m.set_weights([np.zeros((2, 2), np.float32)] + w[1:])
    with pytest.raises(ValueError, match="used"):
        m.set_weights(w + [w[0]])
    with pytest.raises(RuntimeError, match="not built"):
        tmodel.Sequential([tl.Dense(3)]).get_weights()


def test_model_from_json_builds_the_reference_architecture():
    m = tz.mnist_cnn()
    m2 = tmodel.model_from_json(m.to_json())
    assert m2.to_json() == m.to_json()
    assert [type(a) for a in m2.layers] == [type(a) for a in m.layers]
    with pytest.raises(ValueError, match="Unsupported"):
        tmodel.model_from_json(json.dumps({"class_name": "Functional"}))


def test_unported_branches_of_deserialize_raise(monkeypatch):
    # item 18 landed: Keras JSON goes to the Keras adapter, on the device
    # asked for; without Keras its ImportError says what to install
    from dist_keras_tpu_torch.models import keras_adapter

    keras_like = {"model": json.dumps({"class_name": "Sequential",
                                       "layers": [{"class_name": "Keras"}]}),
                  "weights": [np.zeros(2, np.float32)]}
    seen = []
    with monkeypatch.context() as m:
        m.setattr(keras_adapter, "from_keras_json",
                  lambda js, weights=None, device=None:
                  seen.append((js, weights, device)) or "adapter")
        assert tser.deserialize_model(keras_like, device="cpu") == "adapter"
    assert seen == [(keras_like["model"], keras_like["weights"], "cpu")]
    monkeypatch.setitem(sys.modules, "keras", None)
    for call in (lambda: tser.deserialize_model(keras_like, device="cpu"),
                 lambda: keras_adapter.from_keras_json("{}", device="cpu"),
                 lambda: keras_adapter.KerasModelAdapter(object(),
                                                         device="cpu")):
        with pytest.raises(ImportError, match="pip install") as e:
            call()
        assert "KERAS_BACKEND=torch" in str(e.value)
    # item 25 landed: the reference's Transformer JSON (dense and MoE)
    # deserializes into the port's Transformer, computing the same logits
    from dist_keras_tpu.models.transformer import Transformer as JT
    from dist_keras_tpu_torch.models.transformer import Transformer as TT

    x = np.random.default_rng(0).normal(size=(2, 8, 4)).astype(np.float32)
    for moe in (0, 2):
        jm = JT(input_dim=4, seq_len=8, d_model=16, n_heads=2, n_layers=1,
                n_classes=3, moe_experts=moe, seed=1)
        tm = tser.deserialize_model(jser.serialize_model(jm), device="cpu")
        assert isinstance(tm, TT) and tm.cfg == jm.cfg
        _close(tm(torch.from_numpy(x)).detach().numpy(), jm(x))
        again = tser.deserialize_model(tser.serialize_model(tm),
                                       device="cpu")
        for a, b in zip(again.get_weights(), jm.get_weights()):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_params_tree_has_the_reference_layout():
    jm = jmodel.Sequential([jl.Dense(4), jl.BatchNorm(), jl.Dense(2)])
    jm.build((3,))
    tm = tmodel.Sequential([tl.Dense(4), tl.BatchNorm(), tl.Dense(2)])
    tm.build((3,))
    assert [sorted(p) for p in tm.params] == [sorted(p) for p in jm.params]
    assert tm.has_state() and jm.has_state()
    tm.set_params(params_from_jax(jm.params, "cpu"))
    for a, b in zip(jax.tree.leaves(params_to_numpy(tm.params)),
                    jax.tree.leaves(jm.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    trainable, state = tm.split_state(tm.params)
    assert [list(s) for s in state] == [[], ["moving_mean", "moving_var"],
                                        []]
    assert "moving_mean" not in trainable[1]
    cast = tm.cast_params(tm.params, torch.bfloat16)
    assert cast[1]["gamma"].dtype == torch.bfloat16
    assert cast[1]["moving_var"].dtype == torch.float32
    # the module holds the same tensors: state as buffers
    assert {n for n, _ in tm.named_buffers()} == {
        "layers.1.moving_mean", "layers.1.moving_var"}


def test_build_is_seeded_and_device_free():
    a, b = tz.mnist_mlp(seed=3), tz.mnist_mlp(seed=3)
    c = tz.mnist_mlp(seed=4)
    assert all(np.array_equal(x, y)
               for x, y in zip(a.get_weights(), b.get_weights()))
    assert not np.array_equal(a.get_weights()[0], c.get_weights()[0])
    assert all(p.device.type == "cpu" for p in a.parameters())
