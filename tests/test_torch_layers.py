"""The port's layers against the JAX package's, on the reference's weights
carried across with ``params_from_jax`` (CPU, f32).

Tolerances: forwards 1e-5 relative to the largest entry of the JAX
output (the same math through different BLAS / conv kernels);
gradients 1e-5 likewise.  Dropout cannot reproduce the reference's
threefry bits, so its keep rate is checked statistically: 5 standard
deviations of a binomial over 2**18 draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_keras_tpu.models import layers as jl
from dist_keras_tpu_torch.models import layers as tl
from dist_keras_tpu_torch.utils.bridge import params_from_jax

TOL = 1e-5


def _pair(name, **cfg):
    return getattr(jl, name)(**cfg), getattr(tl, name)(**cfg)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max()) / scale
    assert err <= tol, f"relative error {err:.3g} > {tol}"


def _init(jlayer, tlayer, in_shape, seed=0):
    params, out_shape = jlayer.init(jax.random.PRNGKey(seed), in_shape)
    _, t_shape = tlayer.init(torch.Generator().manual_seed(seed), in_shape)
    assert tuple(t_shape) == tuple(out_shape)
    return jax.tree.map(np.asarray, params), tuple(out_shape)


LAYERS = [
    ("Dense", dict(units=7, activation="relu"), (5,)),
    ("Dense", dict(units=3, use_bias=False), (4, 6)),
    ("Conv2D", dict(filters=4, kernel_size=3, padding="same"), (9, 9, 3)),
    ("Conv2D", dict(filters=4, kernel_size=2, padding="same"), (8, 8, 2)),
    ("Conv2D", dict(filters=3, kernel_size=(3, 2), strides=2,
                    padding="same", activation="tanh"), (9, 8, 2)),
    ("Conv2D", dict(filters=3, kernel_size=4, strides=2, padding="same"),
     (10, 10, 2)),
    ("Conv2D", dict(filters=5, kernel_size=3, padding="valid"), (7, 8, 2)),
    ("Conv2D", dict(filters=2, kernel_size=2, strides=2, padding="valid",
                    activation="relu"), (7, 7, 3)),
    ("MaxPool2D", dict(pool_size=2), (8, 8, 3)),
    ("MaxPool2D", dict(pool_size=3, strides=2, padding="same"), (9, 8, 2)),
    ("MaxPool2D", dict(pool_size=2, padding="same"), (7, 7, 2)),
    ("AvgPool2D", dict(pool_size=2), (8, 6, 3)),
    ("AvgPool2D", dict(pool_size=3, strides=2, padding="same"), (9, 8, 2)),
    ("AvgPool2D", dict(pool_size=2, padding="same"), (7, 7, 2)),
    ("Flatten", {}, (4, 3, 2)),
    ("Reshape", dict(target_shape=(3, 8)), (24,)),
    ("LayerNorm", {}, (6,)),
    ("LayerNorm", dict(epsilon=1e-3), (3, 6)),
    ("BatchNorm", {}, (6,)),
    ("BatchNorm", dict(momentum=0.9), (4, 4, 3)),
]


@pytest.mark.parametrize("name,cfg,in_shape", LAYERS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(LAYERS)])
@pytest.mark.parametrize("training", [False, True])
def test_forward_matches_jax(name, cfg, in_shape, training):
    jlayer, tlayer = _pair(name, **cfg)
    params, _ = _init(jlayer, tlayer, in_shape)
    if name == "BatchNorm":   # moving stats away from their init values
        rng = np.random.default_rng(5)
        params["moving_mean"] = rng.normal(size=in_shape[-1:]).astype(
            np.float32)
        params["moving_var"] = rng.uniform(0.5, 2, in_shape[-1:]).astype(
            np.float32)
    # MaxPool: distinct values, so no window has a tied maximum
    x = np.random.default_rng(1).permutation(
        np.arange(3 * np.prod(in_shape))).reshape(3, *in_shape).astype(
            np.float32) / 10 - 3
    want, jstate = jlayer.apply_with_state(params, jnp.asarray(x),
                                           training=training)
    got, tstate = tlayer.apply_with_state(
        params_from_jax(params, "cpu"), torch.from_numpy(x),
        training=training)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.numpy(), want)
    assert sorted(tstate) == sorted(jstate)
    for k in jstate:
        _close(tstate[k].numpy(), jstate[k])
        assert tstate[k].dtype == torch.float32


def test_batchnorm_state_stays_f32_under_bf16():
    jlayer, tlayer = _pair("BatchNorm")
    params, _ = _init(jlayer, tlayer, (6,))
    tp = params_from_jax(params, "cpu")
    tp = {k: v.to(torch.bfloat16) if k in ("gamma", "beta") else v
          for k, v in tp.items()}
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(8, 6)).astype(np.float32)).to(torch.bfloat16)
    y, state = tlayer.apply_with_state(tp, x, training=True)
    assert y.dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in state.values())


def test_embedding_matches_jax():
    jlayer, tlayer = _pair("Embedding", input_dim=11, output_dim=5)
    params, out_shape = _init(jlayer, tlayer, (4,))
    assert out_shape == (4, 5)
    idx = np.random.default_rng(0).integers(0, 11, size=(3, 4))
    want = jlayer.apply(params, jnp.asarray(idx, jnp.int32))
    got = tlayer.apply(params_from_jax(params, "cpu"), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("act", sorted(tl._ACTIVATIONS))
def test_activation_matches_jax(act):
    x = np.linspace(-6, 6, 97).astype(np.float32).reshape(1, 97)
    want = jl.Activation(act).apply({}, jnp.asarray(x))
    got = tl.Activation(act).apply({}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=1e-6)


GRAD_LAYERS = [
    ("Dense", dict(units=5, activation="tanh"), (6,)),
    ("Conv2D", dict(filters=3, kernel_size=3, padding="same",
                    activation="relu"), (6, 6, 2)),
    ("Conv2D", dict(filters=3, kernel_size=2, strides=2, padding="same"),
     (7, 6, 2)),
    ("MaxPool2D", dict(pool_size=2), (6, 6, 2)),
    ("MaxPool2D", dict(pool_size=3, strides=2, padding="same"), (7, 7, 2)),
    ("AvgPool2D", dict(pool_size=2), (6, 6, 2)),
    ("AvgPool2D", dict(pool_size=3, strides=2, padding="same"), (7, 7, 2)),
    ("LayerNorm", {}, (7,)),
]


@pytest.mark.parametrize("name,cfg,in_shape", GRAD_LAYERS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(GRAD_LAYERS)])
def test_gradients_match_jax(name, cfg, in_shape):
    jlayer, tlayer = _pair(name, **cfg)
    params, out_shape = _init(jlayer, tlayer, in_shape)
    if name == "LayerNorm":   # non-trivial scale and shift
        rng = np.random.default_rng(3)
        params = {k: rng.normal(size=v.shape).astype(np.float32)
                  for k, v in params.items()}
    rng = np.random.default_rng(2)
    # untied inputs: the pools' gradient at a tied maximum differs
    x = rng.permutation(np.arange(2 * np.prod(in_shape))).reshape(
        2, *in_shape).astype(np.float32) / 7 - 1
    w = rng.normal(size=(2, *out_shape)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jlayer.apply(p, xx) * w)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in
          params_from_jax(params, "cpu").items()}
    tx = torch.from_numpy(x).requires_grad_()
    (tlayer.apply(tp, tx) * torch.from_numpy(w)).sum().backward()
    _close(tx.grad.numpy(), jgx)
    for k in params:
        _close(tp[k].grad.numpy(), jgp[k])


@pytest.mark.parametrize("rate", [0.25, 0.5, 0.3])
def test_dropout_keep_rate_and_scaling(rate):
    layer = tl.Dropout(rate)
    x = torch.ones(512, 512)
    gen = torch.Generator().manual_seed(0)
    y = layer.apply({}, x, training=True, generator=gen)
    keep = 1.0 - rate
    kept = (y != 0)
    n = x.numel()
    sd = np.sqrt(n * keep * (1 - keep))
    assert abs(int(kept.sum()) - n * keep) < 5 * sd
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / keep))
    # a second draw from the same generator is another mask
    y2 = layer.apply({}, x, training=True, generator=gen)
    assert not torch.equal(y, y2)
    # off in inference, and a training call needs a generator
    assert layer.apply({}, x, training=False) is x
    with pytest.raises(ValueError, match="generator"):
        layer.apply({}, x, training=True)


def test_glorot_uniform_lies_within_the_keras_limit():
    gen = torch.Generator().manual_seed(0)
    for shape in [(784, 500), (3, 3, 32, 64), (10,)]:
        w = tl.glorot_uniform(gen, shape)
        fan_in, fan_out = tl._fans(shape)
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        assert w.shape == shape and w.dtype == torch.float32
        assert float(w.abs().max()) <= limit
        assert float(w.abs().max()) > 0.9 * limit   # it fills the range
        # uniform: mean 0, standard deviation limit / sqrt(3)
        assert abs(float(w.mean())) < 5 * limit / np.sqrt(3 * w.numel())
    assert tl._fans((3, 3, 32, 64)) == jl._fans((3, 3, 32, 64))


def test_layer_holds_its_params_under_the_reference_names():
    layer = tl.BatchNorm()
    params, _ = layer.init(torch.Generator().manual_seed(0), (4,))
    layer.set_params(params)
    assert list(layer.params()) == ["gamma", "beta", "moving_mean",
                                    "moving_var"]
    assert sorted(n for n, _ in layer.named_parameters()) == ["beta",
                                                              "gamma"]
    assert sorted(n for n, _ in layer.named_buffers()) == ["moving_mean",
                                                           "moving_var"]
    assert repr(layer) == repr(jl.BatchNorm())
