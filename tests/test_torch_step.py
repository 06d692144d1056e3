"""The port's train step against the JAX package's ``make_model_step``
(CPU), on the reference's weights.

Tolerances: f32 loss 1e-6 relative, gradients (read as the params' move
under sgd(1.0)) 1e-5 relative to the largest entry; bf16 compute 2e-2
relative (bf16 keeps 8 mantissa bits, and the two packages round the
casts and the products' accumulations differently); BatchNorm moving
statistics after 3 steps 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dist_keras_tpu.models import layers as jl
from dist_keras_tpu.models import model as jmodel
from dist_keras_tpu.ops.losses import categorical_crossentropy as jcce
from dist_keras_tpu.trainers import step as jstep
from dist_keras_tpu_torch.models import layers as tl
from dist_keras_tpu_torch.models import model as tmodel
from dist_keras_tpu_torch.ops import optimizers as toptim
from dist_keras_tpu_torch.ops.losses import categorical_crossentropy as tcce
from dist_keras_tpu_torch.trainers import step as tstep
from dist_keras_tpu_torch.utils.bridge import params_from_jax, params_to_numpy
from dist_keras_tpu_torch.utils.pytree import tree_leaves


def _models(batchnorm):
    def stack(m):
        extra = [m.BatchNorm(), m.Activation("relu")] if batchnorm else []
        return [m.Dense(16, activation=None if batchnorm else "relu"),
                *extra, m.Dense(4)]

    jm = jmodel.Sequential(stack(jl))
    jm.build((6,), seed=0)
    tm = tmodel.Sequential(stack(tl))
    tm.build((6,))
    tm.set_params(params_from_jax(jm.params, "cpu"))
    return jm, tm


def _batch(seed=0, n=12, x_scale=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 6)) * x_scale).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return x, y


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def _jax_steps(jm, batches, tx, compute_dtype=None, skip=False):
    step, opt_init = jstep.make_model_step(jm, jcce, tx, compute_dtype,
                                           skip_nonfinite=skip)
    carry = (jm.params, opt_init(jm.params), jax.random.PRNGKey(0))
    losses = []
    for x, y in batches:
        carry, loss = step(carry, (jnp.asarray(x), jnp.asarray(y)))
        losses.append(float(loss))
    return carry, losses


def _torch_steps(tm, batches, tx, compute_dtype=None, skip=False):
    step, opt_init = tstep.make_model_step(tm, tcce, tx, compute_dtype,
                                           skip_nonfinite=skip)
    params = tm.params
    carry = (params, opt_init(params), torch.Generator().manual_seed(0))
    losses = []
    for x, y in batches:
        carry, loss = step(carry, (torch.from_numpy(x), torch.from_numpy(y)))
        losses.append(float(loss))
    return carry, losses


@pytest.mark.parametrize("batchnorm", [False, True],
                         ids=["stateless", "batchnorm"])
def test_one_step_loss_and_gradients_match_jax_f32(batchnorm):
    jm, tm = _models(batchnorm)
    batch = [_batch()]
    (jp, _, _), [jloss] = _jax_steps(jm, batch, optax.sgd(1.0))
    (tp, _, _), [tloss] = _torch_steps(tm, batch, toptim.sgd(1.0))
    np.testing.assert_allclose(tloss, jloss, rtol=1e-6)
    # sgd(1.0): the params' move is minus the gradient
    # (relative to the largest gradient entry of all leaves: a Dense
    # bias before a BatchNorm has a gradient that is zero up to rounding)
    p0 = jax.tree.leaves(jm.params)
    jg = [a - b for a, b in zip(p0, jax.tree.leaves(jp))]
    tg = [a - b for a, b in zip(p0, jax.tree.leaves(params_to_numpy(tp)))]
    scale = max(float(np.abs(b).max()) for b in jg)
    paths = jax.tree_util.tree_flatten_with_path(jm.params)[0]
    for a, b, (path, _) in zip(tg, jg, paths):
        assert np.abs(a - b).max() <= 1e-5 * scale, path
    if batchnorm:   # the moving statistics take no gradient step
        np.testing.assert_allclose(tp[1]["moving_mean"].numpy(),
                                   np.asarray(jp[1]["moving_mean"]),
                                   atol=1e-6)


def test_loss_fn_gradients_match_jax_directly():
    jm, tm = _models(False)
    x, y = _batch(1)
    jloss, jg = jax.value_and_grad(jstep.make_loss_fn(jm.apply, jcce))(
        jm.params, jnp.asarray(x), jnp.asarray(y))
    loss_of = tstep.make_loss_fn(tm.apply, tcce)
    tloss, tg = tstep._value_and_grad(loss_of, tm.params,
                                      torch.from_numpy(x),
                                      torch.from_numpy(y))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(params_to_numpy(tg)),
                    jax.tree.leaves(jg)):
        assert _rel(a, b) <= 1e-5
    assert all(g.dtype == torch.float32 for g in tree_leaves(tg))


@pytest.mark.parametrize("batchnorm", [False, True],
                         ids=["stateless", "batchnorm"])
def test_bf16_compute_dtype_matches_jax_and_keeps_f32_masters(batchnorm):
    jm, tm = _models(batchnorm)
    batches = [_batch(s) for s in range(3)]
    (jp, _, _), jl_ = _jax_steps(jm, batches, optax.sgd(0.1, momentum=0.9),
                                 jnp.bfloat16)
    (tp, topt, _), tl_ = _torch_steps(tm, batches,
                                      toptim.sgd(0.1, momentum=0.9),
                                      torch.bfloat16)
    np.testing.assert_allclose(tl_, jl_, rtol=2e-2)
    # master params and the optimizer state stay f32
    assert all(p.dtype == torch.float32 for p in tree_leaves(tp))
    assert all(t.dtype == torch.float32 for t in tree_leaves(topt))
    # the params' move after 3 steps: bf16 gradients, within 2e-2 of the
    # largest move
    p0 = jax.tree.leaves(jm.params)
    jd = [a - b for a, b in zip(p0, jax.tree.leaves(jp))]
    td = [a - b for a, b in zip(p0, jax.tree.leaves(params_to_numpy(tp)))]
    scale = max(float(np.abs(b).max()) for b in jd)
    for a, b in zip(td, jd):
        assert np.abs(a - b).max() <= 2e-2 * scale
    # the bf16 loss is close to the f32 one from the same params
    _, [f32_loss] = _torch_steps(_models(batchnorm)[1], batches[:1],
                                 toptim.sgd(0.0))
    np.testing.assert_allclose(tl_[0], f32_loss, rtol=2e-2)


def test_bf16_gradients_arrive_in_f32_and_match():
    jm, tm = _models(False)
    x, y = _batch(2)
    _, jg = jax.value_and_grad(jstep.make_loss_fn(
        jm.apply, jcce, jnp.bfloat16))(jm.params, jnp.asarray(x),
                                       jnp.asarray(y))
    _, tg = tstep._value_and_grad(
        tstep.make_loss_fn(tm.apply, tcce, torch.bfloat16), tm.params,
        torch.from_numpy(x), torch.from_numpy(y))
    for a, b in zip(jax.tree.leaves(params_to_numpy(tg)),
                    jax.tree.leaves(jg)):
        assert a.dtype == np.float32
        assert _rel(a, np.asarray(b, np.float32)) <= 2e-2


@pytest.mark.parametrize("batchnorm", [False, True],
                         ids=["stateless", "batchnorm"])
def test_skip_nonfinite_keeps_params_and_optimizer_state(batchnorm):
    _, tm = _models(batchnorm)
    good, bad = _batch(0), _batch(1)
    bad = (bad[0].copy(), bad[1])
    bad[0][3, 2] = np.nan
    step, opt_init = tstep.make_model_step(tm, tcce, toptim.adam(1e-2),
                                           skip_nonfinite=True)
    gen = torch.Generator().manual_seed(0)
    carry = (tm.params, opt_init(tm.params), gen)
    carry, loss = step(carry, tuple(map(torch.from_numpy, good)))
    assert torch.isfinite(loss)
    before = carry
    carry, loss = step(carry, tuple(map(torch.from_numpy, bad)))
    assert torch.isnan(loss)
    for a, b in zip(tree_leaves(carry[:2]), tree_leaves(before[:2])):
        assert torch.equal(a, b)
    assert int(carry[1]["count"]) == 1
    # without the guard the NaN reaches the params
    step, _ = tstep.make_model_step(tm, tcce, toptim.adam(1e-2))
    poisoned, _ = step(before, tuple(map(torch.from_numpy, bad)))
    assert not all(torch.isfinite(p).all() for p in tree_leaves(poisoned[0]))


def test_skip_nonfinite_matches_jax_on_a_bad_batch():
    jm, tm = _models(False)
    bad = _batch(3)
    bad[0][0, 0] = np.inf
    batches = [_batch(0), bad, _batch(1)]
    (jp, _, _), jl_ = _jax_steps(jm, batches, optax.sgd(0.1), skip=True)
    (tp, _, _), tl_ = _torch_steps(tm, batches, toptim.sgd(0.1), skip=True)
    assert np.isnan(jl_[1]) and np.isnan(tl_[1])
    np.testing.assert_allclose(np.asarray(tl_)[[0, 2]],
                               np.asarray(jl_)[[0, 2]], rtol=1e-6)
    for a, b in zip(jax.tree.leaves(params_to_numpy(tp)),
                    jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=1e-5)


def test_batchnorm_state_advances_as_the_reference():
    jm, tm = _models(True)
    batches = [_batch(s, x_scale=3.0) for s in range(3)]
    (jp, _, _), _ = _jax_steps(jm, batches, optax.sgd(0.1))
    (tp, _, _), _ = _torch_steps(tm, batches, toptim.sgd(0.1))
    for k in ("moving_mean", "moving_var"):
        want = np.asarray(jp[1][k])
        assert not np.allclose(want, np.asarray(jm.params[1][k]))
        np.testing.assert_allclose(tp[1][k].numpy(), want, atol=1e-5,
                                   rtol=1e-5)
    # the optimizer state covers the trainable split only
    _, opt_init = tstep.make_model_step(tm, tcce, toptim.adam(1e-3))
    state = opt_init(tm.params)
    assert sorted(state["mu"][1]) == ["beta", "gamma"]


def test_uint8_batches_are_cast_on_the_device():
    jm, tm = _models(False)
    rng = np.random.default_rng(4)
    x = rng.integers(0, 255, size=(8, 6)).astype(np.uint8)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)]
    jloss = jstep.make_loss_fn(jm.apply, jcce)(jm.params, jnp.asarray(x),
                                              jnp.asarray(y))
    tloss = tstep.make_loss_fn(tm.apply, tcce)(
        tm.params, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
