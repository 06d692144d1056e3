"""The port's loss and optimizer registries against the JAX package's
(``dist_keras_tpu.ops.losses`` / ``get_optimizer``, i.e. optax 0.2.6),
on the CPU.

Tolerances: losses 1e-6 relative (f32, same formulas); optimizers after
20 steps on fixed gradients, params within 2e-6 absolute + 1e-5
relative (f32 arithmetic in the same order, but torch's and XLA's
sqrt / rsqrt / pow may round the last bit differently, and 20 steps
compound it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_keras_tpu.ops import losses as jlosses
from dist_keras_tpu.ops import optimizers as joptim
from dist_keras_tpu_torch.ops import losses as tlosses
from dist_keras_tpu_torch.ops import optimizers as toptim
from dist_keras_tpu_torch.utils.bridge import params_from_jax, params_to_numpy

STEPS = 20


@pytest.mark.parametrize("name", sorted(jlosses._LOSSES))
def test_loss_matches_jax(name):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(16, 5)).astype(np.float32) * 3
    if name.startswith("sparse"):
        targets = rng.integers(0, 5, size=(16,)).astype(np.float32)
    elif name.startswith("binary"):
        logits = logits[:, :1] * 10   # saturated logits too
        targets = rng.integers(0, 2, size=(16, 1)).astype(np.float32)
    elif name.startswith("categorical"):
        targets = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 16)]
    else:
        targets = rng.normal(size=(16, 5)).astype(np.float32)
    want = float(jlosses.get_loss(name)(jnp.asarray(logits),
                                        jnp.asarray(targets)))
    got = tlosses.get_loss(name)(torch.from_numpy(logits),
                                 torch.from_numpy(targets))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-7)


def test_loss_registry_surface():
    assert sorted(tlosses._LOSSES) == sorted(jlosses._LOSSES)
    fn = lambda p, t: (p - t).sum()  # noqa: E731
    assert tlosses.get_loss(fn) is fn
    with pytest.raises(ValueError, match="known"):
        tlosses.get_loss("hinge")
    tlosses.register_loss("my_loss", fn)
    try:
        assert tlosses.get_loss("my_loss") is fn
    finally:
        del tlosses._LOSSES["my_loss"]


def _params(rng):
    return [{"kernel": rng.normal(size=(4, 3)).astype(np.float32),
             "bias": rng.normal(size=(3,)).astype(np.float32)},
            {"kernel": rng.normal(size=(3, 2)).astype(np.float32)}]


def _grads(rng):
    out = []
    for _ in range(STEPS):
        g = _params(rng)
        g[0]["kernel"][0] *= 1e-6   # tiny gradients too
        g[0]["bias"][1] = 0.0       # and an exact zero
        out.append(g)
    return out


OPTIMIZERS = [
    ("sgd", {}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "nesterov": True,
             "warmup_steps": 7}),
    ("sgd", {"learning_rate": 0.1, "warmup_steps": 5}),
    ("adam", {}),
    ("adam", {"learning_rate": 3e-2, "b1": 0.8, "b2": 0.99, "eps": 1e-5}),
    ("adagrad", {}),
    ("adagrad", {"learning_rate": 0.1, "initial_accumulator_value": 0.0,
                 "warmup_steps": 3}),
    ("rmsprop", {}),
    ("rmsprop", {"learning_rate": 1e-2, "rho": 0.8, "momentum": 0.5}),
    ("adadelta", {}),
    ("adadelta", {"learning_rate": 1.0, "rho": 0.9, "eps": 1e-6}),
    ("nadam", {}),
    ("adamw", {}),
    ("adamw", {"learning_rate": 1e-2, "weight_decay": 0.1}),
]


@pytest.mark.parametrize("name,kwargs", OPTIMIZERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(OPTIMIZERS)])
def test_optimizer_matches_optax(name, kwargs):
    import optax

    rng = np.random.default_rng(0)
    params, grads = _params(rng), _grads(rng)
    tx = joptim.get_optimizer(name, **kwargs)
    jp, jstate = params, tx.init(params)
    opt = toptim.get_optimizer(name, **kwargs)
    tp = params_from_jax(params, "cpu")
    state = opt.init(tp)
    for g in grads:
        upd, jstate = tx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, state = opt.update(params_from_jax(g, "cpu"), state, tp)
        tp = toptim.apply_updates(tp, tupd)
    for a, b in zip(jax.tree.leaves(params_to_numpy(tp)),
                    jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-6, rtol=1e-5)
    # the params moved: the comparison is not of two unchanged trees
    assert not np.allclose(params_to_numpy(tp)[1]["kernel"],
                           params[1]["kernel"])


def test_warmup_gives_lr_zero_on_the_first_step():
    p = {"w": torch.ones(3)}
    opt = toptim.get_optimizer("sgd", learning_rate=0.5, warmup_steps=4)
    state = opt.init(p)
    g = {"w": torch.ones(3)}
    lrs = []
    for _ in range(6):
        upd, state = opt.update(g, state, p)
        lrs.append(-float(upd["w"][0]))
    np.testing.assert_allclose(lrs, [0.0, 0.125, 0.25, 0.375, 0.5, 0.5],
                               rtol=1e-6)


def test_registry_defaults_are_keras_and_optax_adam_keeps_its_own():
    import inspect

    assert inspect.signature(toptim._adam).parameters["eps"].default == 1e-7
    assert inspect.signature(toptim.adam).parameters["eps"].default == 1e-8
    for name in joptim._OPTIMIZERS:
        want = {k: v.default for k, v in inspect.signature(
            joptim._OPTIMIZERS[name]).parameters.items()}
        got = {k: v.default for k, v in inspect.signature(
            toptim._OPTIMIZERS[name]).parameters.items()}
        assert got == want, name
    assert sorted(toptim._OPTIMIZERS) == sorted(joptim._OPTIMIZERS)


def test_optimizer_registry_surface():
    opt = toptim.sgd(0.1)
    assert toptim.get_optimizer(opt) is opt
    made = toptim.get_optimizer(lambda learning_rate: toptim.sgd(
        learning_rate), learning_rate=0.2)
    assert isinstance(made, toptim.Optimizer)
    with pytest.raises(ValueError, match="known"):
        toptim.get_optimizer("lamb")
    toptim.register_optimizer("plain", toptim._sgd)
    try:
        assert isinstance(toptim.get_optimizer("plain"), toptim.Optimizer)
    finally:
        del toptim._OPTIMIZERS["plain"]


def test_adamw_needs_params():
    opt = toptim.get_optimizer("adamw")
    p = {"w": torch.ones(2)}
    with pytest.raises(ValueError, match="params"):
        opt.update(p, opt.init(p))
