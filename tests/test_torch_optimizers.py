"""The port's functional optimizers against optax over several steps on
fixed gradients (CPU).  Tolerance 1e-6: the same arithmetic in f32,
bias corrections computed in f32 as optax computes them."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dist_keras_tpu_torch.ops import optimizers
from dist_keras_tpu_torch.utils.bridge import params_from_jax, params_to_numpy

STEPS = 5


def _tree(rng):
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "blocks": [{"b": rng.normal(size=(3,)).astype(np.float32)},
                       {"b": rng.normal(size=(3,)).astype(np.float32)}]}


@pytest.mark.parametrize("name,kwargs", [
    ("adam", {"learning_rate": 1e-3}),
    ("adam", {"learning_rate": 3e-2, "b1": 0.8, "b2": 0.99, "eps": 1e-6,
              "eps_root": 1e-8}),
    ("sgd", {"learning_rate": 0.1}),
])
def test_optimizer_matches_optax(name, kwargs):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(STEPS)]
    # scale some gradients far down: adam's normalised step must match
    # where |g| is tiny too
    for g in grads:
        g["w"][0] *= 1e-6

    tx = getattr(optax, name)(**kwargs)
    jp, jstate = params, tx.init(params)
    opt = getattr(optimizers, name)(**kwargs)
    tp = params_from_jax(params, "cpu")
    state = opt.init(tp)
    for g in grads:
        upd, jstate = tx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, state = opt.update(params_from_jax(g, "cpu"), state, tp)
        tp = optimizers.apply_updates(tp, tupd)
    for a, b in zip(jax.tree.leaves(params_to_numpy(tp)),
                    jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=0)
    if name == "adam":
        assert state["count"].dtype == torch.int32
        assert int(state["count"]) == STEPS == int(jstate[0].count)
        for a, b in zip(jax.tree.leaves(params_to_numpy(state["nu"])),
                        jax.tree.leaves(jstate[0].nu)):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=1e-5)


def test_updates_leave_inputs_untouched_and_keep_dtypes():
    p = {"a": torch.ones(3, dtype=torch.bfloat16), "b": torch.ones(2)}
    g = {"a": torch.full((3,), 0.5, dtype=torch.bfloat16),
         "b": torch.full((2,), 0.5)}
    opt = optimizers.adam(0.1)
    state = opt.init(p)
    upd, new_state = opt.update(g, state, p)
    new = optimizers.apply_updates(p, upd)
    assert new["a"].dtype == torch.bfloat16 and new["b"].dtype == torch.float32
    assert torch.equal(p["b"], torch.ones(2))
    assert int(state["count"]) == 0 and int(new_state["count"]) == 1
    # first adam step: -lr * g / |g| (bias-corrected) = -0.1
    np.testing.assert_allclose(new["b"].numpy(), 0.9, atol=1e-6)


def test_apply_updates_matches_optax_dtype_rule():
    p = {"x": jnp.ones(2, jnp.bfloat16)}
    u = {"x": jnp.full(2, 0.25, jnp.float32)}
    want = optax.apply_updates(p, u)
    got = optimizers.apply_updates({"x": torch.ones(2, dtype=torch.bfloat16)},
                                   {"x": torch.full((2,), 0.25)})
    assert got["x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["x"].float().numpy(),
                                  np.asarray(want["x"], np.float32))
