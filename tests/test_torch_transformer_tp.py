"""The port's one-card transformer training step against the JAX
``make_tp_train_step`` on a 1x1x1 mesh, on bridged weights (CPU).

Gradients are compared, not adam-updated params: adam's first update is
about +-lr wherever a gradient is tiny, so params after adam compare
noise.  The JAX grads are read exactly through an optax transformation
that keeps the gradient it is given in its state and updates nothing.

Tolerances: f32 loss 1e-5 and grads atol 1e-6 + rtol 1e-4 (same math,
another summation order; observed ~5e-7 relative); params after three
sgd(0.1) steps atol 1e-5; remat policies 1e-6 (the same arithmetic
recomputed); bf16 loss 1e-3 (the JAX CPU path rounds its logits to bf16
where the port keeps them f32; observed ~2e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dist_keras_tpu.models.transformer import (
    transformer_apply as jax_transformer_apply,
)
from dist_keras_tpu.models.transformer import transformer_config
from dist_keras_tpu.parallel.transformer_tp import make_tp_mesh
from dist_keras_tpu.parallel.transformer_tp import (
    make_tp_train_step as jax_make_tp_train_step,
)
from dist_keras_tpu_torch.ops import flash_attention as tflash
from dist_keras_tpu_torch.ops.optimizers import adam, sgd
from dist_keras_tpu_torch.parallel import (
    make_tp_train_step,
    train_tp_transformer,
)
from dist_keras_tpu_torch.parallel.transformer_tp import loss_and_grads
from dist_keras_tpu_torch.utils.bridge import params_from_jax, params_to_numpy
from dist_keras_tpu_torch.utils.pytree import tree_leaves

CFG = transformer_config(input_dim=6, seq_len=16, d_model=16, n_heads=4,
                         n_layers=2, d_ff=32, n_classes=3)


def _data(n=8, t=None, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, t or CFG["seq_len"], CFG["input_dim"]))
    return x.astype(np.float32), rng.integers(0, CFG["n_classes"], n)


def _keep_grads():
    """optax transformation: zero updates, the gradient kept as state."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), {"g": g}))


def _jax_params(seed=0):
    _, init_fn = jax_make_tp_train_step(make_tp_mesh(1, 1, 1), CFG)
    return init_fn(seed)[0]


def _jax_step(params, x, y, tx, steps=1, **kw):
    factory, _ = jax_make_tp_train_step(make_tp_mesh(1, 1, 1), CFG,
                                        optimizer=tx, **kw)
    opt = tx.init(params)
    fn = factory(params, opt)
    for _ in range(steps):
        params, opt, loss = fn(params, opt, jnp.asarray(x), jnp.asarray(y))
    return params, opt, float(loss)


def _bridge(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


def _leaves(tree):
    """numpy leaves in JAX's order (sorted dict keys) for either side."""
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        tree = params_to_numpy(tree)
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("causal", [True, False])
def test_loss_and_grads_match_jax(causal):
    jp = _jax_params()
    x, y = _data()
    _, opt, jloss = _jax_step(jp, x, y, _keep_grads(), causal=causal)
    loss, grads = loss_and_grads(_bridge(jp), torch.from_numpy(x),
                                 torch.from_numpy(y), CFG, causal=causal)
    np.testing.assert_allclose(float(loss), jloss, atol=1e-5)
    got, want = _leaves(grads), _leaves(opt["g"])
    assert len(got) == len(want) == 6 + 12 * CFG["n_layers"]
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-4)


def test_step_returns_jax_loss_and_leaves_params_f32():
    jp = _jax_params()
    x, y = _data()
    _, _, jloss = _jax_step(jp, x, y, optax.sgd(0.1), causal=True)
    factory, _ = make_tp_train_step(CFG, optimizer=sgd(0.1), causal=True,
                                    device="cpu")
    params = _bridge(jp)
    opt = sgd(0.1).init(params)
    new, _, loss = factory(params, opt)(params, opt, x, y)
    np.testing.assert_allclose(float(loss), jloss, atol=1e-5)
    assert all(t.dtype == torch.float32 for t in tree_leaves(new))


def test_three_sgd_steps_match_jax():
    jp = _jax_params(seed=1)
    x, y = _data(seed=1)
    want, _, jloss = _jax_step(jp, x, y, optax.sgd(0.1), steps=3,
                               causal=True)
    factory, _ = make_tp_train_step(CFG, optimizer=sgd(0.1), causal=True,
                                    device="cpu")
    params = _bridge(jp)
    opt = sgd(0.1).init(params)
    step = factory(params, opt)
    for _ in range(3):
        params, opt, loss = step(params, opt, x, y)
    np.testing.assert_allclose(float(loss), jloss, atol=1e-5)
    for a, b in zip(_leaves(params), _leaves(want)):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_remat_policies_agree():
    """remat False / True / "mlp": the same loss and updated params (a
    memory/FLOP trade only), as tests/test_transformer_tp.py holds JAX."""
    x, y = _data(n=4)
    params = _bridge(_jax_params())
    results = []
    for remat in (False, True, "mlp"):
        factory, _ = make_tp_train_step(CFG, optimizer=sgd(0.1),
                                        causal=True, remat=remat,
                                        device="cpu")
        p1, _, loss = factory(params, {})(params, {}, x, y)
        results.append((float(loss), _leaves(p1)))
    for loss, leaves in results[1:]:
        np.testing.assert_allclose(loss, results[0][0], rtol=1e-6)
        for a, b in zip(leaves, results[0][1]):
            np.testing.assert_allclose(a, b, atol=1e-6)


def test_unknown_remat_policy_raises():
    factory, init_fn = make_tp_train_step(CFG, remat="all", device="cpu")
    params, opt = init_fn(0)
    x, y = _data(n=2)
    with pytest.raises(ValueError, match="remat"):
        factory(params, opt)(params, opt, x, y)
    with pytest.raises(ValueError, match="softmax_xent"):
        make_tp_train_step(CFG, loss="mse", device="cpu")


def test_bf16_compute_loss_matches_jax():
    jp = _jax_params()
    x, y = _data()
    _, opt, jloss = _jax_step(jp, x, y, _keep_grads(), causal=True,
                              compute_dtype=jnp.bfloat16)
    params = _bridge(jp)
    loss, grads = loss_and_grads(params, torch.from_numpy(x),
                                 torch.from_numpy(y), CFG, causal=True,
                                 compute_dtype=torch.bfloat16)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), jloss, atol=1e-3)
    # the grads land on the f32 master leaves
    assert all(g.dtype == torch.float32 for g in tree_leaves(grads))


def test_short_input_divides_by_seq_len():
    """T < seq_len: the pooled mean divides by cfg["seq_len"] (the JAX
    step's divisor), not by T as transformer_apply does."""
    jp = _jax_params()
    x, y = _data(t=CFG["seq_len"] // 2)
    _, opt, jloss = _jax_step(jp, x, y, _keep_grads(), causal=True)
    loss, grads = loss_and_grads(_bridge(jp), torch.from_numpy(x),
                                 torch.from_numpy(y), CFG, causal=True)
    np.testing.assert_allclose(float(loss), jloss, atol=1e-5)
    for a, b in zip(_leaves(grads), _leaves(opt["g"])):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-4)
    # the mean over T would give another loss
    logits = jax_transformer_apply(jp, jnp.asarray(x), CFG, causal=True)
    logp = jax.nn.log_softmax(logits)
    mean_t = -float(jnp.take_along_axis(
        logp, jnp.asarray(y)[:, None], axis=-1).mean())
    assert abs(mean_t - float(loss)) > 1e-3


def test_init_fn_mirrors_the_jax_layout():
    _, init_fn = make_tp_train_step(CFG, device="cpu")
    params, opt = init_fn(0)
    again, _ = init_fn(0)
    jp = _jax_params()
    for a, b, c in zip(_leaves(params), _leaves(jp), _leaves(again)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, c)       # seeded
    assert int(opt["count"]) == 0
    assert [m.shape for m in _leaves(opt["mu"])] == \
        [p.shape for p in _leaves(params)]


def test_training_reduces_loss():
    x, y = _data(n=16, seed=3)
    _, losses = train_tp_transformer(CFG, x, y, steps=20,
                                     optimizer=adam(3e-3), device="cpu")
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_a_step_records_its_phases_in_order():
    """``tp.step`` tiled by ``tp.forward``, ``tp.backward`` and
    ``tp.optimizer``; no ``tp.grad_reduce`` without an axis across
    ranks, and no device time on the CPU."""
    from dist_keras_tpu_torch.observability import perf

    factory, init_fn = make_tp_train_step(CFG, device="cpu")
    params, opt = init_fn(0)
    x, y = _data()
    step = factory(params, opt)
    perf.reset()
    for _ in range(2):
        params, opt, _ = step(params, opt, torch.from_numpy(x),
                              torch.from_numpy(y))
    recs = perf.records()
    assert [r["name"] for r in recs] == [
        "tp.step", "tp.forward", "tp.backward", "tp.optimizer"] * 2
    for i in (0, 4):
        outer = recs[i]
        assert outer["parent"] is None
        assert all(r["parent"] == outer["seq"] for r in recs[i + 1:i + 4])
        assert sum(r["host_s"] for r in recs[i + 1:i + 4]) <= outer["host_s"]
    assert all(r["device_s"] is None for r in recs)


def test_cpu_training_launches_no_kernel():
    before = (tflash.flash_fwd_launches, tflash.flash_bwd_dq_launches,
              tflash.flash_bwd_dkv_launches)
    x, y = _data(n=2)
    train_tp_transformer(CFG, x, y, steps=1, causal=True, device="cpu")
    assert (tflash.flash_fwd_launches, tflash.flash_bwd_dq_launches,
            tflash.flash_bwd_dkv_launches) == before
