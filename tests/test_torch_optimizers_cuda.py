"""Adam's update and apply_updates kernels (``csrc/multi_tensor.cu``)
against their plain versions, on the card.

These tests need an NVIDIA GPU and skip elsewhere (the kernels have no
CPU or interpret mode).  The GPU host has no jax, so run them without
the suite's conftest::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_optimizers_cuda.py

Every comparison is ``torch.equal``, bit for bit: the kernels repeat the
plain versions' operations in their order and rounding.
"""

import numpy as np
import pytest
import torch

from dist_keras_tpu_torch.ops import multi_tensor as mt
from dist_keras_tpu_torch.ops import optimizers as opt
from dist_keras_tpu_torch.utils.pytree import tree_leaves, tree_map

pytestmark = pytest.mark.cuda

SIZES = [(1,), (3,), (768,), (5, 7), (1021,), (4099,), (3, 4097),
         (2304, 1024), (768, 3072)]        # 768 x 3072 = 2,359,296


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _tree(rng, shapes, dev, dtype, scale=1.0):
    return {f"l{i}": torch.from_numpy(
        scale * rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
        for i, s in enumerate(shapes)}


def _leaves_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y), float((x.float() - y.float()).abs().max())


def _clone(tree):
    return tree_map(torch.clone, tree)


def _run_chain(rng, dev, shapes, dtype, workers=None, steps=3, lr=1e-3,
               eps=1e-8, grad=None):
    """Three chained steps through the kernels and through the plain
    path from the same params and gradients; every step's updates,
    state and params bit for bit."""
    lead = () if workers is None else (workers,)
    params = _tree(rng, [lead + s for s in shapes], dev, dtype)
    kern, plain = opt.adam(lr, eps=eps), opt.adam_reference(lr, eps=eps)
    state = kern.init(params)
    if workers is not None:
        # stacked workers, each with its own count (the worker step's)
        state["count"] = torch.arange(workers, dtype=torch.int32,
                                      device=dev)
    pk, sk = params, state
    pp, sp = _clone(params), _clone(state)
    for step in range(steps):
        g = (_tree(rng, [lead + s for s in shapes], dev, dtype, 10.0 ** -step)
             if grad is None else grad(step))
        g_copy, sk_copy, pk_copy = _clone(g), _clone(sk), _clone(pk)
        sk_in = sk
        uk, sk = kern.update(g, sk, pk)
        up, sp = plain.update(g, sp, pp)
        _leaves_equal(uk, up)
        _leaves_equal(sk, sp)
        # the inputs stay as they were
        _leaves_equal(g, g_copy)
        _leaves_equal(pk, pk_copy)
        _leaves_equal(sk_in, sk_copy)
        pk_next = opt.apply_updates(pk, uk)
        _leaves_equal(pk, pk_copy)
        pk = pk_next
        pp = opt.apply_updates_reference(pp, up)
        _leaves_equal(pk, pp)
    torch.cuda.synchronize()
    return pk


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("workers", [None, 4])
def test_adam_and_apply_match_the_plain_path_bit_for_bit(dev, dtype, workers):
    rng = np.random.default_rng(0)
    _run_chain(rng, dev, SIZES, dtype, workers)


def test_launch_counts_move_once_a_call(dev):
    rng = np.random.default_rng(1)
    params = _tree(rng, SIZES, dev, torch.float32)
    tx = opt.adam(1e-3)
    state = tx.init(params)
    a0, p0 = mt.adam_update_launches, mt.apply_updates_launches
    upd, state = tx.update(params, state, params)
    opt.apply_updates(params, upd)
    assert mt.adam_update_launches == a0 + 1
    assert mt.apply_updates_launches == p0 + 1
    # the plain path launches neither kernel
    opt.adam_reference(1e-3).update(params, state, params)
    opt.apply_updates_reference(params, upd)
    assert (mt.adam_update_launches, mt.apply_updates_launches) == (
        a0 + 1, p0 + 1)


def test_a_table_larger_than_one_launch(dev):
    rng = np.random.default_rng(2)
    shapes = [(1 + (i * 37) % 300,) for i in range(700)]
    a0, p0 = mt.adam_update_launches, mt.apply_updates_launches
    _run_chain(rng, dev, shapes, torch.float32, steps=1)
    # 700 leaves: 3 launches of at most 300 rows, 2 of at most 480
    assert mt.adam_update_launches == a0 + 3
    assert mt.apply_updates_launches == p0 + 2


def test_the_vit_b16_tree(dev):
    from dist_keras_tpu_torch.models.transformer import (
        init_transformer_params,
        transformer_config,
    )

    cfg = transformer_config(input_dim=768, seq_len=196, d_model=768,
                             n_heads=12, n_layers=12, d_ff=3072,
                             n_classes=1000)
    params = tree_map(
        lambda t: t.to(dev),
        init_transformer_params(torch.Generator().manual_seed(0), cfg))
    leaves = tree_leaves(params)
    assert len(leaves) == 150
    assert sum(t.numel() for t in leaves) == 86_528_488
    gen = torch.Generator(device=dev).manual_seed(0)
    grads = [tree_map(
        lambda t: torch.randn(t.shape, generator=gen, device=dev) * 1e-2,
        params) for _ in range(3)]
    a0, p0 = mt.adam_update_launches, mt.apply_updates_launches
    tx, ref = opt.adam(1e-3), opt.adam_reference(1e-3)
    pk, sk = params, tx.init(params)
    pp, sp = params, ref.init(params)
    for g in grads:
        uk, sk = tx.update(g, sk, pk)
        up, sp = ref.update(g, sp, pp)
        pk = opt.apply_updates(pk, uk)
        pp = opt.apply_updates_reference(pp, up)
        _leaves_equal(sk, sp)
        _leaves_equal(pk, pp)
    # 150 leaves fit one table: one launch of each kernel a step
    assert (mt.adam_update_launches, mt.apply_updates_launches) == (
        a0 + 3, p0 + 3)


def test_strided_inputs_match_the_plain_path(dev):
    """Autograd hands some gradients over transposed (a TP block's w1, a
    conv kernel through its layout permute): they reach the kernels as
    dense copies, the inputs left as they were."""
    rng = np.random.default_rng(3)
    shapes = [(64, 96), (3, 3, 8, 16), (1023,)]

    def grad(step):
        g = _tree(rng, [(96, 64), (16, 8, 3, 3), (2046,)], dev,
                  torch.float32, 10.0 ** -step)
        return {"l0": g["l0"].t(), "l1": g["l1"].permute(2, 3, 1, 0),
                "l2": g["l2"][::2]}

    _run_chain(rng, dev, shapes, torch.float32, grad=grad)
    # and an update that is strided, as sgd's of such a gradient
    p = _tree(rng, shapes, dev, torch.bfloat16)
    u = grad(0)
    _leaves_equal(opt.apply_updates(p, u), opt.apply_updates_reference(p, u))


def test_mixed_apply_dtypes_match(dev):
    rng = np.random.default_rng(4)
    for pd, ud in [(torch.float32, torch.bfloat16),
                   (torch.bfloat16, torch.float32),
                   (torch.bfloat16, torch.bfloat16)]:
        p = _tree(rng, SIZES, dev, pd)
        u = _tree(rng, SIZES, dev, ud, 1e-2)
        _leaves_equal(opt.apply_updates(p, u),
                      opt.apply_updates_reference(p, u))


def test_what_the_kernels_refuse_raises_and_names_the_leaf(dev):
    rng = np.random.default_rng(5)
    params = _tree(rng, [(8,), (4, 4)], dev, torch.float32)
    tx = opt.adam(1e-3)
    state = tx.init(params)
    half = tree_map(lambda t: t.half(), params)
    with pytest.raises(TypeError, match=r"\['l0'\]"):
        tx.update(half, tx.init(half), half)
    mixed = {"l0": params["l0"].bfloat16(), "l1": params["l1"]}
    with pytest.raises(TypeError, match=r"\['l0'\]"):
        tx.update(mixed, state, params)
    with pytest.raises(TypeError, match=r"\['l1'\]"):
        opt.apply_updates(params, {"l0": params["l0"],
                                   "l1": params["l1"].half()})
    # a strided input of any rank is taken, by a dense copy
    deep = torch.randn([2] * 9, device=dev).transpose(0, 8)
    flat = {"l0": torch.randn([2] * 9, device=dev)}
    _leaves_equal(opt.apply_updates(flat, {"l0": deep}),
                  opt.apply_updates_reference(flat, {"l0": deep}))
    with pytest.raises(ValueError, match="one CUDA device"):
        opt.apply_updates(params, {"l0": params["l0"].cpu(),
                                   "l1": params["l1"]})
