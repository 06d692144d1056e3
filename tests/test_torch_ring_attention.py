"""Ring attention's pieces, the mesh axes over ranks and their collectives
in one process (CPU); across ranks they are held to the JAX package in
``test_torch_moe_sp_multiprocess.py``.

At one rank every collective is the identity and touches no
``torch.distributed``; ``ring_attention`` is one block call with the lse
dropped; ``make_tp_train_step(mesh=make_tp_mesh())`` is the one-card
step bit for bit.  ``_merge_blocks`` is held to the JAX package's at
1e-6 (f32 logspace arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dist_keras_tpu.ops import attention as jatt
from dist_keras_tpu_torch.ops import attention as tatt
from dist_keras_tpu_torch.ops.flash_attention import flash_attention_with_lse
from dist_keras_tpu_torch.ops.optimizers import sgd
from dist_keras_tpu_torch.parallel import collectives
from dist_keras_tpu_torch.parallel.mesh import (
    SEQ_AXIS,
    RankAxis,
    make_tp_mesh,
    rank_axis,
)
from dist_keras_tpu_torch.parallel.transformer_tp import (
    make_tp_train_step,
    local_block,
    train_tp_transformer,
)
from dist_keras_tpu_torch.models.transformer import transformer_config
from dist_keras_tpu_torch.utils.pytree import tree_leaves

CFG = transformer_config(input_dim=6, seq_len=16, d_model=16, n_heads=4,
                         n_layers=2, d_ff=32, n_classes=3)


def _qkv(b=2, t=32, h=4, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, t, h, d)).astype(np.float32))
            for _ in range(3)]


@pytest.mark.parametrize("dead", [False, True])
def test_merge_blocks_matches_the_reference(dead):
    rng = np.random.default_rng(1)
    o_acc = rng.normal(size=(2, 8, 3, 4)).astype(np.float32)
    o_blk = rng.normal(size=(2, 8, 3, 4)).astype(np.float32)
    lse_acc = rng.normal(size=(2, 3, 8)).astype(np.float32)
    lse_blk = rng.normal(size=(2, 3, 8)).astype(np.float32)
    if dead:   # a fully masked block: lse -1e30, zero output
        lse_blk[:] = -1e30
        o_blk[:] = 0
    want = jatt._merge_blocks((jnp.asarray(o_acc), jnp.asarray(lse_acc)),
                              jnp.asarray(o_blk), jnp.asarray(lse_blk))
    got = tatt._merge_blocks((torch.from_numpy(o_acc),
                              torch.from_numpy(lse_acc)),
                             torch.from_numpy(o_blk),
                             torch.from_numpy(lse_blk))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    if dead:   # the merge of a masked block is the identity
        np.testing.assert_array_equal(got[0].numpy(), o_acc)
        np.testing.assert_array_equal(got[1].numpy(), lse_acc)


@pytest.mark.parametrize("causal", [False, True])
def test_one_rank_is_one_block_call(causal):
    q, k, v = _qkv()
    calls = []

    def block(*a, **kw):
        calls.append(kw)
        return flash_attention_with_lse(*a, **kw)

    assert not dist.is_initialized()
    out = tatt.ring_attention(q, k, v, causal=causal, attn_fn=block)
    want, _ = flash_attention_with_lse(q, k, v, causal=causal)
    assert len(calls) == 1 and calls[0]["causal"] == causal
    assert torch.equal(out, want)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jatt.attention(
            *(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=causal)),
        atol=2e-5, rtol=1e-4)


def test_one_rank_ring_grads_are_the_block_grads():
    q, k, v = (t.requires_grad_() for t in _qkv(t=16))
    torch.sum(tatt.ring_attention(q, k, v, causal=True) ** 2).backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    out, _ = flash_attention_with_lse(q, k, v, causal=True)
    torch.sum(out ** 2).backward()
    for a, t in zip(got, (q, k, v)):
        assert torch.equal(a, t.grad)


def test_collectives_are_the_identity_at_one_rank():
    axis = rank_axis("experts")
    assert axis == RankAxis("experts", 1, 0, None)
    x = torch.arange(6.0).reshape(1, 2, 3)
    assert collectives.all_to_all(x, axis) is x
    assert collectives.ring_shift(x, axis) is x
    assert collectives.sum_across(x, axis) is x
    assert collectives.copy_to(x, axis) is x
    assert collectives.all_gather(x, axis, 1) is x
    assert collectives.reduce_scatter(x, axis, 2) is x
    assert collectives.broadcast(x, axis, 0) is x
    tree = [x, torch.ones(2)]
    assert collectives.cross_rank_sum(tree, axis) is tree
    assert not dist.is_initialized()
    for op in ("all_reduce", "all_to_all", "ring", "all_gather",
               "reduce_scatter", "broadcast", "p2p"):
        assert set(collectives.reduce_stats(op=op)) == {
            "calls", "bytes", "seconds", "device_seconds"}


def test_all_to_all_checks_its_leading_dim():
    with pytest.raises(ValueError, match="dim 0"):
        collectives.all_to_all(torch.zeros(3, 2), RankAxis("experts", 2, 0))


def test_make_tp_mesh_over_one_process():
    mesh = make_tp_mesh()
    assert mesh.shape == {"workers": 1, "model": 1, "seq": 1}
    assert mesh.seq == RankAxis(SEQ_AXIS, 1, 0, None)
    assert make_tp_mesh(sp=1) == mesh
    with pytest.raises(ValueError, match="dp=2"):
        make_tp_mesh(dp=2)
    with pytest.raises(ValueError, match="tp=2"):
        make_tp_mesh(tp=2, sp=1)
    with pytest.raises(ValueError, match="sp=2"):
        make_tp_mesh(sp=2)


def test_a_one_rank_mesh_is_the_one_card_step_bit_for_bit():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 16, 6)).astype(np.float32)
    y = rng.integers(0, 3, 4)
    assert local_block(x, make_tp_mesh()) is x
    runs = [train_tp_transformer(CFG, x, y, steps=2, optimizer=sgd(0.1),
                                 causal=True, device="cpu", mesh=m)
            for m in (None, make_tp_mesh())]
    (p0, l0), (p1, l1) = runs
    assert l0 == l1
    for a, b in zip(tree_leaves(p0), tree_leaves(p1)):
        assert torch.equal(a, b)
    factory, _ = make_tp_train_step(CFG, device="cpu", mesh=make_tp_mesh())
    assert callable(factory({}, {}))
