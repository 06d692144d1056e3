"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and skip elsewhere (the kernels have no
CPU or interpret mode).  The GPU host has no jax, so run them without
the suite's conftest::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances: f32 max-abs 1e-4, bf16 2e-2 (kernel and plain version sum
in different orders; bf16 rounds p before P.V in both); the forward's
lse 1e-4 in both dtypes, and 1e-5 against log(#visible) when every
score is 0.  The backward
kernels are held relative to the largest entry of the plain result; the
one-pass backward (K4) also bit for bit against itself and against K2 + K3
in both dtypes (it continues their chains: the same mma.sync fragments
in the same order, split-TF32 in f32), so its graduation comes back
"exact".
"""

import numpy as np
import pytest
import torch

from dist_keras_tpu_torch.ops import decode_attention as da
from dist_keras_tpu_torch.ops import flash_attention as fa
from dist_keras_tpu_torch.ops import fused_bwd_experimental as fu

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dev, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        dev, dtype)


@pytest.mark.parametrize("b,tq,tk,h,d,causal,qo,ko,dtype,tol", [
    (1, 1024, 1024, 6, 128, True, 0, 0, torch.float32, 1e-4),
    (2, 77, 130, 4, 64, False, 0, 0, torch.float32, 1e-4),
    (1, 128, 128, 2, 32, True, 0, 64, torch.float32, 1e-4),
    (1, 256, 256, 6, 128, True, 0, 0, torch.bfloat16, 2e-2),
    (2, 256, 256, 6, 128, False, 0, 0, torch.bfloat16, 2e-2),
    (1, 128, 256, 6, 128, True, 192, 0, torch.bfloat16, 2e-2),
    (1, 128, 128, 6, 128, True, 0, 64, torch.bfloat16, 2e-2),
    (1, 1000, 1000, 6, 128, True, 0, 0, torch.bfloat16, 2e-2),
    (2, 77, 130, 4, 64, False, 0, 0, torch.bfloat16, 2e-2),
    (1, 93, 93, 8, 32, True, 0, 0, torch.bfloat16, 2e-2),
])
def test_flash_fwd_matches_plain(dev, b, tq, tk, h, d, causal, qo, ko,
                                 dtype, tol):
    rng = np.random.default_rng(0)
    q = _randn(rng, (b, tq, h, d), dev, dtype)
    k = _randn(rng, (b, tk, h, d), dev, dtype)
    v = _randn(rng, (b, tk, h, d), dev, dtype)
    before = fa.flash_fwd_launches
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal,
                                           q_offset=qo, kv_offset=ko)
    assert fa.flash_fwd_launches == before + 1
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal,
                                                q_offset=qo, kv_offset=ko)
    assert out.dtype == dtype
    assert float((out.float() - ref.float()).abs().max()) <= tol
    # lse is f32 arithmetic on exact products in both dtypes: a key
    # missing from a row of T moves it by about 1/T, far above 1e-4
    assert float((lse - ref_lse).abs().max()) <= 1e-4
    if ko > qo:
        assert float(out[:, :ko - qo].float().abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,tq,tk,h,d,qo,ko", [
    (1, 1000, 1000, 6, 128, 0, 0),
    (1, 300, 300, 6, 128, 0, 64),
    (2, 77, 130, 4, 64, 100, 0),
    (1, 93, 93, 8, 32, 5, 0),
])
def test_flash_fwd_uniform_scores_probe(dev, b, tq, tk, h, d, qo, ko, dtype):
    """K = 0 makes every causal score 0: each row's lse is exactly
    log(#visible keys) (-1e30 where none is), so a mask that is off by
    one key moves it by at least 1/Tk."""
    rng = np.random.default_rng(5)
    q = _randn(rng, (b, tq, h, d), dev, dtype)
    k = torch.zeros((b, tk, h, d), dtype=dtype, device=dev)
    v = _randn(rng, (b, tk, h, d), dev, dtype)
    out, lse = fa.flash_fwd(q, k, v, True, d ** -0.5, qo, ko)
    n = (qo + torch.arange(tq, device=dev) - ko + 1).clamp(0, tk)
    want = torch.where(n > 0, torch.log(n.clamp_min(1).double()), -1e30)
    assert float((lse - want.float()).abs().max()) <= 1e-5
    ref, _ = fa.flash_attention_reference(q, k, v, causal=True, q_offset=qo,
                                          kv_offset=ko)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert float((out.float() - ref.float()).abs().max()) <= tol
    dead = int((n == 0).sum())
    if dead:
        assert float(out[:, :dead].float().abs().max()) == 0.0


def _rel(got, want):
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


BWD_CASES = [
    (2, 512, 512, 6, 128, True, 0, 0, torch.float32, 1e-4),
    (2, 77, 130, 4, 64, False, 0, 0, torch.float32, 1e-4),
    (1, 128, 128, 2, 32, True, 0, 64, torch.float32, 1e-4),
    (1, 256, 256, 6, 128, True, 0, 0, torch.bfloat16, 2e-2),
    (1, 1000, 1000, 6, 128, True, 0, 0, torch.bfloat16, 2e-2),   # ragged T
    (1, 128, 256, 6, 128, True, 192, 0, torch.bfloat16, 2e-2),   # Tq != Tk
    (1, 256, 256, 6, 128, True, 0, 96, torch.bfloat16, 2e-2),    # dead rows
    (1, 128, 128, 2, 32, True, 0, 64, torch.bfloat16, 2e-2),     # dead rows
    (2, 77, 130, 4, 64, False, 0, 0, torch.bfloat16, 2e-2),
    (2, 300, 300, 8, 64, True, 0, 0, torch.bfloat16, 2e-2),
    (1, 93, 93, 8, 32, True, 0, 0, torch.bfloat16, 2e-2),
    (2, 512, 768, 6, 128, False, 0, 0, torch.bfloat16, 2e-2),
]


@pytest.mark.parametrize("b,tq,tk,h,d,causal,qo,ko,dtype,tol", BWD_CASES)
def test_flash_bwd_matches_plain(dev, b, tq, tk, h, d, causal, qo, ko,
                                 dtype, tol):
    rng = np.random.default_rng(1)
    q = _randn(rng, (b, tq, h, d), dev, dtype)
    k = _randn(rng, (b, tk, h, d), dev, dtype)
    v = _randn(rng, (b, tk, h, d), dev, dtype)
    do = _randn(rng, (b, tq, h, d), dev, dtype)
    _, lse = fa.flash_fwd(q, k, v, causal, d ** -0.5, qo, ko)
    dl = _randn(rng, (b, h, tq), dev)
    args = (q, k, v, do, lse, dl, causal, d ** -0.5, qo, ko)
    before = (fa.flash_bwd_dq_launches, fa.flash_bwd_dkv_launches)
    got = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
    assert (fa.flash_bwd_dq_launches, fa.flash_bwd_dkv_launches) == (
        before[0] + 1, before[1] + 1)
    for g, w in zip(got, fa.flash_bwd_reference(*args)):
        assert g.dtype == dtype and _rel(g, w) <= tol
    if ko > qo:
        assert float(got[0][:, :ko - qo].abs().max()) == 0.0


@pytest.mark.parametrize("b,tq,tk,h,d,causal,qo,ko,dtype,tol", [
    (2, 512, 512, 6, 128, True, 0, 0, torch.float32, 1e-4),
    (2, 77, 130, 4, 64, False, 0, 0, torch.float32, 1e-4),
    (1, 128, 128, 2, 32, True, 0, 64, torch.float32, 1e-4),
    (1, 256, 256, 6, 128, True, 0, 0, torch.bfloat16, 2e-2),
    (1, 128, 128, 2, 32, True, 0, 64, torch.bfloat16, 2e-2),
    (1, 1000, 1000, 6, 128, True, 0, 0, torch.bfloat16, 2e-2),   # ragged T
    (1, 128, 256, 6, 128, True, 192, 0, torch.bfloat16, 2e-2),   # Tq != Tk
    (2, 77, 130, 4, 64, False, 0, 0, torch.bfloat16, 2e-2),
])
def test_fused_bwd_matches_plain_and_equals_two_kernels(
        dev, b, tq, tk, h, d, causal, qo, ko, dtype, tol):
    rng = np.random.default_rng(4)
    q = _randn(rng, (b, tq, h, d), dev, dtype)
    k = _randn(rng, (b, tk, h, d), dev, dtype)
    v = _randn(rng, (b, tk, h, d), dev, dtype)
    do = _randn(rng, (b, tq, h, d), dev, dtype)
    _, lse = fa.flash_fwd(q, k, v, causal, d ** -0.5, qo, ko)
    dl = _randn(rng, (b, h, tq), dev)
    args = (q, k, v, do, lse, dl, causal, d ** -0.5, qo, ko)
    before = fu.fused_bwd_launches
    got = fu.fused_bwd(*args)
    again = fu.fused_bwd(*args)
    assert fu.fused_bwd_launches == before + 2
    for g, w in zip(got, fu.fused_bwd_reference(*args)):
        assert g.dtype == dtype and _rel(g, w) <= tol
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    two = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
    for g, w in zip(got, two):   # the same chains in both dtypes
        assert torch.equal(g, w)
    if ko > qo:
        assert float(got[0][:, :ko - qo].abs().max()) == 0.0


def test_fused_bwd_graduates_on_the_card(dev):
    """K4 is K2 + K3 bit for bit in both dtypes, so it graduates in both."""
    fu.clear_verdicts()
    try:
        for dtype in (torch.float32, torch.bfloat16):
            v = fu.selfcheck(bh=4, t=512, d=128, dtype=dtype)
            assert v.status == "exact" and v.err == 0.0
    finally:
        fu.clear_verdicts()


def test_flash_core_grads_match_plain_autograd(dev):
    from dist_keras_tpu_torch.ops.attention import attention_with_lse

    rng = np.random.default_rng(2)
    q, k, v = (_randn(rng, (2, 300, 4, 64), dev).requires_grad_()
               for _ in range(3))

    def f(fn):
        out, lse = fn(q, k, v, causal=True)
        return (out ** 2).sum() + torch.sin(lse).sum()

    got = torch.autograd.grad(f(fa.flash_attention_with_lse), (q, k, v))
    want = torch.autograd.grad(f(attention_with_lse), (q, k, v))
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-4


def test_train_step_on_card_matches_plain_attention(dev):
    from dist_keras_tpu_torch.models.transformer import transformer_config
    from dist_keras_tpu_torch.ops.attention import attention_with_lse
    from dist_keras_tpu_torch.parallel.transformer_tp import (
        loss_and_grads,
        make_tp_train_step,
    )
    from dist_keras_tpu_torch.utils.pytree import tree_leaves

    cfg = transformer_config(input_dim=8, seq_len=128, d_model=64,
                             n_heads=2, n_layers=2, n_classes=3)
    _, init_fn = make_tp_train_step(cfg, device=dev)
    params, _ = init_fn(0)
    rng = np.random.default_rng(3)
    x = _randn(rng, (2, 128, 8), dev)
    y = torch.tensor([0, 2], device=dev)
    loss, grads = loss_and_grads(params, x, y, cfg, causal=True)
    ploss, pgrads = loss_and_grads(
        params, x, y, cfg, causal=True,
        attn_fn=lambda q, k, v, causal: attention_with_lse(
            q, k, v, causal=causal)[0])
    assert abs(float(loss) - float(ploss)) <= 1e-5
    for g, w in zip(tree_leaves(grads), tree_leaves(pgrads)):
        assert float((g - w).norm() / w.norm()) <= 1e-4


def test_flash_fwd_rejects_what_it_does_not_take(dev):
    q = torch.zeros((1, 8, 2, 48), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), q.half(), q.half())
    lse = torch.zeros((1, 2, 8), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_bwd_dq(q, q, q, q, lse, lse, True, 0.1, 0, 0)
    q = torch.zeros((1, 8, 2, 32), device=dev)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_bwd_dkv(q, q, q, q, lse[:, :1], lse, True, 0.1, 0, 0)


def _paged_inputs(rng, dev, s, lengths, h=6, d=128, ps=16, max_pages=128):
    pool = s * max_pages + 1
    q = _randn(rng, (s, h, d), dev)
    kp = _randn(rng, (h, pool, ps, d), dev)
    vp = _randn(rng, (h, pool, ps, d), dev)
    pt = torch.from_numpy(rng.integers(0, pool, size=(s, max_pages),
                                       dtype=np.int32)).to(dev)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, pt, ln


@pytest.mark.parametrize("n_split", [None, 1, 2, "cap"])
@pytest.mark.parametrize("s", [1, 4, 8])
def test_paged_decode_matches_plain(dev, s, n_split):
    rng = np.random.default_rng(s)
    ps, max_pages = 16, 128
    picks = [0, 5, ps, max_pages * ps, 1000, 33, ps + 1, 2047]
    args = _paged_inputs(rng, dev, s, picks[:s])
    if n_split == "cap":   # one chunk per split
        n_split = -(-max_pages * ps // da.CHUNK)
    got = (da.paged_attention_auto(*args) if n_split is None   # the plan
           else da.paged_attention_kernel(*args, n_split=n_split))
    ref = da.paged_attention_reference(*args)
    assert float((got - ref).abs().max()) <= 1e-4
    assert float(got[0].abs().max()) == 0.0      # slot 0 has length 0
    # the partials merge in split order: two launches give the same bits
    assert torch.equal(got, da.paged_attention_kernel(*args,
                                                      n_split=n_split))


def test_paged_decode_plan_fills_the_card(dev):
    n_sm = da.sm_count(dev)
    for s in (1, 8):
        n = da.split_plan(s, 6, 128, 16, n_sm)
        assert 6 * s * n >= n_sm


def test_paged_decode_on_two_streams_at_once(dev):
    rng = np.random.default_rng(11)
    cases = [_paged_inputs(rng, dev, 8, [2048, 0, 1000, 33, 2048, 5, 17, 16]),
             _paged_inputs(rng, dev, 4, [2048] * 4)]
    refs = [da.paged_attention_reference(*c) for c in cases]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(8):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(da.paged_attention_kernel(*cases[i]))
    torch.cuda.synchronize()
    for i in range(2):
        for o in outs[i]:
            assert float((o - refs[i]).abs().max()) <= 1e-4


