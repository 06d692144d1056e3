"""The flash backward's plain version and the port's differentiable core
against the JAX package: ``_bwd_call`` (the Pallas dq and dk/dv kernels)
in interpret mode, and ``jax.grad`` through ``flash_attention_with_lse``
in interpret mode, as ``tests/test_pallas.py`` runs them.

Tolerances: f32 max-abs 1e-5 (same math, summation order differs);
bf16 2e-2 (both round P and dS to bf16 before the products, from f32
sums taken in different orders, as ``tests/test_torch_attention.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_keras_tpu.ops.pallas.flash_attention import _bwd_call
from dist_keras_tpu.ops.pallas.flash_attention import (
    flash_attention_with_lse as jax_flash_attention_with_lse,
)
from dist_keras_tpu_torch.ops import flash_attention as tflash

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _arrays(b, tq, tk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda t: rng.normal(size=(b, t, h, d)).astype(np.float32)  # noqa: E731
    return mk(tq), mk(tk), mk(tk), mk(tq), rng.normal(size=(b, h, tq)).astype(
        np.float32)


def _to_bh(x):
    b, t, h, d = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, d)


def _from_bh(x, b, h):
    bh, t, d = x.shape
    return np.asarray(x, np.float32).reshape(b, h, t, d).transpose(0, 2, 1, 3)


def _both_bwd(q, k, v, do, g_lse, causal, q_offset=0, kv_offset=0,
              dtype=torch.float32, jdtype=jnp.float32):
    """(port's flash_bwd_reference, JAX _bwd_call interpreted) on the
    same inputs; lse comes from the port's forward, dl = g_lse - delta."""
    b, tq, h, d = q.shape
    scale = d ** -0.5
    tq_, tk_, tv_, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    out, lse = tflash.flash_attention_reference(
        tq_, tk_, tv_, causal=causal, q_offset=q_offset, kv_offset=kv_offset)
    dl = torch.from_numpy(g_lse) - (tdo.float() * out.float()).sum(
        -1).transpose(1, 2)
    got = tflash.flash_bwd_reference(tq_, tk_, tv_, tdo, lse, dl, causal,
                                     scale, q_offset, kv_offset)
    cast = lambda x: _to_bh(np.asarray(x.float())).astype(jdtype)  # noqa: E731
    want = _bwd_call(cast(tq_), cast(tk_), cast(tv_), cast(tdo),
                     jnp.asarray(lse.numpy()).reshape(b * h, tq, 1),
                     jnp.asarray(dl.numpy()).reshape(b * h, tq, 1),
                     causal, scale, 8, 8, q_offset, kv_offset, True)
    return ([g.float().numpy() for g in got],
            [_from_bh(w, b, h) for w in want])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("g_lse_scale", [0.0, 1.0])
def test_plain_bwd_matches_pallas_kernels(causal, g_lse_scale):
    q, k, v, do, g = _arrays(2, 32, 32, 2, 8)
    got, want = _both_bwd(q, k, v, do, g * g_lse_scale, causal)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=F32_TOL, rtol=0)


def test_plain_bwd_offsets_match_pallas_kernels():
    # rows 16..31 against keys 0..31 of a longer sequence; Tq != Tk
    q, k, v, do, g = _arrays(1, 16, 32, 2, 8, seed=1)
    got, want = _both_bwd(q, k, v, do, g, True, q_offset=16)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=F32_TOL, rtol=0)


def test_plain_bwd_dead_rows_are_exact_zeros():
    # keys at global 4..11 vs queries 0..7: rows 0..3 see nothing
    q, k, v, do, g = _arrays(2, 8, 8, 2, 8, seed=2)
    got, want = _both_bwd(q, k, v, do, g, True, kv_offset=4)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=F32_TOL, rtol=0)
    assert np.abs(got[0][:, :4]).max() == 0.0
    assert np.abs(want[0][:, :4]).max() == 0.0


BF16_CASES = {
    # name: (tq, tk, d, causal, q_offset, kv_offset, g_lse scale)
    "causal": (16, 16, 8, True, 0, 0, 0.0),
    "non_causal_tq_ne_tk": (16, 24, 8, False, 0, 0, 0.0),
    "causal_q_offset": (16, 32, 8, True, 16, 0, 0.0),
    "dead_rows": (8, 8, 8, True, 0, 4, 0.0),
    "several_tiles": (32, 32, 8, True, 0, 0, 0.0),
    "head_dim_32": (16, 16, 32, True, 0, 0, 0.0),
    "random_g_lse": (16, 16, 8, True, 0, 0, 1.0),
}


@pytest.mark.parametrize("case", list(BF16_CASES), ids=list(BF16_CASES))
def test_plain_bwd_bf16_matches_pallas_kernels(case):
    """The port's plain bf16 backward (the oracle the tensor-core K2 and
    K3 are held to on the card) against the Pallas dq and dk/dv kernels
    interpreted, within BF16_TOL; dead rows' dq exact zeros in both."""
    tq, tk, d, causal, qo, ko, g_scale = BF16_CASES[case]
    q, k, v, do, g = _arrays(1, tq, tk, 2, d, seed=3)
    got, want = _both_bwd(q, k, v, do, g * g_scale, causal, q_offset=qo,
                          kv_offset=ko, dtype=torch.bfloat16,
                          jdtype=jnp.bfloat16)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=BF16_TOL, rtol=0)
    if ko > qo:
        assert np.abs(got[0][:, :ko - qo]).max() == 0.0
        assert np.abs(want[0][:, :ko - qo]).max() == 0.0


def test_bwd_halves_equal_the_whole():
    q, k, v, do, g = (torch.from_numpy(x) for x in _arrays(1, 24, 40, 2, 8))
    out, lse = tflash.flash_attention_reference(q, k, v, causal=True)
    args = (q, k, v, do, lse, g, True, 0.3, 0, 0)
    dq, dk, dv = tflash.flash_bwd_reference(*args)
    assert torch.equal(dq, tflash.flash_bwd_dq_reference(*args))
    dk2, dv2 = tflash.flash_bwd_dkv_reference(*args)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def _grads_both(q, k, v, f, **kw):
    """grads of f(out, lse) through the port's core (CPU) and through the
    JAX Pallas kernels' custom VJP (interpret mode)."""
    tq = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, lse = tflash.flash_attention_with_lse(*tq, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionCoreBackward"
    got = torch.autograd.grad(f(out, lse, torch), tq)

    def jf(q, k, v):
        o, l = jax_flash_attention_with_lse(q, k, v, block_q=8, block_k=8,
                                            interpret=True, **kw)
        return f(o, l, jnp)

    want = jax.grad(jf, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("causal", [False, True])
def test_core_grads_match_jax_with_lse_cotangent(causal):
    q, k, v, _, _ = _arrays(2, 16, 16, 2, 8)
    got, want = _grads_both(
        q, k, v, lambda o, l, m: (o ** 2).sum() + m.sin(l).sum(),
        causal=causal)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=F32_TOL, rtol=0)


def test_core_grads_dead_rows_match_jax():
    q, k, v, _, _ = _arrays(2, 8, 8, 2, 8, seed=4)
    got, want = _grads_both(q, k, v, lambda o, l, m: (o ** 2).sum(),
                            causal=True, q_offset=0, kv_offset=4)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=F32_TOL, rtol=0)
    assert np.abs(got[0][:, :4]).max() == 0.0


def test_without_grad_the_core_saves_nothing():
    q, k, v = (torch.from_numpy(x) for x in _arrays(1, 8, 8, 2, 8)[:3])
    with torch.inference_mode():
        out, lse = tflash.flash_attention_with_lse(q, k, v, causal=True)
    assert out.grad_fn is None
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert tflash.flash_attention(qg, k, v).grad_fn is None
    assert tflash.flash_attention(qg, k, v).grad_fn is not None


def test_cpu_backward_launches_no_kernel():
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _arrays(1, 8, 8, 2, 8)[:3])
    before = (tflash.flash_bwd_dq_launches, tflash.flash_bwd_dkv_launches)
    tflash.flash_attention(q, k, v, causal=True).sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None
    assert (tflash.flash_bwd_dq_launches,
            tflash.flash_bwd_dkv_launches) == before


def test_kernel_entries_refuse_cpu_tensors():
    q, k, v, do, g = (torch.from_numpy(x) for x in _arrays(1, 8, 8, 2, 32))
    lse = torch.zeros(1, 2, 8)
    for fn in (tflash.flash_bwd_dq, tflash.flash_bwd_dkv):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, k, v, do, lse, g, True, 0.1, 0, 0)


# -- the f32 kernels' split-TF32 arithmetic, rehearsed on the CPU ----------
#
# The f32 K2, K3 and K4 (csrc/flash_bwd_f32.cuh) form every product from
# TF32 hi + lo splits of both operands (P and dS included): lo*hi + hi*lo
# + hi*hi per 8-wide k-step.  These tests model that rounding in torch
# (the forward's helpers, tests/test_torch_attention.py) and hold it to
# the card's f32 tolerance, relative to the largest entry of the plain
# result, as chip_smoke.py and tests/test_torch_kernels_cuda.py hold the
# kernels.  The tensor cores' order of addition within one mma is not
# modelled.

from test_torch_attention import _mm_split_tf32, _tf32_hi, _tf32_operand  # noqa: E402

CARD_F32_TOL = 1e-4
LOG2E = 1.4426950408889634


def _card_inputs(b, tq, tk, h, d, causal, qo, ko, g_lse, seed=5):
    """q, k, v, dO, the plain forward's lse and dl = g_lse - rowsum(dO*O),
    with a random g_lse when asked (as chip_smoke.py's bwd_inputs)."""
    rng = np.random.default_rng(seed)
    mk = lambda t: torch.from_numpy(  # noqa: E731
        rng.standard_normal((b, t, h, d), np.float32))
    q, k, v, do = mk(tq), mk(tk), mk(tk), mk(tq)
    out, lse = tflash.flash_attention_reference(
        q, k, v, causal=causal, q_offset=qo, kv_offset=ko)
    dl = -(do * out).sum(-1).transpose(1, 2)
    if g_lse:
        dl = dl + torch.from_numpy(rng.standard_normal((b, h, tq),
                                                       np.float32))
    return q, k, v, do, lse, dl.contiguous()


def _visible(tq, tk, causal, qo, ko):
    rows = qo + torch.arange(tq)[:, None]
    keys = ko + torch.arange(tk)[None, :]
    return keys <= rows if causal else torch.ones(tq, tk, dtype=torch.bool)


def _p_ds(q, k, v, do, lse, dl, causal, scale, qo, ko, terms=3):
    """P and dS (B,H,Tq,Tk) as the kernels' `p_ds` forms them from split
    S = Q K^T and dP = dO V^T: P = 2^(s * scale log2(e) - lse log2(e)),
    0 where masked, a dead row shifting by 0; dS = P * (dP + dl)."""
    qh, kh, vh, doh = (x.permute(0, 2, 1, 3) for x in (q, k, v, do))
    s = _mm_split_tf32(qh, kh.transpose(-1, -2), terms)
    dp = _mm_split_tf32(doh, vh.transpose(-1, -2), terms)
    lse2 = torch.where(lse <= -5e29, 0.0, lse)[..., None] * LOG2E
    ok = _visible(q.shape[1], k.shape[1], causal, qo, ko)
    p = torch.where(ok, torch.exp2(s * (scale * LOG2E) - lse2), 0.0)
    return p, p * (dp + dl[..., None])


def _split_tf32_backward(q, k, v, do, lse, dl, causal, scale, qo=0, ko=0,
                         terms=3):
    """The f32 backward kernels' products in torch -> (dq, dk, dv)
    (B,T,H,D): dQ = scale dS K, dV = P^T dO, dK = scale dS^T Q, each a
    split-TF32 product (one TF32 product with ``terms=1``)."""
    p, ds = _p_ds(q, k, v, do, lse, dl, causal, scale, qo, ko, terms)
    qh, kh, doh = (x.permute(0, 2, 1, 3) for x in (q, k, do))
    dq = scale * _mm_split_tf32(ds, kh, terms)
    dv = _mm_split_tf32(p.transpose(-1, -2), doh, terms)
    dk = scale * _mm_split_tf32(ds.transpose(-1, -2), qh, terms)
    return tuple(x.permute(0, 2, 1, 3) for x in (dq, dk, dv))


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


SPLIT_BWD_CASES = {
    # name: (b, tq, tk, h, causal, q_offset, kv_offset, g_lse, blocks)
    "causal_training_like": (1, 128, 128, 2, True, 0, 0, False, 16),
    "ragged_t": (1, 72, 72, 2, True, 0, 0, False, 8),
    "dead_rows": (1, 64, 64, 2, True, 0, 16, False, 16),
    "tq_ne_tk_random_g_lse": (1, 64, 96, 2, True, 32, 0, True, 16),
    "non_causal_random_g_lse": (2, 48, 80, 2, False, 0, 0, True, 16),
}


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("case", list(SPLIT_BWD_CASES),
                         ids=list(SPLIT_BWD_CASES))
def test_split_tf32_backward_meets_the_card_tolerance(case, d):
    """Three-term split-TF32 products (P and dS split too) stay within
    CARD_F32_TOL of the plain f32 backward and of the Pallas dq and dk/dv
    kernels interpreted, with dl = g_lse - rowsum(dO O) cancelling most
    of dP where g_lse is 0; dead rows' dq exact zeros."""
    b, tq, tk, h, causal, qo, ko, g_lse, blk = SPLIT_BWD_CASES[case]
    q, k, v, do, lse, dl = _card_inputs(b, tq, tk, h, d, causal, qo, ko,
                                        g_lse)
    scale = d ** -0.5
    got = _split_tf32_backward(q, k, v, do, lse, dl, causal, scale, qo, ko)
    plain = tflash.flash_bwd_reference(q, k, v, do, lse, dl, causal, scale,
                                       qo, ko)
    pallas = _bwd_call(*(_to_bh(x.numpy()) for x in (q, k, v, do)),
                       jnp.asarray(lse.numpy()).reshape(b * h, tq, 1),
                       jnp.asarray(dl.numpy()).reshape(b * h, tq, 1),
                       causal, scale, blk, blk, qo, ko, True)
    for g, w, j in zip(got, plain, pallas):
        assert _rel(g.numpy(), w.numpy()) <= CARD_F32_TOL
        assert _rel(g.numpy(), _from_bh(j, b, h)) <= CARD_F32_TOL
    if ko > qo:
        assert float(got[0][:, :ko - qo].abs().max()) == 0.0


def test_one_tf32_product_misses_the_card_tolerance():
    """Why the backward splits as the forward does: with one TF32 product
    per f32 product (11 significant bits of each operand) dq, dk and dv
    miss CARD_F32_TOL against the plain f32 backward (by 4.6x to 8.4x
    here)."""
    d = 64
    q, k, v, do, lse, dl = _card_inputs(1, 128, 128, 2, d, True, 0, 0,
                                        True)
    plain = tflash.flash_bwd_reference(q, k, v, do, lse, dl, True,
                                       d ** -0.5)
    one = _split_tf32_backward(q, k, v, do, lse, dl, True, d ** -0.5,
                               terms=1)
    errs = [_rel(g.numpy(), w.numpy()) for g, w in zip(one, plain)]
    assert min(errs) > 2 * CARD_F32_TOL, errs


def _mma3_step(acc, a, b):
    """One k-step of the kernels' split-TF32 mma: acc += lo*hi, then
    hi*lo, then hi*hi, each an m16n8k8 product summed exactly (TF32
    products are exact in f32, eight of them in f64) and rounded to f32
    once, as the tensor cores add within one mma."""
    ah, bh = _tf32_hi(a), _tf32_hi(b)
    al, bl = _tf32_operand(a - ah), _tf32_operand(b - bh)
    for x, y in ((al, bh), (ah, bl), (ah, bh)):
        acc = (acc.double() + x.double() @ y.double()).float()
    return acc


def _dq_k2_order(ds, kh, causal, qo, ko):
    """K2's dQ chain (before scale): per 64-row q block, over the 64-key kv
    tiles up to the last key the block's last row sees, 8-key k-steps
    ascending, one f32 accumulator from 0."""
    tq, tk = ds.shape[-2], ds.shape[-1]
    acc = torch.zeros(*ds.shape[:-1], kh.shape[-1])
    for q0 in range(0, tq, 64):
        q1 = min(q0 + 64, tq)
        kv_end = max(0, min(tk, qo + q1 - 1 - ko + 1)) if causal else tk
        for k0 in range(0, -(-kv_end // 64) * 64, 8):
            acc[..., q0:q1, :] = _mma3_step(
                acc[..., q0:q1, :], ds[..., q0:q1, k0:k0 + 8],
                kh[..., k0:k0 + 8, :])
    return acc


def _dq_k4_order(ds, kh, causal, qo, ko):
    """K4's dQ chain: kv tile by kv tile (64 keys), each continuing the
    f32 partial of every 32-row q tile it sees (from first_q_tile on)
    over its eight k-steps in ascending order."""
    tq, tk = ds.shape[-2], ds.shape[-1]
    part = torch.zeros(*ds.shape[:-1], kh.shape[-1])
    for k0 in range(0, tk, 64):
        first = max(0, ko + k0 - qo) // 32 * 32 if causal else 0
        for q0 in range(first, tq, 32):
            for j in range(k0, k0 + 64, 8):
                part[..., q0:q0 + 32, :] = _mma3_step(
                    part[..., q0:q0 + 32, :], ds[..., q0:q0 + 32, j:j + 8],
                    kh[..., j:j + 8, :])
    return part


@pytest.mark.parametrize("case", ["causal_training_like", "ragged_t",
                                  "dead_rows", "tq_ne_tk_random_g_lse",
                                  "non_causal_random_g_lse"])
def test_k4_dq_order_gives_k2_bits(case):
    """K4 continues each q tile's dQ partial tile by tile through f32 in
    device memory; in the model that is K2's chain bit for bit (the
    trailing k-steps past a row's causal edge add exact zeros)."""
    b, tq, tk, h, causal, qo, ko, g_lse, _ = SPLIT_BWD_CASES[case]
    d = 32
    q, k, v, do, lse, dl = _card_inputs(b, tq, tk, h, d, causal, qo, ko,
                                        g_lse)
    # pad to whole tiles as the kernels' zero-filled rows do
    tq_p, tk_p = -(-tq // 64) * 64, -(-tk // 64) * 64
    _, ds = _p_ds(q, k, v, do, lse, dl, causal, d ** -0.5, qo, ko)
    ds = torch.nn.functional.pad(ds, (0, tk_p - tk, 0, tq_p - tq))
    kh = torch.nn.functional.pad(k.permute(0, 2, 1, 3),
                                 (0, 0, 0, tk_p - tk))
    two = _dq_k2_order(ds, kh, causal, qo, ko)[..., :tq, :]
    one = _dq_k4_order(ds, kh, causal, qo, ko)[..., :tq, :]
    assert torch.equal(two, one)
    assert float(two.abs().max()) > 0.0
