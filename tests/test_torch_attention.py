"""The port's attention (plain + the flash path's CPU version) against the
JAX package: ``ops.attention`` and the Pallas flash forward in interpret
mode, as ``tests/test_pallas.py`` runs it.

Tolerance: f32 max-abs 1e-5 (same math, summation order differs);
bf16 2e-2 on out (both cast p to bf16 before P.V, at different tile
orders) and 1e-4 on lse (f32 arithmetic on exact bf16 products)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_keras_tpu.ops import attention as jattn
from dist_keras_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention,
)
from dist_keras_tpu.ops.pallas.flash_attention import (
    flash_attention_with_lse as jax_flash_attention_with_lse,
)
from dist_keras_tpu_torch.ops import attention as tattn
from dist_keras_tpu_torch.ops import flash_attention as tflash

F32_TOL = 1e-5


def _qkv(b=2, tq=32, tk=None, h=2, d=8, seed=0):
    rng = np.random.default_rng(seed)
    tk = tq if tk is None else tk
    return (rng.normal(size=(b, tq, h, d)).astype(np.float32),
            rng.normal(size=(b, tk, h, d)).astype(np.float32),
            rng.normal(size=(b, tk, h, d)).astype(np.float32))


def _both(q, k, v, **kw):
    """(port's CPU flash path, JAX Pallas kernel in interpret mode)."""
    out, lse = tflash.flash_attention_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), **kw)
    jout, jlse = jax_flash_attention_with_lse(
        *(jnp.asarray(x) for x in (q, k, v)), block_q=8, block_k=8,
        interpret=True, **kw)
    return (out.numpy(), lse.numpy()), (np.asarray(jout), np.asarray(jlse))


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(32, 32), (16, 40), (24, 24)])
def test_flash_path_matches_pallas_kernel(causal, tq, tk):
    (out, lse), (jout, jlse) = _both(*_qkv(tq=tq, tk=tk), causal=causal)
    _close(out, jout)
    _close(lse, jlse)


def test_causal_offsets_match_pallas_kernel():
    q, k, v = _qkv(tq=32)
    # rows 16..31 against keys 0..15: fully visible
    (out, lse), (jout, jlse) = _both(q[:, 16:], k[:, :16], v[:, :16],
                                     causal=True, q_offset=16, kv_offset=0)
    _close(out, jout)
    _close(lse, jlse)
    # rows 0..15 against keys 16..31: fully masked -> zeros, lse -1e30
    (out, lse), (jout, jlse) = _both(q[:, :16], k[:, 16:], v[:, 16:],
                                     causal=True, q_offset=0, kv_offset=16)
    assert np.abs(out).max() == 0.0 and np.abs(jout).max() == 0.0
    assert np.all(lse <= -1e29) and np.all(jlse <= -1e29)


def test_dead_rows_inside_a_visible_tile():
    # keys at global 4..11 vs queries 0..7: rows 0..3 see nothing
    (out, lse), (jout, jlse) = _both(*_qkv(tq=8), causal=True, q_offset=0,
                                     kv_offset=4)
    _close(out, jout)
    _close(lse, jlse)
    assert np.abs(out[:, :4]).max() == 0.0
    assert np.all(lse[:, :, :4] <= -1e29)


def test_ragged_t_matches_reference_fallback():
    # T=24 does not tile by 16: the JAX wrapper falls back to its
    # reference; the port needs no fallback (the kernel masks edges)
    q, k, v = _qkv(tq=24)
    got = tflash.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal=True)
    want = jax_flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                               causal=True, block_q=16, block_k=16,
                               interpret=True)
    _close(got.numpy(), np.asarray(want))


BF16_CASES = {
    # name: (tq, tk, d, causal, q_offset, kv_offset)
    "causal": (16, 16, 8, True, 0, 0),
    "non_causal_tq_ne_tk": (16, 24, 8, False, 0, 0),
    "causal_q_offset": (16, 32, 8, True, 16, 0),
    "dead_rows_in_a_visible_tile": (8, 8, 8, True, 0, 4),
    "several_tiles": (32, 32, 8, True, 0, 0),
    "head_dim_32": (16, 16, 32, True, 0, 0),
}


@pytest.mark.parametrize("case", list(BF16_CASES), ids=list(BF16_CASES))
def test_bf16_flash_path_matches_pallas_kernel(case):
    """The port's plain bf16 forward (the oracle the Hopper kernel is held
    to on the card) against the Pallas kernel interpreted: out within
    2e-2 (both round p to bf16, at different tile orders), lse within
    1e-4 (f32 arithmetic on exact bf16 products in both)."""
    tq, tk, d, causal, qo, ko = BF16_CASES[case]
    q, k, v = _qkv(tq=tq, tk=tk, d=d)
    tq_ = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    out, lse = tflash.flash_attention_with_lse(*tq_, causal=causal,
                                               q_offset=qo, kv_offset=ko)
    jq = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    jout, jlse = jax_flash_attention_with_lse(*jq, causal=causal,
                                              q_offset=qo, kv_offset=ko,
                                              block_q=8, block_k=8,
                                              interpret=True)
    assert out.dtype == torch.bfloat16
    _close(out.float().numpy(), np.asarray(jout, np.float32), tol=2e-2)
    _close(lse.numpy(), np.asarray(jlse), tol=1e-4)
    if ko > qo:
        dead = ko - qo
        assert np.abs(out[:, :dead].float().numpy()).max() == 0.0
        assert np.all(lse[:, :, :dead].numpy() <= -1e29)


def _tf32_hi(x):
    """x rounded to TF32 as the f32 flash forward rounds it (sm90_ptx.cuh's
    dk_split_tf32): half a TF32 ulp added to the bit pattern, the 13 low
    bits cleared (to nearest, ties away from zero), as f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_operand(x):
    """x as a TF32 operand of mma.sync reads it: the top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_split_tf32(a, b, terms=3):
    """a @ b from the kernel's split operands: hi = _tf32_hi(x) and lo = x -
    hi (exact in f32), which the mma truncates to TF32; lo*hi + hi*lo +
    hi*hi summed in f32 (a product of two TF32 values is exact in f32).
    The order in which the tensor cores add within one mma is not
    modelled.  ``terms=1`` is one TF32 product of the rounded operands."""
    ah, bh = _tf32_hi(a), _tf32_hi(b)
    if terms == 1:
        return ah @ bh
    al, bl = _tf32_operand(a - ah), _tf32_operand(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _split_tf32_forward(q, k, v, causal, q_offset=0, kv_offset=0, terms=3):
    """The f32 flash forward kernel's arithmetic in torch: 32-row q blocks;
    each 64-key tile split into two 32-key halves, each half with its own
    online softmax (f32, base 2 as in the kernel) over its keys, the two
    meeting at the end, each rescaled to the larger max; S = Q K^T and
    O += P V as split-TF32 products; dead rows 0 with lse -1e30.
    q (B,Tq,H,D), k/v (B,Tk,H,D) f32 -> (out (B,Tq,H,D), lse (B,H,Tq))."""
    b, tq, h, d = q.shape
    tk, scale = k.shape[1], d ** -0.5
    scale2 = scale * math.log2(math.e)
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    out, lse = torch.zeros_like(qh), torch.empty(b, h, tq)
    for q0 in range(0, tq, 32):
        rows = q_offset + torch.arange(q0, min(q0 + 32, tq))
        halves = []
        for half in (0, 1):   # keys 32 half.. of each 64-key tile
            m = torch.full((b, h, len(rows)), -1e30)
            l = torch.zeros((b, h, len(rows)))
            acc = torch.zeros((b, h, len(rows), d))
            for k0 in range(32 * half, tk, 64):
                s = _mm_split_tf32(qh[:, :, q0:q0 + 32],
                                   kh[:, :, k0:k0 + 32].transpose(-1, -2),
                                   terms)
                if causal:
                    keys = kv_offset + torch.arange(k0, min(k0 + 32, tk))
                    s = s.masked_fill(keys[None, :] > rows[:, None], -1e30)
                m_new = torch.maximum(m, s.amax(-1))
                shift = torch.where(m_new <= -5e29, 0.0, m_new * scale2)
                p = torch.exp2(s * scale2 - shift[..., None])
                corr = torch.exp2((m - m_new) * scale2)
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + _mm_split_tf32(
                    p, vh[:, :, k0:k0 + 32], terms)
                m = m_new
            halves.append((m, l, acc))
        (m0, l0, a0), (m1, l1, a1) = halves
        m = torch.maximum(m0, m1)
        c0, c1 = torch.exp2((m0 - m) * scale2), torch.exp2((m1 - m) * scale2)
        l = l0 * c0 + l1 * c1
        acc = a0 * c0[..., None] + a1 * c1[..., None]
        out[:, :, q0:q0 + 32] = acc / l.clamp_min(1e-30)[..., None]
        lse[:, :, q0:q0 + 32] = torch.where(l > 0, m * scale + torch.log(l),
                                            -1e30)
    return out.permute(0, 2, 1, 3), lse


SPLIT_TF32_CASES = {
    # name: (tq, tk, causal, q_offset, kv_offset)
    "causal": (64, 64, True, 0, 0),
    "non_causal_tq_ne_tk": (48, 80, False, 0, 0),
    "causal_q_offset": (32, 64, True, 32, 0),
    "dead_rows": (48, 48, True, 0, 16),
}


@pytest.mark.parametrize("case", list(SPLIT_TF32_CASES),
                         ids=list(SPLIT_TF32_CASES))
def test_split_tf32_forward_meets_the_f32_tolerance(case):
    """The f32 kernel's precision design, rehearsed on the CPU: its
    rounding of each operand and its key halves (not the tensor cores'
    order of addition within an mma) stay within F32_TOL of the Pallas
    kernel in interpret mode, on out and lse."""
    tq, tk, causal, qo, ko = SPLIT_TF32_CASES[case]
    q, k, v = _qkv(tq=tq, tk=tk, d=32)
    out, lse = _split_tf32_forward(*(torch.from_numpy(x) for x in (q, k, v)),
                                   causal, qo, ko)
    jout, jlse = jax_flash_attention_with_lse(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal, q_offset=qo,
        kv_offset=ko, block_q=16, block_k=16, interpret=True)
    _close(out.numpy(), np.asarray(jout))
    _close(lse.numpy(), np.asarray(jlse))
    if ko > qo:
        assert np.abs(out[:, :ko - qo].numpy()).max() == 0.0
        assert np.all(lse[:, :, :ko - qo].numpy() <= -1e29)


def test_one_tf32_product_misses_the_f32_tolerance():
    """Why the kernel splits: one TF32 product per f32 product keeps 11
    significant bits of each operand, and the forward then misses
    F32_TOL by orders of magnitude."""
    q, k, v = _qkv(tq=64, d=32)
    want, _ = jax_flash_attention_with_lse(
        *(jnp.asarray(x) for x in (q, k, v)), causal=True, block_q=16,
        block_k=16, interpret=True)
    out, _ = _split_tf32_forward(*(torch.from_numpy(x) for x in (q, k, v)),
                                 True, terms=1)
    assert np.abs(out.numpy() - np.asarray(want)).max() > 10 * F32_TOL


@pytest.mark.parametrize("causal", [False, True])
def test_plain_attention_matches_jax(causal):
    q, k, v = _qkv(tq=12, tk=20)
    got = tattn.attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          causal=causal)
    want = jattn.attention(*(jnp.asarray(x) for x in (q, k, v)),
                           causal=causal)
    _close(got.numpy(), np.asarray(want))
    out, lse = tattn.attention_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        q_offset=8, kv_offset=0)
    jout, jlse = jattn.attention_with_lse(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal, q_offset=8,
        kv_offset=0)
    _close(out.numpy(), np.asarray(jout))
    _close(lse.numpy(), np.asarray(jlse))


def test_attention_auto_on_cpu_is_plain_and_launches_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv())
    before = tflash.flash_fwd_launches
    got = tflash.attention_auto(q, k, v, causal=True)
    assert torch.equal(got, tattn.attention(q, k, v, causal=True))
    assert tflash.flash_fwd_launches == before


def test_kernel_entry_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _qkv())
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_fwd(q, k, v, True, 0.1, 0, 0)
