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
