"""The one-pass backward's plain version and the ``DK_FUSED_BWD`` machinery
against the JAX package (``ops/pallas/fused_bwd_experimental.py``).

Oracles.  At a single kv block the JAX fused kernel, run in interpret
mode as ``tests/test_speed.py`` runs it, is exact, so it is the oracle
there.  With several kv blocks its aliased dq revisit is last-write-wins
in interpret mode (the JAX module's docstring), so it is no oracle:
there the port's plain version is held against ``_bwd_call`` (the
two-kernel backward, interpreted), which computes the function the
port's kernel computes.  The port's plain version walks 64-key kv tiles,
so the multi-block cases use Tk > 64.

Tolerances: f32 max-abs 1e-5 (same math, summation order differs); bf16
2e-2 (both round P and dS to bf16 from f32 sums taken in different
orders), as ``tests/test_torch_flash_bwd.py``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_keras_tpu.ops.pallas.flash_attention import _bwd_call
from dist_keras_tpu.ops.pallas.fused_bwd_experimental import fused_bwd_call
from dist_keras_tpu_torch.observability import events
from dist_keras_tpu_torch.ops import flash_attention as tflash
from dist_keras_tpu_torch.ops import fused_bwd_experimental as fused

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _arrays(b, tq, tk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda t: rng.normal(size=(b, t, h, d)).astype(np.float32)  # noqa: E731
    return (mk(tq), mk(tk), mk(tk), mk(tq),
            rng.normal(size=(b, h, tq)).astype(np.float32))


def _to_bh(x):
    b, t, h, d = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, d)


def _from_bh(x, b, h):
    bh, t, d = x.shape
    return np.asarray(x, np.float32).reshape(b, h, t, d).transpose(0, 2, 1, 3)


def _both(jax_fn, q, k, v, do, g_lse, causal, block_q, block_k, q_offset=0,
          kv_offset=0, dtype=torch.float32, jdtype=jnp.float32):
    """(port's fused_bwd_reference, ``jax_fn`` interpreted) on the same
    inputs; lse from the port's forward, dl = g_lse - delta."""
    b, tq, h, d = q.shape
    scale = d ** -0.5
    tq_, tk_, tv_, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    out, lse = tflash.flash_attention_reference(
        tq_, tk_, tv_, causal=causal, q_offset=q_offset, kv_offset=kv_offset)
    dl = torch.from_numpy(g_lse) - (tdo.float() * out.float()).sum(
        -1).transpose(1, 2)
    got = fused.fused_bwd_reference(tq_, tk_, tv_, tdo, lse, dl, causal,
                                    scale, q_offset, kv_offset)
    cast = lambda x: _to_bh(np.asarray(x.float())).astype(jdtype)  # noqa: E731
    want = jax_fn(cast(tq_), cast(tk_), cast(tv_), cast(tdo),
                  jnp.asarray(lse.numpy()).reshape(b * h, tq, 1),
                  jnp.asarray(dl.numpy()).reshape(b * h, tq, 1),
                  causal, scale, block_q, block_k, q_offset, kv_offset, True)
    return ([g.float().numpy() for g in got],
            [_from_bh(w, b, h) for w in want])


def _fused_call(q, k, v, do, lse, dl, causal, scale, block_q, block_k,
                q_offset, kv_offset, interpret):
    return fused_bwd_call(q, k, v, do, lse, dl, causal, scale, block_q,
                          block_k, q_offset=q_offset, kv_offset=kv_offset,
                          interpret=interpret)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_jax_fused_kernel_at_one_kv_block(causal):
    q, k, v, do, g = _arrays(2, 32, 32, 2, 8)
    got, want = _both(_fused_call, q, k, v, do, g * 0, causal, 8, 32)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_two_kernel_backward_at_many_kv_blocks(causal):
    q, k, v, do, g = _arrays(1, 96, 160, 2, 8, seed=1)
    got, want = _both(_bwd_call, q, k, v, do, g, causal, 32, 32)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("q_offset,kv_offset", [(64, 0), (0, 40)],
                         ids=["q_offset", "dead_rows"])
def test_plain_matches_two_kernel_backward_with_offsets(q_offset, kv_offset):
    q, k, v, do, g = _arrays(1, 64, 128, 2, 8, seed=2)
    got, want = _both(_bwd_call, q, k, v, do, g, True, 32, 32,
                      q_offset=q_offset, kv_offset=kv_offset)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=F32_TOL, rtol=0)
    if kv_offset > q_offset:
        assert np.abs(got[0][:, :kv_offset - q_offset]).max() == 0.0


def test_plain_bf16_matches_two_kernel_backward():
    q, k, v, do, g = _arrays(1, 32, 96, 2, 8, seed=3)
    got, want = _both(_bwd_call, q, k, v, do, g, False, 32, 32,
                      dtype=torch.bfloat16, jdtype=jnp.bfloat16)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=BF16_TOL, rtol=0)


def test_plain_equals_the_two_kernel_plain_version():
    q, k, v, do, g = (torch.from_numpy(x) for x in _arrays(1, 40, 200, 2, 8))
    _, lse = tflash.flash_attention_reference(q, k, v, causal=True)
    args = (q, k, v, do, lse, g, True, 0.3, 0, 0)
    for a, b in zip(fused.fused_bwd_reference(*args),
                    tflash.flash_bwd_reference(*args)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_kernel_entry_refuses_cpu_tensors():
    q, k, v, do, g = (torch.from_numpy(x) for x in _arrays(1, 8, 8, 2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        fused.fused_bwd(q, k, v, do, torch.zeros(1, 2, 8), g, True, 0.1, 0, 0)


# -- the selfcheck / graduation machinery (tests/test_speed.py:316-441) --
@pytest.fixture
def clean(monkeypatch, tmp_path):
    monkeypatch.delenv("DK_OBS_DIR", raising=False)
    monkeypatch.delenv("DK_FUSED_BWD", raising=False)
    events.reset()
    fused.clear_verdicts()
    yield tmp_path
    events.reset()
    fused.clear_verdicts()


def _perturbed(monkeypatch):
    orig = fused.fused_bwd_reference

    def bad(*a, **kw):
        dq, dk, dv = orig(*a, **kw)
        return dq * 1.01 + 1e-2, dk, dv

    monkeypatch.setattr(fused, "fused_bwd_reference", bad)


def _kinds(obs):
    kinds = []
    for f in obs.glob("events-*"):
        kinds += [json.loads(ln)["kind"] for ln in f.read_text().splitlines()
                  if ln.strip()]
    return kinds


def test_selfcheck_unverifiable_without_cuda(clean, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    v = fused.selfcheck(bh=1, t=16, d=8)
    ok, err = v
    assert v.status == "unverifiable"
    assert ok is False and err is None
    assert "cuda" in v.reason.lower() and "device" in v.reason


def test_selfcheck_on_the_cpu_is_exact(clean):
    v = fused.selfcheck(bh=1, t=16, d=8, dtype=torch.float32, device="cpu")
    assert v.status == "exact"
    assert v.ok is True and v.err <= 1e-6


def test_selfcheck_detects_a_perturbed_fused_backward(clean, monkeypatch):
    _perturbed(monkeypatch)
    v = fused.selfcheck(bh=1, t=16, d=8, dtype=torch.float32, device="cpu")
    assert v.status == "mismatch"
    assert v.err is not None and v.err > 1e-3
    assert "diverged" in v.reason


def _qkv(t=16, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(1, t, 1, d)).astype(
        np.float32)).requires_grad_() for _ in range(3)]


def _grads(q, k, v):
    out = tflash.flash_attention(q, k, v, causal=True)
    return torch.autograd.grad((out ** 2).sum(), (q, k, v))


def test_fused_routing_off_by_default(clean, monkeypatch):
    called = []
    orig = tflash._fused_bwd_graduated

    def spy(*a, **kw):
        called.append(orig(*a, **kw))
        return called[-1]

    monkeypatch.setattr(tflash, "_fused_bwd_graduated", spy)
    _grads(*_qkv())
    assert called == [False]
    assert not fused._VERDICTS


def test_fused_routing_rejects_then_graduates(clean, monkeypatch):
    """DK_FUSED_BWD=1: a perturbed fused plain version is rejected (K2+K3's
    plain version serves, grads unchanged, ONE fused_bwd_rejected event
    over two backwards); the intact one graduates and serves."""
    q, k, v = _qkv()
    want = _grads(q, k, v)                      # knob off: K2 + K3 route
    monkeypatch.setenv("DK_FUSED_BWD", "1")
    monkeypatch.setenv("DK_OBS_DIR", str(clean))
    events.reset()
    with monkeypatch.context() as m:
        _perturbed(m)
        for _ in range(2):
            got = _grads(q, k, v)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    assert _kinds(clean).count("fused_bwd_rejected") == 1
    [rec] = [json.loads(ln) for f in clean.glob("events-*")
             for ln in f.read_text().splitlines()]
    assert rec["reason"] == "mismatch" and rec["shape"] == [1, 16, 16, 8]

    fused.clear_verdicts()
    served = []
    orig = fused.fused_bwd_reference

    def spy(*a, **kw):
        served.append(a[0].shape)
        return orig(*a, **kw)

    monkeypatch.setattr(fused, "fused_bwd_reference", spy)
    got = _grads(q, k, v)
    # the parity run calls the plain version once, the backward once more
    assert len(served) == 2 and served[-1] == (1, 16, 1, 8)
    assert [vv.status for vv in fused._VERDICTS.values()] == ["exact"]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0)
    assert _kinds(clean).count("fused_bwd_rejected") == 1


def test_fused_verdict_cached_one_parity_run(clean, monkeypatch):
    calls = []
    orig = fused.selfcheck

    def spy(*a, **kw):
        calls.append(kw)
        return orig(*a, **kw)

    monkeypatch.setattr(fused, "selfcheck", spy)
    for _ in range(3):
        v = fused.graduate(1, 16, 16, 8, torch.float32, True, device="cpu")
    assert v.status == "exact"
    assert len(calls) == 1


def test_fused_offsets_never_graduate(clean, monkeypatch):
    monkeypatch.setenv("DK_OBS_DIR", str(clean))
    events.reset()
    for _ in range(2):
        v = fused.graduate(1, 16, 16, 8, torch.float32, True, q_offset=16,
                           device="cpu")
    assert v.status == "unverifiable"
    assert "offset" in v.reason
    assert _kinds(clean) == ["fused_bwd_rejected"]


def test_fingerprint_names_the_build():
    fp = fused.compiler_fingerprint("cpu")
    assert torch.__version__ in fp
    assert "libfused_bwd-" in fp
