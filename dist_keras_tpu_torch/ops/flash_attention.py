"""Flash attention: the Hopper kernels, their plain versions, and the
differentiable core.

Counterpart of ``ops/pallas/flash_attention.py``.  The kernels are
``csrc/flash_fwd.cu`` (K1, the forward: f32 on split-TF32 tensor-core
products in ``flash_fwd_f32.cuh``, bf16 in ``flash_fwd_bf16.cuh``) and
``csrc/flash_bwd.cu`` (K2, dQ; K3, dK/dV; bf16 on the tensor cores in
``flash_bwd_bf16.cuh``); see their headers for the designs and bounds.
The one-pass backward K4 and its ``DK_FUSED_BWD`` graduation live in
``ops/fused_bwd_experimental.py``.

- :func:`flash_attention_reference` — the forward's plain version, with
  the kernel's arithmetic: f32 logits and softmax state, probabilities
  cast to the input dtype before P.V, dead rows giving zeros and
  lse = -1e30.
- :func:`flash_bwd_reference` (and its halves
  :func:`flash_bwd_dq_reference`, :func:`flash_bwd_dkv_reference`) —
  the backward's plain version, the counterpart of ``_bwd_call``: P
  recomputed from lse, dS = P * (dO V^T + dl) in f32, P cast to dO's
  dtype before P^T dO and dS to the input dtype before dS K and
  dS^T Q.
- :func:`flash_attention_with_lse` / :func:`flash_attention` — the JAX
  API and layouts (``(B, T, H, D)`` in, lse ``(B, H, T)``), through the
  autograd function :class:`FlashAttentionCore` (the counterpart of
  ``_flash_core``) whenever a gradient is wanted.  A CUDA tensor
  launches the kernels or raises; a CPU tensor takes the plain
  versions.  The TPU block sizes and ``interpret`` have no meaning here
  and are not taken: the kernels tile themselves and mask ragged edges,
  so no T falls back to the reference.
- :func:`attention_auto` — the model's attention: the kernels on CUDA,
  plain ``ops.attention.attention`` on the CPU.

``flash_fwd_launches``, ``flash_bwd_dq_launches`` and
``flash_bwd_dkv_launches`` count kernel launches (never plain-version
calls), so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from dist_keras_tpu_torch.ops import _build
from dist_keras_tpu_torch.ops.attention import (
    NEG_INF,
    attention,
    attention_with_lse,
)
from dist_keras_tpu_torch.utils import knobs

HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_FWD_SIGNATURES = {"dk_flash_fwd": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _F, _I, _I, _I, _P]}
_BWD_SIGNATURES = {
    "dk_flash_bwd_dq": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _F, _I, _I, _I, _P],
    "dk_flash_bwd_dkv": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _F, _I, _I, _I, _P],
}

flash_fwd_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0
_COUNT_LOCK = threading.Lock()


def _count(name):
    with _COUNT_LOCK:
        globals()[name] += 1


def flash_attention_reference(q, k, v, causal=False, scale=None, q_offset=0,
                              kv_offset=0):
    """Plain version of the forward kernel. q (B,Tq,H,D), k/v (B,Tk,H,D)
    -> (out (B,Tq,H,D) in q's dtype, lse (B,H,Tq) float32); p is rounded
    to the input dtype before P.V, as in the kernel."""
    return attention_with_lse(q, k, v, causal=causal, scale=scale,
                              q_offset=q_offset, kv_offset=kv_offset,
                              p_dtype=v.dtype)


def _bwd_tiles(q, k, v, do, lse, dl, causal, scale, q_offset, kv_offset):
    """(P, dS), f32 (B,H,Tq,Tk), as ``_p_tile`` / ``_ds_tile`` recompute
    them: masked logits -> -1e30, dead rows (lse <= -5e29) shift by 0."""
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = kv_offset + torch.arange(k.shape[1], device=q.device)
        logits = logits.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
    safe_lse = torch.where(lse <= NEG_INF / 2, 0.0, lse)
    p = torch.exp(logits - safe_lse[..., None])
    dov = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    return p, p * (dov + dl[..., None])


def _dq_from(ds, k, scale, dtype):
    return (scale * torch.einsum("bhts,bshd->bthd", ds.to(k.dtype).float(),
                                 k.float())).to(dtype)


def _dkv_from(p, ds, q, do, scale, k_dtype, v_dtype):
    dv = torch.einsum("bhts,bthd->bshd", p.to(do.dtype).float(), do.float())
    dk = scale * torch.einsum("bhts,bthd->bshd", ds.to(q.dtype).float(),
                              q.float())
    return dk.to(k_dtype), dv.to(v_dtype)


def flash_bwd_reference(q, k, v, do, lse, dl, causal=False, scale=None,
                        q_offset=0, kv_offset=0):
    """Plain version of the backward kernels (``_bwd_call``).

    q/do (B,Tq,H,D), k/v (B,Tk,H,D); lse and dl = g_lse - rowsum(dO*O)
    (B,H,Tq) float32 -> (dq, dk, dv) in q's, k's and v's dtypes."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    p, ds = _bwd_tiles(q, k, v, do, lse, dl, causal, scale, q_offset,
                       kv_offset)
    return (_dq_from(ds, k, scale, q.dtype),
            *_dkv_from(p, ds, q, do, scale, k.dtype, v.dtype))


def flash_bwd_dq_reference(q, k, v, do, lse, dl, causal=False, scale=None,
                           q_offset=0, kv_offset=0):
    """Plain version of K2 alone -> dq."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    _, ds = _bwd_tiles(q, k, v, do, lse, dl, causal, scale, q_offset,
                       kv_offset)
    return _dq_from(ds, k, scale, q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, dl, causal=False, scale=None,
                            q_offset=0, kv_offset=0):
    """Plain version of K3 alone -> (dk, dv)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    p, ds = _bwd_tiles(q, k, v, do, lse, dl, causal, scale, q_offset,
                       kv_offset)
    return _dkv_from(p, ds, q, do, scale, k.dtype, v.dtype)


def _check_inputs(what, q, k, v, *more):
    """q (B,Tq,H,D) and k/v (B,Tk,H,D) on one CUDA device, one dtype the
    kernels take; ``more`` are further tensors shaped like q (dO)."""
    if not (q.is_cuda and all(x.device == q.device for x in (k, v, *more))):
        raise ValueError(
            f"{what}: q, k, v must lie on one CUDA device; got "
            f"{[str(x.device) for x in (q, k, v, *more)]}")
    if q.dtype not in _DTYPE_CODES or any(x.dtype != q.dtype
                                          for x in (k, v, *more)):
        raise ValueError(
            f"{what} takes float32 or bfloat16 inputs of one dtype; got "
            f"{[x.dtype for x in (q, k, v, *more)]}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or any(x.shape != q.shape for x in more):
        raise ValueError(
            f"{what} wants q (B,Tq,H,D) and k/v (B,Tk,H,D); got "
            f"{[tuple(x.shape) for x in (q, k, v, *more)]}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(
            f"{what}: k/v {tuple(k.shape)} do not match q "
            f"{tuple(q.shape)} in batch, heads or head_dim")
    if d not in HEAD_DIMS:
        raise ValueError(
            f"{what} supports head_dim in {HEAD_DIMS}; got {d}")


def _aligned(*xs):
    """Contiguous, and starting 16-byte aligned: the kernels read rows as
    4-element vectors."""
    xs = (x.contiguous() for x in xs)
    return tuple(x.clone() if x.data_ptr() % 16 else x for x in xs)


def flash_fwd(q, k, v, causal, scale, q_offset, kv_offset):
    """Launch the forward kernel on CUDA tensors (no fallback: it runs or
    raises). -> (out (B,Tq,H,D), lse (B,H,Tq) float32)."""
    _check_inputs("flash_fwd", q, k, v)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    q, k, v = _aligned(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _build.load("flash_fwd", _FWD_SIGNATURES)
    code = lib.dk_flash_fwd(
        _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, h, tq, tk, float(scale),
        int(bool(causal)), int(q_offset), int(kv_offset),
        _build.stream_handle(q.device))
    _build.check(lib, code, "flash_fwd")
    _count("flash_fwd_launches")
    return out, lse


def _bwd_inputs(what, q, k, v, do, lse, dl):
    _check_inputs(what, q, k, v, do)
    b, tq, h, _ = q.shape
    for name, x in (("lse", lse), ("dl", dl)):
        if x.shape != (b, h, tq) or x.dtype != torch.float32 \
                or x.device != q.device:
            raise ValueError(
                f"{what}: {name} must be float32 (B,H,Tq)={(b, h, tq)} on "
                f"{q.device}; got {x.dtype} {tuple(x.shape)} on {x.device}")
    return _aligned(q, k, v, do, lse, dl)


def _bwd_scalars(q, k, scale, causal, q_offset, kv_offset):
    b, tq, h, _ = q.shape
    return (b, h, tq, k.shape[1], float(scale), int(bool(causal)),
            int(q_offset), int(kv_offset), _build.stream_handle(q.device))


def flash_bwd_dq(q, k, v, do, lse, dl, causal, scale, q_offset, kv_offset):
    """Launch K2 on CUDA tensors (runs or raises) -> dq (B,Tq,H,D) in
    q's dtype.  lse and dl (= g_lse - rowsum(dO*O)) are (B,H,Tq) f32."""
    q, k, v, do, lse, dl = _bwd_inputs("flash_bwd_dq", q, k, v, do, lse, dl)
    lib = _build.load("flash_bwd", _BWD_SIGNATURES)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    code = lib.dk_flash_bwd_dq(
        _DTYPE_CODES[q.dtype], q.shape[-1], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(), dl.data_ptr(),
        dq.data_ptr(), *_bwd_scalars(q, k, scale, causal, q_offset,
                                     kv_offset))
    _build.check(lib, code, "flash_bwd_dq")
    _count("flash_bwd_dq_launches")
    return dq


def flash_bwd_dkv(q, k, v, do, lse, dl, causal, scale, q_offset, kv_offset):
    """Launch K3 on CUDA tensors (runs or raises) -> (dk, dv)
    (B,Tk,H,D) in k's dtype."""
    q, k, v, do, lse, dl = _bwd_inputs("flash_bwd_dkv", q, k, v, do, lse,
                                       dl)
    lib = _build.load("flash_bwd", _BWD_SIGNATURES)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    code = lib.dk_flash_bwd_dkv(
        _DTYPE_CODES[q.dtype], q.shape[-1], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(), dl.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *_bwd_scalars(q, k, scale, causal,
                                                    q_offset, kv_offset))
    _build.check(lib, code, "flash_bwd_dkv")
    _count("flash_bwd_dkv_launches")
    return dk, dv


def _forward(q, k, v, causal, scale, q_offset, kv_offset):
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale,
                                         q_offset=q_offset,
                                         kv_offset=kv_offset)
    return flash_fwd(q, k, v, causal, scale, q_offset, kv_offset)


def _fused_bwd_graduated(q, k, causal, q_offset, kv_offset):
    """``DK_FUSED_BWD`` routing predicate (the counterpart of the JAX
    ``_fused_bwd_graduated``): True only when the knob is on AND the
    cached parity run of ``fused_bwd_experimental.graduate`` came back
    exact for this configuration.  A mismatch (or no card to run it on)
    caches a rejection and one ``fused_bwd_rejected`` event, and K2 + K3
    keep serving."""
    if not knobs.get("DK_FUSED_BWD"):
        return False
    from dist_keras_tpu_torch.ops import fused_bwd_experimental as fused

    b, tq, h, d = q.shape
    verdict = fused.graduate(b * h, tq, k.shape[1], d, q.dtype, causal,
                             q_offset=q_offset, kv_offset=kv_offset,
                             device=q.device.type)
    return verdict.status == "exact"


def _backward(q, k, v, do, lse, dl, causal, scale, q_offset, kv_offset):
    if _fused_bwd_graduated(q, k, causal, q_offset, kv_offset):
        from dist_keras_tpu_torch.ops import fused_bwd_experimental as fused

        fn = (fused.fused_bwd_reference if q.device.type == "cpu"
              else fused.fused_bwd)
        return fn(q, k, v, do, lse, dl, causal, scale, q_offset, kv_offset)
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, do, lse, dl, causal=causal,
                                   scale=scale, q_offset=q_offset,
                                   kv_offset=kv_offset)
    dq = flash_bwd_dq(q, k, v, do, lse, dl, causal, scale, q_offset,
                      kv_offset)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, dl, causal, scale,
                               q_offset, kv_offset))


class FlashAttentionCore(torch.autograd.Function):
    """``(q, k, v) -> (out, lse)`` with the flash backward — the
    counterpart of ``_flash_core``.

    The forward is K1 (CPU: :func:`flash_attention_reference`) and keeps
    q, k, v, the output in the input dtype and lse.  The backward follows
    ``_flash_core_bwd``: delta = rowsum(f32(dO) * f32(out)), dl = g_lse -
    delta (g_lse is zeros when the lse got no gradient), then K2 and K3
    (CPU: :func:`flash_bwd_reference`) — or, with ``DK_FUSED_BWD`` on and
    the configuration graduated (:func:`_fused_bwd_graduated`), the
    one-pass K4 (CPU: ``fused_bwd_experimental.fused_bwd_reference``),
    whose results are K2 + K3's bit for bit (graduation serves it only
    where they are)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, kv_offset):
        out, lse = _forward(q, k, v, causal, scale, q_offset, kv_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, q_offset, kv_offset)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        delta = (g_out.float() * out.float()).sum(-1).transpose(1, 2)
        dl = g_lse.float() - delta
        dq, dk, dv = _backward(q, k, v, g_out, lse, dl, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention_with_lse(q, k, v, causal=False, scale=None, q_offset=0,
                             kv_offset=0):
    """q,k,v: (B, T, H, D) -> (out (B,T,H,D), lse (B,H,T) float32).

    Offsets shift the global positions of the local q / kv blocks for
    causal masking.  CUDA tensors run the kernels; CPU tensors the plain
    versions.  Differentiable in q, k and v (through both outputs) when
    a gradient is wanted; otherwise (``torch.no_grad``,
    ``torch.inference_mode``) the forward runs alone and saves nothing."""
    scale = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    args = (bool(causal), scale, int(q_offset), int(kv_offset))
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttentionCore.apply(q, k, v, *args)
    return _forward(q, k, v, *args)


def flash_attention(q, k, v, causal=False, scale=None):
    """Flash attention. q,k,v: (B, T, H, D) -> (B, T, H, D)."""
    out, _ = flash_attention_with_lse(q, k, v, causal=causal, scale=scale)
    return out


def attention_auto(q, k, v, causal=False, scale=None):
    """Device-dispatching attention: the Hopper kernels for CUDA tensors,
    plain attention for CPU tensors."""
    if q.device.type == "cpu":
        return attention(q, k, v, causal=causal, scale=scale)
    return flash_attention(q, k, v, causal=causal, scale=scale)
