"""Paged decode attention: the Hopper kernel and its plain version.

Counterpart of ``ops/pallas/decode_attention.py``: ONE query position
per slot over a paged KV pool.  The kernel is ``csrc/paged_decode.cu``;
see its header for the design and its bound.

Shapes: ``q (S, H, D)``; pools ``k/v (H, P, page_size, D)``;
``page_table (S, max_pages) int32`` (entries past a slot's allocation
may hold any valid page id: they are masked by ``lengths``);
``lengths (S,) int32`` = valid KV positions per slot, INCLUDING the
current token (its k/v is written before attention).

The JAX package serves the jnp reference by default and graduates its
Pallas kernel behind ``DK_DECODE_KERNEL`` and a cached self-check.  The
port has no such switch: :func:`paged_attention_auto` launches the
kernel for CUDA tensors (it runs or raises) and takes
:func:`paged_attention_reference` only for CPU tensors.
``paged_decode_launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from dist_keras_tpu_torch.ops import _build
from dist_keras_tpu_torch.ops.attention import NEG_INF

HEAD_DIMS = (32, 64, 128)
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"dk_paged_decode": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, ctypes.c_float, _P]}

paged_decode_launches = 0
_COUNT_LOCK = threading.Lock()


def paged_attention_reference(q, k_pages, v_pages, page_table, lengths,
                              *, scale=None):
    """Plain version: gather each slot's pages into a contiguous
    ``(S, H, T, D)`` view (T = max_pages * page_size), mask positions
    past ``lengths``, softmax — with the dead-row guards, so a
    ``length == 0`` padding slot yields exact zeros, not NaN."""
    s, h, d = q.shape
    scale = (d ** -0.5) if scale is None else scale
    ps = k_pages.shape[2]
    pt = page_table.long()
    # (H, S, max_pages, ps, D) -> (S, H, T, D)
    t = pt.shape[1] * ps
    k = k_pages[:, pt].movedim(0, 1).reshape(s, h, t, d)
    v = v_pages[:, pt].movedim(0, 1).reshape(s, h, t, d)
    logits = torch.einsum("shd,shtd->sht", q, k).float() * scale
    kpos = torch.arange(t, device=q.device)
    mask = kpos[None, None, :] < lengths.to(q.device)[:, None, None]
    logits = logits.masked_fill(~mask, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - torch.where(m <= NEG_INF / 2, 0.0, m))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("sht,shtd->shd", p, v.float()) / l.clamp_min(1e-30)
    return out.to(q.dtype)


def _check_inputs(q, k_pages, v_pages, page_table, lengths):
    dev = q.device
    tensors = (q, k_pages, v_pages, page_table, lengths)
    if not q.is_cuda or any(x.device != dev for x in tensors):
        raise ValueError("paged_decode: every input must lie on one CUDA "
                         f"device; got {[str(x.device) for x in tensors]}")
    if any(x.dtype != torch.float32 for x in (q, k_pages, v_pages)):
        raise ValueError(
            "paged_decode takes float32 q and pools; got "
            f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"paged_decode wants q (S,H,D) and pools (H,P,page_size,D); got "
            f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
            f"{tuple(v_pages.shape)}")
    s, h, d = q.shape
    if k_pages.shape[0] != h or k_pages.shape[3] != d:
        raise ValueError(
            f"paged_decode: pools {tuple(k_pages.shape)} do not match q "
            f"{tuple(q.shape)} in heads or head_dim")
    if d not in HEAD_DIMS:
        raise ValueError(
            f"paged_decode supports head_dim in {HEAD_DIMS}; got {d}")
    if page_table.dim() != 2 or page_table.shape[0] != s \
            or tuple(lengths.shape) != (s,):
        raise ValueError(
            f"paged_decode wants page_table (S,max_pages) and lengths (S,) "
            f"for S={s}; got {tuple(page_table.shape)}, "
            f"{tuple(lengths.shape)}")
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"paged_decode: {name} must be contiguous and "
                             "16-byte aligned (the kernel loads float4)")


def paged_attention_kernel(q, k_pages, v_pages, page_table, lengths,
                           *, scale=None):
    """Launch the Hopper kernel on CUDA tensors (no fallback: it runs or
    raises). -> (S, H, D) float32."""
    global paged_decode_launches
    _check_inputs(q, k_pages, v_pages, page_table, lengths)
    s, h, d = q.shape
    _, n_pool, ps, _ = k_pages.shape
    scale = (d ** -0.5) if scale is None else float(scale)
    q = q.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    ln = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if s == 0 or h == 0:
        return out
    lib = _build.load("paged_decode", _SIGNATURES)
    code = lib.dk_paged_decode(
        d, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        pt.data_ptr(), ln.data_ptr(), out.data_ptr(), s, h, n_pool, ps,
        pt.shape[1], scale, _build.stream_handle(q.device))
    _build.check(lib, code, "paged_decode")
    with _COUNT_LOCK:
        paged_decode_launches += 1
    return out


def paged_attention_auto(q, k_pages, v_pages, page_table, lengths,
                         *, scale=None):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         lengths, scale=scale)
    return paged_attention_kernel(q, k_pages, v_pages, page_table, lengths,
                                  scale=scale)
