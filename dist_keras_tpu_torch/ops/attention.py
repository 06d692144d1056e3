"""Plain attention in PyTorch — the counterpart of ``ops/attention.py``.

Shapes are ``(batch, seq, heads, head_dim)`` as in the JAX package.
These are the oracles the kernels are held against, and the CPU path of
``ops/flash_attention.py``.  Ring attention (sequence parallelism) is
not ported yet.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention(q, k, v, causal=False, scale=None):
    """Reference attention. q,k,v: (B, T, H, D) -> (B, T, H, D)."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    logits = torch.einsum("bthd,bshd->bhts", q, k) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        mask = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril(diagonal=tk - tq)
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def attention_with_lse(q, k, v, causal=False, scale=None, q_offset=0,
                       kv_offset=0, p_dtype=torch.float32):
    """Attention returning (out (B,T,H,D), lse (B,H,T) float32).

    ``q_offset``/``kv_offset`` shift the global positions used by the
    causal mask.  Fully-masked rows produce a zero output row and
    lse = -1e30 (finite, so a downstream logaddexp merge stays NaN-free).
    Logits and the softmax run in f32; the probabilities are rounded to
    ``p_dtype`` before P.V (the flash kernels pass the input dtype).
    """
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = kv_offset + torch.arange(k.shape[1], device=q.device)
        logits = logits.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    dead = m <= NEG_INF / 2            # fully-masked rows
    p = torch.exp(logits - torch.where(dead, 0.0, m))
    l = p.sum(dim=-1, keepdim=True)
    out = (torch.einsum("bhts,bshd->bthd", p.to(p_dtype).float(), v.float())
           / l.clamp_min(1e-30).transpose(1, 2))
    lse = torch.where(dead[..., 0], NEG_INF,
                      m[..., 0] + torch.log(l[..., 0].clamp_min(1e-30)))
    return out.to(q.dtype), lse
