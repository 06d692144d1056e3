"""Plain attention in PyTorch — the counterpart of ``ops/attention.py``.

Shapes are ``(batch, seq, heads, head_dim)`` as in the JAX package.
:func:`attention` and :func:`attention_with_lse` are the oracles the
kernels are held against, and the CPU path of ``ops/flash_attention.py``.

:func:`ring_attention` is sequence parallelism over a ``seq`` mesh axis
of ranks (``parallel.mesh.RankAxis``): each rank holds one sequence
block of Q/K/V; K and V rotate to the next rank at each of the n - 1
ring steps (``parallel.collectives.ring_shift``) while the normalised
block outputs merge through their logsumexp (:func:`_merge_blocks`, the
flash recurrence in logspace).  The block compute is
``flash_attention_with_lse``: the Hopper kernels on the card (K1
forward, K2 + K3 backward with the lse cotangent flowing), the plain
versions on the CPU.
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


def _merge_blocks(acc, o_blk, lse_blk):
    """Fold a normalised block (o (B,T,H,D), lse (B,H,T)) into the
    running f32 (o, lse): the flash recurrence in logspace."""
    o_acc, lse_acc = acc
    lse_new = torch.logaddexp(lse_acc, lse_blk)
    w_old = torch.exp(lse_acc - lse_new).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_blk - lse_new).transpose(1, 2)[..., None]
    return o_acc * w_old + o_blk.float() * w_new, lse_new


def ring_attention(q, k, v, axis=None, causal=False, scale=None,
                   attn_fn=None):
    """Sequence-parallel attention over the ranks of ``axis`` (a
    ``parallel.mesh.RankAxis``; None: every rank of the process group).

    q,k,v: this rank's blocks (B, T_local, H, D); the full sequence is
    the blocks in rank order.  -> this rank's (B, T_local, H, D) output
    block, in q's dtype.  ``attn_fn(q, k, v, causal=, scale=) -> (out,
    lse)`` is the block compute (default ``flash_attention_with_lse``).

    The blocks are aligned and equal, so a K/V block is the diagonal
    (local causal mask), strictly earlier (fully visible) or strictly
    later (fully masked).  The reference gives a strictly later block
    lse = -1e30 and a zero output, so its merge is the identity
    (weights 1 and 0): here such a block is not computed at all, and K
    and V still rotate through every step; each rank runs every
    rotation's backward (the exchanges pair up across the ranks).  At
    size 1 this is one block call with the lse dropped."""
    from dist_keras_tpu_torch.parallel.collectives import ring_shift
    from dist_keras_tpu_torch.parallel.mesh import SEQ_AXIS, rank_axis

    if attn_fn is None:
        from dist_keras_tpu_torch.ops.flash_attention import (
            flash_attention_with_lse as attn_fn,
        )
    axis = rank_axis(SEQ_AXIS) if axis is None else axis
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    o, lse = attn_fn(q, k, v, causal=causal, scale=scale)
    n, idx = axis.size, axis.index
    if n == 1:
        return o
    # the accumulator runs in f32 whatever the input dtype; cast back
    o = o.float()
    kv = torch.stack((k, v))
    for r in range(1, n):
        kv = ring_shift(kv, axis)
        # K/V received at step r came from rank (idx - r) mod n
        if causal and (idx - r) % n > idx:
            continue
        o_blk, lse_blk = attn_fn(q, kv[0], kv[1], causal=False, scale=scale)
        o, lse = _merge_blocks((o, lse), o_blk, lse_blk)
    if causal and idx < n - 1 and kv.requires_grad:
        # this rank skipped the last block: tie its K/V to the output so
        # that every rank runs every shift's backward and the exchanges
        # pair up
        o = _Tie.apply(o, kv)
    return o.to(q.dtype)


class _Tie(torch.autograd.Function):
    """``o`` unchanged; the backward hands ``kv`` a zero cotangent."""

    @staticmethod
    def forward(ctx, o, kv):
        ctx.kv = (kv.shape, kv.dtype, kv.device)
        return o.view_as(o)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.kv
        return g, torch.zeros(shape, dtype=dtype, device=device)
