"""The transformer training step on one card — counterpart of
``parallel/transformer_tp.py`` on its 1x1x1 mesh.

On one device every collective of the JAX step is the identity: the
``psum`` over ``model``, the ``pmean`` over ``workers``, and
``ring_attention`` with one block, which is one
``flash_attention_with_lse`` call with the lse dropped, that is
``flash_attention``, the default ``attn_fn`` here.  So this module
takes no mesh: the forward, the loss and the update are the reference's,
attention runs K1 forward and K2 + K3 backward on the card
(``ops/flash_attention.py``), and the grads come from
``torch.autograd.grad``.  Tensor, sequence and data parallelism across
cards are not ported yet.

Three details must match the reference: the pooled mean divides by
``cfg["seq_len"]``, not by the input's T; the positions are sliced to
``[:T]``; and with ``compute_dtype`` the floating params and x are cast
for the forward and backward while the master params, the optimizer
state and the loss (f32 log-softmax, mean nll) stay f32.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from dist_keras_tpu_torch.models.transformer import (
    attention_half,
    init_transformer_params,
    layer_norm,
    mlp_half,
)
from dist_keras_tpu_torch.ops.flash_attention import flash_attention
from dist_keras_tpu_torch.ops.optimizers import adam, apply_updates
from dist_keras_tpu_torch.utils.device import resolve_device
from dist_keras_tpu_torch.utils.pytree import (
    tree_cast,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


def _tp_block(blk, h, causal, remat_mlp=False, attn_fn=flash_attention):
    """One block; ``remat_mlp`` checkpoints only the MLP half (its 4x-wide
    intermediate is the long-context activation hog), so the backward
    re-runs one dense forward and never the attention kernels."""
    h = attention_half(blk, h, attn_fn, causal)
    if remat_mlp:
        return checkpoint(mlp_half, blk, h, use_reentrant=False)
    return mlp_half(blk, h)


def tp_transformer_forward(params, x, cfg, causal=False, remat=False,
                           attn_fn=flash_attention):
    """x: (B, T, input_dim) -> logits (B, n_classes).

    ``remat``: ``False`` stores every activation; ``"mlp"`` checkpoints
    each block's MLP half; ``True`` checkpoints whole blocks (the
    backward re-runs each block's forward, attention kernels included).
    ``attn_fn`` swaps the attention (the kernel path by default), so a
    check can run the same step with plain attention."""
    if remat not in (False, True, "mlp", None):
        raise ValueError(
            f"remat={remat!r}: expected False, True, or 'mlp'")
    t = x.shape[1]
    h = x @ params["proj"] + params["pos"][:t][None]
    for blk in params["blocks"]:
        if remat == "mlp":
            h = _tp_block(blk, h, causal, remat_mlp=True, attn_fn=attn_fn)
        elif remat:
            h = checkpoint(_tp_block, blk, h, causal, False, attn_fn,
                           use_reentrant=False)
        else:
            h = _tp_block(blk, h, causal, attn_fn=attn_fn)
    pooled = layer_norm(params["ln_f"], h).sum(dim=1) / cfg["seq_len"]
    return pooled @ params["head"]["kernel"] + params["head"]["bias"]


def loss_and_grads(params, x, y, cfg, causal=False, compute_dtype=None,
                   remat=False, attn_fn=flash_attention):
    """-> (loss, grads): the mean softmax cross-entropy of one batch and
    its gradient tree, f32 like ``params``.  The cast to
    ``compute_dtype`` is inside the differentiated function, so the
    grads arrive on the f32 leaves."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    if compute_dtype is not None:
        p = tree_cast(p, compute_dtype)
        x = x.to(compute_dtype)
    logits = tp_transformer_forward(p, x, cfg, causal=causal, remat=remat,
                                    attn_fn=attn_fn)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, y.long()[:, None]).mean()
    grads = torch.autograd.grad(nll, leaves)
    return nll.detach(), tree_unflatten(params, grads)


def make_tp_train_step(cfg, optimizer=None, loss="softmax_xent",
                       causal=False, compute_dtype=None, remat=False,
                       device=None):
    """-> (step_fn_factory, init_fn).

    ``init_fn(seed) -> (params, opt_state)`` on the device, the params
    drawn from a ``torch.Generator`` (not ``jax.random``'s numbers).
    ``step_fn_factory(params, opt_state) -> step_fn``, and
    ``step_fn(params, opt_state, x, y) -> (params, opt_state, loss)``
    with x (batch, T, input_dim) and y (batch,) int labels.  The default
    optimizer is ``adam(1e-3)``.  Runs on ``cuda`` unless given
    ``device="cpu"``."""
    if cfg.get("moe_experts", 0):
        raise ValueError(
            "the transformer step supports dense FFN blocks only; MoE is "
            "not ported yet")
    if loss != "softmax_xent":
        raise ValueError(f"loss={loss!r}: only 'softmax_xent' is supported")
    dev = resolve_device(device)
    tx = optimizer or adam(1e-3)

    def step(params, opt_state, x, y):
        x = torch.as_tensor(x, device=dev)
        y = torch.as_tensor(y, device=dev)
        loss_val, grads = loss_and_grads(params, x, y, cfg, causal=causal,
                                         compute_dtype=compute_dtype,
                                         remat=remat)
        updates, opt_state = tx.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss_val

    def init_fn(seed=0):
        gen = torch.Generator().manual_seed(int(seed))
        params = tree_map(lambda t: t.to(dev),
                          init_transformer_params(gen, cfg))
        return params, tx.init(params)

    def step_fn_factory(params, opt_state):
        # the JAX factory needs the trees for its shardings; one card needs
        # nothing from them, so every call hands back the same step
        return step

    return step_fn_factory, init_fn


def train_tp_transformer(cfg, x, y, steps=10, optimizer=None, seed=0,
                         causal=False, compute_dtype=None, remat=False,
                         device=None):
    """Run ``steps`` full-batch updates from ``init_fn(seed)``.

    x: (N, seq_len, input_dim); y: (N,) int labels -> (params, losses)."""
    step_factory, init_fn = make_tp_train_step(
        cfg, optimizer=optimizer, causal=causal,
        compute_dtype=compute_dtype, remat=remat, device=device)
    params, opt_state = init_fn(seed)
    fn = step_factory(params, opt_state)
    losses = []
    for _ in range(steps):
        params, opt_state, loss_val = fn(params, opt_state, x, y)
        losses.append(float(loss_val))
    return params, losses
