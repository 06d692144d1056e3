"""The transformer training step — counterpart of
``parallel/transformer_tp.py`` on a ``(workers, model, seq)`` mesh of
``dp = tp = 1`` and ``sp`` ranks.

Without a mesh (or at ``sp = 1``) every collective of the JAX step is
the identity: the ``psum`` over ``model``, the ``pmean`` over
``workers``, and ``ring_attention`` with one block, which is one
``flash_attention_with_lse`` call with the lse dropped, that is
``flash_attention``, the default ``attn_fn`` here.  The forward, the
loss and the update are the reference's, attention runs K1 forward and
K2 + K3 backward on the card (``ops/flash_attention.py``), and the
grads come from ``torch.autograd.grad``.

``mesh=make_tp_mesh(sp=n)`` (``parallel/mesh.py``) splits the sequence
over the n ranks of the process group (``examples/long_context.py
--ring``'s path): each rank holds its block ``(B, T/n, input_dim)``, its
positions sliced at ``rank * T/n``; attention is ``ring_attention`` over
the ``seq`` ranks (K1 / K2 + K3 on each block); the pooled sum is summed
across the ranks (``collectives.sum_across``, whose backward passes the
cotangent through, as every rank holds the same loss) and divided by
``cfg["seq_len"]``; after the backward the gradients of every leaf
before the pooling are summed across the ranks (the head's are whole on
every rank already).  Tensor and data parallelism across ranks wait for
ROADMAP queue 1, item 17 (``make_tp_mesh`` refuses ``tp`` or ``dp`` > 1).

Three details must match the reference: the pooled mean divides by
``cfg["seq_len"]``, not by the input's T; the positions are sliced to
this block's ``[start, start + T)``; and with ``compute_dtype`` the
floating params and x are cast for the forward and backward while the
master params, the optimizer state and the loss (f32 log-softmax, mean
nll) stay f32.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from dist_keras_tpu_torch.models.transformer import (
    attention_half,
    init_transformer_params,
    layer_norm,
    mlp_half,
)
from dist_keras_tpu_torch.ops.attention import ring_attention
from dist_keras_tpu_torch.ops.flash_attention import flash_attention
from dist_keras_tpu_torch.ops.optimizers import adam, apply_updates
from dist_keras_tpu_torch.parallel import collectives
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


def _seq(mesh):
    """The mesh's ``seq`` axis when it spans several ranks, else None."""
    return mesh.seq if mesh is not None and mesh.seq.size > 1 else None


def tp_transformer_forward(params, x, cfg, causal=False, remat=False,
                           attn_fn=flash_attention, mesh=None):
    """x: (B, T, input_dim) -> logits (B, n_classes); under a ``mesh``
    with ``sp > 1``, x is this rank's block (B, T / sp, input_dim) and
    the logits are the whole sequence's, on every rank.

    ``remat``: ``False`` stores every activation; ``"mlp"`` checkpoints
    each block's MLP half; ``True`` checkpoints whole blocks (the
    backward re-runs each block's forward, attention kernels included).
    ``attn_fn`` swaps the attention (the kernel path by default), so a
    check can run the same step with plain attention; across ranks the
    attention is ``ring_attention``, whose blocks run the kernels."""
    if remat not in (False, True, "mlp", None):
        raise ValueError(
            f"remat={remat!r}: expected False, True, or 'mlp'")
    t = x.shape[1]
    seq = _seq(mesh)
    start = 0
    if seq is not None:
        if attn_fn is not flash_attention:
            raise ValueError("across seq ranks the attention is "
                             "ring_attention; attn_fn cannot be swapped")
        attn_fn = functools.partial(ring_attention, axis=seq)
        start = seq.index * t
    h = x @ params["proj"] + params["pos"][start:start + t][None]
    for blk in params["blocks"]:
        if remat == "mlp":
            h = _tp_block(blk, h, causal, remat_mlp=True, attn_fn=attn_fn)
        elif remat:
            h = checkpoint(_tp_block, blk, h, causal, False, attn_fn,
                           use_reentrant=False)
        else:
            h = _tp_block(blk, h, causal, attn_fn=attn_fn)
    pooled = layer_norm(params["ln_f"], h).sum(dim=1)
    if seq is not None:
        pooled = collectives.sum_across(pooled, seq)
    pooled = pooled / cfg["seq_len"]
    return pooled @ params["head"]["kernel"] + params["head"]["bias"]


def loss_and_grads(params, x, y, cfg, causal=False, compute_dtype=None,
                   remat=False, attn_fn=flash_attention, mesh=None):
    """-> (loss, grads): the mean softmax cross-entropy of one batch and
    its gradient tree, f32 like ``params``.  The cast to
    ``compute_dtype`` is inside the differentiated function, so the
    grads arrive on the f32 leaves.  Across seq ranks the grads of the
    leaves before the pooling are summed over the ranks (one packed
    all-reduce)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    if compute_dtype is not None:
        p = tree_cast(p, compute_dtype)
        x = x.to(compute_dtype)
    logits = tp_transformer_forward(p, x, cfg, causal=causal, remat=remat,
                                    attn_fn=attn_fn, mesh=mesh)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, y.long()[:, None]).mean()
    grads = list(torch.autograd.grad(nll, leaves))
    seq = _seq(mesh)
    if seq is not None:
        # the head sits after the pooled sum: its grads are whole on
        # every rank; every other leaf's are this rank's share
        head = {id(t) for t in tree_leaves(params["head"])}
        local = [i for i, t in enumerate(tree_leaves(params))
                 if id(t) not in head]
        for i, g in zip(local, collectives.cross_rank_sum(
                [grads[i] for i in local], seq)):
            grads[i] = g
    return nll.detach(), tree_unflatten(params, grads)


def make_tp_train_step(cfg, optimizer=None, loss="softmax_xent",
                       causal=False, compute_dtype=None, remat=False,
                       device=None, mesh=None):
    """-> (step_fn_factory, init_fn).

    ``init_fn(seed) -> (params, opt_state)`` on the device, the params
    drawn from a ``torch.Generator`` (not ``jax.random``'s numbers; the
    same on every rank).  ``step_fn_factory(params, opt_state) ->
    step_fn``, and ``step_fn(params, opt_state, x, y) -> (params,
    opt_state, loss)`` with x (batch, T, input_dim) and y (batch,) int
    labels; under ``mesh=make_tp_mesh(sp=n)`` x is this rank's sequence
    block (batch, T / n, input_dim) (:func:`seq_block`).  The default
    optimizer is ``adam(1e-3)``.  Runs on ``cuda`` unless given
    ``device="cpu"``."""
    if cfg.get("moe_experts", 0):
        raise ValueError(
            "the Megatron TP step supports dense FFN blocks only; for "
            "MoE use make_moe_train_step (dense compute) or "
            "make_moe_ep_train_step (expert parallelism)")
    if loss != "softmax_xent":
        raise ValueError(f"loss={loss!r}: only 'softmax_xent' is supported")
    dev = resolve_device(device)
    tx = optimizer or adam(1e-3)

    def step(params, opt_state, x, y):
        x = torch.as_tensor(x, device=dev)
        y = torch.as_tensor(y, device=dev)
        loss_val, grads = loss_and_grads(params, x, y, cfg, causal=causal,
                                         compute_dtype=compute_dtype,
                                         remat=remat, mesh=mesh)
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


def seq_block(x, mesh):
    """This rank's sequence block of the global x (N, seq_len, ...)
    under ``mesh`` (x itself without one)."""
    seq = _seq(mesh)
    if seq is None:
        return x
    t = x.shape[1] // seq.size
    return x[:, seq.index * t:(seq.index + 1) * t]


def train_tp_transformer(cfg, x, y, steps=10, optimizer=None, seed=0,
                         causal=False, compute_dtype=None, remat=False,
                         device=None, mesh=None):
    """Run ``steps`` full-batch updates from ``init_fn(seed)``.

    x: (N, seq_len, input_dim), the whole sequences on every rank (each
    takes its block under ``mesh``); y: (N,) int labels -> (params,
    losses)."""
    step_factory, init_fn = make_tp_train_step(
        cfg, optimizer=optimizer, causal=causal,
        compute_dtype=compute_dtype, remat=remat, device=device, mesh=mesh)
    x = seq_block(x, mesh)
    params, opt_state = init_fn(seed)
    fn = step_factory(params, opt_state)
    losses = []
    for _ in range(steps):
        params, opt_state, loss_val = fn(params, opt_state, x, y)
        losses.append(float(loss_val))
    return params, losses
