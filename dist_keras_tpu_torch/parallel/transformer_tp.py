"""The transformer training step — counterpart of
``parallel/transformer_tp.py`` on a ``(workers, model, seq)`` mesh of
ranks (``parallel/mesh.py`` ``make_tp_mesh``).

Without a mesh (or on a mesh of one rank) every collective of the JAX
step is the identity: the ``psum`` over ``model``, the ``pmean`` over
``workers``, and ``ring_attention`` with one block, which is one
``flash_attention_with_lse`` call with the lse dropped, that is
``flash_attention``, the default ``attn_fn`` here.  The forward, the
loss and the update are the reference's, attention runs K1 forward and
K2 + K3 backward on the card (``ops/flash_attention.py``), and the
grads come from ``torch.autograd.grad``.

Across ranks each rank holds one block of the JAX step's shard_map:

- **model** (tensor parallelism, Megatron's split): the rank holds its
  heads of ``wq/wk/wv/wo`` and its columns of ``w1``/``b1``, rows of
  ``w2`` (:func:`param_specs`, :func:`split_tp_params`).  The block
  is ``models/transformer.py``'s ``attention_half`` / ``mlp_half``
  given the ``model`` axis: the
  replicated activation enters each half's column-split products
  through ``collectives.copy_to`` (*f*: identity forward, the sum of
  the ranks' cotangents backward) and leaves ``wo`` and ``w2`` through
  ``collectives.sum_across`` (*g*: the ``psum``, identity backward).
  JAX's vma-aware transpose places *f* by itself; without it the grads
  of ``ln1``, ``ln2``, ``proj``, ``pos`` and the residual stream would
  be one rank's share.  A model-split leaf's grad is whole on its rank
  and is never reduced over ``model``.
- **seq** (sequence parallelism): x is the rank's sequence block, its
  positions sliced at ``seq.index * T_local``; attention is
  ``ring_attention`` over the ``seq`` ranks (K1 / K2 + K3 on each
  block); the pooled sum is summed across the ranks (``sum_across``)
  and divided by ``cfg["seq_len"]``; after the backward the grads of
  every leaf before the pooling are summed over ``seq`` (the head's are
  whole on every rank already).
- **workers** (data parallelism): x is the rank's batch *and* sequence
  block, ``P(workers, seq, None)`` (:func:`local_block`); the loss is
  the mean over the workers ranks, and so is every leaf's grad (one
  packed all-reduce with the loss).

Every rank runs every collective, forward and backward, in one order:
the checkpointed block of ``remat=True`` re-runs its forward
collectives inside the backward on every rank alike.

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
from dist_keras_tpu_torch.parallel.fsdp import (
    gather_by_specs,
    match_specs_for_state,
    place_by_specs,
)
from dist_keras_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    SEQ_AXIS,
    WORKER_AXIS,
    P,
)
from dist_keras_tpu_torch.utils.device import resolve_device
from dist_keras_tpu_torch.utils.pytree import (
    tree_cast,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

_BLOCK_SPECS = {
    "ln1": {"scale": P(), "bias": P()},
    "wq": P(None, MODEL_AXIS, None),
    "wk": P(None, MODEL_AXIS, None),
    "wv": P(None, MODEL_AXIS, None),
    "wo": P(MODEL_AXIS, None, None),
    "ln2": {"scale": P(), "bias": P()},
    "w1": P(None, MODEL_AXIS),
    "b1": P(MODEL_AXIS),
    "w2": P(MODEL_AXIS, None),
    "b2": P(),
}


def param_specs(params):
    """PartitionSpec tree (keys as ``params``'): the head axis / ff axis
    over ``model``, everything else replicated (LN, embeddings, head)."""
    def replicated(tree):
        return tree_map(lambda _: P(), tree)

    return {k: ([{n: _BLOCK_SPECS[n] for n in b} for b in v]
                if k == "blocks" else replicated(v))
            for k, v in params.items()}


def tp_step_specs(params, opt_state):
    """The TP step's argument PartitionSpecs: the params', the optimizer
    state's (each leaf inherits its mirrored param's spec by tree path,
    ``fsdp.match_specs_for_state``), x's and y's."""
    pspecs = param_specs(params)
    ospecs = match_specs_for_state(params, pspecs, opt_state)
    return (pspecs, ospecs, P(WORKER_AXIS, SEQ_AXIS, None), P(WORKER_AXIS))


def _axis(mesh, name):
    """The mesh's axis ``name`` when it spans several ranks, else None."""
    if mesh is None:
        return None
    axis = mesh.axis(name)
    return axis if axis.size > 1 else None


def split_tp_params(params, mesh):
    """A full transformer tree -> this rank's: each ``model``-split leaf
    cut to the rank's heads / FFN units (copies), the rest as it is."""
    if mesh is None:
        return params
    return place_by_specs(mesh, params, param_specs(params))


def gather_tp_params(params, mesh):
    """This rank's tree (params, or grads shaped like them) -> the full
    one on every rank: the ``model``-split leaves all-gathered over the
    model ranks in order."""
    if mesh is None:
        return params
    return gather_by_specs(mesh, params, param_specs(params))


def local_block(x, mesh):
    """This rank's block of a global batch: rows over ``workers``, and
    for x (N, seq_len, ...) the sequence over ``seq``
    (``P(workers, seq, None)``; labels (N,) ``P(workers)``); x itself
    without a mesh or on one rank."""
    if mesh is None:
        return x
    return place_by_specs(mesh, x, P(*(WORKER_AXIS, SEQ_AXIS)[:x.ndim]))


def _tp_block(blk, h, causal, remat_mlp=False, attn_fn=flash_attention,
              model=None):
    """One block; ``remat_mlp`` checkpoints only the MLP half (its 4x-wide
    intermediate is the long-context activation hog), so the backward
    re-runs one dense forward and never the attention kernels."""
    h = attention_half(blk, h, attn_fn, causal, model)
    if remat_mlp:
        return checkpoint(mlp_half, blk, h, model, use_reentrant=False)
    return mlp_half(blk, h, model)


def tp_transformer_forward(params, x, cfg, causal=False, remat=False,
                           attn_fn=flash_attention, mesh=None):
    """x: (B, T, input_dim) -> logits (B, n_classes); under a ``mesh``
    x is this rank's block (B / dp, T / sp, input_dim), ``params`` its
    split (:func:`split_tp_params`), and the logits are its rows' whole
    sequences, on every model and seq rank.

    ``remat``: ``False`` stores every activation; ``"mlp"`` checkpoints
    each block's MLP half; ``True`` checkpoints whole blocks (the
    backward re-runs each block's forward, attention kernels and
    collectives included).  ``attn_fn`` swaps the attention (the kernel
    path by default), so a check can run the same step with plain
    attention; across seq ranks the attention is ``ring_attention``,
    whose blocks run the kernels."""
    if remat not in (False, True, "mlp", None):
        raise ValueError(
            f"remat={remat!r}: expected False, True, or 'mlp'")
    t = x.shape[1]
    model, seq = _axis(mesh, MODEL_AXIS), _axis(mesh, SEQ_AXIS)
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
            h = _tp_block(blk, h, causal, True, attn_fn, model)
        elif remat:
            h = checkpoint(_tp_block, blk, h, causal, False, attn_fn, model,
                           use_reentrant=False)
        else:
            h = _tp_block(blk, h, causal, False, attn_fn, model)
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
    leaves before the pooling are summed over ``seq``; across workers
    ranks the loss and every grad are averaged over ``workers`` (one
    packed all-reduce each)."""
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
    nll = nll.detach()
    seq = _axis(mesh, SEQ_AXIS)
    if seq is not None:
        # the head sits after the pooled sum: its grads are whole on
        # every rank; every other leaf's are this rank's share
        head = {id(t) for t in tree_leaves(params["head"])}
        local = [i for i, t in enumerate(tree_leaves(params))
                 if id(t) not in head]
        for i, g in zip(local, collectives.cross_rank_sum(
                [grads[i] for i in local], seq)):
            grads[i] = g
    workers = _axis(mesh, WORKER_AXIS)
    if workers is not None:
        *grads, nll = [g / workers.size for g in collectives.cross_rank_sum(
            grads + [nll], workers)]
    return nll, tree_unflatten(params, grads)


def make_tp_train_step(cfg, optimizer=None, loss="softmax_xent",
                       causal=False, compute_dtype=None, remat=False,
                       device=None, mesh=None):
    """-> (step_fn_factory, init_fn).

    ``init_fn(seed) -> (params, opt_state)`` on the device, the params
    drawn from a ``torch.Generator`` (not ``jax.random``'s numbers; the
    same on every rank) and split for this rank's ``model`` index, the
    optimizer state on that split.  ``step_fn_factory(params,
    opt_state) -> step_fn``, and ``step_fn(params, opt_state, x, y) ->
    (params, opt_state, loss)`` with x (batch, T, input_dim) and y
    (batch,) int labels; under ``mesh=make_tp_mesh(dp, tp, sp)`` x and
    y are this rank's block (:func:`local_block`) and the loss is the
    global batch's.  The default optimizer is ``adam(1e-3)``.  Runs on
    ``cuda`` unless given ``device="cpu"``."""
    if cfg.get("moe_experts", 0):
        raise ValueError(
            "the Megatron TP step supports dense FFN blocks only; for "
            "MoE use make_moe_train_step (dense compute) or "
            "make_moe_ep_train_step (expert parallelism)")
    if loss != "softmax_xent":
        raise ValueError(f"loss={loss!r}: only 'softmax_xent' is supported")
    model = _axis(mesh, MODEL_AXIS)
    if model is not None and (cfg["n_heads"] % model.size
                              or cfg["d_ff"] % model.size):
        raise ValueError(
            f"tp={model.size} must divide n_heads={cfg['n_heads']} and "
            f"d_ff={cfg['d_ff']}")
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
        params = split_tp_params(init_transformer_params(gen, cfg), mesh)
        params = tree_map(lambda t: t.to(dev), params)
        return params, tx.init(params)

    def step_fn_factory(params, opt_state):
        # the split is in the trees already: every call hands back the
        # same step
        return step

    return step_fn_factory, init_fn


def train_tp_transformer(cfg, x, y, steps=10, optimizer=None, seed=0,
                         causal=False, compute_dtype=None, remat=False,
                         device=None, mesh=None):
    """Run ``steps`` full-batch updates from ``init_fn(seed)``.

    x: (N, seq_len, input_dim), y: (N,) int labels, the global batch on
    every rank (each takes its block under ``mesh``; N must divide by
    the mesh's ``workers`` size and seq_len by its ``seq`` size) ->
    (params, losses), the params this rank's split."""
    step_factory, init_fn = make_tp_train_step(
        cfg, optimizer=optimizer, causal=causal,
        compute_dtype=compute_dtype, remat=remat, device=device, mesh=mesh)
    x, y = local_block(x, mesh), local_block(y, mesh)
    params, opt_state = init_fn(seed)
    fn = step_factory(params, opt_state)
    losses = []
    for _ in range(steps):
        params, opt_state, loss_val = fn(params, opt_state, x, y)
        losses.append(float(loss_val))
    return params, losses
