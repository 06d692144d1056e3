"""Switch mixture-of-experts FFN and its training steps — counterpart of
``parallel/moe.py``.

- **Routing** (:func:`_route`): top-1 (Switch) router; each expert takes
  at most ``C = ceil(tokens * capacity_factor / num_experts)`` tokens, in
  assignment order (an int32 cumsum, exact at any token count); a token
  past its expert's capacity is dropped (zero output: the residual
  carries it).  The aux loss is Switch's ``sum(frac_tokens *
  frac_probs) * E``.
- **Dispatch by index.**  The reference builds one-hot ``(N, E, C)``
  dispatch and combine tensors and moves tokens with the einsums
  ``"nec,nd->ecd"`` / ``"nec,ecd->nd"``.  At ``bench_transformer_tp``'s
  shape (N = 32,768 tokens, E = 8, C = 5,120) each of those tensors is
  1.34e9 elements a layer, and each einsum ~2 PFLOP.  The port moves
  the same rows with gathers instead: each token's slot ``expert * C +
  position`` (kept tokens only) is inverted into the token of each slot
  (:func:`_slots`), the experts' input is one ``index_select`` of the
  tokens and the output one ``index_select`` of the experts' rows
  scaled by the gate.  Each output entry of the einsums has exactly one
  non-zero term, so for finite inputs the results are the einsums' bit
  for bit; the gradients are the same math (the backward of a gather
  adds each row once), with the gate's and the biases' sums run in
  another order.  :func:`switch_moe_dense_reference` keeps
  the one-hot form as the plain version (tests and the card's check);
  nothing on the path calls it.
- **Dtypes.**  The experts' products run in the tokens' dtype (bf16
  under a bf16 compute dtype); the combine is f32 (the gate is f32),
  cast back to the tokens' dtype.  The reference's one-hot dispatch is
  f32, so its einsum promotes bf16 tokens to f32; on f32 inputs the two
  agree bit for bit.
- **Expert parallelism** (:func:`switch_moe_ep`): the experts are split
  over the ranks of the ``experts`` axis (``mesh.RankAxis``), each rank
  holding ``E / ep`` of them and its own tokens; one
  ``collectives.all_to_all`` each way moves the tokens to their
  expert's rank and the results back (its backward is the reverse
  exchange).  Capacity comes from the local token count, as in the
  reference.

The steps: :func:`make_moe_train_step` (one card; nll + aux_weight *
aux) and :func:`make_moe_ep_train_step` (sequences batch-split over the
expert ranks, expert stacks split over the same ranks; the replicated
leaves' gradients summed across the ranks through the packed
all-reduce, the expert leaves' complete on their owner through the
exchange's backward).  Attention is ``attention_auto``: K1 forward and
K2 + K3 backward on the card.
"""

from __future__ import annotations

import functools
import math

import torch

from dist_keras_tpu_torch.models.transformer import (
    _glorot_uniform,
    apply_block_aux,
    gelu,
    init_transformer_params,
    layer_norm,
    transformer_apply_with_aux,
)
from dist_keras_tpu_torch.ops.optimizers import adam, apply_updates
from dist_keras_tpu_torch.parallel import collectives
from dist_keras_tpu_torch.parallel.mesh import EXPERT_AXIS, rank_axis
from dist_keras_tpu_torch.utils.device import resolve_device
from dist_keras_tpu_torch.utils.pytree import (
    tree_cast,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

__all__ = ["EXPERT_AXIS", "gather_moe_params", "init_moe_params",
           "make_moe_ep_train_step", "make_moe_train_step",
           "moe_param_specs", "moe_transformer_param_specs",
           "split_moe_params",
           "switch_moe_dense", "switch_moe_dense_reference",
           "switch_moe_ep"]


def init_moe_params(gen, d_model, d_ff, num_experts):
    """Router + per-expert FFN stacks (CPU tensors from the
    ``torch.Generator`` ``gen``; the reference's layout)."""
    return {
        "router": _glorot_uniform(gen, (d_model, num_experts)),
        "w1": _glorot_uniform(gen, (num_experts, d_model, d_ff)),
        "b1": torch.zeros(num_experts, d_ff),
        "w2": _glorot_uniform(gen, (num_experts, d_ff, d_model)),
        "b2": torch.zeros(num_experts, d_model),
    }


def moe_param_specs(axis=EXPERT_AXIS):
    """The layer's split rule: the expert stacks on ``axis``, the router
    replicated (None)."""
    return {"router": None, "w1": axis, "b1": axis, "w2": axis, "b2": axis}


def _capacity(n, capacity_factor, num_experts):
    return int(math.ceil(n * capacity_factor / num_experts))


def _route(params, x, num_experts, capacity):
    """-> (expert (N,), position (N,), keep (N,), gate (N,) f32, probs
    (N, E) f32, aux): top-1 routing with per-expert capacity; a token's
    position in its expert's queue is its assignment order."""
    logits = x @ params["router"]
    probs = torch.softmax(logits.float(), dim=-1)
    gate = probs.amax(dim=-1)
    expert = probs.argmax(dim=-1)
    onehot = torch.nn.functional.one_hot(expert, num_experts).to(torch.int32)
    # int32 cumsum: exact for any token count (an f32 one loses exactness
    # past 2^24 tokens and would corrupt the capacity assignment); run
    # over the tokens as the innermost dim of an (E, N) copy, since a scan
    # over the outer dim of (N, E) runs E columns in parallel at most
    counts = torch.cumsum(onehot.t().contiguous(), dim=1, dtype=torch.int32)
    pos = (counts.t() * onehot - onehot).sum(dim=-1, dtype=torch.int32)
    keep = pos < capacity
    frac_tokens = onehot.float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = torch.sum(frac_tokens * frac_probs) * num_experts
    return expert, pos, keep, gate, probs, aux


def _slots(expert, pos, keep, num_experts, capacity):
    """-> (slot (N,), token (E*C,)): each token's slot ``e * C + pos``
    (E*C for a dropped token) and each slot's token (N for an empty
    slot).  Dropped tokens scatter to slots of their own past E*C, so
    every index written is distinct."""
    n = expert.shape[0]
    ec = num_experts * capacity
    ar = torch.arange(n, device=expert.device)
    slot = torch.where(keep, expert * capacity + pos, ec + ar)
    token = torch.full((ec + n,), n, dtype=torch.long, device=expert.device)
    token.scatter_(0, slot, ar)
    return torch.where(keep, slot, ec), token[:ec]


def _dispatch(x, token, num_experts, capacity):
    """Tokens -> the experts' queues (E, C, d); empty slots are zero."""
    x_pad = torch.cat((x, x.new_zeros(1, x.shape[1])))
    return x_pad.index_select(0, token).view(num_experts, capacity, -1)


def _combine(ys, slot, keep, gate):
    """The experts' rows back to their tokens, scaled by the gate (f32;
    zero for a dropped token)."""
    flat = ys.reshape(-1, ys.shape[-1])
    y_pad = torch.cat((flat, flat.new_zeros(1, flat.shape[1])))
    rows = y_pad.index_select(0, slot).float()
    return (gate * keep)[:, None] * rows


def _expert_ffn(w1, b1, w2, b2, xs, activation):
    h = activation(torch.einsum("ecd,edf->ecf", xs, w1) + b1[:, None])
    return torch.einsum("ecf,efd->ecd", h, w2) + b2[:, None]


def switch_moe_dense(params, x, capacity_factor=1.25, activation=gelu):
    """The mixture on one device, dispatched by index.  x: (N, d) ->
    (out (N, d) in x's dtype, aux f32)."""
    num_experts = params["router"].shape[1]
    capacity = _capacity(x.shape[0], capacity_factor, num_experts)
    expert, pos, keep, gate, _, aux = _route(params, x, num_experts,
                                             capacity)
    slot, token = _slots(expert, pos, keep, num_experts, capacity)
    xs = _dispatch(x, token, num_experts, capacity)
    ys = _expert_ffn(params["w1"], params["b1"], params["w2"],
                     params["b2"], xs, activation)
    return _combine(ys, slot, keep, gate).to(x.dtype), aux


def switch_moe_dense_reference(params, x, capacity_factor=1.25,
                               activation=gelu):
    """Plain version of :func:`switch_moe_dense`: the reference's one-hot
    ``(N, E, C)`` dispatch and combine tensors and their einsums.  Only
    for token counts where those tensors fit."""
    num_experts = params["router"].shape[1]
    capacity = _capacity(x.shape[0], capacity_factor, num_experts)
    expert, pos, keep, gate, _, aux = _route(params, x, num_experts,
                                             capacity)
    onehot = torch.nn.functional.one_hot(expert, num_experts).float()
    posc = torch.nn.functional.one_hot(pos.long().clamp_max(capacity - 1),
                                       capacity).float()
    dispatch = (keep[:, None] * onehot)[:, :, None] * posc[:, None, :]
    combine = dispatch * gate[:, None, None]
    xs = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), x)
    ys = _expert_ffn(params["w1"], params["b1"], params["w2"],
                     params["b2"], xs, activation)
    out = torch.einsum("nec,ecd->nd", combine, ys.float())
    return out.to(x.dtype), aux


def switch_moe_ep(params, x, axis=None, capacity_factor=1.25,
                  activation=gelu):
    """The expert-parallel mixture on this rank.  ``axis``: the
    ``experts`` ``mesh.RankAxis`` (None: every rank of the process
    group).  x: this rank's tokens (N_local, d); ``params``' expert
    leaves hold this rank's ``E_local = E / ep`` experts, the router
    all E.  -> (out (N_local, d), this rank's aux)."""
    axis = rank_axis(EXPERT_AXIS) if axis is None else axis
    ep = axis.size
    e_local = params["w1"].shape[0]
    num_experts = ep * e_local
    if params["router"].shape[1] != num_experts:
        raise ValueError(
            f"the router scores {params['router'].shape[1]} experts, the "
            f"ranks hold {ep} x {e_local}")
    capacity = _capacity(x.shape[0], capacity_factor, num_experts)
    expert, pos, keep, gate, _, aux = _route(params, x, num_experts,
                                             capacity)
    slot, token = _slots(expert, pos, keep, num_experts, capacity)
    d = x.shape[-1]
    # (E, C, d) -> (ep, E_local, C, d): dim 0 the destination rank; after
    # the exchange dim 0 is the source rank
    xs = _dispatch(x, token, num_experts, capacity)
    xs = collectives.all_to_all(xs.view(ep, e_local, capacity, d), axis)
    # each local expert takes its whole queue in one batched product
    xs = xs.transpose(0, 1).reshape(e_local, ep * capacity, d)
    ys = _expert_ffn(params["w1"], params["b1"], params["w2"],
                     params["b2"], xs, activation)
    ys = ys.view(e_local, ep, capacity, d).transpose(0, 1)
    ys = collectives.all_to_all(ys, axis).reshape(num_experts, capacity, d)
    return _combine(ys, slot, keep, gate).to(x.dtype), aux


# ---------------------------------------------------------------------------
# training steps
# ---------------------------------------------------------------------------
def _nll(logits, y):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, y.long()[:, None]).mean()


def _leaves_with_grad(params, compute_dtype):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    if compute_dtype is not None:
        p = tree_cast(p, compute_dtype)
    return leaves, p


def make_moe_train_step(cfg, optimizer=None, aux_weight=1e-2, causal=False,
                        attn_fn=None, remat=False, device=None,
                        compute_dtype=None):
    """-> (init_fn, step) for a MoE transformer (``transformer_config(
    moe_experts=E)``) on one device.

    The objective is ``nll + aux_weight * aux`` (the Switch recipe).
    ``step(params, opt_state, x, y) -> (params, opt_state, {"loss",
    "nll", "aux"})``; ``init_fn(seed) -> (params, opt_state)`` draws the
    params from a ``torch.Generator`` on the device.  The default
    optimizer is ``adam(1e-3)``; ``compute_dtype`` casts the params and
    x for the forward and backward while the master params, the
    optimizer state and the loss stay f32.  Runs on ``cuda`` unless
    given ``device="cpu"``."""
    if not cfg.get("moe_experts", 0):
        raise ValueError("make_moe_train_step needs moe_experts > 0")
    dev = resolve_device(device)
    tx = optimizer or adam(1e-3)

    def init_fn(seed=0):
        gen = torch.Generator().manual_seed(int(seed))
        params = tree_map(lambda t: t.to(dev),
                          init_transformer_params(gen, cfg))
        return params, tx.init(params)

    def step(params, opt_state, x, y):
        x = torch.as_tensor(x, device=dev)
        y = torch.as_tensor(y, device=dev)
        leaves, p = _leaves_with_grad(params, compute_dtype)
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        logits, aux = transformer_apply_with_aux(
            p, x, cfg, causal=causal, attn_fn=attn_fn, remat=remat)
        nll = _nll(logits, y)
        loss = nll + aux_weight * aux
        grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
        updates, opt_state = tx.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, {
            "loss": loss.detach(), "nll": nll.detach(),
            "aux": aux.detach()}

    return init_fn, step


def moe_transformer_param_specs(params, axis=EXPERT_AXIS):
    """The split rule of a MoE transformer's params: a tree of ``axis``
    for the expert stacks (every ``moe`` leaf but the router; split on
    dim 0) and None for the replicated leaves."""
    def spec(tree, in_moe=False):
        if isinstance(tree, dict):
            return {k: spec(v, in_moe or k == "moe") if k != "router"
                    else None for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(spec(v, in_moe) for v in tree)
        return axis if in_moe else None

    return spec(params)


def split_moe_params(params, axis=None):
    """A full MoE transformer tree -> this rank's: the expert stacks cut
    to the rank's ``E / ep`` experts (copies), the rest as it is."""
    axis = rank_axis(EXPERT_AXIS) if axis is None else axis
    specs = tree_leaves(moe_transformer_param_specs(params))

    def cut(x):
        e = x.shape[0] // axis.size
        return x[axis.index * e:(axis.index + 1) * e].clone()

    return tree_unflatten(params, [
        cut(x) if s else x for x, s in
        zip(tree_leaves(params), specs)])


def gather_moe_params(params, axis=None):
    """This rank's MoE transformer tree -> the full one on every rank
    (the expert stacks gathered over the ranks in order, on the host's
    side group), on the leaves' device."""
    axis = rank_axis(EXPERT_AXIS) if axis is None else axis
    if axis.size == 1:
        return params
    from dist_keras_tpu_torch.comm import backend as comm

    leaves = tree_leaves(params)
    specs = tree_leaves(moe_transformer_param_specs(params))
    split = [i for i, s in enumerate(specs) if s]
    full = comm.fetch_global([leaves[i] for i in split])
    for i, x in zip(split, full):
        leaves[i] = torch.as_tensor(x).to(leaves[i].device)
    return tree_unflatten(params, leaves)


def make_moe_ep_train_step(cfg, optimizer=None, aux_weight=1e-2,
                           causal=False, attn_fn=None, axis=None,
                           device=None):
    """-> (step_fn_factory, init_fn): MoE transformer training with the
    experts split over the ranks of ``axis`` (the ``experts``
    ``mesh.RankAxis``; None: every rank of the process group).

    Sequences are batch-split over the same ranks (attention stays on
    the rank, whole sequences); every block's FFN is
    :func:`switch_moe_ep`.  ``init_fn(seed) -> (params, opt_state)``:
    this rank's part of the seed's full tree (:func:`split_moe_params`)
    and its optimizer state.  ``step_fn(params, opt_state, x, y) ->
    (params, opt_state, {"loss", "nll", "aux"})`` takes this rank's
    sequences x (B_local, T, input_dim) and labels; nll and aux are the
    means over the ranks.  Each rank differentiates (its nll + aux_weight
    * its aux) / ep; the replicated leaves' gradients are then summed
    across the ranks (one packed all-reduce with the metrics), and the
    expert leaves' arrive whole through the exchange's backward.  At one
    rank this is :func:`make_moe_train_step`'s math and touches no
    ``torch.distributed``."""
    if not cfg.get("moe_experts", 0):
        raise ValueError("make_moe_ep_train_step needs moe_experts > 0")
    axis = rank_axis(EXPERT_AXIS) if axis is None else axis
    if cfg["moe_experts"] % axis.size:
        raise ValueError(f"moe_experts={cfg['moe_experts']} does not split "
                         f"over {axis.size} ranks")
    dev = resolve_device(device)
    tx = optimizer or adam(1e-3)
    if attn_fn is None:
        from dist_keras_tpu_torch.ops.flash_attention import attention_auto

        attn_fn = attention_auto
    moe_fn = functools.partial(switch_moe_ep, axis=axis,
                               capacity_factor=cfg.get(
                                   "moe_capacity_factor", 1.25))

    def forward(p, x):
        h = x @ p["proj"] + p["pos"][None, :x.shape[1]]
        aux = h.new_zeros((), dtype=torch.float32)
        for blk in p["blocks"]:
            h, a = apply_block_aux(blk, h, attn_fn, causal, moe_fn=moe_fn)
            aux = aux + a
        pooled = layer_norm(p["ln_f"], h).mean(dim=1)
        return pooled @ p["head"]["kernel"] + p["head"]["bias"], aux

    def step(params, opt_state, x, y):
        x = torch.as_tensor(x, device=dev)
        y = torch.as_tensor(y, device=dev)
        leaves, p = _leaves_with_grad(params, None)
        logits, aux = forward(p, x)
        nll = _nll(logits, y)
        grads = list(torch.autograd.grad(
            (nll + aux_weight * aux) / axis.size, leaves))
        specs = tree_leaves(moe_transformer_param_specs(params))
        shared = [i for i, s in enumerate(specs) if not s]
        summed = collectives.cross_rank_sum(
            [grads[i] for i in shared] + [torch.stack(
                (nll.detach(), aux.detach()))], axis)
        for i, g in zip(shared, summed):
            grads[i] = g
        nll, aux = summed[-1] / axis.size
        grads = tree_unflatten(params, grads)
        updates, opt_state = tx.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, {
            "loss": nll + aux_weight * aux, "nll": nll, "aux": aux}

    def init_fn(seed=0):
        gen = torch.Generator().manual_seed(int(seed))
        params = split_moe_params(init_transformer_params(gen, cfg), axis)
        params = tree_map(lambda t: t.to(dev), params)
        return params, tx.init(params)

    def step_fn_factory(params, opt_state):
        # the split is in the trees already: every call hands back the
        # same step
        return step

    return step_fn_factory, init_fn
