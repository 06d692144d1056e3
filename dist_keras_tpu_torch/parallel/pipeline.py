"""Pipeline parallelism — GPipe, 1F1B and interleaved 1F1B over a
``stages`` axis of ranks; counterpart of ``parallel/pipeline.py``.

The layers are cut into P contiguous stages, one per rank of the
``stages`` axis (:func:`make_pp_mesh`; a ``(workers, stages)`` mesh is a
grid), and a batch into M microbatches that flow through the stages.
The JAX package runs one lock-step ``lax.scan`` with one ring
``ppermute`` per tick, because one compiled program serves every
device.  Here each rank runs its own schedule, a list of forward (F)
and backward (B) actions, and messages only its neighbours: an
activation goes to the next stage and a cotangent to the previous one
(``collectives.isend`` / ``recv``; each message tagged with its kind,
chunk and microbatch, the sends posted without waiting).  Each
direction between two neighbouring stages travels on a two-rank group
of its own (``RankAxis.links``, created with the mesh by
``mesh.grid_mesh``).  Under NCCL every send and receive between
two ranks of one group shares one stream, in posting order, whatever
the tag: on one group, 1F1B's stage s posting its next activation
while stage s + 1 posts a cotangent would cross two sends and hang
above NCCL's staging buffer.  With a group a direction, each stream
carries one direction, and the two ends post it in one order (the
schedules' tick order; autograd's reverse order in GPipe's backward),
which ``collectives.check_mirror`` holds on the recorded ops.  This
design, not Megatron's batching of a crossing send and receive into one
``batch_isend_irecv``, because it leaves every schedule as it is (GPipe's
backward is autograd's order, which no step could batch) for two more
communicators per pair of neighbours.  No ``batch_isend_irecv`` is used,
so NCCL's rule that a group's first batch involve all of its ranks does
not arise.  gloo matches by tag and ran either way; the results are the
same bits.

- :func:`gpipe_apply` — GPipe: every stage forwards its microbatches in
  order (fill, then drain), and the backward is autograd through the
  messages: a received activation's backward sends its cotangent back,
  a sent one's backward receives it.  O(M) activations live.
  :func:`interleaved_gpipe_apply` does the same with ``virtual``
  non-contiguous chunks a rank (the JAX package's ring order, chunk
  ``c`` of microbatch ``mi`` at its tick ``g*v*P + w + c*P + s``).
- :func:`pipeline_1f1b` — 1F1B with the JAX package's manual backward:
  the stage stashes only its microbatch inputs and recomputes its
  forward inside the backward (the ``jax.checkpoint`` trade).  The
  schedule is the canonical one: stage s warms up with ``P - 1 - s``
  forwards, then alternates one forward and one backward, then cools
  down; its stash peaks at ``min(M, P - s)`` inputs (within the JAX
  engine's ``min(M, 2P - 1)``; :func:`stash_peak` reads it).
- :func:`pipeline_interleaved_1f1b` — v chunks a rank in
  :func:`stack_blocks_interleaved`'s layout, each action at the JAX
  engine's tick (forward ``g*v*P + w + c*P + s``, backward ``g*v*P + w
  + (2v-2-c)*P + 2P-2-s``), its warm-up and drain skipped, not masked.

JAX's results are kept: the loss and the aux are summed over the stages
(one packed all-reduce, on every stage); the readout (``ln_f`` and the
mean-pool) runs at the last stage (the ``collect`` hook); the
embedding's VJP at stage 0 (``first_fn``); the head's grads come from
the last stage only.  In GPipe the collected outputs are broadcast from
the last stage, and the replicated leaves used on one stage only (the
embedding at stage 0, ``ln_f`` at the last) are summed over the stages
in the backward, as JAX's transpose of a replicated-to-varying
promotion sums them.

Attention is ``attention_auto`` (K1 forward, K2 + K3 backward on the
card) inside every stage's blocks; everything else is plain tensor
algebra, as in the JAX package.

No counterpart: ``_tree_where``, ``_pcast_like`` and ``_grow_carry_vma``
only satisfy ``shard_map``'s varying-axes check, which a rank's own
schedule does not have.
"""

from __future__ import annotations

import torch

from dist_keras_tpu_torch.models.transformer import (
    apply_block_aux,
    init_transformer_params,
    layer_norm,
)
from dist_keras_tpu_torch.ops.optimizers import adam, apply_updates
from dist_keras_tpu_torch.parallel import collectives
from dist_keras_tpu_torch.parallel.mesh import (
    PIPE_AXIS,
    WORKER_AXIS,
    P,
    RankAxis,
    grid_mesh,
    rank_axis,
)
from dist_keras_tpu_torch.utils.device import resolve_device
from dist_keras_tpu_torch.utils.pytree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)


__all__ = ["PIPE_AXIS", "bubble_fraction", "gather_stage_blocks",
           "gpipe_apply", "interleaved_1f1b_stash_entries",
           "interleaved_gpipe_apply", "make_pp_mesh", "make_pp_train_step",
           "pipeline_1f1b", "pipeline_interleaved_1f1b",
           "pp_transformer_1f1b_grads", "pp_transformer_apply",
           "pp_transformer_interleaved_apply", "split_stage_blocks",
           "stack_blocks", "stack_blocks_interleaved", "stash_peak",
           "train_pp_transformer"]

_STATS = {"stash_peak": 0}
_PENDING = []     # posted sends not yet waited


def stash_peak():
    """The most microbatch inputs this rank's last 1F1B run held at once."""
    return _STATS["stash_peak"]


def _pipe_axis(axis):
    """The ``stages`` :class:`RankAxis` of ``axis``: itself, a mesh's, or
    (None) every rank of the process group."""
    if axis is None:
        return rank_axis(PIPE_AXIS)
    if isinstance(axis, RankAxis):
        return axis
    return axis.axis(PIPE_AXIS)


def _tag(kind, c, mi, m):
    """A message's tag: its kind (0 activation, 1 cotangent) and the
    (chunk, microbatch) it is for at the receiver."""
    return 16 + 2 * (c * m + mi) + kind


def _post(works):
    """Keep posted sends until they are taken; drop the finished."""
    _PENDING[:] = [w for w in _PENDING if not w.done()] + list(works)


def _flush():
    for w in _PENDING:
        # dklint: ignore[unbounded-wait] each is a posted send's
        # torch.distributed Work, bounded by the process group's timeout
        # (comm/backend.py); not a thread/event wait
        w.wait()
    del _PENDING[:]


def _links(axis):
    """-> ``axis.links``, the two-rank group of each direction between
    neighbouring stages, made with the axis by ``mesh.grid_mesh``: a
    mesh's when it is built (``make_pp_mesh``); the whole group's
    (``axis=None``, every rank a stage) when it is first asked for."""
    if axis.links is None:
        raise ValueError(
            f"the {axis.name!r} axis of {axis.size} ranks carries no "
            f"per-direction links: build it with make_pp_mesh or "
            f"rank_axis({PIPE_AXIS!r})")
    return axis.links


def _send(leaves, axis, to, tag):
    link = _links(axis)[(axis.index, to)]
    _post([collectives.isend(x, axis, to, tag, group=link) for x in leaves])


def _recv(likes, axis, frm, tag):
    link = _links(axis)[(frm, axis.index)]
    return [collectives.recv(x.shape, x.dtype, x.device, axis, frm, tag,
                             group=link) for x in likes]


def _split(tree, m):
    """Leaves (B, ...) -> m microbatch trees (views)."""
    b = tree_leaves(tree)[0].shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible into {m} microbatches")
    parts = [x.chunk(m) for x in tree_leaves(tree)]
    return [tree_unflatten(tree, [p[i] for p in parts]) for i in range(m)]


# ---------------------------------------------------------------------------
# the schedules: each rank's ordered actions
# ---------------------------------------------------------------------------
def _forward_ticks(p, s, m, v):
    """The (chunk, microbatch) forwards of stage ``s`` in the ring
    order: chunk c of microbatch mi at tick ``g*v*p + w + c*p + s``."""
    jobs = [(mi // p * v * p + mi % p + c * p + s, c, mi)
            for mi in range(m) for c in range(v)]
    return [(c, mi) for _, c, mi in sorted(jobs)]


def _1f1b_order(p, s, m):
    """Canonical 1F1B on stage ``s``: ``P - 1 - s`` warm-up forwards,
    then one forward and one backward at a time, then the cool-down
    backwards.  -> [("F" | "B", chunk 0, microbatch)]."""
    warm = min(p - 1 - s, m)
    order = [("F", 0, i) for i in range(warm)]
    for i in range(m - warm):
        order += [("F", 0, warm + i), ("B", 0, i)]
    return order + [("B", 0, i) for i in range(m - warm, m)]


def _interleaved_order(p, s, m, v):
    """Interleaved 1F1B on stage ``s``: each (chunk, microbatch) forward
    and backward at its tick of the JAX engine, forward first within a
    tick (the last stage turns its final chunk around the same tick)."""
    jobs = []
    for mi in range(m):
        base = mi // p * v * p + mi % p
        for c in range(v):
            jobs.append((base + c * p + s, 0, "F", c, mi))
            jobs.append((base + (2 * v - 2 - c) * p + 2 * p - 2 - s, 1, "B",
                         c, mi))
    return [(k, c, mi) for _, _, k, c, mi in sorted(jobs)]


# ---------------------------------------------------------------------------
# GPipe: autograd through the messages
# ---------------------------------------------------------------------------
class _Like:
    """A leaf's shape, dtype and device (a message's receive buffer; the
    collected outputs' template crossing to the other stages)."""

    def __init__(self, t):
        self.shape, self.dtype = tuple(t.shape), t.dtype
        self.device = t.device

    def zeros(self, device=None):
        return torch.zeros(self.shape, dtype=self.dtype,
                           device=device or self.device)


class _Recv(torch.autograd.Function):
    """Receive an activation; the backward sends its cotangent back."""

    @staticmethod
    def forward(ctx, anchor, axis, frm, tags, likes):
        ctx.axis, ctx.frm, ctx.tag, ctx.likes = axis, frm, tags[1], likes
        return tuple(_recv(likes, axis, frm, tags[0]))

    @staticmethod
    def backward(ctx, *grads):
        _send([g if g is not None else like.zeros()
               for g, like in zip(grads, ctx.likes)],
              ctx.axis, ctx.frm, ctx.tag)
        return None, None, None, None, None


class _Send(torch.autograd.Function):
    """Send an activation; -> a token whose backward receives the
    activation's cotangent."""

    @staticmethod
    def forward(ctx, axis, to, tags, *leaves):
        ctx.axis, ctx.to, ctx.tag = axis, to, tags[1]
        ctx.likes = [_Like(x) for x in leaves]
        _send(leaves, axis, to, tags[0])
        return leaves[0].new_zeros(())

    @staticmethod
    def backward(ctx, g):
        got = _recv(ctx.likes, ctx.axis, ctx.to, ctx.tag)
        return (None, None, None, *got)


class _Deliver(torch.autograd.Function):
    """The last stage's collected outputs, broadcast to every stage.  The
    backward keeps the last stage's own cotangent (every stage holds the
    same loss) and gives the tokens and the shared leaves zeros, so that
    every stage runs their backwards."""

    @staticmethod
    def forward(ctx, axis, n_outs, *args):
        ctx.axis = axis
        ctx.rest = [_Like(a) for a in args[n_outs:]]
        return tuple(collectives.broadcast(o.detach(), axis, axis.size - 1)
                     for o in args[:n_outs])

    @staticmethod
    def backward(ctx, *grads):
        last = ctx.axis.index == ctx.axis.size - 1
        outs = [g if last else None for g in grads]
        return (None, None, *outs, *[like.zeros() for like in ctx.rest])


class _StageShared(torch.autograd.Function):
    """Replicated leaves entering the pipe: the identity; the backward
    sums each leaf's cotangent over the stages (one packed all-reduce)."""

    @staticmethod
    def forward(ctx, axis, *leaves):
        ctx.axis = axis
        return tuple(x.view_as(x) for x in leaves)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *collectives.cross_rank_sum(list(grads), ctx.axis))


def _gpipe(stage_fn, chunks, x, m, axis, collect_fn, shared=()):
    """The GPipe engine over ``len(chunks)`` chunks a rank (the ring
    order of :func:`_forward_ticks`).  -> the collected tree stacked
    over microbatches (the full-batch output tree without
    ``collect_fn``), on every stage.  ``shared``: the outputs of
    :class:`_StageShared`, tied to the delivery so that every stage
    runs their backward."""
    _flush()
    p, s, v = axis.size, axis.index, len(chunks)
    collect = collect_fn or (lambda y: y)
    xs = _split(x, m)
    if p == 1:
        outs = []
        for xm in xs:
            for c in range(v):
                xm = stage_fn(chunks[c], xm)
            outs.append(collect(xm))
        return _stack_outs(outs, collect_fn)
    _links(axis)     # none: raise before any message is posted
    like = [_Like(t) for t in tree_leaves(xs[0])]
    dev = like[0].device
    anchor = torch.empty(0, device=dev, requires_grad=True)
    outs, tokens = {}, []
    for c, mi in _forward_ticks(p, s, m, v):
        if s == 0 and c == 0:
            inp = xs[mi]
        else:
            tags = (_tag(0, c, mi, m), _tag(1, c, mi, m))
            inp = tree_unflatten(xs[mi], list(_Recv.apply(
                anchor, axis, (s - 1) % p, tags, like)))
        y = stage_fn(chunks[c], inp)
        if s == p - 1 and c == v - 1:
            outs[mi] = collect(y)
        else:
            cn = c + 1 if s == p - 1 else c
            tags = (_tag(0, cn, mi, m), _tag(1, cn, mi, m))
            tokens.append(_Send.apply(axis, (s + 1) % p, tags,
                                      *tree_leaves(y)))
    _flush()
    import torch.distributed as dist

    box = [None]
    if s == p - 1:
        stacked = _stack_outs([outs[i] for i in range(m)], collect_fn)
        flat = tree_leaves(stacked)
        box[0] = tree_map(_Like, stacked)
    dist.broadcast_object_list(box, collectives._peer(axis, p - 1),
                               group=axis.group)
    if s != p - 1:
        flat = [t.zeros(dev) for t in tree_leaves(box[0])]
    got = _Deliver.apply(axis, len(flat), *flat, *tokens, *shared)
    return tree_unflatten(box[0], list(got))


def _stack_outs(outs, collect_fn):
    """Per-microbatch outputs -> stacked (M, ...) leaves, or the
    re-merged (B, ...) batch without a ``collect_fn``."""
    stacked = [torch.stack(ls) for ls in zip(*[tree_leaves(o)
                                                for o in outs])]
    if collect_fn is None:
        stacked = [t.reshape(-1, *t.shape[2:]) for t in stacked]
    return tree_unflatten(outs[0], stacked)


def gpipe_apply(stage_fn, stage_params, x, num_microbatches, axis=None,
                collect_fn=None):
    """Run a P-stage GPipe pipeline on this rank's stage.

    ``stage_fn(stage_params, x_mb) -> y_mb``, structure- and
    shape-preserving over a tree of microbatch leaves; ``stage_params``
    this rank's stage.  ``x``: a tree whose leaves are the whole local
    batch ``(B, ...)`` on every stage (split into ``num_microbatches``
    along dim 0; stage 0 feeds them, the others take only their
    shapes).  ``axis``: the ``stages`` :class:`RankAxis` (or a mesh
    holding it; None: every rank of the group).

    ``collect_fn(y_mb) -> out_mb`` reduces each finished microbatch at
    the last stage before it is broadcast.  -> with ``collect_fn=None``
    the full-batch output tree (leaves ``(B, ...)``); with one, the
    collected tree stacked over microbatches (leaves ``(M, ...)``); on
    every stage.  Differentiable: the backward runs the reverse
    schedule through the same messages."""
    return _gpipe(stage_fn, [stage_params], x, int(num_microbatches),
                  _pipe_axis(axis), collect_fn)


def bubble_fraction(p, m, v=1):
    """Analytic pipeline bubble fraction: (P-1)/(vM+P-1) (v = 1: plain
    fill-drain)."""
    return (p - 1) / (v * m + p - 1)


def interleaved_gpipe_apply(stage_fn, chunk_params, x, num_microbatches,
                            virtual, axis=None, collect_fn=None):
    """Interleaved-virtual-stage GPipe: this rank holds ``virtual``
    non-contiguous chunks of the layer stack (``chunk_params``: leaves
    (virtual, ...), :func:`stack_blocks_interleaved`'s layout), and the
    microbatches go round the ring of stages ``virtual`` times.  Forward
    order and results as :func:`gpipe_apply`; the fill / drain bubble
    shrinks v-fold (:func:`bubble_fraction`)."""
    v = int(virtual)
    chunks = [tree_map(lambda a: a[c], chunk_params) for c in range(v)]
    return _gpipe(stage_fn, chunks, x, int(num_microbatches),
                  _pipe_axis(axis), collect_fn)


def stack_blocks(blocks):
    """list of per-block param dicts -> one tree with leading L dim."""
    return tree_map(lambda *ls: torch.stack(ls), blocks[0], *blocks[1:])


def stack_blocks_interleaved(blocks, p, v):
    """Blocks -> leaves (P, v, Lpc, ...) laid out for the interleaved
    ring: stage s's chunk c holds global blocks ``[(c*P + s)*Lpc,
    (c*P + s + 1)*Lpc)``, so the execution order (chunk-major over ring
    visits) is the layer order.  Stage s takes ``[s]``."""
    n = len(blocks)
    if n % (p * v):
        raise ValueError(f"{n} blocks not divisible into {p} stages x "
                         f"{v} chunks")
    lpc = n // (p * v)
    order = torch.tensor([(c * p + s) * lpc + j for s in range(p)
                          for c in range(v) for j in range(lpc)])
    return tree_map(lambda a: a[order].reshape(p, v, lpc, *a.shape[1:]),
                    stack_blocks(blocks))


def _stage_fn(cfg, causal, attn_fn):
    """The transformer's stage: its blocks (leaves (L_local, ...)) in
    order on (h, aux) -> (h, aux + each block's aux)."""
    cf = cfg.get("moe_capacity_factor", 1.25)

    def stage_fn(stage_blocks, carry):
        h, aux = carry
        for i in range(tree_leaves(stage_blocks)[0].shape[0]):
            blk = tree_map(lambda a: a[i], stage_blocks)
            h, a = apply_block_aux(blk, h, attn_fn, causal, cf)
            aux = aux + a
        return h, aux

    return stage_fn


def _attn(attn_fn):
    if attn_fn is None:
        from dist_keras_tpu_torch.ops.flash_attention import attention_auto

        return attention_auto
    return attn_fn


def _pp_forward(params, chunks, x, cfg, m, causal, axis, attn_fn, with_aux):
    moe = bool(cfg.get("moe_experts", 0))
    if moe and not with_aux:
        raise ValueError(
            "pipelined MoE configs must be called with with_aux=True so "
            "the router's load-balancing loss reaches the objective")
    axis = _pipe_axis(axis)
    shared = [params["proj"], params["pos"], *tree_leaves(params["ln_f"])]
    if axis.size > 1:
        shared = list(_StageShared.apply(axis, *shared))
    proj, pos, *ln_f = shared
    ln_f = tree_unflatten(params["ln_f"], ln_f)
    h = x @ proj + pos[None, :x.shape[1]]
    aux0 = h.new_zeros((h.shape[0],), dtype=torch.float32)

    def collect(c):
        h_mb, aux_mb = c
        return layer_norm(ln_f, h_mb).mean(dim=1), aux_mb.mean()

    pooled, aux = _gpipe(_stage_fn(cfg, causal, _attn(attn_fn)), chunks,
                         (h, aux0), int(m), axis, collect,
                         shared if axis.size > 1 else ())
    logits = (pooled.reshape(x.shape[0], -1) @ params["head"]["kernel"]
              + params["head"]["bias"])
    if with_aux:
        return logits, aux.mean()
    return logits


def pp_transformer_apply(params, stacked_blocks, x, cfg, num_microbatches,
                         causal=False, axis=None, attn_fn=None,
                         with_aux=False):
    """Pipelined (GPipe) forward of ``models/transformer.py`` on this
    rank's stage.  ``params``: the non-block leaves (proj / pos / ln_f /
    head), whole on every stage; ``stacked_blocks``: this stage's
    (L_local, ...) block stack (:func:`split_stage_blocks`); x: (B, T,
    input_dim) the local batch on every stage.  The embedding runs at
    stage 0, the readout (``ln_f`` and the mean-pool) at the last stage,
    the head on every stage on the broadcast (B, d_model) readout.

    MoE blocks carry each microbatch's accumulated router aux through
    the pipe beside the activations; ``with_aux=True`` (mandatory for
    MoE configs) returns ``(logits, aux)``, aux the mean over
    microbatches of the per-microbatch router loss (the microbatched
    single-device forward is the oracle)."""
    return _pp_forward(params, [stacked_blocks], x, cfg, num_microbatches,
                       causal, axis, attn_fn, with_aux)


def pp_transformer_interleaved_apply(params, chunk_blocks, x, cfg,
                                     num_microbatches, virtual,
                                     causal=False, axis=None, attn_fn=None,
                                     with_aux=False):
    """:func:`pp_transformer_apply` with ``virtual`` chunks a rank:
    ``chunk_blocks`` this rank's (virtual, Lpc, ...) chunk stack
    (:func:`stack_blocks_interleaved`'s ``[s]``).  The same results, the
    fill / drain bubble cut ``virtual``-fold."""
    chunks = [tree_map(lambda a: a[c], chunk_blocks)
              for c in range(int(virtual))]
    return _pp_forward(params, chunks, x, cfg, num_microbatches, causal,
                       axis, attn_fn, with_aux)


# ---------------------------------------------------------------------------
# 1F1B: the manual backward (stashed inputs, recompute VJP)
# ---------------------------------------------------------------------------
def interleaved_1f1b_stash_entries(p, v, m):
    """The JAX engine's static stash allocation of
    :func:`pipeline_interleaved_1f1b` (in microbatch inputs):
    ``v * min(m, 3p)`` — the bound this port's live stash stays within."""
    return v * min(m, 3 * p)


def _1f1b(stage_fn, chunks, h, m, order, last_fn, axis, aux_ct, first_fn,
          extras_like, first_extras_like):
    """Run ``order`` (this rank's [("F" | "B", chunk, microbatch)]).
    -> (loss_sum, aux_sum, per-chunk grads, last extras, first extras),
    the sums over the stages."""
    _flush()
    p, s, v = axis.size, axis.index, len(chunks)
    hs = h.chunk(m)
    like = [_Like(hs[0])]
    dev = hs[0].device
    leaves = [[t.detach().requires_grad_() for t in tree_leaves(c)]
              for c in chunks]
    gacc = [[torch.zeros_like(t) for t in ls] for ls in leaves]
    stash, turn = {}, {}
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    aux_acc = torch.zeros((), dtype=torch.float32, device=dev)
    extras_acc = fextras_acc = None
    peak = 0
    mailbox = {}     # one stage: its chunks hand over in place
    if p > 1:
        _links(axis)     # none: raise before any message is posted

    def send(t, to, tag):
        if p == 1:
            mailbox[tag] = t
        else:
            _send([t], axis, to, tag)

    def recv(frm, tag):
        if p == 1:
            return mailbox.pop(tag)
        return _recv(like, axis, frm, tag)[0]

    for kind, c, mi in order:
        first = s == 0 and c == 0
        final = s == p - 1 and c == v - 1
        if kind == "F":
            if first:
                x_in = hs[mi]
            else:
                x_in = recv((s - 1) % p, _tag(0, c, mi, m))
            with torch.no_grad():
                y, _ = stage_fn(chunks[c], x_in)
            stash[(c, mi)] = x_in
            peak = max(peak, len(stash))
            if final:
                turn[mi] = y
            else:
                cn = c + 1 if s == p - 1 else c
                send(y, (s + 1) % p, _tag(0, cn, mi, m))
            continue
        x_st = stash.pop((c, mi))
        if final:
            loss_mb, dy, extras = last_fn(turn.pop(mi), mi)
            loss_acc = loss_acc + loss_mb
            extras_acc = extras if extras_acc is None else tree_map(
                torch.add, extras_acc, extras)
        else:
            dy = recv((s + 1) % p, _tag(1, c, mi, m))
        want_dx = not first or first_fn is not None
        with torch.enable_grad():
            xr = x_st.detach().requires_grad_(want_dx)
            y2, aux2 = stage_fn(tree_unflatten(chunks[c], leaves[c]), xr)
            outs, cots = [y2], [dy]
            if aux2.requires_grad:
                outs.append(aux2)
                cots.append(torch.full_like(aux2, aux_ct))
            ins = leaves[c] + ([xr] if want_dx else [])
            grads = torch.autograd.grad(outs, ins, cots, allow_unused=True)
        for g_acc, g in zip(gacc[c], grads):
            if g is not None:
                g_acc += g
        aux_acc = aux_acc + aux2.detach().float()
        if not want_dx:
            continue
        dx = grads[-1]
        if first:
            fex = first_fn(dx, mi)
            fextras_acc = fex if fextras_acc is None else tree_map(
                torch.add, fextras_acc, fex)
        else:
            cp = c - 1 if s == 0 else c
            send(dx, (s - 1) % p, _tag(1, cp, mi, m))
    _flush()
    _STATS["stash_peak"] = peak
    # the stages that ran no last_fn / first_fn add zeros of the
    # templates to the sums
    if extras_acc is None:
        extras_acc = tree_map(torch.zeros_like, extras_like)
    if first_fn is None:
        fextras_acc = {}
    elif fextras_acc is None:
        fextras_acc = tree_map(torch.zeros_like, first_extras_like)
    if p > 1:
        flat = [loss_acc, aux_acc] + tree_leaves(extras_acc) + tree_leaves(
            fextras_acc)
        flat = collectives.cross_rank_sum(flat, axis)
        loss_acc, aux_acc = flat[0], flat[1]
        k = len(tree_leaves(extras_acc))
        extras_acc = tree_unflatten(extras_acc, flat[2:2 + k])
        fextras_acc = tree_unflatten(fextras_acc, flat[2 + k:])
    grads = [tree_unflatten(chunks[c], gacc[c]) for c in range(v)]
    return loss_acc, aux_acc, grads, extras_acc, fextras_acc


def pipeline_1f1b(stage_fn, stage_params, h, num_microbatches, last_fn,
                  axis=None, aux_ct=0.0, first_fn=None, *, extras_like,
                  first_extras_like=None):
    """1F1B on this rank's stage: forward and backward in one schedule
    (warm-up, steady state, cool-down), the backward by recomputing the
    stage's forward from its stashed input.

    ``stage_fn(stage_params, h_mb) -> (h_out, aux_scalar)``:
    shape-preserving activations plus this stage's per-microbatch
    auxiliary loss (0.0 for dense stages).  ``last_fn(h_mb, mi) ->
    (loss, dh, extras)``: the head and loss of a finished microbatch at
    the last stage (``dh`` the loss's cotangent w.r.t. ``h_mb``,
    ``extras`` a tree to accumulate, e.g. the head's grads).
    ``first_fn(dh_mb, mi) -> extras``: consumes microbatch ``mi``'s
    input cotangent at stage 0 (the embedding's VJP).  ``h``: (B, ...)
    the pipeline's input on every stage (stage 0 feeds it).  ``aux_ct``:
    the cotangent fed to each stage's aux.  ``extras_like`` /
    ``first_extras_like``: trees shaped like ``last_fn``'s / ``first_fn``'s
    extras (JAX reads those shapes with ``eval_shape``); a stage that
    runs no ``last_fn`` / ``first_fn`` adds their zeros to the sums.

    Objective = sum_mb loss_mb + aux_ct * sum_{stage, mb} aux.  ->
    ``(loss_sum, aux_sum, stage_grads, last_extras, first_extras)``, the
    sums and extras whole on every stage, ``stage_grads`` this stage's.
    :func:`stash_peak` reads the run's peak stash."""
    axis = _pipe_axis(axis)
    m = int(num_microbatches)
    if h.shape[0] % m:
        raise ValueError(f"batch {h.shape[0]} not divisible into {m} "
                         "microbatches")
    loss, aux, (grads,), extras, fextras = _1f1b(
        stage_fn, [stage_params], h, m, _1f1b_order(axis.size, axis.index, m),
        last_fn, axis, aux_ct, first_fn, extras_like, first_extras_like)
    return loss, aux, grads, extras, fextras


def pipeline_interleaved_1f1b(stage_fn, chunk_params, h, num_microbatches,
                              virtual, last_fn, axis=None, aux_ct=0.0,
                              first_fn=None, *, extras_like,
                              first_extras_like=None):
    """Interleaved 1F1B: ``virtual`` chunks a rank (``chunk_params``
    leaves (virtual, ...), :func:`stack_blocks_interleaved`'s layout)
    with :func:`pipeline_1f1b`'s recompute backward.  Needs
    ``num_microbatches % stages == 0``.  ``stage_fn`` takes one chunk;
    the rest as :func:`pipeline_1f1b`, ``stage_grads`` with the
    (virtual, ...) chunk axis."""
    axis = _pipe_axis(axis)
    m, v, p = int(num_microbatches), int(virtual), axis.size
    if h.shape[0] % m:
        raise ValueError(f"batch {h.shape[0]} not divisible into {m} "
                         "microbatches")
    if m % p:
        raise ValueError(
            f"interleaved 1F1B needs num_microbatches % stages == 0 "
            f"(got {m} % {p}); pad the microbatch count")
    chunks = [tree_map(lambda a: a[c], chunk_params) for c in range(v)]
    loss, aux, grads, extras, fextras = _1f1b(
        stage_fn, chunks, h, m, _interleaved_order(p, axis.index, m, v),
        last_fn, axis, aux_ct, first_fn, extras_like, first_extras_like)
    stacked = tree_map(lambda *gs: torch.stack(gs), grads[0], *grads[1:])
    return loss, aux, stacked, extras, fextras


def pp_transformer_1f1b_grads(params, stacked_blocks, x, y, cfg,
                              num_microbatches, causal=False, axis=None,
                              attn_fn=None, aux_weight=1e-2, virtual=1):
    """1F1B forward and backward of the transformer on this rank's stage:
    the objective of the MoE / TP train steps, ``mean-over-batch nll +
    aux_weight * mean-over-microbatches router aux``.  The embedding's
    VJP runs per microbatch at stage 0, the head, loss and their grads
    at the last stage; block grads stay on their stage.

    ``virtual > 1`` selects :func:`pipeline_interleaved_1f1b`
    (``stacked_blocks`` this rank's (v, L_per_chunk, ...) chunk stack;
    the block grads in the same layout).  x: (B, T, input_dim), y: (B,)
    int labels, the local batch on every stage.  -> ``(loss, aux,
    rest_grads, block_grads)``: the unweighted nll and mean router aux
    (the returned GRADIENTS include the weighted aux term);
    ``rest_grads`` the proj / pos / ln_f / head grads, whole on every
    stage; ``block_grads`` this stage's."""
    attn_fn = _attn(attn_fn)
    m = int(num_microbatches)
    b, t = x.shape[0], x.shape[1]
    if b % m:
        raise ValueError(f"batch {b} not divisible into {m} microbatches")
    xs, ys = x.chunk(m), y.chunk(m)
    with torch.no_grad():
        h = x @ params["proj"] + params["pos"][None, :t]
    blocks_fn = _stage_fn(cfg, causal, attn_fn)

    def stage_fn(stage_blocks, h_mb):
        return blocks_fn(stage_blocks, (h_mb, h_mb.new_zeros(
            (), dtype=torch.float32)))

    def last_fn(h_mb, mi):
        with torch.enable_grad():
            ln_f = tree_map(lambda a: a.detach().requires_grad_(),
                            params["ln_f"])
            head = tree_map(lambda a: a.detach().requires_grad_(),
                            params["head"])
            hm = h_mb.detach().requires_grad_()
            pooled = layer_norm(ln_f, hm).mean(dim=1)
            logits = pooled @ head["kernel"] + head["bias"]
            logp = torch.log_softmax(logits.float(), dim=-1)
            nll = -logp.gather(1, ys[mi].long()[:, None]).mean() / m
            ins = tree_leaves(ln_f) + tree_leaves(head) + [hm]
            g = torch.autograd.grad(nll, ins)
        k = len(tree_leaves(ln_f))
        return nll.detach(), g[-1], (tree_unflatten(ln_f, g[:k]),
                                     tree_unflatten(head, g[k:-1]))

    def first_fn(dh_mb, mi):
        with torch.enable_grad():
            proj = params["proj"].detach().requires_grad_()
            pos = params["pos"].detach().requires_grad_()
            emb = xs[mi] @ proj + pos[None, :t]
            return torch.autograd.grad(emb, (proj, pos), dh_mb)

    like = {"extras_like": (params["ln_f"], params["head"]),
            "first_extras_like": (params["proj"], params["pos"])}
    if int(virtual) > 1:
        loss, aux_sum, block_grads, (d_lnf, d_head), (d_proj, d_pos) = (
            pipeline_interleaved_1f1b(
                stage_fn, stacked_blocks, h, m, int(virtual), last_fn, axis,
                aux_ct=aux_weight / m, first_fn=first_fn, **like))
    else:
        loss, aux_sum, block_grads, (d_lnf, d_head), (d_proj, d_pos) = (
            pipeline_1f1b(stage_fn, stacked_blocks, h, m, last_fn, axis,
                          aux_ct=aux_weight / m, first_fn=first_fn, **like))
    rest_grads = {"proj": d_proj, "pos": d_pos, "ln_f": d_lnf,
                  "head": d_head}
    return loss, aux_sum / m, rest_grads, block_grads


# ---------------------------------------------------------------------------
# the PP train step: 1F1B grads + optimizer, composed with data parallelism
# ---------------------------------------------------------------------------
def make_pp_mesh(stages, dp=1):
    """The ``(workers, stages)`` grid over the process group (stages
    last: rank ``w * stages + s``); ``dp`` 1 is pure PP."""
    return grid_mesh({WORKER_AXIS: int(dp), PIPE_AXIS: int(stages)})


def split_stage_blocks(blocks, axis, virtual=1):
    """The stacked blocks ((L, ...) leaves, or :func:`stack_blocks_
    interleaved`'s (P, v, Lpc, ...) with ``virtual > 1``) -> this stage's
    part (copies): its (L / P, ...) slice, or its (v, Lpc, ...) chunks."""
    axis = _pipe_axis(axis)
    if int(virtual) > 1:
        return tree_map(lambda a: a[axis.index].clone(), blocks)
    n = tree_leaves(blocks)[0].shape[0] // axis.size
    return tree_map(lambda a: a[axis.index * n:(axis.index + 1) * n].clone(),
                    blocks)


def gather_stage_blocks(blocks, axis, virtual=1):
    """This stage's blocks -> every stage's, in :func:`split_stage_blocks`'
    input layout, on every stage."""
    axis = _pipe_axis(axis)
    if int(virtual) > 1:
        return tree_map(lambda a: collectives.all_gather(a[None], axis),
                        blocks)
    return tree_map(lambda a: collectives.all_gather(a, axis), blocks)


def make_pp_train_step(mesh, cfg, num_microbatches, optimizer=None,
                       causal=False, aux_weight=1e-2, attn_fn=None,
                       virtual=1, device=None):
    """-> (step_factory, init_fn): train through the 1F1B pipe.

    ``mesh`` carries ``stages`` (:func:`make_pp_mesh`); a ``workers``
    axis of more than one rank composes data parallelism: the batch is
    split over the workers, each worker's column of stages runs its own
    pipe, and the loss, the aux and every grad are averaged over the
    workers (one packed all-reduce) before the update.  ``virtual > 1``
    trains through :func:`pipeline_interleaved_1f1b`.

    ``init_fn(seed) -> (rest, blocks, opt_rest, opt_blocks)`` on the
    device: ``rest`` the non-block params (whole on every rank),
    ``blocks`` this stage's part of the stacked blocks
    (:func:`split_stage_blocks`), each with its optimizer state (a
    stage holds its own blocks' moments only).  ``step_fn(rest, blocks,
    opt_rest, opt_blocks, x, y) -> (rest, blocks, opt_rest, opt_blocks,
    loss, aux)``; x (B / dp, T, input_dim), y (B / dp,) this worker's
    rows.  Runs on ``cuda`` unless given ``device="cpu"``."""
    dev = resolve_device(device)
    tx = optimizer or adam(1e-3)
    v = int(virtual)
    stages, workers = mesh.stages, mesh.workers

    def step(rest, blocks, opt_rest, opt_blocks, x, y):
        x = torch.as_tensor(x, device=dev)
        y = torch.as_tensor(y, device=dev)
        loss, aux, rest_g, block_g = pp_transformer_1f1b_grads(
            rest, blocks, x, y, cfg, num_microbatches, causal=causal,
            axis=stages, attn_fn=attn_fn, aux_weight=aux_weight, virtual=v)
        if workers.size > 1:
            flat = [loss, aux] + tree_leaves(rest_g) + tree_leaves(block_g)
            flat = [t / workers.size for t in
                    collectives.cross_rank_sum(flat, workers)]
            loss, aux = flat[0], flat[1]
            k = 2 + len(tree_leaves(rest_g))
            rest_g = tree_unflatten(rest_g, flat[2:k])
            block_g = tree_unflatten(block_g, flat[k:])
        u_r, opt_rest = tx.update(rest_g, opt_rest, rest)
        rest = apply_updates(rest, u_r)
        u_b, opt_blocks = tx.update(block_g, opt_blocks, blocks)
        blocks = apply_updates(blocks, u_b)
        return rest, blocks, opt_rest, opt_blocks, loss, aux

    def init_fn(seed=0):
        gen = torch.Generator().manual_seed(int(seed))
        full = init_transformer_params(gen, cfg)
        blocks = full.pop("blocks")
        blocks = (stack_blocks_interleaved(blocks, stages.size, v) if v > 1
                  else stack_blocks(blocks))
        blocks = tree_map(lambda t: t.to(dev),
                          split_stage_blocks(blocks, stages, v))
        rest = tree_map(lambda t: t.to(dev), full)
        return rest, blocks, tx.init(rest), tx.init(blocks)

    def pp_step_specs(rest, blocks, opt_rest, opt_blocks):
        """The arguments' PartitionSpecs (the JAX step's in_specs)."""
        from dist_keras_tpu_torch.parallel.fsdp import match_specs_for_state

        rspecs = tree_map(lambda _: P(), rest)
        bspecs = tree_map(lambda _: P(PIPE_AXIS), blocks)
        return (rspecs, bspecs,
                match_specs_for_state(rest, rspecs, opt_rest),
                match_specs_for_state(blocks, bspecs, opt_blocks),
                P(WORKER_AXIS if workers.size > 1 else None))

    def step_factory(rest, blocks, opt_rest, opt_blocks):
        # the split is in the trees already: every call hands back the
        # same step
        return step

    step_factory.specs = pp_step_specs
    return step_factory, init_fn


def train_pp_transformer(mesh, cfg, x, y, num_microbatches, steps=10,
                         optimizer=None, seed=0, causal=False,
                         aux_weight=1e-2, virtual=1, device=None):
    """Run ``steps`` full-batch updates through the 1F1B pipe from
    ``init_fn(seed)``; x (N, T, input_dim), y (N,) the global batch on
    every rank (each worker takes its rows) -> ((rest, blocks), losses),
    ``blocks`` this stage's.  ``virtual > 1``: the interleaved engine."""
    factory, init_fn = make_pp_train_step(
        mesh, cfg, num_microbatches, optimizer=optimizer, causal=causal,
        aux_weight=aux_weight, virtual=virtual, device=device)
    rest, blocks, opt_rest, opt_blocks = init_fn(seed)
    fn = factory(rest, blocks, opt_rest, opt_blocks)
    workers = mesh.workers
    n = x.shape[0] // workers.size
    rows = slice(workers.index * n, (workers.index + 1) * n)
    xd, yd = x[rows], y[rows]
    losses = []
    for _ in range(steps):
        rest, blocks, opt_rest, opt_blocks, loss, aux = fn(
            rest, blocks, opt_rest, opt_blocks, xd, yd)
        losses.append(float(loss))
    return (rest, blocks), losses
