"""FSDP / ZeRO-3-style fully-sharded training — counterpart of
``parallel/fsdp.py``.

Parameters AND optimizer state live sharded across the ranks of one
mesh axis (``workers`` by default), and the batch is data-parallel over
the same axis.  The JAX package annotates the shardings and lets XLA
insert the collectives; here the step writes them out, per leaf of the
spec tree, on every rank in one order:

- before the forward, each sharded leaf is all-gathered over the axis
  (``collectives.all_gather`` along the dimension its spec names);
- ``apply_fn`` / ``loss_fn`` run unmodified on the gathered tree and
  this rank's batch, and ``torch.autograd.grad`` gives the full grads;
- after the backward the sharded leaves' grads are reduce-scattered
  (SUM, ``collectives.reduce_scatter``) back to this rank's block and
  the replicated leaves' grads all-reduced (one packed all-reduce, with
  the loss); both are divided by the axis size, since the global loss
  is the mean over the global batch;
- the optimizer updates this rank's shard with this rank's state only.

The gathered leaves live inside the step alone: a rank's persistent
footprint (params + optimizer state) is the sharded one, as JAX's
donated, sharded step buffers are.  ``torch.distributed.fsdp`` is not
used: it shards dimension 0 of flattened parameters, not the dimension
``fsdp_specs`` names, so its state would not match the JAX package's
spec for spec.

``fsdp_specs`` shards each leaf along its largest dimension that
divides the axis size (leaves smaller than ``min_shard_elems`` stay
replicated — gathering tiny tensors costs more than storing them).
Specs are ``mesh.PartitionSpec`` trees; ``Checkpointer.save(step,
state, shard_specs=...)`` records them, so an FSDP state saved over n
ranks restores at another world size through the elastic restore.
"""

from __future__ import annotations

import numpy as np
import torch

from dist_keras_tpu_torch.ops.optimizers import adam, apply_updates
from dist_keras_tpu_torch.parallel import collectives
from dist_keras_tpu_torch.parallel.mesh import (
    WORKER_AXIS,
    P,
    PartitionSpec,
    tree_map_specs,
)
from dist_keras_tpu_torch.utils.bridge import params_from_jax
from dist_keras_tpu_torch.utils.device import resolve_device
from dist_keras_tpu_torch.utils.pytree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)

__all__ = ["fsdp_specs", "gather_by_specs", "make_fsdp_train_step",
           "match_specs_by_shape", "match_specs_for_state",
           "persistent_bytes", "place_by_specs", "train_fsdp"]


def fsdp_specs(params, axis_size, axis=WORKER_AXIS, min_shard_elems=2 ** 12):
    """PartitionSpec tree: shard each big-enough leaf on its largest
    axis-divisible dimension; replicate the rest."""

    def spec(leaf):
        shape = tuple(np.shape(leaf))
        if int(np.prod(shape, dtype=np.int64)) < min_shard_elems:
            return P()
        divisible = [d for d in range(len(shape))
                     if shape[d] % axis_size == 0 and shape[d] >= axis_size]
        if not divisible:
            return P()
        best = max(divisible, key=lambda d: shape[d])
        parts = [None] * len(shape)
        parts[best] = axis
        return P(*parts)

    return tree_map(spec, params)


def place_by_specs(mesh, tree, specs):
    """-> this rank's block of ``tree`` (a host or device tree every rank
    holds whole): each leaf cut, along every dimension its spec names,
    to this rank's index on that mesh axis (copies; numpy leaves stay
    numpy).  ``specs`` mirrors ``tree`` or is one spec for every leaf.
    On a mesh of one rank the leaves come back as they are."""
    def cut(x, spec):
        for dim, name in enumerate(spec or ()):
            if name is None:
                continue
            axis = mesh.axis(name)
            if axis.size == 1:
                continue
            n = x.shape[dim] // axis.size
            if n * axis.size != x.shape[dim]:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"split over {axis.size} {name} ranks")
            x = x[(slice(None),) * dim + (slice(axis.index * n,
                                                (axis.index + 1) * n),)]
            x = x.clone() if isinstance(x, torch.Tensor) else \
                np.ascontiguousarray(x)
        return x

    if isinstance(specs, PartitionSpec):
        return tree_map(lambda x: cut(x, specs), tree)
    return tree_map_specs(cut, tree, specs)


def gather_by_specs(mesh, tree, specs):
    """The inverse of :func:`place_by_specs`: this rank's block of each
    leaf -> the whole leaf on every rank, all-gathered over each mesh
    axis its spec names (in rank order).  Leaves with ``P()`` come back
    as they are."""
    def gather(x, spec):
        for dim, name in enumerate(spec or ()):
            if name is not None:
                x = collectives.all_gather(x, mesh.axis(name), dim)
        return x

    return tree_map_specs(gather, tree, specs)


def _with_paths(tree, path=()):
    """[(path, leaf)] of a params or spec tree (a PartitionSpec is a
    leaf); paths are tuples of dict keys and list indices."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _with_paths(v, path + (k,))]
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        return [x for i, v in enumerate(tree)
                for x in _with_paths(v, path + (i,))]
    return [(path, tree)]


def match_specs_for_state(params, pspecs, tree):
    """Spec tree for ``tree`` (an optimizer state): each leaf inherits
    the spec of the param whose tree path is a *suffix* of the leaf's
    own path with a matching shape.

    Optimizer states embed the param tree structurally (adam's mu/nu,
    sgd's momentum trace are each a copy of the param tree nested
    inside the state), so the param path appears verbatim at the tail
    of the state leaf's path — structural matching identifies the right
    spec even when many params share one shape.  The longest matching
    suffix wins; leaves with no param-path suffix (step counters)
    replicate.  Shared by FSDP, the TP step and the pipeline step."""
    spec_of = dict(_with_paths(pspecs))
    by_path = {path: (tuple(np.shape(leaf)), spec_of[path])
               for path, leaf in _with_paths(params)}

    def spec_for(path, leaf):
        shape = tuple(np.shape(leaf))
        for start in range(len(path)):  # longest suffix first
            hit = by_path.get(path[start:])
            if hit is not None and hit[0] == shape:
                return hit[1]
        return P()

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, path + (i,)) for i, v in enumerate(t))
        return spec_for(path, t)

    return walk(tree, ())


def match_specs_by_shape(params, pspecs, opt_state):
    """Deprecated name for :func:`match_specs_for_state` (path-suffix
    matching, no longer shape-keyed).  Warns on use."""
    import warnings

    warnings.warn(
        "match_specs_by_shape is deprecated (semantics changed in round "
        "3 from shape-keyed to path-suffix matching); call "
        "match_specs_for_state instead", DeprecationWarning, stacklevel=2)
    return match_specs_for_state(params, pspecs, opt_state)


def persistent_bytes(*trees):
    """The bytes of the tensors in ``trees`` (a rank's params and
    optimizer state: its persistent footprint)."""
    return sum(x.numel() * x.element_size() for t in trees
               for x in tree_leaves(t) if isinstance(x, torch.Tensor))


def make_fsdp_train_step(mesh, loss_fn, apply_fn, optimizer=None,
                         axis=WORKER_AXIS, min_shard_elems=2 ** 12,
                         device=None):
    """-> (init_fn, step_fn_factory) for fully-sharded data-parallel
    training over ``mesh``'s ``axis``.

    ``apply_fn(params, x) -> logits``; ``loss_fn(logits, y) -> scalar``
    (the mean over the batch it is given).

    ``init_fn(params)`` takes the full tree (the same on every rank) ->
    ``(params, opt_state)``: this rank's shards on the device and the
    optimizer state of those shards.  ``step_fn_factory(params,
    opt_state) -> step_fn``; ``step_fn(params, opt_state, x, y) ->
    (params, opt_state, loss)`` takes this rank's rows of the global
    batch (``place_by_specs(mesh, x, P(axis))``) and returns the global
    batch's loss.  Runs on ``cuda`` unless given ``device="cpu"``."""
    dev = resolve_device(device)
    tx = optimizer or adam(1e-3)
    ax = mesh.axis(axis)
    n = ax.size
    specs = {}

    def init_fn(params):
        pspecs = fsdp_specs(params, n, axis, min_shard_elems)
        specs["params"] = pspecs
        params = place_by_specs(mesh, params_from_jax(params, "cpu"),
                                pspecs)
        params = tree_map(lambda t: t.to(dev), params)
        return params, tx.init(params)

    def step(params, opt_state, x, y):
        pspecs = specs["params"]
        x = torch.as_tensor(x, device=dev)
        y = torch.as_tensor(y, device=dev)
        dims = tree_leaves(tree_map_specs(lambda _, s: s.dim(axis),
                                          params, pspecs))
        shards = tree_leaves(params)
        full = [(collectives.all_gather(t, ax, d) if d is not None else t)
                .detach().requires_grad_() for t, d in zip(shards, dims)]
        loss = loss_fn(apply_fn(tree_unflatten(params, full), x), y)
        grads = list(torch.autograd.grad(loss, full))
        del full
        rep = [i for i, d in enumerate(dims) if d is None]
        *rep_g, loss = collectives.cross_rank_sum(
            [grads[i] for i in rep] + [loss.detach()], ax)
        for i, g in zip(rep, rep_g):
            grads[i] = g
        for i, d in enumerate(dims):
            if d is not None:
                grads[i] = collectives.reduce_scatter(grads[i], ax, d)
        grads = tree_unflatten(params, [g / n for g in grads])
        updates, opt_state = tx.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss / n

    def step_fn_factory(params, opt_state):
        if "params" not in specs:
            raise ValueError("place the state with init_fn first: the step "
                             "needs the full leaves' specs")
        return step

    step_fn_factory.specs = specs
    return init_fn, step_fn_factory


def train_fsdp(mesh, model_apply, loss_fn, params, x, y, steps=10,
               optimizer=None, min_shard_elems=2 ** 12, device=None):
    """Run ``steps`` full-batch updates on sharded state; x, y the global
    batch on every rank (each takes its rows) -> (params, losses), the
    params this rank's shards."""
    init_fn, factory = make_fsdp_train_step(
        mesh, loss_fn, model_apply, optimizer=optimizer,
        min_shard_elems=min_shard_elems, device=device)
    params, opt_state = init_fn(params)
    fn = factory(params, opt_state)
    xd = place_by_specs(mesh, x, P(WORKER_AXIS))
    yd = place_by_specs(mesh, y, P(WORKER_AXIS))
    losses = []
    for _ in range(steps):
        params, opt_state, loss = fn(params, opt_state, xd, yd)
        losses.append(float(loss))
    return params, losses
