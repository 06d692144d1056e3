"""Elastic world resize — resume an N-host run on M hosts; counterpart
of ``resilience/elastic.py``.  Paths in ``shard_meta.json`` use
``jax.tree_util.keystr``'s format (``['key']``, ``[i]``, ``.field``;
``checkpoint._flatten``), so a meta either package wrote resolves in the
other; the gather and the split work on numpy arrays and on the CPU
``torch.bfloat16`` tensors the restore returns for bf16 leaves.

Every recovery path before this module restored the *same* world size:
``supervise_run`` relaunched whole-pod waves, and the multi-host
restore deliberately refused cross-rank fallback because ranks must
agree.  On spot/preemptible pods that made permanent host loss
equivalent to "run over".  This module converts it into "run continues
smaller" (the dist-keras data-parallel elasticity story: workers join
and leave the parameter server freely), in two halves:

**Resharding restore** (:func:`reshard_restore`): a promoted two-phase
checkpoint written by world N — per-host payloads + SHA-256 manifests —
is re-partitioned at load time onto a different ``DK_COORD_WORLD=M``.
Per-leaf sharding is self-describing: a save that passes
``Checkpointer.save(step, state, shard_specs=...)`` records each
sharded leaf's split dimension and local shape in a ``shard_meta.json``
beside the payload (written BEFORE the integrity manifest, so the
manifest signs it and the commit rename publishes it atomically with
the data).  At restore time every source payload is verified against
its manifest BEFORE it contributes bytes (typed
:class:`~dist_keras_tpu_torch.checkpoint.CheckpointCorrupt` naming the file
otherwise), the N per-host shards are gathered by global index
(concatenated in rank order along the recorded dimension — the layout
of a 1-D ``parallel.mesh`` worker axis, which is how
``parallel/fsdp.py`` places FSDP leaves), and re-split contiguously for
the new world.  Leaves without shard metadata are REPLICATED: every new
rank receives the leader's copy.  Shrink and grow both work (M < N and
M > N), and M = 1 reconstructs the full global state — the serving
path a world-1 ``CheckpointWatcher`` uses to hot-load pod-written
checkpoints.

**Elastic supervision** (:func:`choose_surviving_hosts`, used by
``launch.Job.supervise_run``): when a host never comes back after a
relaunch wave — evidence-based: it recorded a nonzero exit code or its
heartbeats went beat-then-dark again in the NEW incarnation — the next
wave launches with the surviving host set, a rotated
``DK_COORD_SESSION`` and re-exported ``DK_COORD_*``.  Workers then see
``saved_world != current_world`` at restore and take the resharding
path automatically (``DK_ELASTIC``, default on).  The resize decision
and the per-restore shard movement are emitted as ``elastic_resize`` /
``reshard_restore`` events so the merged observability report
attributes every resize.

Non-goal: MID-RUN membership change.  A process group /
FileCoordinator world cannot admit or drop a member mid-stream (the op
log is append-ordered per incarnation); a resize happens only ACROSS
incarnations — dead incarnation, resharding restore, smaller world.

Fault points: ``"reshard.load"`` fires per source payload read and
``"reshard.scatter"`` before the re-split, so a death at either instant
is deterministically testable (both are in ``faults.KNOWN_POINTS`` for
chaos mode).

Remote tier (round 18): when the LOCAL directory holds no step at all
— the replacement host of a spot fleet whose dead machines shared no
disk with it — :func:`reshard_restore` pulls the newest completed step
from the ``DK_CKPT_REMOTE`` store (``resilience/store.py``; fetched
into local staging, promoted with the journaled swap, verified through
the same manifests) and reshards that.  True spot-fleet elasticity:
``gates.py --diff-ckpt-only`` proves a wiped-disk world-1 host
restores a world-2 checkpoint purely from the remote tier.

Chunked payloads (``DK_CKPT_CHUNK_MB``, the async-pipeline streaming
format) reshard like any other: the pre-gather verification walks the
manifest's per-chunk entries (one SHA-256 per ``chunk_NNNN.KKKKK``
file, computed as the bytes streamed out at save time), and
``Checkpointer._restore_payload`` reassembles each host's chunked
leaves before the gather — the format is self-describing, so the
per-host ``shard_meta.json`` local shapes and the chunk tables always
agree by construction.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from dist_keras_tpu_torch.resilience.faults import fault_point

SHARD_META_NAME = "shard_meta.json"


# ---------------------------------------------------------------------
# shard-spec normalization + split/gather primitives
# ---------------------------------------------------------------------

def _spec_dim(spec):
    """One leaf's sharded dimension: an int stays itself, a
    ``PartitionSpec`` maps to the index of its (single) named axis,
    ``None``/``P()`` mean replicated.  Typed ValueError on a spec this
    1-D resharding model cannot express (two named axes)."""
    if spec is None:
        return None
    if isinstance(spec, int):
        return int(spec)
    # PartitionSpec (imported lazily: this module must stay usable on
    # the launcher side, before/without a card)
    try:
        entries = list(spec)
    except TypeError:
        raise ValueError(
            f"shard spec {spec!r} is neither an int dimension, None, "
            "nor a PartitionSpec")
    dims = [i for i, axis in enumerate(entries) if axis is not None]
    if not dims:
        return None
    if len(dims) > 1:
        raise ValueError(
            f"shard spec {spec!r} shards more than one dimension — "
            "the elastic resharding model is 1-D (one host axis)")
    return dims[0]


def _is_spec_leaf(x):
    """is_leaf for spec trees: None and ints are leaves (None would
    otherwise vanish as an empty subtree), and so is a PartitionSpec
    (a tuple subclass, by name: the port has none of its own)."""
    if x is None or isinstance(x, int):
        return True
    return type(x).__name__ == "PartitionSpec"


def _spec_leaves(specs):
    """The spec tree's leaves in the state's flatten order (dict keys
    sorted, as ``checkpoint._flatten``)."""
    if _is_spec_leaf(specs):
        return [specs]
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]
    if isinstance(specs, (list, tuple)):
        return [x for v in specs for x in _spec_leaves(v)]
    return [specs]


def spec_dims(specs):
    """Normalize a spec tree (ints / None / PartitionSpecs, mirroring
    the state's structure) into a flat list of int-or-None split
    dimensions, in the state's leaf order."""
    return [_spec_dim(s) for s in _spec_leaves(specs)]


def split_leaf(leaf, dim, world, rank):
    """``rank``'s contiguous block of ``leaf`` split along ``dim`` into
    ``world`` parts (``np.array_split`` semantics: when the dimension
    does not divide evenly the first ``size % world`` blocks carry one
    extra row — deterministic, so save and restore always agree)."""
    import torch

    if isinstance(leaf, torch.Tensor):
        if dim is None:
            return leaf
        if leaf.dim() <= dim:
            raise ValueError(
                f"cannot split a rank-{leaf.dim()} leaf along dim {dim}")
        # tensor_split's uneven blocks are array_split's
        return torch.tensor_split(leaf, int(world),
                                  dim=int(dim))[int(rank)].contiguous()
    leaf = np.asarray(leaf)
    if dim is None:
        return leaf
    if leaf.ndim <= dim:
        raise ValueError(
            f"cannot split a rank-{leaf.ndim} leaf along dim {dim}")
    return np.ascontiguousarray(
        np.array_split(leaf, int(world), axis=int(dim))[int(rank)])


def gather_leaf(shards, dim):
    """The inverse of :func:`split_leaf`: rank-ordered shards
    concatenated along ``dim`` (``dim=None``: replicated — the
    leader's copy wins)."""
    import torch

    if isinstance(shards[0], torch.Tensor):
        return (shards[0] if dim is None
                else torch.cat(list(shards), dim=int(dim)))
    if dim is None:
        return np.asarray(shards[0])
    return np.concatenate([np.asarray(s) for s in shards],
                          axis=int(dim))


# ---------------------------------------------------------------------
# shard metadata (the self-describing half of the checkpoint)
# ---------------------------------------------------------------------

def build_shard_meta(state, specs, world, rank):
    """The ``shard_meta.json`` payload for ONE host's shard of
    ``state``: per sharded leaf its split dimension and this host's
    LOCAL shape (what the re-assembling restore needs to rebuild an
    exact-shape template for this payload).  Replicated leaves are
    omitted — absence means replicated, so a spec-less save stays
    byte-identical to the pre-elastic format."""
    from dist_keras_tpu_torch.checkpoint import _flatten

    dim_leaves = spec_dims(specs)
    flat_state, _ = _flatten(state)
    if len(dim_leaves) != len(flat_state):
        raise ValueError(
            f"shard_specs has {len(dim_leaves)} leaves but the state "
            f"has {len(flat_state)} — the spec pytree must mirror the "
            "state leaf-for-leaf")
    leaves = {}
    for (path, leaf), dim in zip(flat_state, dim_leaves):
        if dim is None:
            continue
        leaves[path] = {
            "dim": int(dim),
            "shape": [int(s) for s in tuple(leaf.shape)],
        }
    return {"format": 1, "world": int(world), "rank": int(rank),
            "leaves": leaves}


def write_shard_meta(payload_dir, state, specs, world, rank):
    """Write :func:`build_shard_meta` into ``payload_dir`` atomically
    (tmp + rename), BEFORE the integrity manifest is built so the
    manifest signs it; -> the meta dict."""
    meta = build_shard_meta(state, specs, world, rank)
    path = os.path.join(payload_dir, SHARD_META_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=0, sort_keys=True)
    os.replace(tmp, path)
    return meta


def read_shard_meta(payload_dir):
    """The payload's shard metadata, or None for a pre-elastic /
    spec-less payload (every leaf replicated).  A torn or malformed
    meta is a typed :class:`~dist_keras_tpu_torch.checkpoint.CheckpointCorrupt`
    at the caller (the manifest covers the file, so verification
    convicts it first in the normal path)."""
    path = os.path.join(payload_dir, SHARD_META_NAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------
# the resharding restore
# ---------------------------------------------------------------------

def _nbytes(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return np.asarray(x).nbytes


def reshard_restore(checkpointer, step=None, template=None, verify=None,
                    rank=None, world=None):
    """Restore ``step`` from a checkpoint written by a DIFFERENT world
    size, re-partitioned for this process; -> ``(step, local_state)``.

    The load plan:

    1. every source payload (all N of them, not just one rank's) is
       verified against its integrity manifest BEFORE it contributes
       bytes — ``Checkpointer.verify(step, all_hosts=True)``, so a
       mismatch raises the usual typed
       :class:`~dist_keras_tpu_torch.checkpoint.CheckpointCorrupt` naming
       each rotted file (``verify`` defaults to ``DK_CKPT_VERIFY``;
       this path NEVER quarantines — it may be a reader of someone
       else's live training directory.  A world-1 caller's
       ``Checkpointer.restore`` falls back to the previous promoted
       step on this verdict, mirroring the single-host self-healing
       loop; a world > 1 caller propagates it typed, for the same
       ranks-must-agree reason the same-world pod restore refuses
       per-rank fallback);
    2. each payload is loaded (``"reshard.load"`` fault point per
       payload); the formats are self-describing, so no per-host
       template is needed;
    3. sharded leaves are gathered by global index (rank-ordered
       concatenation along the recorded dim); replicated leaves take
       the leader's copy;
    4. (``"reshard.scatter"``) the global leaves are re-split
       contiguously for ``(rank, world)`` — the same deterministic
       split a same-world save would have produced, so a reshard
       through M = 1 is bit-equal to a single-host reference restore.

    ``rank``/``world`` default to the checkpointer's coordination
    identity.  Emits one ``reshard_restore`` event carrying the resize
    (saved_world -> world), leaf counts and byte movement, plus the
    uniform ``ckpt_restore``; bumps ``reshard.restores`` /
    ``reshard.bytes``.
    """
    from dist_keras_tpu_torch.checkpoint import (
        CheckpointCorrupt,
        _flatten,
        _treedef_str,
        _unflatten,
        apply_template,
    )
    from dist_keras_tpu_torch.observability import events, metrics

    t0 = time.perf_counter()
    if step is None:
        step = checkpointer.latest_step()
        if step is None and checkpointer.has_remote():
            # the spot-fleet replacement host: no local step at all —
            # pull the newest completed step from the remote tier
            # (promoted locally through the normal journaled swap)
            # and reshard THAT.  An empty store keeps the typed
            # no-checkpoints verdict below.
            try:
                step = checkpointer.fetch_remote()
            except FileNotFoundError:
                step = None
    if step is None:
        raise FileNotFoundError(
            f"no checkpoints in {checkpointer.directory}")
    step = int(step)
    if rank is None or world is None:
        crank, cworld = checkpointer._coord_ids()
        rank = crank if rank is None else int(rank)
        world = cworld if world is None else int(world)
    payloads = checkpointer.host_payload_paths(step)
    saved_world = len(payloads)
    if verify is None:
        from dist_keras_tpu_torch.checkpoint import _verify_enabled

        verify = _verify_enabled()
    if verify:
        # the one all-payload verification protocol — emits
        # ckpt_verify/ckpt_corrupt and raises the typed verdict naming
        # each rotted file
        checkpointer.verify(step, all_hosts=True)

    # load every source payload (metadata first: the host template
    # needs each payload's recorded local shapes)
    metas, states = [], []
    for payload in payloads:
        fault_point("reshard.load")
        try:
            meta = read_shard_meta(payload)
        except (OSError, ValueError) as e:
            raise CheckpointCorrupt(step, payload, [
                f"{SHARD_META_NAME}: unreadable "
                f"({type(e).__name__}: {e})"])
        metas.append(meta)
        _s, state = checkpointer._restore_payload(payload, None)
        states.append(state)

    flats, treedefs = zip(*[_flatten(s) for s in states])
    if len({_treedef_str(d) for d in treedefs}) != 1:
        raise CheckpointCorrupt(step, checkpointer._read_path(step), [
            "host payloads disagree on the state's tree structure — "
            "they were not written by one coordinated save"])
    dim_by_key = {k: v["dim"]
                  for k, v in ((metas[0] or {}).get("leaves", {})
                               .items())}

    out_leaves = []
    n_sharded = 0
    bytes_in = 0
    fault_point("reshard.scatter")
    for i, (path, _leaf0) in enumerate(flats[0]):
        dim = dim_by_key.get(path)
        shards = [flat[i][1] for flat in flats]
        global_leaf = gather_leaf(shards, dim)
        if dim is not None:
            n_sharded += 1
            bytes_in += sum(_nbytes(s) for s in shards)
        out_leaves.append(split_leaf(global_leaf, dim, world, rank))
    local = _unflatten(treedefs[0], out_leaves)
    bytes_out = sum(_nbytes(x) for _, x in _flatten(local)[0])
    if template is not None:
        # dtypes, devices (and loud structural drift) from the caller's
        # template, the same-world restore's contract
        local = apply_template(local, template)
    metrics.counter("reshard.restores").inc()
    metrics.counter("reshard.bytes").inc(bytes_in)
    events.emit("reshard_restore", step=step, saved_world=saved_world,
                world=world, rank=rank, n_leaves=len(out_leaves),
                n_sharded=n_sharded, bytes_in=bytes_in,
                bytes_out=bytes_out,
                duration_s=time.perf_counter() - t0)
    events.emit("ckpt_restore", step=step)
    return step, local


# ---------------------------------------------------------------------
# the launcher-side resize decision
# ---------------------------------------------------------------------

def choose_surviving_hosts(hosts, dead_now, dead_at_last_wave,
                           min_world=1):
    """The evidence rule of the elastic supervisor, as a pure function;
    -> ``(survivors, dropped)`` or ``(None, ())`` when no resize should
    happen.

    A host is dropped only when it "never came back": it was dead at
    the conviction that triggered the PREVIOUS relaunch wave AND is
    dead again now, after a whole wave relaunched it (one conviction
    alone is a crash, not a dead machine — the normal whole-pod wave
    already handles it).  No resize when every host is a repeat
    offender (shrinking to world 0 is just giving up — the restart
    budget's typed ``CrashLoop`` owns that verdict) or when the
    survivor count would fall below ``min_world``."""
    repeat = set(dead_now) & set(dead_at_last_wave)
    if not repeat:
        return None, ()
    survivors = [h for h in hosts if h not in repeat]
    if not survivors or len(survivors) < max(1, int(min_world)):
        return None, ()
    return survivors, tuple(h for h in hosts if h in repeat)
