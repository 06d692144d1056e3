"""Checkpoint / resume — counterpart of ``checkpoint.py``.

Names, defaults, the on-disk format and the semantics are the JAX
package's; a step directory either package writes in the chunked or the
``state.pkl`` format is read by the other's manifest check, and the port
restores the reference's steps.  What the layers do:

- **Atomic commits.**  Every save writes ``step_N.tmp``, fsyncs, then
  renames it to ``step_N``; an overwrite first retires the committed
  copy to ``step_N.old`` (journaled swap), and readers count and read
  through a stranded ``.old``, so a kill at any instant leaves the
  previous committed set or the new one.  Read queries are strictly
  read-only; the writer sweeps orphaned staging after its next commit.
  Fault points ``"checkpoint.save"`` (mid-write) and
  ``"checkpoint.commit"`` (mid-swap).
- **Two-phase multi-host commit** (world > 1 from
  ``resilience.coordination`` or ``Checkpointer(rank=, world=)``):
  each host stages ``step_N.mh/host_{i}`` and publishes a
  ``host-{i}.ok`` marker; the leader waits for every marker under a
  deadline (typed ``PeerLost`` / ``BarrierTimeout``, never a hang) and
  promotes the staging directory with the same swap
  (``"coord.commit"`` fires between).
- **Integrity manifests.**  ``manifest.json`` (per-file bytes + SHA-256
  and a tree digest) rides inside every payload; ``verify`` is a
  read-only probe, ``restore`` verifies, quarantines a corrupt step to
  ``step_N.corrupt`` and falls back to the previous one.
- **The async pipeline** (``DK_CKPT_ASYNC``, on by default): ``save``
  snapshots the state at the step boundary and hands the write to a
  background thread; the returned :class:`AsyncSaveHandle` is the
  durability barrier.  Saves coalesce latest-wins on one host and apply
  backpressure on a pod.  ``ckpt.save_stall_s`` / ``ckpt.write_s``
  split the caller's wall from the writer's.
- **The streaming chunked format** (``DK_CKPT_CHUNK_MB``): large leaves
  stream out as raw chunk files hashed as they are written, the rest
  pickles into ``small.pkl``; ``0`` writes the ``state.pkl`` fallback.
- **Differential saves** (``DK_CKPT_DIFF``) into the shared ``chunks/``
  content-addressed directory, with a journaled, grace-fenced chunk GC
  (``"ckpt.gc"``), and the **remote tier** (``resilience/store.py``,
  ``DK_CKPT_REMOTE``) that restore falls back to.
- **Elastic restore**: a step written by another world size reshards
  through ``resilience/elastic.py`` (``DK_ELASTIC``).

What is the port's own:

- **The snapshot** (:func:`_snapshot_host`).  Leaves are CUDA or CPU
  tensors, numpy arrays or Python scalars.  The device-to-host copies
  of the CUDA leaves are enqueued into pinned host buffers on a side
  stream that waits on an event recorded on the caller's current
  stream; each source tensor is ``record_stream``-ed on the side stream
  so the caching allocator cannot hand its memory out while the copy
  runs, and only the writer waits on the copy's event.  Nothing calls
  ``.cpu()`` or ``.item()`` per leaf.  See :func:`_snapshot_host` for
  which leaves are copied on the card first.
- **bf16 without ml_dtypes.**  A bf16 leaf is always written as raw
  16-bit words, chunked with dtype name ``"bfloat16"`` in
  ``chunks.json`` as the reference names it, and read back with
  ``.view(torch.bfloat16)``; restore returns it as a CPU tensor (numpy
  has no bf16).  A small bf16 leaf that the reference pickled into
  ``small.pkl`` needs ml_dtypes to unpickle: it is refused with a
  typed :class:`CheckpointFormatError` naming the leaf.
- **A restricted unpickler** for ``small.pkl`` / ``state.pkl``: numpy's
  reconstructors, builtins and ``collections``; the reference's
  ``_ChunkRef`` maps to the port's; optax's state classes map to
  neutral placeholders (:class:`OptaxState`) recording the class name
  and fields, which ``utils/bridge.opt_state_from_optax`` converts.
  Anything else is a :class:`CheckpointFormatError` naming the class,
  so a reference checkpoint restores with no jax or optax installed.
- **restore** returns host leaves (numpy arrays; bf16 as CPU tensors).
  Given a ``template`` of tensors, each leaf takes the template's dtype
  and device, uploaded from pinned memory.  Saving and restoring are
  bit-exact in every dtype.
- **No orbax.**  An orbax-format step (the reference's writer under
  ``DK_CKPT_CHUNK_MB=0`` with orbax installed) is refused with a typed
  :class:`CheckpointFormatError`; the port's ``DK_CKPT_CHUNK_MB=0``
  writes ``state.pkl``, as the reference does without orbax.
"""

from __future__ import annotations

import builtins
import collections
import json
import os
import pickle
import re
import threading

import numpy as np
import torch

from dist_keras_tpu_torch.utils import knobs

_STEP_RE = re.compile(r"^step_(\d+)$")

MANIFEST_NAME = "manifest.json"
CHUNKS_NAME = "chunks.json"
BF16_NAME = "bfloat16"


class CheckpointFormatError(ValueError):
    """A checkpoint holds something the port cannot read as it is: an
    orbax-format step, a pickled class outside the restricted
    unpickler's allow-list, a bf16 leaf that the reference pickled with
    ml_dtypes, or a training state written by the reference (a JAX PRNG
    key where the port keeps a ``torch.Generator`` state).  Typed and
    never guessed around: the message names the step, file, leaf or
    class and what to do instead.  A ``ValueError``, so the supervisor
    classifies it as fatal — a restart reads the same bytes."""


# ---------------------------------------------------------------------
# trees: nested dicts / lists / tuples / namedtuples, JAX's leaf order
# ---------------------------------------------------------------------

def _is_namedtuple(x):
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _flatten(tree, path="", out=None):
    """-> (``[(path, leaf), ...]``, treedef) in ``jax.tree_util``'s
    order: dict keys sorted, sequences in order, ``None`` an empty node.
    ``path`` strings follow ``jax.tree_util.keystr``: ``['key']`` for
    dict keys, ``[i]`` for list and tuple indices, ``.field`` for a
    namedtuple's fields (the optax placeholders' recorded names), so a
    ``shard_meta.json`` either package wrote resolves in the other."""
    if out is None:
        out = []
    if tree is None:
        return out, ("none",)
    if isinstance(tree, dict):
        keys = sorted(tree)
        defs = tuple(_flatten(tree[k], f"{path}[{k!r}]", out)[1]
                     for k in keys)
        # the leaves go in sorted-key order; the rebuilt dict keeps the
        # tree's own key order
        return out, ("dict", type(tree), tuple(keys), defs, tuple(tree))
    if _is_namedtuple(tree):
        defs = tuple(_flatten(v, f"{path}.{f}", out)[1]
                     for f, v in zip(type(tree)._fields, tree))
        return out, ("namedtuple", type(tree), defs)
    if isinstance(tree, (list, tuple)):
        defs = tuple(_flatten(v, f"{path}[{i}]", out)[1]
                     for i, v in enumerate(tree))
        return out, ("seq", type(tree), defs)
    out.append((path, tree))
    return out, ("leaf",)


def _unflatten(treedef, leaves):
    """The inverse of :func:`_flatten`."""
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        if kind == "dict":
            built = {k: build(c) for k, c in zip(d[2], d[3])}
            return d[1]((k, built[k]) for k in d[4])
        if kind == "namedtuple":
            return d[1](*[build(c) for c in d[2]])
        return d[1](build(c) for c in d[2])

    return build(treedef)


def _treedef_str(treedef):
    """A structure signature two trees share exactly when they flatten
    to the same paths in the same containers."""
    kind = treedef[0]
    if kind in ("none", "leaf"):
        return kind
    if kind == "dict":
        return "{" + ",".join(f"{k!r}:{_treedef_str(c)}"
                              for k, c in zip(treedef[2], treedef[3])) + "}"
    name = treedef[1].__name__
    return f"{name}(" + ",".join(_treedef_str(c) for c in treedef[-1]) + ")"


# ---------------------------------------------------------------------
# host leaves: numpy arrays, and bf16 as raw 16-bit words
# ---------------------------------------------------------------------

class _Bf16Words:
    """A bf16 leaf on the host as its raw 16-bit words (a ``uint16``
    array) — what the writer streams out; numpy itself has no bf16."""

    __slots__ = ("words",)

    def __init__(self, words):
        self.words = words

    @property
    def shape(self):
        return self.words.shape

    @property
    def nbytes(self):
        return self.words.nbytes

    def __reduce__(self):
        # state.pkl (DK_CKPT_CHUNK_MB=0): rebuilt as a CPU bf16 tensor
        return (_bf16_words, (self.words,))


def _bf16_words(words):
    """uint16 words -> a CPU ``torch.bfloat16`` tensor, bit for bit."""
    words = np.ascontiguousarray(words, dtype=np.uint16)
    if not words.flags["WRITEABLE"]:
        words = words.copy()
    return torch.from_numpy(words.view(np.int16)).view(torch.bfloat16)


def _host_array(t):
    """A CPU tensor (already a private copy) -> its host leaf: a numpy
    view of its memory, bf16 as :class:`_Bf16Words`."""
    if t.dtype == torch.bfloat16:
        return _Bf16Words(t.view(torch.int16).numpy().view(np.uint16))
    try:
        return t.numpy()
    except TypeError:
        raise CheckpointFormatError(
            f"cannot checkpoint a {t.dtype} tensor: the format records "
            "numpy dtypes and bfloat16 only") from None


# ---------------------------------------------------------------------
# the restricted unpickler
# ---------------------------------------------------------------------

# optax's state classes that the reference's optimizer registry
# produces, with their fields (optax 0.2.x); each unpickles to an
# OptaxState placeholder of that name
OPTAX_STATE_FIELDS = {
    "EmptyState": (),
    "ScaleByAdamState": ("count", "mu", "nu"),
    "ScaleByScheduleState": ("count",),
    "TraceState": ("trace",),
    "ScaleByRssState": ("sum_of_squares",),
    "ScaleByRmsState": ("nu",),
    "ScaleByAdaDeltaState": ("e_g", "e_x"),
}


class OptaxState(tuple):
    """Neutral placeholder for one of optax's NamedTuple states in a
    checkpoint the reference wrote: ``type_name`` is optax's class
    name, ``fields`` its field names, the values its children (a
    namedtuple, so trees walk it by field).  ``utils/bridge.
    opt_state_from_optax`` turns a tree of these into the port's
    optimizer state."""

    __slots__ = ()
    type_name = "OptaxState"
    _fields = ()

    def __reduce__(self):
        return (_optax_state, (self.type_name, tuple(self)))


_OPTAX_CLASSES = {}


def optax_state_class(name):
    """The placeholder class for optax's ``name`` (cached, so two
    placeholders of one optax class share a type)."""
    cls = _OPTAX_CLASSES.get(name)
    if cls is None:
        if name not in OPTAX_STATE_FIELDS:
            raise CheckpointFormatError(
                f"checkpoint pickles optax state class {name!r}, which "
                "no optimizer of the registry produces; the port maps "
                f"only {sorted(OPTAX_STATE_FIELDS)}")
        fields = OPTAX_STATE_FIELDS[name]

        def new(cls_, *values):
            if len(values) != len(fields):
                raise CheckpointFormatError(
                    f"optax {name} pickled with {len(values)} values, "
                    f"expected fields {fields}")
            return tuple.__new__(cls_, values)

        cls = type(name, (OptaxState,), {
            "__slots__": (), "type_name": name, "_fields": fields,
            "__new__": new})
        _OPTAX_CLASSES[name] = cls
    return cls


def _optax_state(name, values):
    return optax_state_class(name)(*values)


class _ForeignScalar:
    """What ``ml_dtypes.<name>`` resolves to inside the unpickler."""

    def __init__(self, name):
        self.name = name


class _ForeignDType:
    """A numpy dtype built from a :class:`_ForeignScalar` (a bf16 leaf
    the reference pickled): it only remembers the name."""

    def __init__(self, name):
        self.name = name

    def __setstate__(self, state):
        pass


class _ArrayStub:
    """An ndarray being unpickled: becomes the array, or remembers the
    foreign dtype that refused it (resolved by :func:`_resolve_stubs`,
    which then knows the leaf's path)."""

    def __init__(self, array=None, refused=None):
        self.array = array
        self.refused = refused

    def __setstate__(self, state):
        dtype = state[2]
        if isinstance(dtype, _ForeignDType):
            self.refused = dtype.name
            return
        arr = _numpy_fn("_reconstruct")(np.ndarray, (0,), b"b")
        arr.__setstate__(state)
        self.array = arr


def _numpy_fn(name):
    for mod in ("numpy._core.multiarray", "numpy.core.multiarray",
                "numpy._core.numeric", "numpy.core.numeric"):
        try:
            m = __import__(mod, fromlist=[name])
        except ImportError:
            continue
        fn = getattr(m, name, None)
        if fn is not None:
            return fn
    raise AttributeError(name)  # pragma: no cover - every numpy has them


def _np_reconstruct(cls, shape, dtype_code):
    if cls is np.ndarray:
        return _ArrayStub()
    return _numpy_fn("_reconstruct")(cls, shape, dtype_code)


def _np_dtype(*args):
    if args and isinstance(args[0], _ForeignScalar):
        return _ForeignDType(args[0].name)
    return np.dtype(*args)


def _np_frombuffer(buf, dtype, shape, order):
    if isinstance(dtype, _ForeignDType):
        return _ArrayStub(refused=dtype.name)
    return np.frombuffer(buf, dtype=dtype).reshape(shape, order=order)


def _np_scalar(dtype, *args):
    if isinstance(dtype, _ForeignDType):
        return _ArrayStub(refused=dtype.name)
    return _numpy_fn("scalar")(dtype, *args)


_SAFE_BUILTINS = frozenset((
    "dict", "list", "tuple", "set", "frozenset", "int", "float",
    "complex", "str", "bytes", "bytearray", "bool", "slice", "range"))
_NUMPY_MODULES = ("numpy.core.multiarray", "numpy._core.multiarray",
                  "numpy.core.numeric", "numpy._core.numeric")
_NUMPY_FNS = {"_reconstruct": _np_reconstruct, "scalar": _np_scalar,
              "_frombuffer": _np_frombuffer}


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "builtins" and name in _SAFE_BUILTINS:
            return getattr(builtins, name)
        if module == "collections" and name in (
                "OrderedDict", "defaultdict", "deque"):
            return getattr(collections, name)
        if module == "numpy" and name == "ndarray":
            return np.ndarray
        if module == "numpy" and name == "dtype":
            return _np_dtype
        if module in _NUMPY_MODULES and name in _NUMPY_FNS:
            return _NUMPY_FNS[name]
        if name == "_ChunkRef" and module in (
                "dist_keras_tpu.checkpoint", __name__):
            return _ChunkRef
        if module == __name__ and name in ("_bf16_words", "_optax_state"):
            return {"_bf16_words": _bf16_words,
                    "_optax_state": _optax_state}[name]
        if module == "optax" or module.startswith("optax."):
            return optax_state_class(name)
        if module == "ml_dtypes" or module.startswith("ml_dtypes."):
            return _ForeignScalar(name)
        raise CheckpointFormatError(
            f"checkpoint pickle names {module}.{name}, which the port's "
            "restricted unpickler does not load (allowed: numpy arrays, "
            "builtins, collections, _ChunkRef and optax's registry "
            "states)")


def _resolve_stubs(tree, where, path=""):
    """Replace each :class:`_ArrayStub` by its array, or refuse the leaf
    it could not build, naming it."""
    if isinstance(tree, _ArrayStub):
        if tree.refused is not None:
            raise CheckpointFormatError(
                f"{where}: leaf {path or '<root>'} is a {tree.refused} "
                "array that the reference pickled with ml_dtypes, which "
                "the port does not use; re-save the step in the "
                "reference with DK_CKPT_CHUNK_MB below this leaf's size, "
                "so that it is written as raw chunks")
        return tree.array
    if isinstance(tree, dict):
        for k in list(tree):
            tree[k] = _resolve_stubs(tree[k], where, f"{path}[{k!r}]")
        return tree
    if _is_namedtuple(tree):
        return type(tree)(*[_resolve_stubs(v, where, f"{path}.{f}")
                            for f, v in zip(type(tree)._fields, tree)])
    if isinstance(tree, list):
        for i, v in enumerate(tree):
            tree[i] = _resolve_stubs(v, where, f"{path}[{i}]")
        return tree
    if isinstance(tree, tuple):
        return type(tree)(_resolve_stubs(v, where, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return tree


def restricted_load(f, where=""):
    """Unpickle a ``small.pkl`` / ``state.pkl`` through the restricted
    unpickler; ``where`` names the file in errors."""
    return _resolve_stubs(_RestrictedUnpickler(f).load(), where)


class SaveSuperseded(RuntimeError):
    """A queued-but-unstarted async save was coalesced away by a newer
    one (latest-wins policy: at most one write in flight plus one
    pending).  Raised by the superseded :class:`AsyncSaveHandle`'s
    ``wait()`` — typed, so a caller that insists on THAT step's
    durability can tell "replaced by something newer" from a failed
    write."""


class AsyncSaveHandle:
    """The ticket ``Checkpointer.save`` returns.

    ``wait()`` is the durability barrier: it blocks until the save is
    committed/promoted (-> the step), the write failed (re-raises the
    writer's typed error), or the save was coalesced away (raises
    :class:`SaveSuperseded`).  Synchronous saves (``DK_CKPT_ASYNC=0``)
    return an already-resolved handle, so call sites are uniform."""

    __slots__ = ("step", "_done", "_exc", "_status")

    def __init__(self, step, status="pending"):
        self.step = int(step)
        self._done = threading.Event()
        self._exc = None
        self._status = status
        if status != "pending":
            self._done.set()

    @property
    def status(self):
        """"pending" | "committed" | "superseded" | "error"."""
        return self._status

    def done(self):
        return self._done.is_set()

    def _resolve(self, status, exc=None):
        self._exc = exc
        self._status = status
        self._done.set()

    def wait(self, timeout_s=None):
        """Block until resolved; -> the committed step.  Raises the
        writer's error, :class:`SaveSuperseded` for a coalesced save,
        or ``TimeoutError`` past ``timeout_s``."""
        if not self._done.wait(timeout_s):
            raise TimeoutError(
                f"async checkpoint save of step {self.step} still in "
                f"flight after {timeout_s}s")
        if self._exc is not None:
            raise self._exc
        return self.step


class _ChunkRef:
    """Placeholder pickled into a chunked payload's ``small.pkl`` where
    a chunked array leaf sits in the pytree; ``index`` keys into the
    ``chunks.json`` leaf table."""

    __slots__ = ("index",)

    def __init__(self, index):
        self.index = int(index)

    def __reduce__(self):
        return (_ChunkRef, (self.index,))


class CheckpointCorrupt(RuntimeError):
    """A checkpoint payload failed its integrity-manifest verification.

    Carries the ``step``, the payload ``path`` and the list of
    ``problems`` (one human-readable string per mismatched / missing /
    unlisted file) so a post-mortem names exactly which bytes rotted.
    Typed — the supervisor and the serving watcher both branch on it.
    """

    def __init__(self, step, path, problems):
        self.step = step
        self.path = path
        self.problems = list(problems)
        head = "; ".join(self.problems[:3])
        more = (f" (+{len(self.problems) - 3} more)"
                if len(self.problems) > 3 else "")
        super().__init__(
            f"checkpoint step {step} at {path} failed integrity "
            f"verification: {head}{more}")


def _verify_enabled():
    """Integrity manifests default ON: ``save`` writes ``manifest.json``
    into every payload and ``restore`` verifies it.  ``DK_CKPT_VERIFY=0``
    opts out of BOTH (the bench measures the hash cost via exactly this
    knob); a per-call ``restore(verify=...)`` overrides the read side
    only."""
    return knobs.get("DK_CKPT_VERIFY")


def _elastic_enabled():
    """``DK_ELASTIC`` (default on): a restore that finds a checkpoint
    written by a DIFFERENT world size re-partitions it via
    ``resilience.elastic.reshard_restore`` instead of refusing (or
    silently reading the leader replica)."""
    return knobs.get("DK_ELASTIC")


def _async_enabled():
    """``DK_CKPT_ASYNC`` (default on): ``save`` snapshots at the step
    boundary, hands the write to a background thread and returns an
    :class:`AsyncSaveHandle`; ``0`` restores the fully synchronous
    save."""
    return knobs.get("DK_CKPT_ASYNC")


def _chunk_bytes():
    """``DK_CKPT_CHUNK_MB`` as bytes (default 64 MB).  > 0 selects the
    streaming chunked payload format (large array leaves written as
    per-file chunks, hashed as the bytes stream out); 0 writes the
    ``state.pkl`` fallback.  Readers understand BOTH formats
    regardless of this knob."""
    return int(max(0.0, float(knobs.get("DK_CKPT_CHUNK_MB"))) * 2**20)


def _diff_enabled():
    """``DK_CKPT_DIFF`` (default off — opt-in this round): chunked
    saves become content-addressed DIFFERENTIAL saves against the
    shared ``chunks/`` CAS directory.  Requires hashing, so
    ``DK_CKPT_VERIFY=0`` disables it regardless."""
    return knobs.get("DK_CKPT_DIFF")


CAS_DIR_NAME = "chunks"
GC_JOURNAL_NAME = "gc-journal.json"


# ---------------------------------------------------------------------
# the boundary snapshot
# ---------------------------------------------------------------------

_COPY_STREAMS = {}
_COPY_STREAMS_LOCK = threading.Lock()


def _copy_stream(device):
    """One side stream per card for the snapshot's device-to-host
    copies (created on first use, then reused)."""
    with _COPY_STREAMS_LOCK:
        s = _COPY_STREAMS.get(device)
        if s is None:
            s = _COPY_STREAMS[device] = torch.cuda.Stream(device=device)
        return s


def _mutable_in_place(t):
    """Whether the caller's loop may change ``t`` in place after
    ``save`` returns, while the side stream still reads it.  The port's
    trainers and optimizers never do: every optimizer in
    ``ops/optimizers.py`` and every trainer step and merge
    (``trainers/step.py``, ``windowed.py``, ``averaging.py``,
    ``dynsgd.py``) returns new tensors, so their leaves are copied to
    the host directly.  A parameter of a ``torch.nn.Module`` (or any
    tensor that requires grad) is what ``torch.optim`` updates in place:
    it is copied on the card first, on the caller's stream."""
    return isinstance(t, torch.nn.Parameter) or t.requires_grad


class _PinnedPool:
    """One ``Checkpointer``'s pinned host staging, reused across saves.

    PyTorch's caching host allocator does not hand a pinned block that an
    asynchronous copy used back to the next allocation, so without this
    every save pays a fresh ``cudaHostAlloc`` for its whole state on the
    caller's thread (``PERF.md`` §6, PR 12).  Each snapshot takes one
    pinned byte arena per card from here, and :meth:`_Snapshot.release`
    puts it back once the writer is done with its bytes.  At most two
    arenas are kept: one save in flight plus one pending."""

    KEEP = 2

    def __init__(self):
        self._free = []
        self._lock = threading.Lock()

    def take(self, nbytes):
        with self._lock:
            for i, arena in enumerate(self._free):
                if arena.numel() >= nbytes:
                    return self._free.pop(i)
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def give(self, arena):
        with self._lock:
            self._free.append(arena)
            self._free.sort(key=lambda t: t.numel())
            del self._free[:-self.KEEP]


class _Snapshot:
    """A state tree whose CUDA leaves are in flight to pinned host
    buffers.  :meth:`host` waits for the copies (the writer's one wait)
    and returns the tree of host leaves; :meth:`release` hands the
    pinned arenas back to the pool once nothing reads them."""

    def __init__(self, tree, events, arenas=(), pool=None):
        self._tree = tree
        self._events = events
        self._arenas = list(arenas)
        self._pool = pool

    def host(self):
        for ev in self._events:
            ev.synchronize()
        self._events = ()
        flat, treedef = _flatten(self._tree)
        self._tree = None
        leaves = [_host_array(x) if isinstance(x, torch.Tensor) else x
                  for _, x in flat]
        return _unflatten(treedef, leaves)

    def release(self):
        """The writer is done with the host tree: its arenas may be
        filled by the next snapshot."""
        arenas, self._arenas = self._arenas, []
        if self._pool is not None:
            for arena in arenas:
                self._pool.give(arena)


_ARENA_ALIGN = 512   # each leaf's offset in an arena, in bytes


def _snapshot_host(tree, pool=None):
    """Boundary snapshot DECOUPLED from anything the caller can mutate:

    - CUDA tensors: the copies into one pinned host arena per card
      (``pool``'s, reused across saves, or a fresh one) are enqueued on a
      side stream that waits on an event recorded on the caller's
      current stream, each source is ``record_stream``-ed on the side
      stream (the caching allocator cannot reuse its memory while the
      copy runs), and only :meth:`_Snapshot.host` — the writer — waits
      on the copy's event.  A leaf the loop may change in place
      (:func:`_mutable_in_place`) is first copied on the card;
    - CPU tensors and numpy arrays are copied on the host (the loop may
      keep mutating the very buffers it passed in);
    - anything else (Python scalars, strings) is kept as it is.

    No ``.cpu()`` and no ``.item()``: the caller never waits for the
    card here.  -> a :class:`_Snapshot`."""
    flat, treedef = _flatten(tree)
    by_device = {}
    leaves = []
    for i, (_, x) in enumerate(flat):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.is_cuda:
                by_device.setdefault(x.device, []).append(i)
                leaves.append(x)
            else:
                leaves.append(x.clone(memory_format=torch.contiguous_format))
        elif isinstance(x, np.ndarray):
            leaves.append(np.array(x))
        else:
            leaves.append(x)
    events, arenas = [], []
    for device, idx in by_device.items():
        caller = torch.cuda.current_stream(device)
        for i in idx:
            if _mutable_in_place(flat[i][1]):
                with torch.cuda.stream(caller):
                    leaves[i] = leaves[i].clone()
        offsets, total = [], 0
        for i in idx:
            offsets.append(total)
            nbytes = leaves[i].numel() * leaves[i].element_size()
            total += -(-nbytes // _ARENA_ALIGN) * _ARENA_ALIGN
        arena = (pool.take(total) if pool is not None else
                 torch.empty(total, dtype=torch.uint8, pin_memory=True))
        arenas.append(arena)
        ready = torch.cuda.Event()
        ready.record(caller)
        side = _copy_stream(device)
        side.wait_event(ready)
        with torch.cuda.stream(side):
            for i, off in zip(idx, offsets):
                src = leaves[i]
                nbytes = src.numel() * src.element_size()
                buf = arena[off:off + nbytes].view(src.dtype).view(
                    src.shape)
                buf.copy_(src, non_blocking=True)
                src.record_stream(side)
                leaves[i] = buf
            done = torch.cuda.Event()
            done.record(side)
        events.append(done)
    return _Snapshot(_unflatten(treedef, leaves), events, arenas, pool)


# ---------------------------------------------------------------------
# restore onto a template
# ---------------------------------------------------------------------

def _host_tensor(x):
    """A host leaf -> a CPU tensor (bf16 leaves already are)."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if not arr.flags["WRITEABLE"] or not arr.flags["C_CONTIGUOUS"]:
        arr = np.array(arr)
    return torch.from_numpy(arr)


def _leaf_like(x, t, path):
    if isinstance(t, torch.Tensor):
        host = _host_tensor(x)
        if tuple(host.shape) != tuple(t.shape):
            raise ValueError(
                f"checkpoint leaf {path or '<root>'} has shape "
                f"{tuple(host.shape)}, the template {tuple(t.shape)}")
        if host.dtype != t.dtype:
            host = host.to(t.dtype)
        if t.device.type == "cuda":
            # uploaded from pinned memory, without a host wait; the
            # caching host allocator keeps the pinned buffer until the
            # copy has run
            return host.pin_memory().to(t.device, non_blocking=True)
        return host.to(t.device)
    if isinstance(t, np.ndarray):
        arr = (x.numpy() if isinstance(x, torch.Tensor)
               else np.asarray(x))
        if arr.shape != t.shape:
            raise ValueError(
                f"checkpoint leaf {path or '<root>'} has shape "
                f"{arr.shape}, the template {t.shape}")
        return arr.astype(t.dtype, copy=False)
    return x


def apply_template(state, template):
    """``state`` (host leaves, as :meth:`Checkpointer.restore` returns
    them) in ``template``'s structure, each leaf with the template
    leaf's dtype and device: CUDA leaves are uploaded from pinned
    memory.  A missing or extra leaf, or a shape that differs, raises
    ``ValueError`` naming the leaf."""
    s_flat, _ = _flatten(state)
    t_flat, t_def = _flatten(template)
    s_paths = [p for p, _ in s_flat]
    t_paths = [p for p, _ in t_flat]
    if s_paths != t_paths:
        missing = sorted(set(t_paths) - set(s_paths))
        extra = sorted(set(s_paths) - set(t_paths))
        raise ValueError(
            "checkpoint structure differs from the template: missing "
            f"{missing[:4]}, unexpected {extra[:4]}")
    return _unflatten(t_def, [_leaf_like(x, t, p) for (p, x), (_, t)
                              in zip(s_flat, t_flat)])


def _two_phase_enabled():
    """The multi-host two-phase commit assumes ``checkpoint_dir`` is
    SHARED storage (NFS/GCS) — that is where cross-host markers can
    rendezvous.  A pod whose checkpoint_dir is per-host LOCAL scratch
    must opt out with ``DK_CKPT_TWO_PHASE=0``: each host then keeps the
    round-6 independent atomic save (the leader's marker wait would
    otherwise stall against markers that land on other machines'
    disks)."""
    return knobs.get("DK_CKPT_TWO_PHASE")


def _fsync_dir(path):
    """fsync a DIRECTORY so a just-committed rename survives power loss
    (POSIX: the rename itself lives in the parent dir's entries)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - e.g. non-POSIX filesystems
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover
        pass
    finally:
        os.close(fd)


def _fsync_tree(root):
    """fsync every file under ``root`` plus the directories themselves —
    the write half of the write->fsync->rename commit protocol."""
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            try:
                fd = os.open(os.path.join(dirpath, name), os.O_RDONLY)
            except OSError:  # pragma: no cover - raced file
                continue
            try:
                os.fsync(fd)
            except OSError:  # pragma: no cover
                pass
            finally:
                os.close(fd)
        _fsync_dir(dirpath)


def _hash_file(path, chunk=1 << 20):
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _manifest_from_entries(files):
    """Manifest dict from ALREADY-HASHED per-file entries
    (``{rel: {bytes, sha256}}``) — what the streaming chunked writer
    uses, its hashes computed as the bytes were written (one pass, no
    whole-payload re-read)."""
    import hashlib

    tree = hashlib.sha256("\n".join(
        f"{rel}:{files[rel]['bytes']}:{files[rel]['sha256']}"
        for rel in sorted(files)).encode()).hexdigest()
    return {"format": 1, "files": files, "tree_sha256": tree}


def build_manifest(root):
    """Integrity manifest of every file under ``root`` (the manifest
    file itself excluded): relative path -> {bytes, sha256}, plus a
    whole-tree digest over the sorted entries so a MISSING or EXTRA
    file is as detectable as a flipped bit."""
    files = {}
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, root)
            if rel == MANIFEST_NAME:
                continue
            files[rel] = {"bytes": os.path.getsize(full),
                          "sha256": _hash_file(full)}
    return _manifest_from_entries(files)


def write_manifest(root, entries=None):
    """Write the manifest into ``root/manifest.json`` atomically (tmp +
    rename: a kill mid-write leaves no torn manifest that would condemn
    a healthy payload).  ``entries`` short-circuits the hashing walk
    with per-file entries already computed as the bytes were written
    (the streaming writer's one-pass path); None re-reads the tree
    (``build_manifest``, the legacy writer's path)."""
    manifest = (build_manifest(root) if entries is None
                else _manifest_from_entries(entries))
    path = os.path.join(root, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=0, sort_keys=True)
    os.replace(tmp, path)
    return manifest


def verify_manifest(root):
    """-> ("ok", []) | ("unverifiable", []) | ("corrupt", problems).

    Strictly read-only.  ``unverifiable`` = no manifest (a legacy
    checkpoint written before integrity manifests, or with
    ``DK_CKPT_VERIFY=0``): old runs must keep restoring, so absence is
    SOFT — the caller decides whether to accept it."""
    path = os.path.join(root, MANIFEST_NAME)
    if not os.path.isdir(root):
        return "corrupt", [f"payload dir {root} missing"]
    if not os.path.exists(path):
        return "unverifiable", []
    try:
        with open(path) as f:
            manifest = json.load(f)
        listed = manifest["files"]
        # shape-check before the walk: valid JSON of the wrong SHAPE
        # (a torn rewrite leaving e.g. a list, or string entries) must
        # stay a typed "corrupt" verdict here — leaked untyped out of
        # the comparison below, supervise() would read the TypeError
        # as a fatal config error instead of healing around the step
        if not isinstance(listed, dict) or not all(
                isinstance(v, dict) for v in listed.values()):
            raise TypeError("files table malformed")
    except (OSError, ValueError, KeyError, TypeError) as e:
        # the manifest ITSELF rotted: as damning as a payload mismatch
        return "corrupt", [f"manifest unreadable: {type(e).__name__}: "
                           f"{e}"]
    problems = []
    seen = set()
    for rel in sorted(listed):
        want = listed[rel]
        full = os.path.join(root, rel)
        seen.add(rel)
        if not os.path.exists(full):
            problems.append(f"{rel}: listed but missing")
            continue
        size = os.path.getsize(full)
        if size != want.get("bytes"):
            problems.append(
                f"{rel}: {size} bytes, manifest says {want.get('bytes')}")
            continue  # hash would fail too; size names the tear better
        got = _hash_file(full)
        if got != want.get("sha256"):
            problems.append(f"{rel}: sha256 {got[:12]}… != manifest "
                            f"{str(want.get('sha256'))[:12]}…")
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            rel = os.path.relpath(os.path.join(dirpath, name), root)
            if rel != MANIFEST_NAME and rel not in seen:
                problems.append(f"{rel}: present but not in manifest")
    # the tree digest must round-trip: recomputed over the manifest's
    # own (path, bytes, sha256) entries it detects a files table that
    # was EDITED after signing (per-file hashes rewritten to match a
    # rotted payload would pass every check above; the stale
    # tree_sha256 still convicts them)
    import hashlib

    tree = hashlib.sha256("\n".join(
        f"{rel}:{listed[rel].get('bytes')}:{listed[rel].get('sha256')}"
        for rel in sorted(listed)).encode()).hexdigest()
    if tree != manifest.get("tree_sha256"):
        problems.append(
            f"tree digest mismatch: recomputed {tree[:12]}… != manifest "
            f"tree_sha256 {str(manifest.get('tree_sha256'))[:12]}…")
    return ("corrupt", problems) if problems else ("ok", [])


def save_model(model, path):
    """Snapshot a model (arch JSON + weights) to ``path`` (a directory):
    ``architecture.json`` and ``weights.npz`` (``w0``, ``w1``, ... in
    Keras order), the reference's layout."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "architecture.json"), "w") as f:
        f.write(model.to_json())
    weights = {f"w{i}": np.asarray(w)
               for i, w in enumerate(model.get_weights())}
    np.savez(os.path.join(path, "weights.npz"), **weights)


def load_model(path):
    path = os.path.abspath(path)
    with open(os.path.join(path, "architecture.json")) as f:
        js = f.read()
    with np.load(os.path.join(path, "weights.npz")) as z:
        weights = [z[f"w{i}"] for i in range(len(z.files))]
    from dist_keras_tpu_torch.utils.serialization import deserialize_model

    return deserialize_model({"model": js, "weights": weights})


class Checkpointer:
    """Step-indexed training-state checkpoints with retention + resume.

    State is any tree of dicts, lists and tuples (typically
    ``{"params": ..., "opt_state": ..., "rng": ...}``) whose leaves are
    CUDA or CPU tensors, numpy arrays or Python scalars.
    """

    def __init__(self, directory, max_to_keep=3, fsync=True, retry=None,
                 rank=None, world=None, commit_timeout_s=None,
                 commit_poll_s=0.02, diff=None, remote_store=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = int(max_to_keep)
        self.fsync = bool(fsync)
        # multi-host identity: None = resolve lazily per save/restore
        # from resilience.coordination (DK_COORD_* env, else rank 0 of
        # world 1).  world > 1 switches save() to the two-phase
        # commit and restore() to the per-host payload layout.
        self._rank = rank
        self._world = world
        self.commit_timeout_s = commit_timeout_s  # None -> coord default
        self.commit_poll_s = float(commit_poll_s)
        # transient FS errors (NFS hiccup, disk-full races with retention)
        # are retried; FaultInjected is deliberately NOT retryable, so an
        # injected mid-write kill stays a kill (guards the test contract)
        if retry is None:
            from dist_keras_tpu_torch.resilience.retry import RetryPolicy

            retry = RetryPolicy(attempts=3, backoff=0.05, jitter=0.0,
                                retryable=(OSError,),
                                name="checkpoint.save")
        self._retry = retry
        self._inflight = None  # "step_NNNNNNNN" currently being written
        # async pipeline: one background writer thread per Checkpointer,
        # at most one write in flight + one pending (latest wins) —
        # never an unbounded queue.  All four fields are guarded by the
        # condition; _async_error is the last background failure not
        # yet surfaced to the caller (re-raised at the next save/drain).
        self._async_cv = threading.Condition()
        self._async_pending = None  # (handle, step, state, specs,
        #                              rank, world, trace_ctx)
        self._async_active = None   # handle currently being written
        self._async_thread = None
        self._async_error = None
        # differential/remote tier: ``diff=None`` resolves DK_CKPT_DIFF
        # per save; ``remote_store=None`` resolves DK_CKPT_REMOTE per
        # call (launcher-export contract).  The uploader is armed
        # lazily by save() when a remote is configured.
        self._diff = diff
        self._remote_store = remote_store
        self._uploader = None
        # chunk-level stats of the LAST chunked payload this instance
        # wrote (None before any, or for non-differential saves) —
        # introspection for the bench row and tests
        self.last_diff_stats = None
        # pinned host staging for the snapshots, reused across saves
        self._pinned = _PinnedPool()

    def _step_dir(self, step):
        return os.path.join(self.directory, f"step_{step:08d}")

    def _coord_ids(self):
        """(rank, world) — explicit constructor values win; otherwise
        resolved from resilience.coordination at call time (so one
        Checkpointer class serves laptop and pod unchanged)."""
        if self._rank is not None and self._world is not None:
            return int(self._rank), int(self._world)
        from dist_keras_tpu_torch.resilience import coordination

        rank = coordination.rank() if self._rank is None else self._rank
        world = (coordination.world() if self._world is None
                 else self._world)
        return int(rank), int(world)

    def all_steps(self):
        """Committed steps — STRICTLY read-only, so any number of
        concurrent pollers (a monitor calling ``latest_step`` in a loop)
        can never interfere with a live writer.  A step whose overwrite
        was killed mid-swap (``step_N.old`` present, ``step_N`` missing)
        still COUNTS: ``restore`` reads through the retired copy, and
        the writer's next successful save cleans it up.  Orphaned
        tmp/staging dirs are ignored here for the same reason.

        Same-INSTANCE reads first JOIN any in-flight async write
        (read-your-writes: ``save`` → ``latest_step`` on one
        ``Checkpointer`` behaves like the synchronous pipeline, so the
        call may block for up to the write's duration, bounded by the
        coordination deadline).  Readers in OTHER processes — the
        deployed watcher pattern — never block here: unpromoted async
        staging is invisible to them by construction."""
        self._join_async()
        steps = set()
        retired = set()
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                steps.add(int(m.group(1)))
            elif name.endswith(".old") and _STEP_RE.match(name[:-4]):
                retired.add(int(name[:-4].split("_")[1]))
        return sorted(steps | retired)

    def _read_path(self, step):
        """Where ``step``'s data lives: the committed dir, or the
        retired ``.old`` copy if an overwrite was killed mid-swap."""
        self._join_async()
        final = self._step_dir(step)
        if not os.path.exists(final) and os.path.exists(final + ".old"):
            return final + ".old"
        return final

    def _payload_dir(self, path):
        """The payload inside a committed step: the step dir itself for
        single-host saves, ``host_{rank}`` for a promoted two-phase
        save.  A rank BEYOND the writing world (resume with a larger
        world) reads the leader's replica; a rank WITHIN it whose
        payload is missing is a corrupt step and must be an error —
        silently restoring another host's state (per-host optimizer
        slots, staleness counters) would diverge the run."""
        rank, _world = self._coord_ids()
        hosts, wrote = self._host_layout(path)
        if not hosts:
            return path  # single-host layout
        mine = f"host_{rank}"
        if mine in hosts:
            return os.path.join(path, mine)
        # the writing world is recorded by the promoted host-ok markers
        # (a deleted payload dir must not shrink it and turn a corrupt
        # step into a silent leader-replica fallback)
        if rank >= wrote:
            return os.path.join(path, "host_0")
        # dklint: ignore[untyped-raise] deliberate refusal, not a
        # retryable CheckpointCorrupt: quarantine/fallback here would
        # silently restore another host's state
        raise RuntimeError(
            f"checkpoint {path} was written by {wrote} hosts but is "
            f"missing this rank's payload {mine!r} (present: {hosts}) "
            "— a promoted step should contain every writer's payload; "
            "refusing to silently restore another host's state")

    def _host_layout(self, path):
        """(host payload dir names, writing-world count) of a promoted
        step's directory — the single reader of the per-host layout.
        The writing world is the max of the payload dirs present and
        the promoted ``host-{i}.ok`` markers, so a deleted payload
        cannot silently shrink it."""
        try:
            names = os.listdir(path)
        except OSError:
            names = []
        # strict host_<N> names only: a stray host_0.tmp staging dir
        # (raced retry) or operator-created sibling must not crash the
        # numeric sort every reader runs
        hosts = sorted(
            (n for n in names if re.fullmatch(r"host_\d+", n)
             and os.path.isdir(os.path.join(path, n))),
            key=lambda n: int(n.split("_")[1]))
        wrote = max(len(hosts),
                    sum(1 for n in names
                        if re.fullmatch(r"host-\d+\.ok", n)))
        return hosts, wrote

    def saved_world(self, step=None):
        """How many hosts WROTE ``step`` (default: latest) — 1 for the
        single-host layout, the per-host payload/marker count for a
        promoted two-phase step.  Strictly read-only; the elastic
        restore compares this against the current world to decide
        whether a resharding load is needed."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        _hosts, wrote = self._host_layout(self._read_path(int(step)))
        return max(wrote, 1)

    def host_payload_paths(self, step):
        """Rank-ordered payload directories of EVERY host that wrote
        ``step`` (the single step dir itself for a single-host save) —
        what ``resilience.elastic.reshard_restore`` gathers from.  A
        payload missing from within the writing world is a typed
        :class:`CheckpointCorrupt` (a promoted step must contain every
        writer's payload)."""
        path = self._read_path(int(step))
        hosts, wrote = self._host_layout(path)
        if wrote == 0:
            return [path]
        expect = [f"host_{r}" for r in range(wrote)]
        missing = sorted(set(expect) - set(hosts))
        if missing:
            raise CheckpointCorrupt(int(step), path, [
                f"{m}: payload missing (step was written by {wrote} "
                "hosts)" for m in missing])
        return [os.path.join(path, n) for n in expect]

    def _gc_orphans(self):
        """Writer-side sweep (after a successful commit): remove staging
        dirs no save will ever commit — interrupted ``step_N.tmp``,
        torn ``step_N.mh`` stagings, orbax staging leftovers, and
        ``.old`` copies whose final exists.  Never runs from read-only
        queries, and in multi-host mode it is LEADER-ONLY: a non-leader
        sweeping here could race another host's in-flight
        ``host_{i}.tmp`` -> ``host_{i}`` rename inside a shared staging
        directory (the round-6 single-writer assumption does not hold on
        a pod)."""
        import shutil

        rank, world = self._coord_ids()
        if world > 1 and rank != 0 and _two_phase_enabled():
            # (with two-phase opted out the directory is per-host local
            # scratch: this host is its sole writer and must keep
            # sweeping it itself)
            return
        inflight_step = (int(self._inflight.split("_")[1])
                         if self._inflight else None)
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            if not name.startswith("step_") or _STEP_RE.match(name):
                continue
            # only STEP-SHAPED names are ever staging: a `step_<N>`
            # stem plus a suffix (.tmp/.mh/.old/.corrupt/.fetch/orbax
            # leftovers).  Anything else that happens to start with
            # "step_" — an operator's notes, a tool's scratch file —
            # is not ours to delete (the `chunks/` CAS dir and the GC
            # journal don't start with "step_" at all and are skipped
            # by the guard above).
            if not _STEP_RE.match(name.split(".", 1)[0]):
                continue
            if self._inflight and name.startswith(self._inflight):
                continue
            if name.endswith(".old") and _STEP_RE.match(name[:-4]):
                if os.path.exists(full[:-4]):  # superseded retired copy
                    shutil.rmtree(full, ignore_errors=True)
                continue  # sole copy of its step: keep (read path)
            if name.endswith(".corrupt") and _STEP_RE.match(name[:-8]):
                # quarantined evidence: kept for the post-mortem, only
                # retention retires it (an orphan sweep deleting it
                # would erase the one artifact that explains the
                # ckpt_corrupt event)
                continue
            if world > 1 and name.endswith(".mh") \
                    and _STEP_RE.match(name[:-3]):
                # a staging dir for a NEWER step than the one this
                # leader just committed may be a fast peer's IN-FLIGHT
                # phase 1 (saves outside the lockstepped boundary loop
                # are not synchronized) — deleting it would destroy
                # that host's payload and strand the next promotion.
                # Steps are saved in increasing order, so only staging
                # provably superseded by the current save is swept.
                if inflight_step is None \
                        or int(name[:-3].split("_")[1]) >= inflight_step:
                    continue
            shutil.rmtree(full, ignore_errors=True)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait_for_step_after(self, step=None, timeout_s=None, poll_s=0.1):
        """Block until a step NEWER than ``step`` is promoted; -> that
        step, or None at the deadline.  STRICTLY read-only (it polls
        :meth:`latest_step`, which only ever sees committed/promoted
        directories), so a serving-side watcher can poll a live
        training run's directory forever without interfering with the
        writer — ``serving.reload.CheckpointWatcher`` probes it with
        ``timeout_s=0`` (one check per loop tick with no promotion
        wait, keeping its own stoppable cadence); pass a real timeout
        to block on a FUTURE promotion.  ``step=None`` waits for the
        first checkpoint ever.  Async caveat (see :meth:`all_steps`):
        probing the SAME instance that is mid-way through an async
        ``save`` first joins that write — the probe then sees the
        step it was about to miss; a cross-process watcher, the
        deployed pattern, never blocks on it."""
        import time

        deadline = (None if timeout_s is None
                    else time.monotonic() + float(timeout_s))
        while True:
            latest = self.latest_step()
            if latest is not None and (step is None or latest > step):
                return latest
            if deadline is not None and time.monotonic() >= deadline:
                return None
            time.sleep(float(poll_s))

    def save(self, step, state, shard_specs=None):
        """Atomic, retried commit: tmp-dir write -> fsync -> rename.

        A kill at any instant leaves the directory with either the old
        committed steps or old + new — ``restore`` can never observe a
        partial write.  The window between write and commit is the
        ``"checkpoint.save"`` fault point.

        Multi-host (world > 1): the two-phase protocol instead — every
        host stages its payload + ``host-{i}.ok`` marker under
        ``step_N.mh``, the leader promotes the staging directory to the
        committed ``step_N`` only when ALL markers have landed (deadline
        -> typed ``PeerLost``, never a hang).

        ``shard_specs`` (optional): a pytree mirroring ``state`` whose
        leaves name each leaf's host-sharded dimension (int, a 1-axis
        ``PartitionSpec``, or None for replicated — e.g.
        ``parallel.fsdp.fsdp_specs`` output).  Recorded as
        ``shard_meta.json`` inside this host's payload (signed by the
        integrity manifest), which is what lets an ELASTIC restore at a
        different world size gather the shards by global index instead
        of guessing.

        ASYNC (``DK_CKPT_ASYNC``, default on): only the snapshot runs
        on this thread, and it only enqueues the device-to-host copies
        on a side stream (nothing here waits for the card); the copy
        wait + serialize + hash + commit chain is handed to the
        background writer and the returned
        :class:`AsyncSaveHandle` is the durability barrier
        (``handle.wait()``).  A previous background failure re-raises
        HERE — the training loop learns its checkpoints stopped
        landing at the next boundary, exactly like a synchronous
        failure.  Synchronous saves return an already-resolved handle,
        so call sites are uniform.  Either way the caller-blocked wall
        lands in the ``ckpt.save_stall_s`` histogram.
        """
        import time as _time

        from dist_keras_tpu_torch.observability import events, metrics
        from dist_keras_tpu_torch.resilience.faults import fault_point

        t0 = _time.perf_counter()
        use_async = _async_enabled()
        # the caller-thread instant before the host snapshot — with an
        # injected kill here nothing was staged, nothing can promote
        fault_point("ckpt.snapshot")
        step = int(step)
        rank, world = self._coord_ids()
        self._maybe_start_uploader(rank, world)
        if not use_async:
            state = _snapshot_host(state, self._pinned)
            # drain any in-flight async write first (the knob re-reads
            # per call, so async->sync can flip mid-process): two
            # _save_sync bodies on one instance would clobber the
            # shared _inflight marker and let the writer's orphan
            # sweep eat this caller's live staging.  A stored
            # background failure surfaces here too, like the async
            # branch.
            from dist_keras_tpu_torch.resilience.coordination import (
                default_timeout_s,
            )

            self.wait_until_finished(timeout_s=default_timeout_s())
            self._save_sync(step, state, rank, world, shard_specs)
            metrics.histogram("ckpt.save_stall_s").observe(
                _time.perf_counter() - t0)
            return AsyncSaveHandle(step, status="committed")
        self._raise_async_error()
        handle = AsyncSaveHandle(step)
        # capture the saving thread's trace context NOW: the background
        # writer resumes it, so the ckpt.save span it opens parents into
        # the trainer's trace across the snapshot->write thread handoff
        from dist_keras_tpu_torch.observability import spans as _spans

        trace_ctx = _spans.capture()
        deadline = None
        if world > 1:
            # ONE shared deadline for the whole backpressure wait: the
            # pre-snapshot slot wait and the publish loop below must
            # together never exceed a single DK_COORD_TIMEOUT_S — the
            # SIGTERM→exit window is sized to one deadline
            from dist_keras_tpu_torch.resilience.coordination import (
                default_timeout_s,
            )

            deadline = _time.monotonic() + default_timeout_s()
            # secure the bounded queue slot BEFORE the snapshot: a
            # backpressured pod save blocks the training thread, so
            # the state cannot move during the wait — snapshotting
            # first would pin a THIRD copy of a multi-GB state in
            # host memory for up to the whole deadline (the publish
            # block below re-checks the slot, so this is purely the
            # memory-bound optimization, not the correctness gate)
            with self._async_cv:
                if self._async_pending is not None:
                    self._async_cv.wait_for(
                        lambda: self._async_pending is None,
                        timeout=max(0.0,
                                    deadline - _time.monotonic()))
        state = _snapshot_host(state, self._pinned)
        with self._async_cv:
            while self._async_pending is not None:
                if world > 1:
                    # a POD must never coalesce, two-phase OR opted
                    # out: under two-phase, one host skipping step S
                    # latest-wins while its peers stage it would
                    # strand the leader's marker wait for the whole
                    # deadline and convict a healthy pod; under
                    # DK_CKPT_TWO_PHASE=0 (per-host local dirs),
                    # per-host coalescing would punch HOLES in one
                    # host's promoted-step sequence and a relaunch
                    # would silently resume ranks from different
                    # steps.  Backpressure instead: the queue stays
                    # bounded at one in flight + one pending, and the
                    # caller blocks only when two saves are already
                    # outstanding (lockstep plans keep this symmetric
                    # across hosts).
                    # the REMAINDER of the one shared deadline armed
                    # before the snapshot — never a second full wait
                    if not self._async_cv.wait_for(
                            lambda: self._async_pending is None,
                            timeout=max(0.0,
                                        deadline - _time.monotonic())):
                        raise TimeoutError(
                            "async checkpoint queue full: the "
                            f"pending save of step "
                            f"{self._async_pending[0].step} never "
                            "started within the coordination deadline")
                else:
                    # single-host latest-wins coalescing: the queued-
                    # but-unstarted save resolves typed instead of
                    # queueing unboundedly
                    old = self._async_pending[0]
                    old._resolve("superseded", SaveSuperseded(
                        f"async save of step {old.step} was "
                        f"superseded by step {step} before its write "
                        "began (latest-wins coalescing)"))
                    events.emit("ckpt_async_coalesced", step=old.step,
                                by=step)
                    self._async_pending = None  # slot taken over
            self._async_pending = (handle, step, state, shard_specs,
                                   rank, world, trace_ctx)
            self._ensure_writer()
            self._async_cv.notify_all()
        stall = _time.perf_counter() - t0
        metrics.histogram("ckpt.save_stall_s").observe(stall)
        events.emit("ckpt_async_enqueue", step=step, stall_s=stall)
        return handle

    def _save_sync(self, step, state, rank, world, shard_specs=None):
        """The copy wait → serialize → hash → commit chain on a
        snapshot (or an already-host ``state``) — the body both the
        synchronous path and the async writer thread run.  Emits
        ``ckpt_save`` (completed saves only) and observes the
        writer-side wall into ``ckpt.write_s``."""
        import time as _time

        from dist_keras_tpu_torch.observability import events, metrics
        from dist_keras_tpu_torch.observability.spans import span

        t0 = _time.perf_counter()
        snap = state if isinstance(state, _Snapshot) else None
        try:
            if snap is not None:
                state = snap.host()  # the writer's one wait for the card
            if world > 1 and _two_phase_enabled():
                with span("ckpt.save", step=step):
                    self._save_multihost(step, state, rank, world,
                                         shard_specs)
                dt = _time.perf_counter() - t0
                metrics.histogram("ckpt.write_s").observe(dt)
                events.emit("ckpt_save", step=step, world=world,
                            duration_s=dt)
                return
            final = self._step_dir(step)
            tmp = final + ".tmp"
            # _inflight is single-writer by construction: the sync path
            # drains the async queue before writing and the writer thread
            # is the only other author — reference assignment is atomic,
            # and its one reader (_gc_orphans, same thread) is in-frame
            # dklint: ignore[unguarded-shared-write] single writer at a time (sync save drains async first); atomic reference assignment
            self._inflight = os.path.basename(final)
            try:
                with span("ckpt.save", step=step):
                    self._retry.call(self._save_once, tmp, final, state,
                                     shard_specs)
                self._gc_orphans()
            finally:
                # dklint: ignore[unguarded-shared-write] same single-writer argument as the store above
                self._inflight = None
            self._retain()
            self.gc_chunks()
            dt = _time.perf_counter() - t0
            metrics.histogram("ckpt.write_s").observe(dt)
            events.emit("ckpt_save", step=step, world=world, duration_s=dt)
        finally:
            # the pinned arenas go back to the pool for the next
            # snapshot: nothing reads the host tree's bytes any more
            state = None
            if snap is not None:
                snap.release()

    # -- async writer machinery -----------------------------------------
    def _ensure_writer(self):
        """Start the background writer (caller holds ``_async_cv``)."""
        t = self._async_thread
        if t is not None and t.is_alive():
            return
        self._async_thread = threading.Thread(
            target=self._writer_loop, daemon=True, name="dk-ckpt-writer")
        self._async_thread.start()

    def _writer_loop(self):
        from dist_keras_tpu_torch.observability import events

        while True:
            with self._async_cv:
                while self._async_pending is None:
                    if not self._async_cv.wait(timeout=60.0):
                        if self._async_pending is None:
                            # idle for a minute: retire (restarted on
                            # demand by _ensure_writer) — a process
                            # that churns Checkpointer instances must
                            # not accumulate parked threads forever
                            self._async_thread = None
                            return
                job = self._async_pending
                self._async_pending = None
                self._async_active = job[0]
                # wake a pod-mode save() backpressured on the pending
                # slot (promotion may take the whole marker wait)
                self._async_cv.notify_all()
            handle, step, state, specs, rank, world, trace_ctx = job
            exc = None
            completed = False
            try:
                # resume the saving thread's trace: the ckpt.save span
                # below joins the trainer's trace across the handoff
                from dist_keras_tpu_torch.observability import spans as _spans

                with _spans.resume(trace_ctx):
                    self._save_sync(step, state, rank, world, specs)
                completed = True
            # dklint: ignore[broad-except] the handle carries the typed
            # error to whoever waits; _async_error re-raises it at the
            # next save/drain — a writer-thread death would hang both
            except Exception as e:
                exc = e
            finally:
                # ALWAYS resolve the handle and clear the active slot,
                # even when something beyond Exception escapes
                # (KeyboardInterrupt / interpreter teardown on the
                # daemon): a reader joining on this condition must
                # never hang forever, and the handle must never claim
                # durability for a write that did not finish
                if not completed and exc is None:
                    exc = RuntimeError(
                        "async checkpoint writer interrupted before "
                        f"completing step {step}")
                handle._resolve("committed" if exc is None else "error",
                                exc)
                with self._async_cv:
                    if exc is not None:
                        self._async_error = exc
                    self._async_active = None
                    self._async_cv.notify_all()
            if exc is not None:
                events.emit("ckpt_async_error", step=step,
                            error=type(exc).__name__,
                            detail=str(exc)[:200])
            # drop the job locals BEFORE parking on the condition: the
            # snapshot (potentially GBs of copied host arrays) must not
            # stay pinned by an idle thread's frame until the next save
            job = handle = state = specs = exc = None

    def _raise_async_error(self):
        with self._async_cv:
            e, self._async_error = self._async_error, None
        if e is not None:
            raise e

    def _join_async(self):
        """Wait (bounded by the coordination deadline) for this
        instance's async queue to drain — the read-side barrier that
        makes ``save`` → ``restore`` on one ``Checkpointer`` behave
        like the synchronous pipeline.  Bounded, not forever: a
        wedged writer must degrade a read query to "shows what is
        promoted so far" (its read-only truth), never hang it.  A
        no-op from the writer thread itself (``_retain``/
        ``_gc_orphans`` read the directory mid-write) and for OTHER
        processes' writers (their staging is invisible until promoted
        anyway — cross-process pollers never block here)."""
        from dist_keras_tpu_torch.resilience.coordination import (
            default_timeout_s,
        )

        # one drain implementation: wait_until_finished already
        # no-ops from the writer thread / with no writer started
        self.wait_until_finished(timeout_s=default_timeout_s(),
                                 raise_errors=False)

    def wait_until_finished(self, timeout_s=None, raise_errors=True):
        """Drain the async pipeline; -> True once idle.  With
        ``raise_errors`` (default) an un-surfaced background failure
        re-raises here and a deadline overrun raises ``TimeoutError``;
        ``raise_errors=False`` returns False at the deadline and leaves
        any stored error for the next boundary to surface."""
        if (self._async_thread is None
                or threading.current_thread() is self._async_thread):
            drained = True
        else:
            with self._async_cv:
                drained = self._async_cv.wait_for(
                    lambda: self._async_pending is None
                    and self._async_active is None, timeout=timeout_s)
        if not drained and raise_errors:
            # a stored earlier failure must not be MASKED by the
            # deadline: chain it so the root cause (say, the ENOSPC
            # that broke save A before save B wedged) survives into
            # the one traceback the run ends with
            with self._async_cv:
                cause = self._async_error
                self._async_error = None
            raise TimeoutError(
                f"async checkpoint writer for {self.directory} still "
                f"busy after {timeout_s}s") from cause
        if drained and raise_errors:
            self._raise_async_error()
        return drained

    def _write_payload(self, tmp, state, shard_specs=None):
        """Write ``state`` into the staging dir ``tmp`` (clean-slate) and
        fsync it — the write half of every commit protocol here.
        ``DK_CKPT_CHUNK_MB`` > 0 (the default) selects the streaming
        chunked format; 0 writes the ``state.pkl`` fallback, as the
        reference does without orbax (bf16 leaves as raw words)."""
        import shutil

        # a retry (or an earlier interrupted save of the same step)
        # may have left the path behind — start clean
        shutil.rmtree(tmp, ignore_errors=True)
        chunk_bytes = _chunk_bytes()
        if chunk_bytes > 0:
            self._write_payload_chunked(tmp, state, shard_specs,
                                        chunk_bytes)
            return
        from dist_keras_tpu_torch.resilience.faults import fault_point

        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, "state.pkl"), "wb") as f:
            pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
        # payload written, manifest not yet: a kill here leaves torn
        # STAGING — invisible to every reader, never promoted
        fault_point("ckpt.write")
        if shard_specs is not None:
            # the self-describing half of the elastic contract: the
            # meta rides INSIDE the payload, BEFORE the manifest, so
            # the manifest signs it and the commit publishes both
            from dist_keras_tpu_torch.resilience import elastic as _elastic

            rank, world = self._coord_ids()
            _elastic.write_shard_meta(tmp, state, shard_specs, world,
                                      rank)
        if _verify_enabled():
            # the integrity manifest rides INSIDE the staging dir, so
            # the commit rename that publishes the payload publishes
            # the manifest with it — exactly as durable, never a
            # separate commit instant
            write_manifest(tmp)
        if self.fsync:
            _fsync_tree(tmp)

    def _write_payload_chunked(self, tmp, state, shard_specs,
                               chunk_bytes):
        """The streaming chunked writer: array leaves >= ``chunk_bytes``
        stream out as raw per-file chunks (``chunk_{leaf}.{k}``), the
        remaining pytree pickles into ``small.pkl`` with
        :class:`_ChunkRef` placeholders, and ``chunks.json`` records
        each chunked leaf's dtype/shape/file list.  EVERY file's
        SHA-256 is computed as its bytes are written, so the integrity
        manifest is assembled in the same single pass — no second
        whole-payload read.  The ``"ckpt.write"`` fault point fires
        once, mid-stream (after the first file, before the manifest):
        the staging dir is torn there, and must never promote."""
        import hashlib

        from dist_keras_tpu_torch.resilience.faults import fault_point

        os.makedirs(tmp, exist_ok=True)
        entries = {}  # rel -> {bytes, sha256}, built as bytes land
        # DK_CKPT_VERIFY=0 opts out of the HASHING too, not just the
        # manifest file — the knob's documented contract is "skip the
        # integrity cost", and hashing multi-GB chunks to discard the
        # digests would silently keep charging it
        hashing = _verify_enabled()
        # the differential path NEEDS the hashes (they are the chunk
        # identities), so opting out of hashing opts out of diff too
        diff_on = hashing and (self._diff if self._diff is not None
                               else _diff_enabled())
        cas_dir = os.path.join(self.directory, CAS_DIR_NAME)
        # the CAS reference recorded in chunks.json/manifest is
        # RELATIVE to the payload dir; tmp and its final location sit
        # at the same depth under the checkpoint directory, so the
        # path computed against staging stays valid after the promote
        cas_rel = os.path.relpath(cas_dir, tmp)
        stats = {"chunks": 0, "skipped": 0,
                 "bytes_written": 0, "bytes_skipped": 0}

        def _put(rel, blocks):
            h = hashlib.sha256() if hashing else None
            n = 0
            with open(os.path.join(tmp, rel), "wb") as f:
                for block in blocks:
                    f.write(block)
                    if h is not None:
                        h.update(block)
                    n += len(block)
            if h is not None:
                entries[rel] = {"bytes": n, "sha256": h.hexdigest()}

        def _put_chunk(i, k, block):
            """One chunk of one leaf; -> the rel path its leaf table
            records.  Differential mode: the chunk's SHA-256 is its
            identity — a hash already in the CAS is REFERENCED (the
            byte write skipped, the file touched so the GC grace
            window covers the reuse), a new one lands atomically
            (tmp + rename: two hosts racing the same content commit
            identical bytes either order)."""
            if not diff_on:
                rel = f"chunk_{i:04d}.{k:05d}"
                _put(rel, (block,))
                return rel
            h = hashlib.sha256()
            h.update(block)
            sha = h.hexdigest()
            n = len(block)
            rel = os.path.join(cas_rel, sha)
            entries[rel] = {"bytes": n, "sha256": sha}
            stats["chunks"] += 1
            full = os.path.join(cas_dir, sha)
            if os.path.exists(full):
                # reuse trusts the content address by name + SIZE: a
                # truncated entry falls through and is rewritten in
                # place (os.replace heals it for every referencing
                # step), while same-size bit rot inside a reused chunk
                # is convicted by the very next verify/restore through
                # the manifest — loud, never silent — and healed from
                # the remote tier, whose fetch re-hashes local CAS
                # entries before trusting them.  Re-hashing here would
                # charge a full read per skipped chunk and erase the
                # differential win.
                try:
                    if os.path.getsize(full) != n:
                        raise OSError(
                            f"CAS entry {sha} truncated: rewrite")
                    os.utime(full, None)  # reuse: reset the GC grace
                    stats["skipped"] += 1
                    stats["bytes_skipped"] += n
                    return rel
                except OSError:
                    pass  # truncated, or deleted by a raced GC sweep
                    #       between exists and touch: write it fresh
            os.makedirs(cas_dir, exist_ok=True)
            ctmp = os.path.join(cas_dir,
                                f".tmp-{os.getpid()}-{sha[:16]}")
            with open(ctmp, "wb") as f:
                f.write(block)
                if self.fsync:
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(ctmp, full)
            stats["bytes_written"] += n
            return rel

        flat, treedef = _flatten(state)
        skeleton, leaf_meta = [], []
        fired = False
        for i, (_, leaf) in enumerate(flat):
            # a bf16 leaf is ALWAYS chunked, whatever its size: numpy
            # has no bf16 to pickle it into small.pkl with
            bf16 = isinstance(leaf, _Bf16Words)
            arr = (leaf.words if bf16 else
                   leaf if isinstance(leaf, np.ndarray) else None)
            if (arr is None or arr.dtype == object
                    or (arr.nbytes < chunk_bytes and not bf16)):
                skeleton.append(leaf)
                continue
            arr = np.ascontiguousarray(arr)
            mv = arr.reshape(-1).view(np.uint8)
            files = []
            for k in range((arr.nbytes + chunk_bytes - 1) // chunk_bytes):
                files.append(_put_chunk(
                    i, k, mv[k * chunk_bytes:(k + 1) * chunk_bytes]))
                if not fired:
                    fired = True  # mid-stream: some chunks staged only
                    fault_point("ckpt.write")
            skeleton.append(_ChunkRef(i))
            # str(dtype), the name the reference records ('float32',
            # and 'bfloat16' for a bf16 leaf's raw words)
            leaf_meta.append({"index": i,
                              "dtype": BF16_NAME if bf16 else str(arr.dtype),
                              "shape": [int(s) for s in arr.shape],
                              "files": files})
        _put("small.pkl", (pickle.dumps(
            _unflatten(treedef, skeleton),
            protocol=pickle.HIGHEST_PROTOCOL),))
        if not fired:
            fault_point("ckpt.write")  # all leaves small: same instant
        _put(CHUNKS_NAME, (json.dumps(
            {"format": 1, "chunk_bytes": int(chunk_bytes),
             "leaves": leaf_meta}, sort_keys=True).encode(),))
        if shard_specs is not None:
            from dist_keras_tpu_torch.resilience import elastic as _elastic

            rank, world = self._coord_ids()
            meta = _elastic.build_shard_meta(state, shard_specs, world,
                                             rank)
            _put(_elastic.SHARD_META_NAME,
                 (json.dumps(meta, indent=0, sort_keys=True).encode(),))
        if hashing:
            write_manifest(tmp, entries=entries)
        if self.fsync:
            _fsync_tree(tmp)
        if diff_on:
            from dist_keras_tpu_torch.observability import events, metrics

            metrics.counter("ckpt.chunks_skipped").inc(stats["skipped"])
            events.emit("ckpt_diff", chunks=stats["chunks"],
                        skipped=stats["skipped"],
                        bytes_written=stats["bytes_written"],
                        bytes_skipped=stats["bytes_skipped"])
        # single writer at a time (the sync path drains the async queue
        # first, and the writer thread is the only other author), so
        # the reference assignment is safe — same argument as _inflight
        self.last_diff_stats = dict(stats) if diff_on else None

    def _swap_in(self, src, final):
        """Journaled overwrite swap: the committed version is RETIRED to
        step_N.old (not deleted) before the new one lands, so a kill
        between the two renames loses nothing — all_steps() rolls the
        .old back when it finds no committed final.  The instant between
        retire and commit is the ``"checkpoint.commit"`` fault point."""
        from dist_keras_tpu_torch.resilience.faults import fault_point

        import shutil

        trash = final + ".old"
        if os.path.exists(final):
            shutil.rmtree(trash, ignore_errors=True)  # stale leftover
            os.rename(final, trash)
        # the deterministic mid-swap kill (old retired, new not committed)
        fault_point("checkpoint.commit")
        os.rename(src, final)
        shutil.rmtree(trash, ignore_errors=True)  # new committed: old goes
        if self.fsync:
            _fsync_dir(self.directory)  # persist the renames themselves

    def _save_once(self, tmp, final, state, shard_specs=None):
        from dist_keras_tpu_torch.resilience.faults import fault_point

        self._write_payload(tmp, state, shard_specs)
        # the deterministic mid-write kill: tmp written, not yet committed
        fault_point("checkpoint.save")
        self._swap_in(tmp, final)

    # -- multi-host two-phase commit ------------------------------------
    def _staging_dir(self, step):
        # deliberately NOT matching _STEP_RE: an unpromoted staging dir
        # is invisible to all_steps/latest_step/restore by construction
        return self._step_dir(step) + ".mh"

    def _marker(self, stage, rank):
        return os.path.join(stage, f"host-{rank}.ok")

    def _save_host_once(self, stage, rank, state, shard_specs=None):
        """Phase 1 on one host: retract own marker -> payload -> fsync
        -> atomic rename -> durable -> publish the ``host-{i}.ok``
        marker LAST.  The retraction runs on EVERY attempt (this
        function is the retry unit): a marker left published from a
        previous attempt would let the leader promote while this host
        is still rewriting its payload.  Marker-after-durable means a
        visible marker always implies a complete, fsynced payload."""
        from dist_keras_tpu_torch.resilience.faults import fault_point

        import shutil

        os.makedirs(stage, exist_ok=True)
        marker = self._marker(stage, rank)
        try:
            os.remove(marker)
        except OSError:
            pass
        hostdir = os.path.join(stage, f"host_{rank}")
        tmp = hostdir + ".tmp"
        self._write_payload(tmp, state, shard_specs)
        # mid-write kill: payload staged, this host's rename not yet done
        fault_point("checkpoint.save")
        shutil.rmtree(hostdir, ignore_errors=True)  # stale earlier attempt
        os.rename(tmp, hostdir)
        if self.fsync:
            _fsync_dir(stage)  # the rename itself, BEFORE the marker
        mtmp = marker + ".tmp"
        with open(mtmp, "w") as f:
            f.write("ok\n")
        os.replace(mtmp, marker)
        if self.fsync:
            _fsync_dir(stage)

    def _promote(self, stage, final, world):
        """Phase 2, leader only: wait (deadline, typed error — never a
        hang) for every host's marker, then promote the staging dir to
        the committed step with the journaled swap.  The rename IS the
        cluster's single commit instant: a kill anywhere before it
        leaves the step invisible to every reader."""
        from dist_keras_tpu_torch.resilience.coordination import (
            default_timeout_s,
            get_coordinator,
            wait_for_peers,
        )
        from dist_keras_tpu_torch.resilience.faults import fault_point

        timeout_s = (default_timeout_s() if self.commit_timeout_s is None
                     else self.commit_timeout_s)

        def _probe(kind):
            # liveness probes must not mask the underlying loss: a
            # broken probe degrades the verdict to BarrierTimeout
            def run():
                try:
                    return getattr(get_coordinator(), kind)()
                # dklint: ignore[broad-except] a broken liveness probe degrades the verdict to BarrierTimeout
                except Exception:
                    return []
            return run

        # the SAME wait-with-liveness protocol as every other
        # rendezvous (coordination.wait_for_peers): early typed
        # PeerLost for a host that beat and went dark, plain
        # BarrierTimeout without evidence.  The hint matters: the most
        # common BENIGN cause of a marker that never appears is
        # checkpoint_dir on per-host local storage, where markers
        # physically cannot rendezvous.
        wait_for_peers(
            lambda: [r for r in range(world)
                     if not os.path.exists(self._marker(stage, r))],
            timeout_s,
            f"two-phase commit of {os.path.basename(stage)} (if "
            "checkpoint_dir is per-host LOCAL storage rather than a "
            "shared filesystem, set DK_CKPT_TWO_PHASE=0)",
            poll_s=self.commit_poll_s,
            stale_fn=_probe("stale_peers"))
        # all markers landed; the torn-commit instant (every host wrote,
        # nothing promoted) is deterministically injectable here
        fault_point("coord.commit")
        self._swap_in(stage, final)
        from dist_keras_tpu_torch.observability import events

        m = _STEP_RE.match(os.path.basename(final))
        events.emit("ckpt_promote", world=world,
                    step=int(m.group(1)) if m else None)

    def _save_multihost(self, step, state, rank, world,
                        shard_specs=None):
        """Two-phase commit across ``world`` hosts sharing this
        directory.  Each host (including the leader) runs phase 1; the
        leader alone runs phase 2.  Non-leaders return after publishing
        their marker — the coordinated-preemption path barriers AFTER
        save on every host, which keeps the leader alive through
        promotion before anyone exits."""
        final = self._step_dir(step)
        stage = self._staging_dir(step)
        # dklint: ignore[unguarded-shared-write] single writer at a time (sync save drains async first); atomic reference assignment
        self._inflight = os.path.basename(final)
        try:
            # every attempt of _save_host_once retracts this rank's own
            # marker before touching data, so the leader can never
            # promote around a host that is still (re)writing
            self._retry.call(self._save_host_once, stage, rank, state,
                             shard_specs)
            if rank == 0:
                self._promote(stage, final, world)
                self._gc_orphans()
        finally:
            # dklint: ignore[unguarded-shared-write] same single-writer argument as the store above
            self._inflight = None
        if rank == 0:
            self._retain()
            self.gc_chunks()

    # -- integrity: verify / quarantine / verified fallback -------------
    def verify(self, step=None, all_hosts=False):
        """Public READ-ONLY integrity probe of ``step`` (default:
        latest) — this rank's payload, the same bytes :meth:`restore`
        would load.  -> ``"ok"`` (every byte hashes clean against the
        manifest) or ``"unverifiable"`` (pre-manifest legacy checkpoint
        — soft, old runs keep restoring).  Raises a typed
        :class:`CheckpointCorrupt` naming each mismatched file.  Never
        mutates the directory: a serving-side watcher probes a live
        training run's checkpoints with this before every hot swap.

        ``all_hosts=True`` probes EVERY writer's payload, not just this
        rank's — what a reshard-bound reader (a world-M process facing
        a world-N step) must use, since a resharding restore will read
        them all.  The combined status is the weakest across payloads
        (any ``unverifiable`` payload makes the step ``unverifiable``).
        """
        import time as _time

        from dist_keras_tpu_torch.observability import events

        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        step = int(step)
        if all_hosts:
            paths = self.host_payload_paths(step)
        else:
            paths = [self._payload_dir(self._read_path(step))]
        t0 = _time.perf_counter()
        status = "ok"
        for path in paths:
            got, problems = verify_manifest(path)
            if got == "corrupt":
                events.emit("ckpt_corrupt", step=step,
                            n_problems=len(problems),
                            problems=problems[:3])
                raise CheckpointCorrupt(step, path, problems)
            if got == "unverifiable":
                status = got
        events.emit("ckpt_verify", step=step, status=status,
                    duration_s=_time.perf_counter() - t0)
        return status

    def latest_verified_step(self):
        """Latest step whose payload verifies (``"ok"`` or legacy
        ``"unverifiable"``), or None.  STRICTLY read-only — corrupt
        steps are skipped, not quarantined (this is the supervisor's
        restart probe, which may run from a non-writer process).

        A step an elastic restore would RESHARD (written by a
        different world) is judged on EVERY payload it would read —
        this rank's clean shard must not advertise a step whose other
        payloads rotted, or the supervised relaunch would crash-loop
        against a restore this probe claimed was safe."""
        rank, world = self._coord_ids()
        reshard_worlds = _elastic_enabled() and (
            world == 1 or _two_phase_enabled())
        for step in reversed(self.all_steps()):
            try:
                if reshard_worlds and self.saved_world(step) != world:
                    paths = self.host_payload_paths(step)
                else:
                    paths = [self._payload_dir(self._read_path(step))]
                statuses = [verify_manifest(p)[0] for p in paths]
            except (OSError, RuntimeError):
                continue  # unreadable layout: as unusable as corrupt
            if all(s != "corrupt" for s in statuses):
                return step
        return None

    def _quarantine(self, step):
        """Retire a corrupt step to ``step_N.corrupt`` so no reader
        (``all_steps``/``latest_step``/a serving watcher) ever counts it
        again, while the bytes stay on disk as post-mortem evidence
        (``_gc_orphans`` skips ``.corrupt``; only retention retires
        them).  Leader-only on pods, mirroring ``_gc_orphans`` — a
        non-leader renaming inside the shared directory could race the
        leader's own sweep."""
        import shutil

        rank, world = self._coord_ids()
        if world > 1 and rank != 0 and _two_phase_enabled():
            return False
        path = self._read_path(step)  # committed dir OR stranded .old
        target = self._step_dir(step) + ".corrupt"
        try:
            shutil.rmtree(target, ignore_errors=True)  # stale quarantine
            os.rename(path, target)
        except OSError:  # pragma: no cover - raced writer / read-only fs
            return False
        if self.fsync:
            _fsync_dir(self.directory)
        return True

    # -- remote checkpoint tier ------------------------------------------
    def _remote(self):
        """The configured remote store, or None: the constructor's
        ``remote_store`` wins, else ``DK_CKPT_REMOTE`` is re-read per
        call (launcher-exported values win regardless of construction
        order)."""
        if self._remote_store is not None:
            return self._remote_store
        from dist_keras_tpu_torch.resilience import store as _store

        return _store.store_from_env()

    def has_remote(self):
        return self._remote() is not None

    def remote_steps(self):
        """Steps the remote tier holds a COMPLETE marker for (sorted).
        Raises the store's typed error on an unreachable tier."""
        s = self._remote()
        if s is None:
            return []
        from dist_keras_tpu_torch.resilience import store as _store

        return _store.remote_steps(s)

    def _remote_has_quiet(self, step):
        """True when the remote tier completely holds ``step`` — a
        PROBE: an unreachable/broken store reads as "no" (the callers
        are fallback paths that must degrade, not die, when the remote
        tier is the thing that is down)."""
        s = self._remote()
        if s is None:
            return False
        from dist_keras_tpu_torch.resilience import store as _store

        try:
            return _store.remote_has_step(s, step)
        except OSError:
            return False

    def _fetch_allowed(self, rank, world):
        """A fetch WRITES the local directory, so it follows the
        writer-side discipline: leader-only on shared-dir pods."""
        return not (world > 1 and rank != 0 and _two_phase_enabled())

    def fetch_remote(self, step=None):
        """Pull ``step`` (default: the newest remote COMPLETE step)
        from the remote tier into the local directory and promote it
        with the normal journaled swap; -> the step.  The fetched copy
        then restores/verifies exactly like a locally written one —
        remote bytes are never trusted blind.  On a shared-dir pod a
        non-leader rank WAITS (bounded) for the leader's fetch to
        appear instead of racing it.  ``FileNotFoundError`` when no
        remote tier is configured or it has no such step."""
        from dist_keras_tpu_torch.resilience.coordination import (
            default_timeout_s,
        )

        s = self._remote()
        if s is None:
            raise FileNotFoundError(
                "no remote checkpoint store configured "
                "(DK_CKPT_REMOTE unset and no remote_store passed)")
        from dist_keras_tpu_torch.resilience import store as _store

        rank, world = self._coord_ids()
        if not self._fetch_allowed(rank, world):
            after = None if step is None else int(step) - 1
            got = self.wait_for_step_after(
                after, timeout_s=default_timeout_s())
            if got is None:
                raise FileNotFoundError(
                    "remote checkpoint fetch is leader-only on a "
                    "shared checkpoint directory and the leader's "
                    "fetched step never appeared within the deadline")
            return got if step is None else int(step)
        if step is None:
            steps = _store.remote_steps(s)
            if not steps:
                raise FileNotFoundError(
                    "remote checkpoint store holds no completed steps")
            step = steps[-1]
        step = int(step)
        stage = _store.fetch_step(s, self.directory, step,
                                  fsync=self.fsync)
        self._swap_in(stage, self._step_dir(step))
        return step

    def fetch_remote_newer(self, after=None, skip=()):
        """Fetch the NEWEST remote step strictly newer than ``after``
        that is neither locally promoted already nor in ``skip``; ->
        the step, or None when the remote tier has nothing newer (or
        none is configured).  The serving watcher's pull-through seam."""
        if self._remote() is None:
            return None
        have = set(self.all_steps())
        for step in reversed(self.remote_steps()):
            if after is not None and step <= after:
                break
            if step in have or step in skip:
                continue
            return self.fetch_remote(step)
        return None

    def _maybe_start_uploader(self, rank, world):
        """Arm the background remote mirror once per instance when a
        remote tier is configured and ``DK_CKPT_REMOTE_PUSH`` is on.
        Leader-only on shared-dir pods (one mirror per pod — the
        promoted step dir carries every host's payload).  Failures to
        arm are absorbed: the run keeps its local durability."""
        if self._uploader is not None:
            return
        if not knobs.get("DK_CKPT_REMOTE_PUSH"):
            return
        if not self._fetch_allowed(rank, world):
            return
        store = self._remote_store
        if store is None \
                and not (knobs.raw("DK_CKPT_REMOTE") or "").strip():
            return
        try:
            from dist_keras_tpu_torch.resilience.store import (
                CheckpointUploader,
            )

            # single writer: save() is the only author of _uploader
            # (the training/caller thread), reference assignment atomic
            self._uploader = CheckpointUploader(
                self, store=store).start()
        # dklint: ignore[broad-except] a misconfigured remote must not
        # kill the save that tripped the arming — local durability
        # stands, the event names the reason
        except Exception as e:
            from dist_keras_tpu_torch.observability import events

            events.emit("ckpt_push", error=type(e).__name__,
                        detail="uploader failed to start: "
                               + str(e)[:160])
            self._uploader = False  # don't retry every save

    def stop_uploader(self, timeout_s=5.0, drain=False):
        """Stop the background mirror (if one was armed); with
        ``drain`` push anything still outstanding after the loop has
        stopped (single poll driver at a time — the uploader's
        contract)."""
        u, self._uploader = self._uploader, None
        if u:
            u.stop(timeout_s)
            if drain:
                u.drain()

    def restore(self, step=None, template=None, verify=None,
                elastic=None):
        """Restore ``step`` (default: latest); -> ``(step, state)`` with
        host leaves (numpy arrays; bf16 leaves as CPU tensors).
        ``template``: a tree of the target structure whose leaves give
        each restored leaf its dtype and device (CUDA leaves are
        uploaded from pinned memory) — :func:`apply_template`.

        ``verify`` (default: ``DK_CKPT_VERIFY``, on): check the payload
        against its integrity manifest first.  A corrupt step emits
        ``ckpt_corrupt``, is quarantined to ``step_N.corrupt`` and the
        restore FALLS BACK to the previous promoted step automatically
        — recovery self-heals instead of exploding mid-restore.  Only
        when no verified step remains does the original
        :class:`CheckpointCorrupt` propagate.

        ``elastic`` (default: ``DK_ELASTIC``, on): when the step was
        written by a DIFFERENT world size than this process's
        (``saved_world(step) != world`` — the post-resize relaunch, or
        a world-1 server loading a pod-written checkpoint), delegate to
        ``resilience.elastic.reshard_restore``: every source payload
        verified, sharded leaves gathered by global index and re-split
        for this (rank, world).  With it off, the pre-elastic
        semantics return."""
        check = _verify_enabled() if verify is None else bool(verify)
        remote_tried = set()  # steps already re-fetched once: a remote
        #                       copy that ALSO rots must not loop
        if step is None:
            step = self.latest_step()
            if step is None and self.has_remote():
                # the spot-fleet replacement host: nothing local, a
                # remote tier configured — pull the newest completed
                # step down and restore it like any local one (a
                # world-N step then reshards below)
                try:
                    step = self.fetch_remote()
                    remote_tried.add(step)
                except FileNotFoundError:
                    step = None  # empty store: same verdict as no dir
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        step = int(step)
        use_elastic = (_elastic_enabled() if elastic is None
                       else bool(elastic))
        if use_elastic:
            rank, world = self._coord_ids()
            # with two-phase opted OUT (world > 1 on per-host LOCAL
            # dirs) the single-host payload layout says nothing about
            # the writing world — a mismatch verdict would be noise,
            # so the elastic detection only applies where the layout
            # is authoritative (a shared directory, or a world-1
            # reader of one)
            while (world == 1 or _two_phase_enabled()) \
                    and self.saved_world(step) != world:
                from dist_keras_tpu_torch.resilience import elastic as _el

                try:
                    return _el.reshard_restore(
                        self, step=step, template=template,
                        verify=check, rank=rank, world=world)
                except CheckpointCorrupt:
                    # world-1 self-heals like the single-host path —
                    # fall back to the previous promoted step (no
                    # quarantine: the reshard path keeps reader
                    # semantics, and the supervisor's probe skips the
                    # corrupt step the same way).  A world > 1 elastic
                    # restore propagates typed for the same reason the
                    # same-world pod path refuses per-rank fallback:
                    # ranks choosing different steps would diverge.
                    if world > 1 or not check:
                        raise
                    if step not in remote_tried \
                            and self._remote_has_quiet(step):
                        # the remote tier still holds a clean copy of
                        # exactly this step: re-fetch it over the
                        # rotted local bytes and retry (the swap
                        # retires the bad copy; the re-verify below
                        # convicts the remote copy too if it rotted)
                        remote_tried.add(step)
                        try:
                            self.fetch_remote(step)
                            continue
                        except (OSError, CheckpointCorrupt):
                            pass  # remote unusable too: fall back
                    fallback = [s for s in self.all_steps()
                                if s < step]
                    if not fallback:
                        raise
                    step = fallback[-1]
                    # a same-world fallback step re-enters the normal
                    # verified-restore loop below
        while True:
            if check:
                try:
                    self.verify(step)  # emits ckpt_verify / ckpt_corrupt
                except CheckpointCorrupt as e:
                    rank, world = self._coord_ids()
                    if world > 1:
                        # a PER-RANK fallback on a pod would silently
                        # diverge the cluster: this rank restoring
                        # step N-1 while peers (whose payloads hash
                        # clean) restore step N is worse than the loud
                        # pre-manifest crash.  Choosing a common
                        # fallback step needs a cluster agreement the
                        # restore path cannot assume (the coordinator
                        # may be poisoned or not yet constructed), so
                        # the typed verdict propagates and the
                        # supervisor/operator restarts the POD from a
                        # step all ranks verify.  This holds with
                        # two-phase opted OUT too (DK_CKPT_TWO_PHASE=0,
                        # per-host local dirs): one host's local copy
                        # rotting must not let that rank quietly resume
                        # from N-1 while its peers resume from N.
                        raise CheckpointCorrupt(
                            e.step, e.path, e.problems + [
                                "multi-host restore does not fall back "
                                "per-rank (peers would diverge); "
                                "restart the pod from an earlier step"])
                    self._quarantine(step)
                    if step not in remote_tried \
                            and self._remote_has_quiet(step):
                        # the remote mirror still holds this exact
                        # step: pull the clean copy into the name the
                        # quarantine just freed and retry — one
                        # checkpoint cadence of staleness becomes
                        # ZERO when the tier has the cure
                        remote_tried.add(step)
                        try:
                            self.fetch_remote(step)
                            continue
                        except (OSError, CheckpointCorrupt):
                            pass  # remote copy unusable: fall back
                    fallback = [s for s in self.all_steps() if s < step]
                    if not fallback:
                        raise
                    step = fallback[-1]
                    continue
            step, state = self._restore_inner(step, template)
            if template is not None:
                state = apply_template(state, template)
            # emitted AFTER the load: like ckpt_save, only a COMPLETED
            # restore is recorded — a crash-loop whose every restart
            # fails to restore must not read as N successful restores
            from dist_keras_tpu_torch.observability import events

            events.emit("ckpt_restore", step=int(step))
            return step, state

    def _restore_inner(self, step, template):
        path = self._payload_dir(self._read_path(step))
        return self._restore_payload(path, template, step=step)

    def _restore_payload(self, path, template, step=None):
        """Load ONE payload directory; -> ``(step, state)`` with host
        leaves (``template`` is applied by the callers).  The unit the
        per-rank restore and the elastic gather (which reads every
        host's payload) share.  Understands both of the port's
        formats regardless of the current knobs — chunked
        (``chunks.json``) and the pickle fallback (``state.pkl``) — so
        chunked and un-chunked checkpoints restore interchangeably in
        both directions; an orbax-format step is refused typed."""
        del template
        if os.path.exists(os.path.join(path, CHUNKS_NAME)):
            return step, self._restore_chunked(path)
        pkl = os.path.join(path, "state.pkl")
        if os.path.exists(pkl):  # fallback-format checkpoint
            try:
                with open(pkl, "rb") as f:
                    return step, restricted_load(f, pkl)
            except (OSError, EOFError, pickle.UnpicklingError,
                    AttributeError, TypeError) as e:
                raise CheckpointCorrupt(step, path, [
                    f"state.pkl unreadable: {type(e).__name__}: {e}"])
        names = set(os.listdir(path)) if os.path.isdir(path) else set()
        if names & {"_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt",
                    "_sharding"} or any(n.startswith("ocdbt.")
                                        for n in names):
            raise CheckpointFormatError(
                f"checkpoint step {step} at {path} is in orbax's format "
                "(the reference's writer under DK_CKPT_CHUNK_MB=0 with "
                "orbax installed); the port reads the chunked and "
                "state.pkl formats only — re-save it in the reference "
                "with DK_CKPT_CHUNK_MB > 0")
        raise CheckpointFormatError(
            f"checkpoint step {step} at {path} holds neither "
            f"{CHUNKS_NAME} nor state.pkl (files: {sorted(names)[:6]})")

    def _restore_chunked(self, path):
        """Read a chunked payload: unpickle the skeleton (restricted),
        then fill each chunked leaf's preallocated buffer from its chunk
        files in order.  Self-describing (dtype + shape recorded at save
        time), so no template is needed; a ``"bfloat16"`` leaf is read
        as raw 16-bit words and viewed as a CPU ``torch.bfloat16``
        tensor.  A missing or short chunk is a typed
        :class:`CheckpointCorrupt` (the verified-restore path convicts
        it via the manifest first; this guards the ``verify=False``
        escape hatch)."""
        try:
            with open(os.path.join(path, CHUNKS_NAME)) as f:
                meta = json.load(f)
            with open(os.path.join(path, "small.pkl"), "rb") as f:
                skeleton = restricted_load(
                    f, os.path.join(path, "small.pkl"))
            cb = int(meta.get("chunk_bytes") or 0)
            # resolve every leaf's plan INSIDE the guard: valid JSON
            # of the wrong SHAPE (rotted key names, a leaf missing
            # 'files', a garbage dtype string) must convict typed too,
            # not leak a bare KeyError/TypeError past verify=False
            plans = [(int(m["index"]),
                      (str(m["dtype"]) if str(m["dtype"]) == BF16_NAME
                       else np.dtype(str(m["dtype"]))),
                      tuple(int(s) for s in m["shape"]),
                      [str(r) for r in m["files"]])
                     for m in meta["leaves"]]
        except (OSError, EOFError, ValueError, KeyError, TypeError,
                pickle.UnpicklingError, AttributeError) as e:
            if isinstance(e, CheckpointFormatError):
                raise
            # the format's own metadata rotted: as damning as a bad
            # chunk, and it must stay TYPED even under verify=False
            raise CheckpointCorrupt(None, path, [
                f"chunked payload metadata unreadable: "
                f"{type(e).__name__}: {e}"])
        arrays = {}
        for index, dtype, shape, files in plans:
            bf16 = isinstance(dtype, str)
            arr = np.empty(shape, dtype=np.uint16 if bf16 else dtype)
            mv = arr.reshape(-1).view(np.uint8)
            off = 0
            for j, rel in enumerate(files):
                # each chunk's exact span is known from the recorded
                # chunk size: a short OR padded chunk file is convicted
                # here, never silently shifted into the next chunk's
                # bytes
                want = (min(cb, arr.nbytes - j * cb) if cb
                        else arr.nbytes)
                full = os.path.join(path, rel)
                try:
                    with open(full, "rb") as f:
                        got = f.readinto(mv[off:off + want])
                        extra = f.read(1)
                except OSError as e:
                    raise CheckpointCorrupt(None, path, [
                        f"{rel}: chunk unreadable "
                        f"({type(e).__name__}: {e})"])
                if got != want or extra:
                    raise CheckpointCorrupt(None, path, [
                        f"{rel}: {got}{'+' if extra else ''} bytes, "
                        f"leaf chunk wants exactly {want}"])
                off += got
            if off != arr.nbytes:
                raise CheckpointCorrupt(None, path, [
                    f"chunk_{index:04d}: {off} bytes read, leaf "
                    f"wants {arr.nbytes}"])
            arrays[index] = _bf16_words(arr) if bf16 else arr
        flat, treedef = _flatten(skeleton)
        leaves = []
        for _, x in flat:
            if isinstance(x, _ChunkRef):
                if x.index not in arrays:
                    # well-formed chunks.json whose leaves table lost
                    # the entry small.pkl still references: typed, like
                    # every other metadata rot
                    raise CheckpointCorrupt(None, path, [
                        f"{CHUNKS_NAME}: no leaf entry for chunk index "
                        f"{x.index} referenced by small.pkl"])
                x = arrays[x.index]
            leaves.append(x)
        return _unflatten(treedef, leaves)

    def _retain(self):
        # leader-only on a pod, like _gc_orphans: retention deletes are
        # writer-side mutations of the shared directory (per-host local
        # dirs — two-phase opted out — retain themselves)
        rank, world = self._coord_ids()
        if world > 1 and rank != 0 and _two_phase_enabled():
            return
        steps = self.all_steps()
        excess = len(steps) - self.max_to_keep
        for step in steps[:max(excess, 0)]:
            import shutil

            shutil.rmtree(self._step_dir(step), ignore_errors=True)
            shutil.rmtree(self._step_dir(step) + ".old",
                          ignore_errors=True)
        # quarantined evidence is retired on the same horizon as the
        # live steps it rode with (it never counts toward max_to_keep,
        # but must not accumulate forever on a long run with a flaky
        # disk) — anything older than the oldest RETAINED step goes
        if steps:
            import shutil

            horizon = steps[max(excess, 0)] if excess > 0 else steps[0]
            for name in os.listdir(self.directory):
                if name.endswith(".corrupt") \
                        and _STEP_RE.match(name[:-8]) \
                        and int(name[:-8].split("_")[1]) < horizon:
                    shutil.rmtree(os.path.join(self.directory, name),
                                  ignore_errors=True)

    # -- content-addressed chunk GC --------------------------------------
    def _live_chunks(self):
        """Every CAS sha referenced by ANY step-shaped directory entry
        — committed steps, retired ``.old`` copies, quarantined
        ``.corrupt`` evidence, fetch staging, and in-flight
        ``.mh``/``.tmp`` staging: a reference ANYWHERE pins the chunk.
        Torn/unreadable ``chunks.json`` tables pin nothing themselves
        (a mid-write table's chunks are inside the mtime grace window;
        a promoted step's table is complete by construction)."""
        from dist_keras_tpu_torch.resilience.store import collect_cas_refs

        live = set()
        for name in os.listdir(self.directory):
            if not _STEP_RE.match(name.split(".", 1)[0]):
                continue  # chunks/ CAS, journal, operator files
            root = os.path.join(self.directory, name)
            if os.path.isdir(root):
                live |= collect_cas_refs(root)
        return live

    def gc_chunks(self, raise_errors=False):
        """Collect CAS chunks nothing references any more; -> how many
        were removed.  Retention-aware by construction — it runs AFTER
        :meth:`_retain`, and a chunk shared with any still-retained,
        quarantined or in-flight step stays (see :meth:`_live_chunks`).
        Leader-only on pods, like every other writer-side sweep.

        Crash-safe: candidates younger (mtime) than
        ``DK_CKPT_GC_GRACE_S`` are never touched (an in-flight save's
        just-written or just-reused chunks), the doomed list is
        journaled durably BEFORE the first unlink
        (``chunks/gc-journal.json`` — the ``"ckpt.gc"`` fault point
        fires exactly between journal and deletes), and liveness is
        recomputed from scratch every sweep, so a kill at any instant
        leaves every referenced chunk in place.  The next sweep
        CONSUMES a crashed sweep's journal: its entries — already
        verified unreferenced and aged when the intent was recorded —
        finish collection immediately (grace-exempt, provided their
        mtime is still older than the journal: a later touch means a
        save adopted the chunk and the normal rules apply) instead of
        re-waiting a full grace window per crash; liveness is still
        re-checked.  GC is maintenance: failures are absorbed
        (recorded on the ``ckpt_gc`` event) unless ``raise_errors``."""
        import time as _time

        from dist_keras_tpu_torch.observability import events

        rank, world = self._coord_ids()
        if world > 1 and rank != 0 and _two_phase_enabled():
            return 0
        cas = os.path.join(self.directory, CAS_DIR_NAME)
        if not os.path.isdir(cas):
            return 0
        journal = os.path.join(cas, GC_JOURNAL_NAME)
        try:
            from dist_keras_tpu_torch.resilience.faults import fault_point

            live = self._live_chunks()
            grace = float(knobs.get("DK_CKPT_GC_GRACE_S"))
            now = _time.time()
            # consume a crashed sweep's journal: its entries were
            # verified unreferenced AND past grace when the intent was
            # made durable, so any of them still UNTOUCHED since then
            # (mtime <= the journal's own timestamp — a later touch
            # means some save adopted the chunk and the normal
            # grace/liveness rules own it again) finish collection
            # NOW instead of waiting out a fresh grace window after
            # every crash.  Liveness is still re-checked below.
            j_doomed, j_t = set(), None
            try:
                with open(journal) as f:
                    j = json.load(f)
                j_doomed = {str(x) for x in j["doomed"]}
                j_t = float(j["t"])
            except (OSError, ValueError, KeyError, TypeError):
                pass  # no journal, or a torn one: plain sweep
            resumed = 0
            doomed = []
            for name in os.listdir(cas):
                if name == GC_JOURNAL_NAME or name in live:
                    continue
                full = os.path.join(cas, name)
                try:
                    mt = os.path.getmtime(full)
                except OSError:  # pragma: no cover - raced delete
                    continue
                if now - mt < grace:
                    if not (name in j_doomed and j_t is not None
                            and mt <= j_t):
                        continue  # maybe referenced by an in-flight
                        #           save whose table isn't on disk yet
                    resumed += 1
                doomed.append(name)
            if not doomed:
                # a leftover journal from a crashed sweep: this sweep
                # recomputed everything and found nothing to do — the
                # record has served its purpose
                try:
                    os.remove(journal)
                except OSError:
                    pass
                return 0
            jtmp = journal + ".tmp"
            with open(jtmp, "w") as f:
                json.dump({"t": now, "doomed": doomed}, f)
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(jtmp, journal)
            if self.fsync:
                _fsync_dir(cas)
            # the deterministic mid-GC kill: intent durable, nothing
            # deleted yet — every retained step must stay restorable
            fault_point("ckpt.gc")
            removed = 0
            for name in doomed:
                try:
                    os.remove(os.path.join(cas, name))
                    removed += 1
                except OSError:  # pragma: no cover - raced
                    pass
            try:
                os.remove(journal)
            except OSError:  # pragma: no cover
                pass
            if self.fsync:
                _fsync_dir(cas)
            events.emit("ckpt_gc", collected=removed, live=len(live),
                        grace_s=grace, resumed=resumed)
            return removed
        # dklint: ignore[broad-except] GC is maintenance — a failing
        # sweep (or an injected chaos kill inside it) must not fail the
        # save that triggered it; the event records it and the next
        # sweep retries from scratch
        except Exception as e:
            if raise_errors:
                raise
            events.emit("ckpt_gc", error=type(e).__name__,
                        detail=str(e)[:200])
            return 0
