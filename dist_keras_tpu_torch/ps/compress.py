"""Commit-delta compression for the PS worker family (``DK_PS_COMPRESS``),
a copy of the JAX package's ``ps/compress.py`` (numpy only).

A PS worker's commit payload is a float32 ``local - pulled`` pytree —
for WAN-separated workers (the ROADMAP round-17 follow-up) that is the
dominant wire cost of the whole training mode.  This module shrinks it
with the classic gradient-compression pair:

- **quantization** — ``fp16`` (2x) or symmetric per-leaf ``int8``
  (~4x: one max-abs scale per leaf, values rounded to [-127, 127]);
- **top-k sparsification** (optional ``@<fraction>`` suffix, e.g.
  ``int8@0.1``) — only the fraction of largest-|value| entries per
  leaf ship (flat indices + values, values then quantized per the
  codec).

Lossy compression biases SGD unless the error is fed back, so the
worker keeps a client-side **error-feedback residual**: what the codec
dropped from this window's delta is added into the NEXT window's delta
before encoding (``worker.py``).  Over the run every gradient
direction eventually ships — compression delays information, it never
destroys it.  The SERVER dequantizes to float32 before DynSGD
staleness scaling (``server.py``), so the center-update algebra —
the bit-parity surface pinned against ``trainers/dynsgd.py`` — sees
ordinary float32 deltas and stays codec-blind.

Wire format: the commit's ``delta`` field becomes
``{"__dk_ps_codec__": spec, "leaves": <tree of per-leaf records>}``;
per-leaf records are plain dicts of numpy arrays, so the existing
pickled-pytree transport carries them unchanged and an uncompressed
worker (or an old client) interoperates with the same server.

Integer leaves (RNG state, never applied by ``apply_commit``) ship as
zero-size markers — they cost nothing on the wire and decode back to
the zeros the uncompressed path sends.
"""

from __future__ import annotations

import math

import numpy as np

from dist_keras_tpu_torch.resilience import faults
from dist_keras_tpu_torch.utils import knobs

_WIRE_KEY = "__dk_ps_codec__"
_CODECS = ("fp16", "int8")


def parse_spec(spec):
    """``None``/empty -> None (off); else ``{"codec", "topk"}``.

    Accepted: ``fp16``, ``int8``, optionally ``@<fraction>`` with
    0 < fraction <= 1 (``int8@0.1`` = int8-quantized top-10%).
    Malformed specs fail LOUDLY — a typo'd compression knob silently
    shipping full deltas would fake the measurement it exists for."""
    if spec is None or not str(spec).strip():
        return None
    raw = str(spec).strip()
    # the framework's uniform boolean-off spellings disable compression
    # (DK_PS_COMPRESS=0 must mean "off", not a codec named "0")
    if raw.lower() in ("0", "off", "no", "false"):
        return None
    codec, _, frac = raw.partition("@")
    codec = codec.strip().lower()
    if codec not in _CODECS:
        raise ValueError(
            f"malformed DK_PS_COMPRESS={spec!r}: codec must be one of "
            f"{_CODECS} (optionally with @<topk_fraction>, e.g. "
            "'int8@0.1')")
    topk = None
    if frac:
        try:
            topk = float(frac)
        except ValueError:
            topk = -1.0
        if not 0.0 < topk <= 1.0:
            raise ValueError(
                f"malformed DK_PS_COMPRESS={spec!r}: topk fraction "
                f"{frac!r} must be a float in (0, 1]")
    return {"codec": codec, "topk": topk, "spec": f"{codec}" + (
        f"@{topk:g}" if topk is not None else "")}


def resolve_spec(explicit=None):
    """The effective spec: an explicit argument wins, else the
    ``DK_PS_COMPRESS`` knob (re-read per call, launcher exports win)."""
    if explicit is not None:
        return parse_spec(explicit)
    return parse_spec(knobs.raw("DK_PS_COMPRESS"))


def _is_float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


_KINDS = ("int", "fp16", "int8")


def _is_record(t):
    """A per-leaf wire record: a dict carrying its codec ``kind`` — a
    LEAF of the encoded tree, never recursed into (real param trees
    hold arrays at their leaves, so the shape is unambiguous)."""
    return isinstance(t, dict) and t.get("kind") in _KINDS


def _tree_map(fn, *trees):
    """Same stdlib-only structure walk as ``center._tree_map`` (the
    wire tree must stay framework-free on the server side), with wire
    records treated as leaves."""
    head = trees[0]
    if isinstance(head, dict) and not _is_record(head):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)):
        out = [_tree_map(fn, *(t[i] for t in trees))
               for i in range(len(head))]
        return type(head)(out) if isinstance(head, tuple) else out
    return fn(*trees)


def _encode_leaf(leaf, codec, topk):
    a = np.asarray(leaf)
    if not _is_float(a):
        # integer leaves never move through apply_commit — ship a
        # zero-size marker instead of the (meaningless) values
        return {"kind": "int", "shape": list(a.shape),
                "dtype": a.dtype.name}
    a32 = np.ascontiguousarray(a, dtype=np.float32)
    rec = {"shape": list(a32.shape)}
    flat = a32.reshape(-1)
    if topk is not None and flat.size:
        k = max(1, int(math.ceil(topk * flat.size)))
        if k < flat.size:
            idx = np.sort(
                np.argpartition(np.abs(flat), flat.size - k)[-k:])
            # the index dtype is the top-k overhead — size it to the
            # leaf (uint16 covers most MLP leaves at 2 bytes/entry)
            if flat.size <= 2**16:
                idt = np.uint16
            elif flat.size <= 2**32:
                idt = np.uint32
            else:  # pragma: no cover - >4G-element leaf
                idt = np.int64
            rec["idx"] = idx.astype(idt)
            flat = flat[idx]
    if codec == "fp16":
        rec.update(kind="fp16", values=flat.astype(np.float16))
        return rec
    # int8: symmetric per-leaf scale (max|x| -> 127)
    amax = float(np.max(np.abs(flat))) if flat.size else 0.0
    scale = amax / 127.0 if amax > 0 else 1.0
    q = np.clip(np.rint(flat / scale), -127, 127).astype(np.int8)
    rec.update(kind="int8", scale=np.float32(scale), values=q)
    return rec


def _decode_leaf(rec):
    if not isinstance(rec, dict) or "kind" not in rec:
        raise ValueError("malformed compressed delta leaf "
                         f"({type(rec).__name__})")
    shape = tuple(int(s) for s in rec.get("shape", ()))
    if rec["kind"] == "int":
        return np.zeros(shape, dtype=rec.get("dtype", "int32"))
    if rec["kind"] == "fp16":
        vals = np.asarray(rec["values"], dtype=np.float32)
    elif rec["kind"] == "int8":
        vals = (np.asarray(rec["values"], dtype=np.float32)
                * np.float32(rec["scale"]))
    else:
        raise ValueError(f"unknown delta codec kind {rec['kind']!r}")
    if "idx" in rec:
        flat = np.zeros(int(np.prod(shape or (1,))), dtype=np.float32)
        flat[np.asarray(rec["idx"], dtype=np.int64)] = vals
        return flat.reshape(shape)
    return vals.reshape(shape)


def encode_tree(delta, spec):
    """delta pytree -> wire dict (or ``delta`` unchanged when ``spec``
    is None).  The injectable ``ps.encode`` fault point fires here so
    the chaos schedule covers the compression seam like every other."""
    if spec is None:
        return delta
    faults.fault_point("ps.encode")
    leaves = _tree_map(
        lambda a: _encode_leaf(a, spec["codec"], spec["topk"]), delta)
    return {_WIRE_KEY: spec["spec"], "leaves": leaves}


def is_encoded(delta):
    return isinstance(delta, dict) and _WIRE_KEY in delta


def decode_tree(delta):
    """Wire dict -> float32 delta pytree; a plain (uncompressed) tree
    passes through untouched — the server stays codec-blind above this
    call."""
    if not is_encoded(delta):
        return delta
    return _tree_map(_decode_leaf, delta["leaves"])


def payload_nbytes(tree):
    """Sum of array-leaf bytes (wire records count every stored array:
    values, indices, scales) — the ``ps.commit_bytes_*`` counters'
    honest payload measure, pickle framing excluded on both sides."""
    total = 0

    def _walk(t):
        nonlocal total
        if isinstance(t, dict):
            for v in t.values():
                _walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                _walk(v)
        elif isinstance(t, str):
            pass
        else:
            total += np.asarray(t).nbytes

    _walk(tree)
    return total


def residual_update(sent, encoded):
    """Error feedback: ``sent - decode(encoded)`` per float leaf — what
    the codec dropped, folded into the next window's delta by the
    worker.  Non-float leaves (markers) residualize to zeros."""
    decoded = decode_tree(encoded)
    return _tree_map(
        lambda s, d: ((np.asarray(s, dtype=np.float32) - d)
                      if _is_float(s) else np.zeros((), np.int32)),
        sent, decoded)
