"""Adam's update and ``apply_updates`` over a whole params tree, each in
one launch of a hand-written kernel (``csrc/multi_tensor.cu``).

The plain versions are ``ops/optimizers.py``'s :func:`adam_reference`
and :func:`apply_updates_reference`; ``adam`` and ``apply_updates``
there route a tree on CUDA here and a tree elsewhere to them.  The
kernels repeat the plain versions' operations in their order and
rounding, so the results are bit-equal.

- :func:`plan_launches` — leaves to launches: each launch takes at most
  ``max_leaves`` leaves (the table a launch's parameters hold), each
  leaf ``ceil(n / CHUNK)`` blocks after the blocks of the leaves before
  it; leaves of no element take no block.
- :func:`row_lengths` — each leaf's elements per value of the step
  count: 0 for a 0-d count (one correction for the tree), ``n / W`` for
  a stacked count of shape ``(W,)`` (``trainers/step.py``'s worker
  step), whose rows are the leaf's leading dims.
- :func:`check_adam` / :func:`check_apply` — what the kernels take:
  f32 or bf16 leaves (adam: g, mu, nu and p of one dtype; the apply: p
  and u each f32 or bf16) of matching shapes; a ``TypeError`` or
  ``ValueError`` names the leaf.
- :func:`adam_update` / :func:`apply_updates` — launch the kernels on a
  tree on one CUDA device (no fallback: they run or raise), new
  contiguous tensors out, the inputs as they were.  An input that is not
  contiguous (autograd hands some gradients over transposed: a TP
  block's ``w1``, a conv kernel) reaches the kernel as a dense copy.

``adam_update_launches`` and ``apply_updates_launches`` count kernel
launches, so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple

import numpy as np
import torch
from torch._utils import _unflatten_dense_tensors

from dist_keras_tpu_torch.ops import _build
from dist_keras_tpu_torch.utils.pytree import (
    tree_map,
    tree_paths,
    tree_unflatten,
)

CHUNK = 4096             # elements a block: CHUNK in csrc/multi_tensor.cu
ADAM_MAX_LEAVES = 300    # rows of a launch's table: ADAM_MAX_LEAVES there
APPLY_MAX_LEAVES = 480   # APPLY_MAX_LEAVES there
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}

# the tables' rows, laid out as AdamLeaf and ApplyLeaf in the source
ADAM_LEAF = np.dtype([("g", "<u8"), ("m", "<u8"), ("v", "<u8"),
                      ("u", "<u8"), ("m_out", "<u8"), ("v_out", "<u8"),
                      ("n", "<i8"), ("row", "<i8"), ("dtype", "<i4"),
                      ("first_block", "<i4")])
APPLY_LEAF = np.dtype([("p", "<u8"), ("u", "<u8"), ("out", "<u8"),
                       ("n", "<i8"), ("p_dtype", "<i4"), ("u_dtype", "<i4"),
                       ("first_block", "<i4"), ("pad", "<i4")])

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "dk_adam_update": [_P, _I, _I, _L, _P, _P, _F, _F, _F, _F, _F, _F, _F,
                       _P],
    "dk_apply_updates": [_P, _I, _I, _L, _P],
}

adam_update_launches = 0
apply_updates_launches = 0
_COUNT_LOCK = threading.Lock()


def _count(name, n):
    with _COUNT_LOCK:
        globals()[name] += n


class Launch(NamedTuple):
    leaves: list        # indices into the tree's leaves
    first_block: list   # each leaf's first block in the launch's grid
    blocks: int


def plan_launches(sizes, max_leaves, chunk=CHUNK):
    """Leaves of ``sizes`` elements -> the :class:`Launch` es that cover
    them, in order, each of at most ``max_leaves`` leaves."""
    launches, idx, firsts, blocks = [], [], [], 0
    for i, n in enumerate(sizes):
        if n == 0:
            continue
        if len(idx) == max_leaves:
            launches.append(Launch(idx, firsts, blocks))
            idx, firsts, blocks = [], [], 0
        idx.append(i)
        firsts.append(blocks)
        blocks += -(-n // chunk)
    if idx:
        launches.append(Launch(idx, firsts, blocks))
    return launches


def row_lengths(shapes, count_shape):
    """Each leaf's elements per value of a count of ``count_shape``: 0
    for a 0-d count, else the leaf's size over the count's (the count's
    shape leads the leaf's, :func:`check_adam`)."""
    if not count_shape:
        return [0] * len(shapes)
    w = math.prod(count_shape)
    return [math.prod(s) // w for s in shapes]


def leaf_path(tree, index):
    """The path of ``tree``'s leaf number ``index`` (``tree_leaves``
    order), as ``['blocks'][3]['wq']``: named only in an error."""
    return tree_paths(tree)[index] or "<root>"


def _zip_leaves(what, *trees):
    """The leaves of ``trees`` side by side, paired as ``tree_map``
    pairs them -> a list of tuples."""
    out = []
    try:
        tree_map(lambda *xs: out.append(xs), *trees)
    except (KeyError, TypeError) as e:
        raise ValueError(f"{what}: the trees differ in structure "
                         f"({e!r})") from None
    return out


def _dense(tensors):
    """``tensors`` with a dense copy of each that is not contiguous: the
    kernels read every input at its element's index."""
    return [t if t.is_contiguous() else t.contiguous() for t in tensors]


def check_adam(grads, mu, nu, count, params=None):
    """Raise unless the update kernel takes these trees: every leaf's g,
    mu, nu (and p, when given) one dtype, f32 or bf16, and of one shape,
    led by the count's shape.  -> (g, mu, nu) a leaf."""
    trees = (grads, mu, nu) if params is None else (grads, mu, nu, params)
    leaves = _zip_leaves("adam", *trees)
    cs = tuple(count.shape)
    for i, ts in enumerate(leaves):
        g, m, v, p = ts if params is not None else (*ts, ts[0])
        dt = g.dtype
        if dt not in _DTYPE_CODES or m.dtype is not dt \
                or v.dtype is not dt or p.dtype is not dt:
            raise TypeError(
                f"adam kernel: leaf {leaf_path(grads, i)} has g, mu, nu, p "
                f"of {g.dtype}, {m.dtype}, {v.dtype}, {p.dtype}; it takes "
                "float32 or bfloat16, one dtype a leaf")
        shape = g.shape
        if m.shape != shape or v.shape != shape or p.shape != shape:
            raise ValueError(
                f"adam kernel: leaf {leaf_path(grads, i)} has g, mu, nu, p "
                f"of shapes {tuple(g.shape)}, {tuple(m.shape)}, "
                f"{tuple(v.shape)}, {tuple(p.shape)}")
        if cs and tuple(shape[:len(cs)]) != cs:
            raise ValueError(
                f"adam kernel: leaf {leaf_path(grads, i)} of shape "
                f"{tuple(shape)} is not led by the step count's shape {cs}")
    return [ts[:3] for ts in leaves]


def check_apply(params, updates):
    """Raise unless the apply kernel takes these trees: p and u each f32
    or bf16 and of one shape.  -> (p, u) a leaf."""
    leaves = _zip_leaves("apply_updates", params, updates)
    for i, (p, u) in enumerate(leaves):
        if p.dtype not in _DTYPE_CODES or u.dtype not in _DTYPE_CODES:
            raise TypeError(
                f"apply_updates kernel: leaf {leaf_path(params, i)} has p "
                f"of {p.dtype} and u of {u.dtype}; it takes float32 or "
                "bfloat16")
        if p.shape != u.shape:
            raise ValueError(
                f"apply_updates kernel: leaf {leaf_path(params, i)} has p "
                f"of shape {tuple(p.shape)} and u of {tuple(u.shape)}")
    return leaves


def _check_device(what, device, tensors):
    index = device.index
    if device.type != "cuda" or any(t.get_device() != index
                                    for t in tensors):
        raise ValueError(
            f"{what} kernel: every leaf must lie on one CUDA device; got "
            f"{sorted({str(t.device) for t in tensors} | {str(device)})}")


def _empties(leaves, n):
    """``n`` lists of new contiguous tensors shaped like ``leaves``.  Each
    list is one allocation a dtype carved into views, each leaf starting
    16-byte aligned (the kernels' vectors): a list of views costs the
    host a fraction of a tensor allocated a leaf."""
    out = [[None] * len(leaves) for _ in range(n)]
    groups = {}
    for i, t in enumerate(leaves):
        if t.numel():
            groups.setdefault(t.dtype, []).append(i)
        else:
            for o in out:
                o[i] = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    for dtype, idx in groups.items():
        align = 16 // _ITEMSIZE[dtype]
        shapes, keep, total = [], [], 0
        for i in idx:
            keep.append(len(shapes))
            shapes.append(leaves[i])
            total += leaves[i].numel()
            if total % align:
                shapes.append(torch.empty(-total % align, device="meta"))
                total += -total % align
        dev = leaves[idx[0]].device
        for o in out:
            views = _unflatten_dense_tensors(
                torch.empty(total, dtype=dtype, device=dev), shapes)
            for i, j in zip(idx, keep):
                o[i] = views[j]
    return out


def _run(lib, fn, what, rows, launches, *args):
    """Launch ``fn`` once a planned launch, each with its rows of the
    table, ``first_block`` filled in."""
    for launch in launches:
        table = rows[launch.leaves]
        table["first_block"] = launch.first_block
        code = getattr(lib, fn)(table.ctypes.data, len(launch.leaves),
                                launch.blocks, CHUNK, *args)
        _build.check(lib, code, what)


def adam_update(grads, mu, nu, c1, c2, b1, b2, eps, eps_root, learning_rate,
                params=None):
    """Adam's step on a CUDA tree in one launch (or a few): -> the trees
    (u, mu', nu'), new and contiguous, u = -lr * m_hat / (sqrt(v_hat +
    eps_root) + eps), the update that ``adam_reference`` gives.  ``c1``
    / ``c2`` are the bias corrections ``1 - b^count``, f32 on the card,
    shaped like the step count."""
    leaves = check_adam(grads, mu, nu, c1, params)
    if not leaves:
        return grads, mu, nu
    gl, ml, vl = zip(*leaves)
    dev = gl[0].device
    _check_device("adam", dev, [c1, c2, *gl, *ml, *vl])
    gl, ml, vl = _dense(gl), _dense(ml), _dense(vl)
    if not (c1.dtype is c2.dtype is torch.float32 and c1.is_contiguous()
            and c2.is_contiguous() and c1.shape == c2.shape):
        raise ValueError("adam kernel: the corrections must be contiguous "
                         "float32 tensors of the count's shape")
    outs = _empties(gl, 3)
    sizes = [g.numel() for g in gl]
    launches = plan_launches(sizes, ADAM_MAX_LEAVES)
    rows = np.zeros(len(gl), ADAM_LEAF)
    for name, ts in zip(("g", "m", "v", "u", "m_out", "v_out"),
                        (gl, ml, vl, *outs)):
        rows[name] = [t.data_ptr() for t in ts]
    rows["n"] = sizes
    rows["row"] = row_lengths([g.shape for g in gl], tuple(c1.shape))
    rows["dtype"] = [_DTYPE_CODES[g.dtype] for g in gl]
    f32 = np.float32
    lib = _build.load("multi_tensor", _SIGNATURES)
    _run(lib, "dk_adam_update", "adam_update", rows, launches,
         c1.data_ptr(), c2.data_ptr(), f32(b1), f32(1 - b1), f32(b2),
         f32(1 - b2), f32(eps), f32(eps_root), f32(-learning_rate),
         _build.stream_handle(dev))
    _count("adam_update_launches", len(launches))
    return tuple(tree_unflatten(grads, ts) for ts in outs)


def apply_updates(params, updates):
    """p + u on a CUDA tree in one launch (or a few), the sum in f32
    rounded to p's dtype, new and contiguous: ``apply_updates_reference``'s
    values."""
    leaves = check_apply(params, updates)
    if not leaves:
        return params
    pl, ul = zip(*leaves)
    dev = pl[0].device
    _check_device("apply_updates", dev, pl + ul)
    pl, ul = _dense(pl), _dense(ul)
    (out,) = _empties(pl, 1)
    sizes = [p.numel() for p in pl]
    launches = plan_launches(sizes, APPLY_MAX_LEAVES)
    rows = np.zeros(len(pl), APPLY_LEAF)
    for name, ts in (("p", pl), ("u", ul), ("out", out)):
        rows[name] = [t.data_ptr() for t in ts]
    rows["n"] = sizes
    rows["p_dtype"] = [_DTYPE_CODES[p.dtype] for p in pl]
    rows["u_dtype"] = [_DTYPE_CODES[u.dtype] for u in ul]
    lib = _build.load("multi_tensor", _SIGNATURES)
    _run(lib, "dk_apply_updates", "apply_updates", rows, launches,
         _build.stream_handle(dev))
    _count("apply_updates_launches", len(launches))
    return tree_unflatten(params, out)
