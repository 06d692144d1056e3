"""Paged decode attention: the Hopper kernel and its plain version.

Counterpart of ``ops/pallas/decode_attention.py``: ONE query position
per slot over a paged KV pool.  The kernel is ``csrc/paged_decode.cu``;
see its header for the design and its bound.  It splits each slot's
extent over ``n_split`` blocks and merges their partial softmax states
in the same launch; :func:`split_plan` picks ``n_split`` from the shapes
and the card's SM count alone (never from ``lengths``, which would make
the host wait on the stream), and :func:`paged_attention_split_reference`
is the plain model of that split arithmetic.

Shapes: ``q (S, H, D)``; pools ``k/v (H, P, page_size, D)``;
``page_table (S, max_pages) int32`` (entries past a slot's allocation
may hold any valid page id: they are masked by ``lengths``);
``lengths (S,) int32`` = valid KV positions per slot, INCLUDING the
current token (its k/v is written before attention).

The JAX package serves the jnp reference by default and graduates its
Pallas kernel behind ``DK_DECODE_KERNEL`` and a cached self-check.  The
port has no such switch: :func:`paged_attention_auto` launches the
kernel for CUDA tensors (it runs or raises) and takes
:func:`paged_attention_reference` only for CPU tensors.
``paged_decode_launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from dist_keras_tpu_torch.ops import _build
from dist_keras_tpu_torch.ops.attention import NEG_INF

HEAD_DIMS = (32, 64, 128)
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"dk_paged_decode": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                   _I, _I, _I, _I, _I, ctypes.c_float, _P]}
# positions per chunk, the unit the kernel splits a slot's extent by
# (CH in csrc/paged_decode.cu)
CHUNK = 32
MAX_SPLIT = 4096    # MAX_SPLIT in csrc/paged_decode.cu

paged_decode_launches = 0
_LOCK = threading.Lock()
_SM_COUNT = {}      # device index -> SM count
_SCRATCH = {}       # (device index, stream) -> (tickets, workspace)


def split_plan(slots, heads, max_pages, page_size, n_sm, chunk=CHUNK):
    """Splits per (slot, head) for the kernel, from shapes only: about
    two blocks per SM, ``ceil(2 * n_sm / (slots * heads))``, capped by
    the chunks in a slot's whole extent (``max_pages * page_size``), so
    that every split of a full slot gets at least one chunk."""
    n_chunks = -(-max_pages * page_size // chunk)
    want = -(-2 * n_sm // max(1, slots * heads))
    return max(1, min(want, n_chunks, MAX_SPLIT))


def sm_count(device):
    """The SM count of a CUDA device, read once per device."""
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    n = _SM_COUNT.get(idx)
    if n is None:
        n = _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


def split_ranges(length, n_split):
    """[start, stop) positions of each split of a slot holding ``length``
    positions: its chunks of CHUNK spread evenly over the splits, as the
    kernel spreads them (empty ranges where splits outnumber chunks)."""
    n_chunks = -(-length // CHUNK)
    return [(min(z * n_chunks // n_split * CHUNK, length),
             min((z + 1) * n_chunks // n_split * CHUNK, length))
            for z in range(n_split)]


def paged_attention_reference(q, k_pages, v_pages, page_table, lengths,
                              *, scale=None):
    """Plain version: gather each slot's pages into a contiguous
    ``(S, H, T, D)`` view (T = max_pages * page_size), mask positions
    past ``lengths``, softmax — with the dead-row guards, so a
    ``length == 0`` padding slot yields exact zeros, not NaN."""
    s, h, d = q.shape
    scale = (d ** -0.5) if scale is None else scale
    ps = k_pages.shape[2]
    pt = page_table.long()
    # (H, S, max_pages, ps, D) -> (S, H, T, D)
    t = pt.shape[1] * ps
    k = k_pages[:, pt].movedim(0, 1).reshape(s, h, t, d)
    v = v_pages[:, pt].movedim(0, 1).reshape(s, h, t, d)
    logits = torch.einsum("shd,shtd->sht", q, k).float() * scale
    kpos = torch.arange(t, device=q.device)
    mask = kpos[None, None, :] < lengths.to(q.device)[:, None, None]
    logits = logits.masked_fill(~mask, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - torch.where(m <= NEG_INF / 2, 0.0, m))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("sht,shtd->shd", p, v.float()) / l.clamp_min(1e-30)
    return out.to(q.dtype)


def paged_attention_split_reference(q, k_pages, v_pages, page_table,
                                    lengths, n_split, *, scale=None):
    """Plain model of the kernel's split arithmetic: each slot's valid
    positions cut by :func:`split_ranges`, one unnormalised softmax state
    (m, l, acc) per split (a split with no position: m = -1e30, l = 0,
    acc = 0), then merged in split order 0 .. n_split-1:
    ``sum e^(m_i - M) acc_i / max(sum e^(m_i - M) l_i, 1e-30)`` with
    M = max m_i, taken as 0 when every split is dead.  For tests: it
    reads ``lengths`` on the host."""
    s, h, d = q.shape
    scale = (d ** -0.5) if scale is None else scale
    ps = k_pages.shape[2]
    pt = page_table.long()
    t = pt.shape[1] * ps
    k = k_pages[:, pt].movedim(0, 1).reshape(s, h, t, d).float()
    v = v_pages[:, pt].movedim(0, 1).reshape(s, h, t, d).float()
    logits = torch.einsum("shd,shtd->sht", q.float(), k) * scale
    out = torch.zeros((s, h, d), dtype=torch.float32, device=q.device)
    for si, n in enumerate(lengths.clamp(0, t).tolist()):
        parts = []
        for lo, hi in split_ranges(n, n_split):
            if hi == lo:
                parts.append((torch.full((h,), NEG_INF, device=q.device),
                               torch.zeros(h, device=q.device),
                               torch.zeros((h, d), device=q.device)))
                continue
            x = logits[si, :, lo:hi]
            m = x.amax(dim=-1)
            p = torch.exp(x - m[:, None])
            parts.append((m, p.sum(dim=-1),
                          torch.einsum("ht,htd->hd", p, v[si, :, lo:hi])))
        big = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        big = torch.where(big <= NEG_INF / 2, 0.0, big)
        l_tot = torch.zeros(h, device=q.device)
        acc = torch.zeros((h, d), device=q.device)
        for m, l, a in parts:
            f = torch.exp(m - big)
            l_tot = l_tot + f * l
            acc = acc + f[:, None] * a
        out[si] = acc / l_tot.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


def _scratch(device, stream, n_tickets, n_work):
    """This stream's tickets (zeros; the kernel leaves them zero) and
    workspace, grown as needed: launches on two streams never share
    them, and launches on one stream run one after another."""
    key = (device.index, stream)
    with _LOCK:
        tickets, work = _SCRATCH.get(key, (None, None))
        if tickets is None or tickets.numel() < n_tickets:
            tickets = torch.zeros(n_tickets, dtype=torch.int32, device=device)
        if work is None or work.numel() < n_work:
            work = torch.empty(n_work, dtype=torch.float32, device=device)
        _SCRATCH[key] = (tickets, work)
    return tickets, work


def _check_inputs(q, k_pages, v_pages, page_table, lengths):
    dev = q.device
    tensors = (q, k_pages, v_pages, page_table, lengths)
    if not q.is_cuda or any(x.device != dev for x in tensors):
        raise ValueError("paged_decode: every input must lie on one CUDA "
                         f"device; got {[str(x.device) for x in tensors]}")
    if any(x.dtype != torch.float32 for x in (q, k_pages, v_pages)):
        raise ValueError(
            "paged_decode takes float32 q and pools; got "
            f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"paged_decode wants q (S,H,D) and pools (H,P,page_size,D); got "
            f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
            f"{tuple(v_pages.shape)}")
    s, h, d = q.shape
    if k_pages.shape[0] != h or k_pages.shape[3] != d:
        raise ValueError(
            f"paged_decode: pools {tuple(k_pages.shape)} do not match q "
            f"{tuple(q.shape)} in heads or head_dim")
    if d not in HEAD_DIMS:
        raise ValueError(
            f"paged_decode supports head_dim in {HEAD_DIMS}; got {d}")
    if page_table.dim() != 2 or page_table.shape[0] != s \
            or tuple(lengths.shape) != (s,):
        raise ValueError(
            f"paged_decode wants page_table (S,max_pages) and lengths (S,) "
            f"for S={s}; got {tuple(page_table.shape)}, "
            f"{tuple(lengths.shape)}")
    if k_pages[0].numel() >= 2 ** 31:
        raise ValueError("paged_decode: one head's pool must hold fewer "
                         "than 2**31 elements (the kernel's offsets are "
                         "32-bit)")
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"paged_decode: {name} must be contiguous and "
                             "16-byte aligned (the kernel loads float4)")


def paged_attention_kernel(q, k_pages, v_pages, page_table, lengths,
                           *, scale=None, n_split=None):
    """Launch the Hopper kernel on CUDA tensors (no fallback: it runs or
    raises). ``n_split`` forces the splits per (slot, head); None takes
    :func:`split_plan`'s. -> (S, H, D) float32."""
    global paged_decode_launches
    _check_inputs(q, k_pages, v_pages, page_table, lengths)
    s, h, d = q.shape
    _, n_pool, ps, _ = k_pages.shape
    max_pages = page_table.shape[1]
    if n_split is None:
        n_split = split_plan(s, h, max_pages, ps, sm_count(q.device))
    elif not 1 <= int(n_split) <= MAX_SPLIT:
        raise ValueError(f"paged_decode: n_split must lie in [1, "
                         f"{MAX_SPLIT}]; got {n_split}")
    n_split = int(n_split)
    scale = (d ** -0.5) if scale is None else float(scale)
    q = q.contiguous()
    if q.data_ptr() % 16:   # the kernel loads q as float4
        q = q.clone()
    pt = page_table.to(torch.int32).contiguous()
    ln = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if s == 0 or h == 0:
        return out
    lib = _build.load("paged_decode", _SIGNATURES)
    stream = _build.stream_handle(q.device)
    tickets = work = None
    if n_split > 1:
        tickets, work = _scratch(q.device, stream.value, s * h,
                                 s * h * n_split * (d + 2))
    code = lib.dk_paged_decode(
        d, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        pt.data_ptr(), ln.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(),
        None if tickets is None else tickets.data_ptr(), s, h, n_pool, ps,
        max_pages, n_split, scale, stream)
    _build.check(lib, code, "paged_decode")
    with _LOCK:
        paged_decode_launches += 1
    return out


def paged_attention_auto(q, k_pages, v_pages, page_table, lengths,
                         *, scale=None):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         lengths, scale=scale)
    return paged_attention_kernel(q, k_pages, v_pages, page_table, lengths,
                                  scale=scale)
