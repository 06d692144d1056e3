"""One-pass flash backward (K4): the Hopper kernel, its plain version,
and the ``DK_FUSED_BWD`` selfcheck / graduation machinery.

Counterpart of ``ops/pallas/fused_bwd_experimental.py``.  The TPU kernel
accumulates dQ across kv blocks through an aliased output whose
revisits Mosaic does not define, so the JAX package serves it only for
a configuration whose cached parity run against the two-kernel
backward came back exact.  The port's kernel (``csrc/fused_bwd.cu``; in
bf16 the tensor-core block of ``csrc/flash_bwd_bf16.cuh``) hands each q
tile's f32 dQ partial from one kv tile to the next in a fixed order
instead, continuing K2's chain, so in both dtypes its dq is K2's and its
dk/dv K3's bit for bit (see the source headers).  The JAX contract is
kept all the same: exact (tol 1e-6) or reject; here it holds by
construction.

- :func:`fused_bwd` — launches K4 on CUDA tensors (runs or raises);
  counts ``fused_bwd_launches``.
- :func:`fused_bwd_reference` — its plain version: one pass over 64-key
  kv tiles in plain torch, adding each tile's dq part in tile order.
- :class:`SelfCheckVerdict`, :func:`selfcheck`, :func:`graduate`,
  :func:`clear_verdicts`, :func:`compiler_fingerprint` — as in the JAX
  module: one cached verdict per (shape, dtype, causal, device,
  fingerprint), nonzero offsets never graduate, and one
  ``fused_bwd_rejected`` event per cached non-exact verdict.  On the
  CPU (``device="cpu"``) the parity run compares the two plain
  versions, the counterpart of the JAX module's ``interpret=True``.

The TPU block sizes and ``interpret`` have no meaning here and are not
taken.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from dist_keras_tpu_torch.observability import events
from dist_keras_tpu_torch.ops import _build
from dist_keras_tpu_torch.ops import flash_attention as fa
from dist_keras_tpu_torch.ops.attention import NEG_INF

KV_TILE = 64   # keys per kv tile, as the kernel's
Q_TILE = 32    # rows per q tile, as the kernel's (one dq counter each)
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"dk_flash_bwd_fused": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _P, _P, _P, _I, _I, _I, _I,
                                      ctypes.c_float, _I, _I, _I, _P]}

fused_bwd_launches = 0
_COUNT_LOCK = threading.Lock()


def fused_bwd(q, k, v, do, lse, dl, causal, scale, q_offset, kv_offset):
    """Launch K4 on CUDA tensors (runs or raises) -> (dq, dk, dv) in the
    inputs' dtype.  q/do (B,Tq,H,D), k/v (B,Tk,H,D); lse and dl (=
    g_lse - rowsum(dO*O)) are (B,H,Tq) float32."""
    global fused_bwd_launches
    q, k, v, do, lse, dl = fa._bwd_inputs("fused_bwd", q, k, v, do, lse, dl)
    b, tq, h, d = q.shape
    dq = torch.zeros_like(q)     # q tiles no kv tile sees stay 0
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq, dk, dv
    dq_acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    counts = torch.zeros(b * h * -(-tq // Q_TILE), dtype=torch.int32,
                         device=q.device)
    lib = _build.load("fused_bwd", _SIGNATURES)
    code = lib.dk_flash_bwd_fused(
        fa._DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(), dl.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dq_acc.data_ptr(),
        counts.data_ptr(), *fa._bwd_scalars(q, k, scale, causal, q_offset,
                                            kv_offset))
    _build.check(lib, code, "fused_bwd")
    with _COUNT_LOCK:
        fused_bwd_launches += 1
    return dq, dk, dv


def fused_bwd_reference(q, k, v, do, lse, dl, causal=False, scale=None,
                        q_offset=0, kv_offset=0):
    """Plain version of K4: one pass over 64-key kv tiles.  Each tile's
    P and dS are recomputed from lse (masked logits -> -1e30, a dead row
    shifts by 0), dK and dV of its keys are formed whole, and its part of
    dQ is added to an f32 sum in tile order; scale multiplies that sum
    once.  The casts are the kernels': P rounded to dO's dtype before
    P^T dO, dS to the input dtype before dS K and dS^T Q.
    -> (dq, dk, dv) in q's, k's and v's dtypes."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    qf, dof = q.float(), do.float()
    safe_lse = torch.where(lse <= NEG_INF / 2, 0.0, lse)[..., None]
    qpos = q_offset + torch.arange(q.shape[1], device=q.device)
    dq = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for s0 in range(0, k.shape[1], KV_TILE):
        kt = k[:, s0:s0 + KV_TILE].float()
        vt = v[:, s0:s0 + KV_TILE].float()
        logits = torch.einsum("bthd,bshd->bhts", qf, kt) * scale
        if causal:
            kpos = kv_offset + torch.arange(s0, s0 + kt.shape[1],
                                            device=q.device)
            logits = logits.masked_fill(qpos[:, None] < kpos[None, :],
                                        NEG_INF)
        p = torch.exp(logits - safe_lse)
        ds = p * (torch.einsum("bthd,bshd->bhts", dof, vt) + dl[..., None])
        dvs.append(torch.einsum("bhts,bthd->bshd", p.to(do.dtype).float(),
                                dof))
        dks.append(scale * torch.einsum("bhts,bthd->bshd",
                                        ds.to(q.dtype).float(), qf))
        dq += torch.einsum("bhts,bshd->bthd", ds.to(k.dtype).float(), kt)
    empty = torch.zeros((k.shape[0], 0, *k.shape[2:]), device=q.device)
    dk = torch.cat(dks, 1) if dks else empty
    dv = torch.cat(dvs, 1) if dvs else empty
    return (scale * dq).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class SelfCheckVerdict(tuple):
    """Typed selfcheck outcome.  Unpacks as the ``(ok, err)`` pair; carries
    ``status`` / ``reason`` for the graduation layer:

    - ``"exact"``        — parity ran and matched within tolerance; the
      fused kernel may serve THIS configuration on THIS build.
    - ``"mismatch"``     — parity ran and diverged (``err`` has the
      measured relative error): the two-kernel backward serves.
    - ``"unverifiable"`` — parity could NOT run (no CUDA device where one
      was asked for, or offsets outside the parity surface); ``err`` is
      None and the two-kernel backward serves.
    """

    def __new__(cls, ok, err, status, reason=""):
        self = super().__new__(cls, (bool(ok), err))
        self.status = status
        self.reason = reason
        return self

    @property
    def ok(self):
        return self[0]

    @property
    def err(self):
        return self[1]


_FINGERPRINTS = {}


def compiler_fingerprint(device="cuda"):
    """A token that changes whenever what decides the fused kernel's
    arithmetic could have changed — the cache axis of the graduation
    verdicts: torch's and CUDA's versions, the card's name and compute
    capability, and the digest of the K4 library's sources and flags."""
    dev = torch.device(device)
    fp = _FINGERPRINTS.get(dev)
    if fp is None:
        parts = [torch.__version__, str(torch.version.cuda)]
        if dev.type == "cuda" and torch.cuda.is_available():
            parts += [torch.cuda.get_device_name(dev),
                      "sm_%d%d" % torch.cuda.get_device_capability(dev)]
        parts.append(_build.library_path("fused_bwd").name)
        fp = _FINGERPRINTS[dev] = "|".join(parts)
    return fp


def _backwards(q, k, v, do, causal, scale):
    """(two-kernel backward, fused backward) on one device: the kernels
    on CUDA, their plain versions on the CPU."""
    cuda = q.device.type == "cuda"
    out, lse = (fa.flash_fwd(q, k, v, causal, scale, 0, 0) if cuda else
                fa.flash_attention_reference(q, k, v, causal=causal,
                                             scale=scale))
    dl = -(do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, dl, causal, scale, 0, 0)
    if cuda:
        ref = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
        return ref, fused_bwd(*args)
    return fa.flash_bwd_reference(*args), fused_bwd_reference(*args)


def selfcheck(bh=2, t=2048, d=128, causal=True, dtype=torch.bfloat16,
              seed=0, tol=1e-6, t_kv=None, device="cuda"):
    """-> :class:`SelfCheckVerdict` (unpacks as ``(ok, max_rel_err)``):
    compare the fused backward against the two-kernel backward on random
    inputs at the given shape (``bh`` rows of one head each), with the
    JAX module's inputs and measure.

    On ``cuda`` it runs K1, then K2 + K3 and K4; without a CUDA device
    the verdict is a typed ``"unverifiable"`` instead of a crash.  With
    ``device="cpu"`` it runs the plain versions, which exercises the
    machinery off the card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        return SelfCheckVerdict(
            False, None, "unverifiable",
            f"device {device!r}: no CUDA device is available to run the "
            "fused kernel — the two-kernel backward stays in effect")
    t_kv = t if t_kv is None else t_kv
    rng = np.random.default_rng(seed)
    mk = lambda tt: (torch.from_numpy(  # noqa: E731
        rng.normal(size=(bh, tt, d))).to(dtype) * 0.3).reshape(
            bh, tt, 1, d).to(dev)
    # draw order q, k, v, do, as the JAX module's
    q, k, v, do = mk(t), mk(t_kv), mk(t_kv), mk(t)
    ref, got = _backwards(q, k, v, do, causal, d ** -0.5)
    err = 0.0
    for a, b in zip(ref, got):
        a, b = a.float(), b.float()
        err = max(err, float((a - b).abs().max() / (a.abs().max() + 1e-9)))
    if err <= tol:
        return SelfCheckVerdict(True, err, "exact")
    return SelfCheckVerdict(
        False, err, "mismatch",
        f"fused backward diverged from the two-kernel backward "
        f"(rel err {err:.3g} > tol {tol:g})")


# -- graduation (DK_FUSED_BWD) ------------------------------------------
# One verdict per (shape, dtype, causal, device, fingerprint) per
# process: the parity run executes ONCE, at the first backward of that
# configuration, and every later backward reuses the cached verdict.
# `fused_bwd_rejected` is emitted exactly when a non-exact verdict is
# first cached.
_VERDICTS = {}


def clear_verdicts():
    """Drop the cached graduation verdicts (tests / a rebuilt kernel)."""
    _VERDICTS.clear()
    _FINGERPRINTS.clear()


def graduate(bh, tq, tk, d, dtype, causal, q_offset=0, kv_offset=0,
             device="cuda"):
    """-> the cached :class:`SelfCheckVerdict` deciding whether the fused
    backward may serve this exact configuration.

    Only ``status == "exact"`` graduates.  Nonzero offsets (the ring-
    attention path) never graduate: the parity run covers offset-0
    masking only, and an unverified configuration must not serve."""
    dev = torch.device(device)
    if q_offset or kv_offset:
        key = ("offsets", dev.type)
        v = _VERDICTS.get(key)
        if v is None:
            v = _VERDICTS[key] = SelfCheckVerdict(
                False, None, "unverifiable",
                "nonzero q/kv offsets (ring attention) are outside the "
                "selfcheck parity surface")
            events.emit("fused_bwd_rejected", reason=v.status,
                        detail=v.reason, shape=[bh, tq, tk, d])
        return v
    key = (bh, tq, tk, d, str(dtype), bool(causal), dev.type,
           compiler_fingerprint(dev))
    v = _VERDICTS.get(key)
    if v is None:
        v = _VERDICTS[key] = selfcheck(bh=bh, t=tq, t_kv=tk, d=d,
                                       causal=causal, dtype=dtype,
                                       device=dev)
        if v.status != "exact":
            events.emit("fused_bwd_rejected", reason=v.status,
                        detail=v.reason, err=v.err, shape=[bh, tq, tk, d])
    return v
