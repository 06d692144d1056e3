"""The arithmetic of the plain reference's products, in two precisions.

- :data:`F32`: float32 products with TF32 off (``allow_tf32`` False for
  matmul and cuDNN while the reference runs: :func:`strict_f32`).
- :data:`FP8`: the control.  Each product's operands are rounded to
  float8 with one scale per tensor, as an fp8 training recipe does: the
  forward's inputs and weights to e4m3 (largest 448), the gradient that
  flows back into the product to e5m2 (largest 57344); the products
  themselves and everything between them stay float32.  It is the step
  below the configurations' bfloat16 compute, and ``correct`` has to
  come out false on it.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


@contextlib.contextmanager
def strict_f32():
    """float32 products without TF32, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8_round(x, dtype, largest):
    """``x`` rounded to float8 ``dtype`` under one scale that maps its
    largest magnitude to ``largest``, back in x's dtype."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = largest / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


def _e4m3(x):
    return fp8_round(x, torch.float8_e4m3fn, E4M3_MAX)


def _e5m2(x):
    return fp8_round(x, torch.float8_e5m2, E5M2_MAX)


class _MatmulFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _e4m3(a), _e4m3(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _e5m2(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class _ConvFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, padding):
        qx, qw = _e4m3(x), _e4m3(w)
        ctx.save_for_backward(qx, qw)
        ctx.padding = padding
        return F.conv2d(qx, qw, padding=padding)

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        qg = _e5m2(g)
        gx = torch.nn.grad.conv2d_input(qx.shape, qw, qg,
                                        padding=ctx.padding)
        gw = torch.nn.grad.conv2d_weight(qx, qw.shape, qg,
                                         padding=ctx.padding)
        return gx, gw, None


class _F32:
    name = "float32"

    @staticmethod
    def mm(a, b):
        """a (..., k) @ b (k, n), or two batched operands of one rank."""
        return a @ b

    @staticmethod
    def conv(x, w, padding):
        return F.conv2d(x, w, padding=padding)


class _FP8:
    name = "fp8"

    @staticmethod
    def mm(a, b):
        if b.dim() == 2 and a.dim() > 2:
            lead = a.shape[:-1]
            return _MatmulFP8.apply(a.reshape(-1, a.shape[-1]),
                                    b).reshape(*lead, b.shape[-1])
        return _MatmulFP8.apply(a, b)

    @staticmethod
    def conv(x, w, padding):
        return _ConvFP8.apply(x, w, padding)


F32, FP8 = _F32(), _FP8()
PRECISIONS = {"float32": F32, "fp8": FP8}
