"""Operations and bytes from shapes, and the card's peaks: the yardstick
of the benchmark's utilization and roofline metrics.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit): 989 TFLOP/s
of bf16 on the tensor cores; 3.35 TB/s of HBM3.  A card set below 700 W
reaches less; the harness prints its ``power.limit`` beside the numbers.

FLOPs count 2 a multiply-add.  Training is three forwards (the backward
is two), as PaLM's MFU counts it; recomputed work is not
counted, and the same work is counted whatever implements it.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16, F32_BYTES = 2, 4


def vit_forward_flops(dims):
    """One sample's forward: the patch projection, per layer the q/k/v/o
    products, the MLP and attention's two T x T products (4 T^2 d), and
    the head.  LayerNorm, GELU, softmax and the pooling are not counted."""
    t, d, ff = dims["seq_len"], dims["d"], dims["ff"]
    layer = 8 * t * d * d + 4 * t * d * ff + 4 * t * t * d
    return (2 * t * dims["input_dim"] * d + dims["layers"] * layer
            + 2 * d * dims["classes"])


def vit_train_flops(dims):
    return 3 * vit_forward_flops(dims)


def cnn_forward_macs(config):
    """Multiply-adds of one sample's forward through the MNIST CNN ('same'
    3x3 convs, 2x2 pools): chip_smoke.py's ``mnist_cnn_flops_per_sample``
    rule, from the configuration's sizes."""
    h, w, c = config["input_shape"]
    f1, f2, f3 = config["conv_filters"]
    macs = h * w * f1 * 9 * c + h * w * f2 * 9 * f1
    macs += (h // 2) * (w // 2) * f3 * 9 * f2
    flat = (h // 4) * (w // 4) * f3
    macs += flat * config["dense_units"]
    macs += config["dense_units"] * config["num_classes"]
    return macs


def cnn_train_flops(config):
    return 6 * cnn_forward_macs(config)


# -- the attention kernels: one launch's least time --------------------------

def attention_launch(kind, b, t, h, d, elem=BF16):
    """-> (flops, bytes) one non-causal launch needs at q, k, v (b, t, h,
    d) in ``elem``-byte elements.  Each input read once, each output
    written once; the per-row f32 statistics (lse, and the backward's
    ``dl``) are counted.

    - ``fwd`` (K1): S = QK^T and O = PV: 4 b h t^2 d; reads q, k, v,
      writes o and lse.
    - ``bwd_dq`` (K2): S, dP = dO V^T, dQ = dS K: 6 b h t^2 d; reads q,
      k, v, dO, lse, dl, writes dq.
    - ``bwd_dkv`` (K3): S, dP, dV = P^T dO, dK = dS^T Q: 8 b h t^2 d;
      reads q, k, v, dO, lse, dl, writes dk and dv.
    - ``bwd_fused`` (K4): S, dP, dV, dK and dQ: 10 b h t^2 d; reads as
      K2, writes dq, dk and dv."""
    qkv = b * t * h * d * elem
    row = b * h * t * F32_BYTES
    if kind == "fwd":
        return 4 * b * h * t * t * d, 3 * qkv + qkv + row
    if kind == "bwd_dq":
        return 6 * b * h * t * t * d, 4 * qkv + 2 * row + qkv
    if kind == "bwd_dkv":
        return 8 * b * h * t * t * d, 4 * qkv + 2 * row + 2 * qkv
    if kind == "bwd_fused":   # K4: K2 and K3 in one pass
        return 10 * b * h * t * t * d, 4 * qkv + 2 * row + 3 * qkv
    raise ValueError(f"unknown attention launch {kind!r}")


def bound_s(flops, nbytes):
    """The least time for ``flops`` bf16 operations moving ``nbytes``."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
