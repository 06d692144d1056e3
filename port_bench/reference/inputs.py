"""Inputs made from the seed: weights and data, on the device, in a few
large calls of one ``torch.Generator`` each.

The harness hands these to the program and the reference makes them
again from the same seed, so both sides start from the same numbers and
the reference takes nothing that the program made.  A CUDA generator and
a CPU generator draw different numbers for one seed; each side draws on
the device it runs on.
"""

from __future__ import annotations

import hashlib
import math

import torch


def sub_seed(seed, *tags):
    """A 63-bit seed for the stream ``tags`` of run ``seed`` (any whole
    number, also past 32 bits)."""
    text = "/".join(str(t) for t in (int(seed), *tags))
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def generator(device, seed, *tags):
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *tags))
    return g


def glorot_limit(shape):
    """The port's Glorot-uniform fan rule: a kernel of rank > 2 counts its
    leading dims as its receptive field."""
    if len(shape) == 2:
        fan_in, fan_out = shape
    else:
        receptive = math.prod(shape[:-2])
        fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    return math.sqrt(6.0 / (fan_in + fan_out))


def glorot_leaves(shapes, device, gen):
    """One ``torch.rand`` call for every kernel in ``shapes`` -> the
    kernels, each uniform in its own Glorot limit (f32, views of one
    buffer)."""
    sizes = [math.prod(s) for s in shapes]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = [], 0
    for shape, n in zip(shapes, sizes):
        out.append((u[at:at + n] * 2 - 1).mul_(glorot_limit(shape))
                   .reshape(shape))
        at += n
    return out


# -- ViT ---------------------------------------------------------------------

def vit_dims(cfg):
    """-> dict of the model's sizes from a configuration file's keys."""
    patch, px = cfg["patch_size"], cfg["image_size"]
    return {
        "input_dim": patch * patch * cfg["num_channels"],
        "seq_len": (px // patch) ** 2,
        "d": cfg["hidden_size"],
        "heads": cfg["num_attention_heads"],
        "layers": cfg["num_hidden_layers"],
        "ff": cfg["intermediate_size"],
        "classes": cfg["num_labels"],
    }


def vit_params(dims, seed, device):
    """The parameter tree in the port's layout (``proj``, ``pos``,
    ``blocks[i]`` with ``ln1``, ``wq/wk/wv`` (d, h, dh), ``wo`` (h, dh,
    d), ``ln2``, ``w1``, ``b1``, ``w2``, ``b2``; ``ln_f``; ``head``):
    kernels Glorot-uniform, ``pos`` 0.02 N(0, 1), LN scales 1, biases 0,
    as the port's own initialiser draws them."""
    d, h, ff = dims["d"], dims["heads"], dims["ff"]
    dh = d // h
    block_shapes = [(d, h, dh)] * 3 + [(h, dh, d), (d, ff), (ff, d)]
    shapes = [(dims["input_dim"], d)]
    shapes += block_shapes * dims["layers"]
    shapes += [(d, dims["classes"])]
    kernels = iter(glorot_leaves(shapes, device,
                                 generator(device, seed, "vit", "kernels")))
    pos = 0.02 * torch.randn((dims["seq_len"], d), device=device,
                             generator=generator(device, seed, "vit", "pos"))

    def ln():
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}

    proj = next(kernels)
    blocks = []
    for _ in range(dims["layers"]):
        wq, wk, wv, wo, w1, w2 = (next(kernels) for _ in range(6))
        blocks.append({"ln1": ln(), "wq": wq, "wk": wk, "wv": wv, "wo": wo,
                       "ln2": ln(), "w1": w1,
                       "b1": torch.zeros(ff, device=device), "w2": w2,
                       "b2": torch.zeros(d, device=device)})
    head = {"kernel": next(kernels),
            "bias": torch.zeros(dims["classes"], device=device)}
    return {"proj": proj, "pos": pos, "blocks": blocks, "ln_f": ln(),
            "head": head}


def vit_batch(dims, batch, seed, index, device):
    """Global batch ``index`` of a run: random patches x (batch, seq_len,
    input_dim) f32 and labels y (batch,) int64."""
    g = generator(device, seed, "vit", "batch", index)
    x = torch.randn((batch, dims["seq_len"], dims["input_dim"]),
                    device=device, generator=g)
    y = torch.randint(0, dims["classes"], (batch,), device=device,
                      generator=g)
    return x, y


# -- the MNIST CNN ---------------------------------------------------------

def cnn_shapes(cfg):
    """The Sequential's weights in the port's order: per layer with
    weights, (kernel shape, bias size)."""
    h, w, c = cfg["input_shape"]
    out = []
    for f in cfg["conv_filters"][:2]:
        out.append(((3, 3, c, f), f))
        c = f
    f = cfg["conv_filters"][2]
    out.append(((3, 3, c, f), f))
    flat = (h // 4) * (w // 4) * f
    out.append(((flat, cfg["dense_units"]), cfg["dense_units"]))
    out.append(((cfg["dense_units"], cfg["num_classes"]), cfg["num_classes"]))
    return out


def cnn_weights(cfg, seed, device):
    """-> [kernel, bias, kernel, bias, ...] in the port's
    ``Sequential.get_weights`` order: kernels Glorot-uniform, biases 0."""
    shapes = cnn_shapes(cfg)
    kernels = glorot_leaves([k for k, _ in shapes], device,
                            generator(device, seed, "cnn", "kernels"))
    out = []
    for kernel, (_, n) in zip(kernels, shapes):
        out += [kernel, torch.zeros(n, device=device)]
    return out


def cnn_rows(cfg, rows, seed, device):
    """The epoch's rows: x (rows, h, w, c) N(0, 1) f32 and integer labels
    (rows,)."""
    g = generator(device, seed, "cnn", "rows")
    x = torch.randn((rows, *cfg["input_shape"]), device=device, generator=g)
    y = torch.randint(0, cfg["num_classes"], (rows,), device=device,
                      generator=g)
    return x, y


def dropout_seed(seed):
    """The seed that a run of ``seed`` gives the trainer's dropout
    generator."""
    return sub_seed(seed, "cnn", "dropout")


def dropout_masks(rate, shape, steps, seed, device):
    """The keep masks (bool, ``steps`` x ``shape``) that the trainer of a
    run of ``seed`` draws, or None at rate 0.  The port's rule: a
    ``torch.Generator`` on the device seeded with :func:`dropout_seed`,
    made anew in each ``train`` call; one draw a global step of every
    worker's mask together (``shape`` is (workers, batch, units)), uint8
    bits kept where under ``(1 - rate) * 256``, for a rate that 8 bits
    express."""
    if rate <= 0:
        return None
    thresh = (1.0 - rate) * 256
    if thresh != int(thresh):
        raise ValueError(f"dropout rate {rate}: not a multiple of 1/256")
    g = torch.Generator(device=device)
    g.manual_seed(dropout_seed(seed))
    return [torch.randint(0, 256, shape, generator=g, dtype=torch.uint8,
                          device=device) < int(thresh)
            for _ in range(steps)]
