"""The causal transformer — counterpart of ``models/transformer.py``.

Same parameter tree and layouts as the JAX package, so weights bridge
one to one (``utils/bridge.py``): flat ``proj`` (input_dim, d) and
``pos`` (seq_len, d); ``blocks[i]`` with ``ln1``/``ln2`` (scale, bias),
``wq/wk/wv`` (d, h, dh), ``wo`` (h, dh, d), ``w1`` (d, ff), ``b1``,
``w2`` (ff, d), ``b2``; ``ln_f``; ``head`` (kernel (d, n_classes),
bias).  Pre-LN residual blocks; mean-pool + linear head.

Two details must match the reference exactly: ``jax.nn.gelu`` defaults
to the tanh approximation, and ``layer_norm`` divides by the population
variance (eps 1e-5).  MoE blocks are not ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from dist_keras_tpu_torch.ops.flash_attention import attention_auto
from dist_keras_tpu_torch.utils.bridge import params_from_jax
from dist_keras_tpu_torch.utils.device import resolve_device


def transformer_config(input_dim, seq_len, d_model=64, n_heads=4,
                       n_layers=2, d_ff=None, n_classes=2):
    return {
        "input_dim": int(input_dim),
        "seq_len": int(seq_len),
        "d_model": int(d_model),
        "n_heads": int(n_heads),
        "n_layers": int(n_layers),
        "d_ff": int(d_ff if d_ff is not None else 4 * d_model),
        "n_classes": int(n_classes),
    }


def _glorot_uniform(gen, shape):
    """Glorot-uniform with the JAX package's fan rule (leading dims of a
    rank > 2 kernel count as its receptive field)."""
    if len(shape) == 2:
        fan_in, fan_out = shape
    else:
        receptive = math.prod(shape[:-2])
        fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=gen) * 2 - 1) * limit


def init_transformer_params(gen, cfg):
    """-> params tree (CPU tensors) drawn from the ``torch.Generator``
    ``gen``.  The layout is the reference's; the numbers are not (the
    parity tests bridge the reference's weights instead)."""
    d, h = cfg["d_model"], cfg["n_heads"]
    dh, ff = d // h, cfg["d_ff"]

    def ln():
        return {"scale": torch.ones(d), "bias": torch.zeros(d)}

    return {
        "proj": _glorot_uniform(gen, (cfg["input_dim"], d)),
        "pos": 0.02 * torch.randn((cfg["seq_len"], d), generator=gen),
        "blocks": [{
            "ln1": ln(),
            "wq": _glorot_uniform(gen, (d, h, dh)),
            "wk": _glorot_uniform(gen, (d, h, dh)),
            "wv": _glorot_uniform(gen, (d, h, dh)),
            "wo": _glorot_uniform(gen, (h, dh, d)),
            "ln2": ln(),
            "w1": _glorot_uniform(gen, (d, ff)),
            "b1": torch.zeros(ff),
            "w2": _glorot_uniform(gen, (ff, d)),
            "b2": torch.zeros(d),
        } for _ in range(cfg["n_layers"])],
        "ln_f": ln(),
        "head": {"kernel": _glorot_uniform(gen, (d, cfg["n_classes"])),
                 "bias": torch.zeros(cfg["n_classes"])},
    }


def layer_norm(p, x, eps=1e-5):
    """Pre-LN normalisation with the POPULATION variance, as
    ``jnp.var`` computes it."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def attention_half(blk, h, attn_fn, causal):
    """The block's pre-LN attention residual (the attention half of
    ``_tp_block``). h: (B, T, d)."""
    y = layer_norm(blk["ln1"], h)
    q = torch.einsum("btd,dhk->bthk", y, blk["wq"])
    k = torch.einsum("btd,dhk->bthk", y, blk["wk"])
    v = torch.einsum("btd,dhk->bthk", y, blk["wv"])
    a = attn_fn(q, k, v, causal=causal)
    return h + torch.einsum("bthk,hkd->btd", a, blk["wo"])


def mlp_half(blk, h):
    """The block's pre-LN FFN residual (``_mlp_half``). h: (..., d)."""
    y = layer_norm(blk["ln2"], h)
    u = gelu(y @ blk["w1"] + blk["b1"])
    return h + u @ blk["w2"] + blk["b2"]


def apply_block(blk, h, attn_fn, causal):
    """One pre-LN attention + FFN residual block. h: (B, T, d)."""
    return mlp_half(blk, attention_half(blk, h, attn_fn, causal))


def transformer_apply(params, x, cfg, *, causal=False, attn_fn=None):
    """Forward pass. x: (B, T, input_dim) -> logits (B, n_classes).

    ``attn_fn`` defaults to ``attention_auto`` (the Hopper kernel for
    CUDA tensors, plain attention on the CPU); pass ``ops.attention.
    attention`` to force the plain version."""
    attn_fn = attention_auto if attn_fn is None else attn_fn
    h = x @ params["proj"] + params["pos"][None, :x.shape[1]]
    for blk in params["blocks"]:
        h = apply_block(blk, h, attn_fn, causal)
    pooled = layer_norm(params["ln_f"], h).mean(dim=1)
    return pooled @ params["head"]["kernel"] + params["head"]["bias"]


def _populate(mod, tree):
    """Register ``tree``'s leaves on ``mod`` under their paths joined by
    dots (``blocks.0.wq``), so ``named_parameters`` lists the reference
    pytree's leaves one to one."""
    for key, val in tree.items():
        if isinstance(val, list):
            mod.add_module(key, nn.ModuleList(
                _populate(nn.Module(), t) for t in val))
        elif isinstance(val, dict):
            mod.add_module(key, _populate(nn.Module(), val))
        else:
            mod.register_parameter(key, nn.Parameter(val))
    return mod


def _tree_from_module(mod):
    if isinstance(mod, nn.ModuleList):
        return [_tree_from_module(m) for m in mod]
    tree = dict(mod.named_parameters(recurse=False))
    tree.update((k, _tree_from_module(m)) for k, m in mod.named_children())
    return tree


class Transformer(nn.Module):
    """The model as an ``nn.Module``: ``cfg`` plus parameters laid out
    as the reference's pytree (``params`` returns that nested dict of
    the live ``nn.Parameter``s).

    ``params`` (a reference-layout tree of numpy arrays or tensors)
    loads given weights; otherwise they are drawn from ``seed``.
    """

    def __init__(self, cfg=None, seed=0, device=None, params=None,
                 **cfg_kw):
        super().__init__()
        self.cfg = cfg or transformer_config(**cfg_kw)
        dev = resolve_device(device)
        if params is None:
            gen = torch.Generator().manual_seed(int(seed))
            tree = init_transformer_params(gen, self.cfg)
        else:
            tree = params_from_jax(params, "cpu")
        _populate(self, tree)
        self.to(dev)

    @property
    def params(self):
        return _tree_from_module(self)

    def forward(self, x, causal=False):
        return transformer_apply(self.params, x, self.cfg, causal=causal)
