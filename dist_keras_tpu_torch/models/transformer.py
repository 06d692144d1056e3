"""The causal transformer — counterpart of ``models/transformer.py``.

Same parameter tree and layouts as the JAX package, so weights bridge
one to one (``utils/bridge.py``): flat ``proj`` (input_dim, d) and
``pos`` (seq_len, d); ``blocks[i]`` with ``ln1``/``ln2`` (scale, bias),
``wq/wk/wv`` (d, h, dh), ``wo`` (h, dh, d), ``w1`` (d, ff), ``b1``,
``w2`` (ff, d), ``b2``; ``ln_f``; ``head`` (kernel (d, n_classes),
bias).  Pre-LN residual blocks; mean-pool + linear head.

``moe_experts > 0`` puts a Switch-MoE FFN (``blk["moe"]``: ``router``
(d, E), ``w1`` (E, d, ff), ``b1`` (E, ff), ``w2`` (E, ff, d), ``b2``
(E, d); ``parallel/moe.py``) in place of ``w1/b1/w2/b2`` in every
block.  Such a config trains through :func:`transformer_apply_with_aux`
(``parallel.make_moe_train_step``), so the router's load-balancing loss
reaches the objective; :func:`transformer_apply` refuses it, and the
:class:`Transformer` module's forward drops the aux for inference.

Two details must match the reference exactly: ``jax.nn.gelu`` defaults
to the tanh approximation, and ``layer_norm`` divides by the population
variance (eps 1e-5).
"""

from __future__ import annotations

import functools
import json
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dist_keras_tpu_torch.ops.flash_attention import attention_auto
from dist_keras_tpu_torch.utils.bridge import params_from_jax
from dist_keras_tpu_torch.utils.device import resolve_device


def transformer_config(input_dim, seq_len, d_model=64, n_heads=4,
                       n_layers=2, d_ff=None, n_classes=2,
                       moe_experts=0, moe_capacity_factor=1.25):
    """The reference's config dict; ``moe_experts > 0`` makes every
    block's FFN a Switch-MoE of that many experts."""
    return {
        "input_dim": int(input_dim),
        "seq_len": int(seq_len),
        "d_model": int(d_model),
        "n_heads": int(n_heads),
        "n_layers": int(n_layers),
        "d_ff": int(d_ff if d_ff is not None else 4 * d_model),
        "n_classes": int(n_classes),
        "moe_experts": int(moe_experts),
        "moe_capacity_factor": float(moe_capacity_factor),
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
    moe = cfg.get("moe_experts", 0)

    def ln():
        return {"scale": torch.ones(d), "bias": torch.zeros(d)}

    def block():
        blk = {
            "ln1": ln(),
            "wq": _glorot_uniform(gen, (d, h, dh)),
            "wk": _glorot_uniform(gen, (d, h, dh)),
            "wv": _glorot_uniform(gen, (d, h, dh)),
            "wo": _glorot_uniform(gen, (h, dh, d)),
            "ln2": ln(),
        }
        if moe:
            from dist_keras_tpu_torch.parallel.moe import init_moe_params

            blk["moe"] = init_moe_params(gen, d, ff, moe)
        else:
            blk.update({
                "w1": _glorot_uniform(gen, (d, ff)),
                "b1": torch.zeros(ff),
                "w2": _glorot_uniform(gen, (ff, d)),
                "b2": torch.zeros(d),
            })
        return blk

    return {
        "proj": _glorot_uniform(gen, (cfg["input_dim"], d)),
        "pos": 0.02 * torch.randn((cfg["seq_len"], d), generator=gen),
        "blocks": [block() for _ in range(cfg["n_layers"])],
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


def _megatron(model):
    """-> (f, g) over the ``model`` axis (a ``parallel.mesh.RankAxis``):
    Megatron's pair, ``parallel/collectives.py`` ``copy_to`` (identity
    forward, the sum of the ranks' cotangents backward) and
    ``sum_across`` (the sum forward, identity backward); both the
    identity without an axis, so the parallel package is imported only
    by a step that splits the heads."""
    if model is None:
        return _identity, _identity
    from dist_keras_tpu_torch.parallel.collectives import copy_to, sum_across

    return (functools.partial(copy_to, axis=model),
            functools.partial(sum_across, axis=model))


def _identity(x):
    return x


def attention_half(blk, h, attn_fn, causal, model=None):
    """The block's pre-LN attention residual (the attention half of
    ``_tp_block``). h: (B, T, d).  Under a ``model`` axis ``blk`` holds
    this rank's heads: the normalised input enters the column-split
    products through *f* and the ``wo`` product leaves through *g*
    (:func:`_megatron`)."""
    f, g = _megatron(model)
    y = f(layer_norm(blk["ln1"], h))
    q = torch.einsum("btd,dhk->bthk", y, blk["wq"])
    k = torch.einsum("btd,dhk->bthk", y, blk["wk"])
    v = torch.einsum("btd,dhk->bthk", y, blk["wv"])
    a = attn_fn(q, k, v, causal=causal)
    return h + g(torch.einsum("bthk,hkd->btd", a, blk["wo"]))


def mlp_half(blk, h, model=None):
    """The block's pre-LN FFN residual (``_mlp_half``). h: (..., d).
    Under a ``model`` axis ``blk`` holds this rank's columns of ``w1`` /
    ``b1`` and rows of ``w2``: *f* before ``w1``, *g* after ``w2``."""
    f, g = _megatron(model)
    y = f(layer_norm(blk["ln2"], h))
    u = gelu(y @ blk["w1"] + blk["b1"])
    return h + g(u @ blk["w2"]) + blk["b2"]


def apply_block_aux(blk, h, attn_fn, causal, capacity_factor=1.25,
                    moe_fn=None):
    """One pre-LN attention + FFN residual block -> (h, aux): the one
    block definition of the forward, the MoE step and the
    expert-parallel step.  Dense blocks give aux = 0; MoE blocks
    (``"moe"`` in ``blk``) the Switch router's load-balancing loss.
    ``moe_fn(moe_params, tokens_2d) -> (out_2d, aux)`` is injectable
    (the expert-parallel step passes ``switch_moe_ep``); the default is
    ``switch_moe_dense`` at ``capacity_factor``."""
    h = attention_half(blk, h, attn_fn, causal)
    if "moe" not in blk:
        return mlp_half(blk, h), h.new_zeros((), dtype=torch.float32)
    if moe_fn is None:
        from dist_keras_tpu_torch.parallel.moe import switch_moe_dense

        moe_fn = functools.partial(switch_moe_dense,
                                   capacity_factor=capacity_factor)
    y = layer_norm(blk["ln2"], h)
    b, t, d = y.shape
    u, aux = moe_fn(blk["moe"], y.reshape(b * t, d))
    return h + u.reshape(b, t, d), aux


def apply_block(blk, h, attn_fn, causal):
    """One pre-LN attention + FFN residual block (aux dropped: MoE
    blocks train through :func:`apply_block_aux`). h: (B, T, d)."""
    return apply_block_aux(blk, h, attn_fn, causal)[0]


def transformer_apply_with_aux(params, x, cfg, *, causal=False,
                               attn_fn=None, remat=False):
    """Forward -> (logits (B, n_classes), the summed aux loss, f32): the
    path of MoE configs; for dense ones the logits are
    :func:`transformer_apply`'s and aux is 0.  ``remat=True``
    checkpoints each block (recomputed in the backward)."""
    attn_fn = attention_auto if attn_fn is None else attn_fn
    block = functools.partial(
        apply_block_aux, attn_fn=attn_fn, causal=causal,
        capacity_factor=cfg.get("moe_capacity_factor", 1.25))
    h = x @ params["proj"] + params["pos"][None, :x.shape[1]]
    aux = h.new_zeros((), dtype=torch.float32)
    for blk in params["blocks"]:
        if remat:
            h, a = checkpoint(block, blk, h, use_reentrant=False)
        else:
            h, a = block(blk, h)
        aux = aux + a
    pooled = layer_norm(params["ln_f"], h).mean(dim=1)
    logits = pooled @ params["head"]["kernel"] + params["head"]["bias"]
    return logits, aux


def transformer_apply(params, x, cfg, *, causal=False, attn_fn=None,
                      remat=False):
    """Forward pass. x: (B, T, input_dim) -> logits (B, n_classes).

    ``attn_fn`` defaults to ``attention_auto`` (the Hopper kernel for
    CUDA tensors, plain attention on the CPU); pass ``ops.attention.
    attention`` to force the plain version.  MoE configs raise: their
    router loss must reach the objective (:func:`transformer_apply_with_
    aux`)."""
    if cfg.get("moe_experts", 0):
        raise ValueError(
            "MoE transformer configs must use transformer_apply_with_aux "
            "(or make_moe_train_step) so the router's load-balancing "
            "loss reaches the objective; for pure inference the "
            "Transformer module's forward discards aux for you")
    return transformer_apply_with_aux(params, x, cfg, causal=causal,
                                      attn_fn=attn_fn, remat=remat)[0]


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


def _sorted_paths(tree, prefix=()):
    """The leaf paths of a params tree in the JAX package's leaf order
    (``jax.tree.leaves``: dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [prefix]
    return [p for k, v in items for p in _sorted_paths(v, prefix + (k,))]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class Transformer(nn.Module):
    """The model as an ``nn.Module``: ``cfg`` plus parameters laid out
    as the reference's pytree (``params`` returns that nested dict of
    the live ``nn.Parameter``s).

    ``params`` (a reference-layout tree of numpy arrays or tensors)
    loads given weights; otherwise they are drawn from ``seed``.  The
    weights round-trip as the reference's: :meth:`get_weights` /
    :meth:`set_weights` in ``jax.tree.leaves`` order, :meth:`to_json`
    ``{"class_name": "Transformer", "config": cfg}``
    (``utils.serialization.deserialize_model`` builds it back).
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
        """Logits; a MoE config's router aux loss is dropped (inference:
        train it through ``parallel.make_moe_train_step``)."""
        return transformer_apply_with_aux(self.params, x, self.cfg,
                                          causal=causal)[0]

    def get_weights(self):
        """The weights as numpy arrays in the reference's leaf order."""
        tree = self.params
        return [_at(tree, p).detach().cpu().numpy().copy()
                for p in _sorted_paths(tree)]

    def set_weights(self, weights):
        """Load :meth:`get_weights`' list (the reference's order)."""
        tree = self.params
        paths = _sorted_paths(tree)
        weights = list(weights)
        if len(weights) != len(paths):
            raise ValueError(f"got {len(weights)} weights, the model has "
                             f"{len(paths)}")
        with torch.no_grad():
            for path, w in zip(paths, weights):
                p = _at(tree, path)
                w = np.asarray(w)
                if tuple(w.shape) != tuple(p.shape):
                    raise ValueError(
                        f"weight {'/'.join(map(str, path))}: shape "
                        f"{w.shape} != {tuple(p.shape)}")
                p.copy_(torch.from_numpy(w.copy()))

    def to_json(self):
        return json.dumps({"class_name": "Transformer", "config": self.cfg})

    @property
    def count_params(self):
        return sum(p.numel() for p in self.parameters())
