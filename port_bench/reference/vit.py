"""The plain ViT: forward, loss, gradients and adam, in float32.

Follows the port's blocks, which depart from ViT-B/16 as the
configuration file lists (mean-pooled head without a class token, no
bias on the q/k/v/o and patch products, LayerNorm eps 1e-5, tanh GELU):
x (B, T, patch features) -> ``x @ proj + pos`` -> pre-LN blocks of
multi-head softmax attention and a GELU MLP -> final LN, mean over the
tokens -> ``@ head``.  The loss is the mean softmax cross-entropy; adam
is optax's (eps outside the root, bias-corrected).  Rows run in chunks
whose gradients are summed, so the whole batch fits.  It imports
nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from port_bench.reference import inputs
from port_bench.reference.numbers import (
    CHECK_STEPS,
    change_norms,
    flat,
    norms,
)
from port_bench.reference.precision import F32, strict_f32


def layer_norm(p, x, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def forward(p, x, dims, prec=F32):
    """x (B, T, input_dim) -> logits (B, classes)."""
    b, t, _ = x.shape
    d, heads = dims["d"], dims["heads"]
    dh = d // heads
    h = prec.mm(x, p["proj"]) + p["pos"][:t]
    for blk in p["blocks"]:
        y = layer_norm(blk["ln1"], h)

        def split(w):
            return prec.mm(y, w.reshape(d, d)).reshape(
                b, t, heads, dh).transpose(1, 2)

        q, k, v = split(blk["wq"]), split(blk["wk"]), split(blk["wv"])
        s = prec.mm(q, k.transpose(-1, -2)) / math.sqrt(dh)
        o = prec.mm(torch.softmax(s, dim=-1), v)
        o = o.transpose(1, 2).reshape(b, t, d)
        h = h + prec.mm(o, blk["wo"].reshape(d, d))
        y = layer_norm(blk["ln2"], h)
        u = F.gelu(prec.mm(y, blk["w1"]) + blk["b1"], approximate="tanh")
        h = h + prec.mm(u, blk["w2"]) + blk["b2"]
    pooled = layer_norm(p["ln_f"], h).mean(dim=1)
    return prec.mm(pooled, p["head"]["kernel"]) + p["head"]["bias"]


def _unflat(tree, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    return build(tree)


def loss_and_grads(params, x, y, dims, prec=F32, chunk=16):
    """-> (mean cross-entropy, grads as [(path, tensor)]) over the rows of
    x, ``chunk`` rows at a time."""
    paths = [p for p, _ in flat(params)]
    leaves = [t.detach().requires_grad_() for _, t in flat(params)]
    tree = _unflat(params, leaves)
    n = x.shape[0]
    total = torch.zeros((), device=x.device, dtype=torch.float64)
    grads = [torch.zeros_like(t) for t in leaves]
    for i in range(0, n, chunk):
        logits = forward(tree, x[i:i + chunk], dims, prec)
        nll = -torch.log_softmax(logits, dim=-1).gather(
            1, y[i:i + chunk, None]).sum() / n
        for g, d in zip(grads, torch.autograd.grad(nll, leaves)):
            g += d
        total += nll.detach().double()
    return float(total), list(zip(paths, grads))


def adam_step(params, grads, state, lr, b1=0.9, b2=0.999, eps=1e-8):
    """optax's adam on ``[(path, tensor)]`` lists; ``state`` is
    ``{"t", "m", "v"}`` (empty to start) -> new params list."""
    t = state.get("t", 0) + 1
    m = state.get("m") or [torch.zeros_like(g) for _, g in grads]
    v = state.get("v") or [torch.zeros_like(g) for _, g in grads]
    out = []
    for i, ((path, p), (_, g)) in enumerate(zip(params, grads)):
        m[i] = b1 * m[i] + (1 - b1) * g
        v[i] = b2 * v[i] + (1 - b2) * g * g
        mh = m[i] / (1 - b1 ** t)
        vh = v[i] / (1 - b2 ** t)
        out.append((path, p - lr * mh / (torch.sqrt(vh) + eps)))
    state.update(t=t, m=m, v=v)
    return out


def check_numbers(config, traffic, seed, device, prec=F32, rows=1.0,
                  chunk=None):
    """The reference's record (``numbers``) of a ViT cell's check: the
    first :data:`CHECK_STEPS` adam steps from the seed's weights
    on the run's first global batches, in float32 (or ``prec``), each
    step on the first ``rows`` share of its batch's rows (1 for the
    reference; less plants the "part of the batch" fault)."""
    dims = inputs.vit_dims({**config, **traffic})
    batch = traffic["batch_per_rank"] * traffic["ranks"]
    chunk = chunk or traffic.get("reference_chunk", 16)
    steps, lr = CHECK_STEPS, config["learning_rate"]
    with strict_f32():
        p0 = inputs.vit_params(dims, seed, device)
        params, state, rec = flat(p0), {}, {"loss": {}}
        for i in range(steps):
            x, y = inputs.vit_batch(dims, batch, seed, i, device)
            keep = max(1, int(round(batch * rows)))
            loss, grads = loss_and_grads(
                _unflat(p0, [t for _, t in params]), x[:keep], y[:keep],
                dims, prec, chunk)
            del x, y
            rec["loss"][str(i)] = loss
            if i == 0:
                rec["grad"] = norms(grads)
            params = adam_step(params, grads, state, lr)
        rec["change"] = change_norms(p0, _unflat(p0, [t for _, t in params]))
    return rec
