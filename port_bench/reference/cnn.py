"""The plain MNIST CNN and the paper's ADAG over it, in float32.

The network of dist-keras's ``examples/mnist.py`` (NHWC, HWIO kernels):
conv 3x3 'same' + ReLU, conv 3x3 'same' + ReLU, 2x2 max-pool, conv 3x3
'same' + ReLU, 2x2 max-pool, flatten (in NHWC order), dense + ReLU,
dropout, dense to the logits; the loss is the mean softmax
cross-entropy of one-hot labels.  The dropout masks are drawn again
from the run's seed by the port's rule (``inputs.dropout_masks``).

ADAG (dist-keras ``workers.py``): every worker starts from the center,
takes ``window`` Keras-adam steps (eps 1e-7) on its own contiguous
share of the rows, and the center then gains the sum over the workers
of ``(local - center) / window``.  It imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference import inputs
from port_bench.reference.numbers import CHECK_STEPS, norms
from port_bench.reference.precision import F32, strict_f32
from port_bench.reference.vit import adam_step


def forward(ws, x, prec=F32, mask=None, rate=0.0):
    """ws [k1, b1, ..., k5, b5] (HWIO kernels), x (B, H, W, C) ->
    logits (B, classes); ``mask`` (B, units) keeps the dense layer's
    outputs that dropout at ``rate`` keeps (None: no dropout)."""
    k1, b1, k2, b2, k3, b3, k4, b4, k5, b5 = ws

    def conv(h, k, b):
        return torch.relu(prec.conv(h, k.permute(3, 2, 0, 1), 1)
                          + b[:, None, None])

    h = x.permute(0, 3, 1, 2)
    h = F.max_pool2d(conv(conv(h, k1, b1), k2, b2), 2)
    h = F.max_pool2d(conv(h, k3, b3), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = torch.relu(prec.mm(h, k4) + b4)
    if mask is not None:
        h = torch.where(mask, h / (1.0 - rate), 0.0)
    return prec.mm(h, k5) + b5


def loss_and_grads(ws, x, y, prec=F32, mask=None, rate=0.0):
    leaves = [w.detach().requires_grad_() for w in ws]
    nll = -torch.log_softmax(forward(leaves, x, prec, mask, rate),
                             dim=-1).gather(1, y[:, None]).mean()
    return float(nll.detach()), list(torch.autograd.grad(nll, leaves))


def leaf_names(config):
    """The keys of the weights: ``<layer>.kernel`` / ``<layer>.bias``,
    counting the layers that have weights."""
    n = len(inputs.cnn_shapes(config))
    return [f"{j}.{w}" for j in range(n) for w in ("kernel", "bias")]


def check_numbers(config, traffic, seed, device, prec=F32, rows=1.0):
    """The reference's record of an ADAG cell's check: one communication
    window of every worker from the seed's weights and rows, then the
    merge.  ``loss`` holds each worker's first :data:`CHECK_STEPS` losses,
    ``grad`` each worker's first gradient, ``change`` the center's change
    after the merge.  ``rows`` < 1 trains each step on that share of its
    batch (the "part of the batch" fault)."""
    workers, batch = traffic["workers"], traffic["batch"]
    window, lr = traffic["window"], config["learning_rate"]
    names, rate = leaf_names(config), config["dropout"]
    with strict_f32():
        center = inputs.cnn_weights(config, seed, device)
        x, y = inputs.cnn_rows(config, traffic["rows"], seed, device)
        masks = inputs.dropout_masks(
            rate, (workers, batch, config["dense_units"]), window, seed,
            device)
        per = traffic["rows"] // workers // batch * batch
        keep = max(1, int(round(batch * rows)))
        rec = {"loss": {}, "grad": {}}
        delta = [torch.zeros_like(c) for c in center]
        for w in range(workers):
            params, state = list(zip(names, center)), {}
            for s in range(window):
                lo = w * per + s * batch
                loss, grads = loss_and_grads(
                    [p for _, p in params], x[lo:lo + keep],
                    y[lo:lo + keep], prec,
                    None if masks is None else masks[s][w, :keep], rate)
                if s < CHECK_STEPS:
                    rec["loss"][f"w{w}/{s}"] = loss
                if s == 0:
                    rec["grad"].update(
                        (f"w{w}/{k}", v) for k, v in
                        norms(list(zip(names, grads))).items())
                params = adam_step(params, list(zip(names, grads)), state,
                                   lr, eps=config["adam_eps"])
            for d, (_, p), c in zip(delta, params, center):
                d += (p - c) / window
        rec["change"] = norms(list(zip(names, delta)))
    return rec
