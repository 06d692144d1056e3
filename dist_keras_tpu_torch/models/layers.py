"""Layer library — counterpart of ``models/layers.py``.

The reference's layers are stateless config objects with

    params, out_shape = layer.init(key, in_shape)
    y = layer.apply(params, x, training=..., rng=...)

Here each layer is an ``nn.Module`` that keeps the same surface:

    params, out_shape = layer.init(generator, in_shape)
    y = layer.apply(params, x, training=..., generator=...)

``apply`` is a plain function of the tensors it is given (the trainers
differentiate it with respect to their own params tree), while the
module holds the built weights as ``nn.Parameter``s (state leaves such
as BatchNorm's moving statistics as buffers) under the reference's
names: ``kernel``, ``bias``, ``scale``, ``gamma``, ``beta``,
``moving_mean``, ``moving_var``, ``embeddings``.  Layouts are the
reference's too: Dense kernels ``(in, out)``, Conv2D HWIO kernels on
NHWC activations, so weights cross with ``utils/bridge.py`` unchanged.

Random draws take an explicit ``torch.Generator``: ``init`` draws on
the generator's device (the CPU when a model is built), Dropout draws
its mask from the trainer's generator on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# --------------------------------------------------------------------------
# activations (jax.nn's definitions: gelu is the tanh approximation)
# --------------------------------------------------------------------------

_ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": F.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "elu": F.elu,
    "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "silu": F.silu,
}


def get_activation(name):
    if name is None:
        return _ACTIVATIONS["linear"]
    if callable(name):
        return name
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"Unknown activation {name!r}") from None


# --------------------------------------------------------------------------
# initializers (Keras defaults)
# --------------------------------------------------------------------------

def glorot_uniform(generator, shape, dtype=torch.float32):
    """Uniform in [-limit, limit), limit = sqrt(6 / (fan_in + fan_out))."""
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return (2.0 * u - 1.0) * limit


def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels: (kh, kw, in, out)
    receptive = int(np.prod(shape[:-2]))
    return shape[-2] * receptive, shape[-1] * receptive


def _promote(x, w):
    """x and w in their common dtype (int x f32 -> f32, bf16 x f32 ->
    f32), the promotion ``x @ w`` gets in JAX."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


def _same_pads(size, k, s):
    """(out, lo, hi) of 'same' padding along one axis: lax's rule, which
    puts the odd element of an odd total at the end."""
    out = -(-size // s)
    total = max(0, (out - 1) * s + k - size)
    return out, total // 2, total - total // 2


def _window_out(h, w, kernel, strides, padding):
    """Output (h, w) of a window op, or raise on an unknown padding."""
    (kh, kw), (sh, sw) = kernel, strides
    if padding.upper() == "SAME":
        return _same_pads(h, kh, sh)[0], _same_pads(w, kw, sw)[0]
    if padding.upper() == "VALID":
        return (h - kh) // sh + 1, (w - kw) // sw + 1
    raise ValueError(f"padding {padding!r} must be 'same' or 'valid'")


def _pad_nchw(x, kernel, strides, padding, value=0.0):
    """Explicit 'same' padding of an NCHW tensor (torch's padding='same'
    is symmetric and refuses strides > 1); 'valid' passes through."""
    if padding.upper() != "SAME":
        return x
    (kh, kw), (sh, sw) = kernel, strides
    _, top, bottom = _same_pads(x.shape[2], kh, sh)
    _, left, right = _same_pads(x.shape[3], kw, sw)
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


# --------------------------------------------------------------------------
# layer base + registry
# --------------------------------------------------------------------------

LAYER_REGISTRY = {}


def register_layer(cls):
    LAYER_REGISTRY[cls.__name__] = cls
    return cls


class Layer(nn.Module):
    """Config in the object, parameters in a dict of tensors."""

    _param_order = ()   # the held params' names, in init's order

    def init(self, generator, in_shape):
        """-> (params, out_shape). in/out shapes exclude the batch dim."""
        return {}, in_shape

    def apply(self, params, x, *, training=False, generator=None):
        return x

    def apply_with_state(self, params, x, *, training=False,
                         generator=None):
        """-> (y, state_update): the layer's state leaves (see
        ``state_names``) after this batch; stateless layers return an
        empty dict."""
        return self.apply(params, x, training=training,
                          generator=generator), {}

    # ---- the built weights, held by the module ----
    def params(self):
        """-> {name: tensor} in the order ``init`` made them."""
        return {name: getattr(self, name) for name in self._param_order}

    def set_params(self, params):
        """Hold ``params`` (a dict as ``init`` returns it): state leaves
        as buffers, the rest as parameters."""
        for name in self._param_order:
            delattr(self, name)
        state = set(self.state_names())
        for name, value in params.items():
            value = value.detach()
            if name in state:
                self.register_buffer(name, value)
            else:
                self.register_parameter(name, nn.Parameter(value))
        self._param_order = tuple(params)

    # ---- state leaves (non-trainable, updated via the aux channel) ----
    def state_names(self):
        """Parameter names that are running state, not trainable weights."""
        return ()

    # ---- config round-trip (Keras `get_config` / `from_config` parity) ----
    def get_config(self):
        return {}

    @classmethod
    def from_config(cls, config):
        return cls(**config)

    # ---- weight ordering (Keras: kernel then bias, layer by layer) ----
    def weight_names(self):
        """Ordered parameter names for get_weights/set_weights."""
        return []

    def __repr__(self):
        cfg = ", ".join(f"{k}={v!r}" for k, v in self.get_config().items())
        return f"{type(self).__name__}({cfg})"


@register_layer
class Dense(Layer):
    def __init__(self, units, activation=None, use_bias=True):
        super().__init__()
        self.units = int(units)
        self.activation = activation
        self.use_bias = bool(use_bias)

    def init(self, generator, in_shape):
        in_dim = in_shape[-1]
        params = {"kernel": glorot_uniform(generator, (in_dim, self.units))}
        if self.use_bias:
            params["bias"] = torch.zeros((self.units,), dtype=torch.float32,
                                         device=generator.device)
        return params, (*in_shape[:-1], self.units)

    def apply(self, params, x, *, training=False, generator=None):
        x, kernel = _promote(x, params["kernel"])
        y = x @ kernel
        if self.use_bias:
            y = y + params["bias"]
        return get_activation(self.activation)(y)

    def get_config(self):
        return {"units": self.units, "activation": self.activation,
                "use_bias": self.use_bias}

    def weight_names(self):
        return ["kernel", "bias"] if self.use_bias else ["kernel"]


@register_layer
class Conv2D(Layer):
    """NHWC conv with an HWIO kernel, as the reference stores them; the
    product runs as ``F.conv2d`` on NCHW views (channels-last strides,
    which cuDNN takes as they are)."""

    def __init__(self, filters, kernel_size, strides=(1, 1), padding="valid",
                 activation=None, use_bias=True):
        super().__init__()
        self.filters = int(filters)
        self.kernel_size = tuple(np.broadcast_to(kernel_size, (2,)).tolist())
        self.strides = tuple(np.broadcast_to(strides, (2,)).tolist())
        self.padding = padding
        self.activation = activation
        self.use_bias = bool(use_bias)

    def init(self, generator, in_shape):
        h, w, c = in_shape
        kh, kw = self.kernel_size
        params = {"kernel": glorot_uniform(generator,
                                           (kh, kw, c, self.filters))}
        if self.use_bias:
            params["bias"] = torch.zeros((self.filters,), dtype=torch.float32,
                                         device=generator.device)
        oh, ow = _window_out(h, w, self.kernel_size, self.strides,
                             self.padding)
        return params, (oh, ow, self.filters)

    def apply(self, params, x, *, training=False, generator=None):
        kernel = params["kernel"].to(x.dtype).permute(3, 2, 0, 1)  # OIHW
        xc = _pad_nchw(x.permute(0, 3, 1, 2), self.kernel_size,
                       self.strides, self.padding)
        y = F.conv2d(xc, kernel, stride=self.strides).permute(0, 2, 3, 1)
        if self.use_bias:
            y = y + params["bias"].to(y.dtype)
        return get_activation(self.activation)(y)

    def get_config(self):
        return {"filters": self.filters, "kernel_size": self.kernel_size,
                "strides": self.strides, "padding": self.padding,
                "activation": self.activation, "use_bias": self.use_bias}

    def weight_names(self):
        return ["kernel", "bias"] if self.use_bias else ["kernel"]


class _Pool2D(Layer):
    def __init__(self, pool_size=(2, 2), strides=None, padding="valid"):
        super().__init__()
        self.pool_size = tuple(np.broadcast_to(pool_size, (2,)).tolist())
        self.strides = (tuple(np.broadcast_to(strides, (2,)).tolist())
                        if strides is not None else self.pool_size)
        self.padding = padding

    def init(self, generator, in_shape):
        h, w, c = in_shape
        return {}, (*_window_out(h, w, self.pool_size, self.strides,
                                 self.padding), c)

    def get_config(self):
        return {"pool_size": self.pool_size, "strides": self.strides,
                "padding": self.padding}


@register_layer
class MaxPool2D(_Pool2D):
    """Max over each window; 'same' pads with -inf, as reduce_window
    does.  At tied maxima the gradient goes to one position (the
    reference's CPU path splits it evenly; both are subgradients)."""

    def apply(self, params, x, *, training=False, generator=None):
        xc = _pad_nchw(x.permute(0, 3, 1, 2), self.pool_size, self.strides,
                       self.padding, value=-math.inf)
        y = F.max_pool2d(xc, self.pool_size, self.strides)
        return y.permute(0, 2, 3, 1)


@register_layer
class AvgPool2D(_Pool2D):
    """Mean over each window.  'same' divides by the count of valid
    (non-padded) positions in the window, as Keras/TF average pooling
    does."""

    def _sum(self, xc):
        xc = _pad_nchw(xc, self.pool_size, self.strides, self.padding)
        return F.avg_pool2d(xc, self.pool_size, self.strides,
                            divisor_override=1)

    def apply(self, params, x, *, training=False, generator=None):
        xc = x.permute(0, 3, 1, 2)
        summed = self._sum(xc)
        if self.padding.upper() == "VALID":
            y = summed / (self.pool_size[0] * self.pool_size[1])
        else:
            y = summed / self._sum(torch.ones_like(xc[:1, :1]))
        return y.permute(0, 2, 3, 1)


@register_layer
class Flatten(Layer):
    """Flattens in NHWC order, so a bridged Dense kernel after a conv
    multiplies the features in the reference's order."""

    def init(self, generator, in_shape):
        return {}, (int(np.prod(in_shape)),)

    def apply(self, params, x, *, training=False, generator=None):
        return x.reshape(x.shape[0], -1)


@register_layer
class Reshape(Layer):
    def __init__(self, target_shape):
        super().__init__()
        self.target_shape = tuple(target_shape)

    def init(self, generator, in_shape):
        return {}, self.target_shape

    def apply(self, params, x, *, training=False, generator=None):
        return x.reshape(x.shape[0], *self.target_shape)

    def get_config(self):
        return {"target_shape": self.target_shape}


@register_layer
class Activation(Layer):
    def __init__(self, activation):
        super().__init__()
        self.activation = activation

    def apply(self, params, x, *, training=False, generator=None):
        return get_activation(self.activation)(x)

    def get_config(self):
        return {"activation": self.activation}


@register_layer
class Dropout(Layer):
    """Inverted dropout: ``where(mask, x / keep, 0)``.  Keep rates that
    8 bits express exactly (0.25 / 0.5 / 0.75) threshold uniform uint8
    draws, as the reference does; others compare uniform floats.  The
    mask comes from the caller's generator, so it cannot reproduce the
    reference's threefry bits, only their keep rate."""

    def __init__(self, rate):
        super().__init__()
        self.rate = float(rate)

    def apply(self, params, x, *, training=False, generator=None):
        if not training or self.rate <= 0.0:
            return x
        if generator is None:
            raise ValueError("Dropout needs a generator when training=True")
        keep = 1.0 - self.rate
        thresh = int(round(keep * 256))
        if abs(thresh - keep * 256) < 1e-9 and 0 < thresh < 256:
            bits = torch.randint(0, 256, x.shape, generator=generator,
                                 dtype=torch.uint8, device=x.device)
            mask = bits < thresh
        else:
            mask = torch.rand(x.shape, generator=generator,
                              device=x.device) < keep
        return torch.where(mask, x / keep, 0.0).to(x.dtype)

    def get_config(self):
        return {"rate": self.rate}


@register_layer
class LayerNorm(Layer):
    def __init__(self, epsilon=1e-5):
        super().__init__()
        self.epsilon = float(epsilon)

    def init(self, generator, in_shape):
        dim = in_shape[-1]
        dev = generator.device
        return {"scale": torch.ones((dim,), dtype=torch.float32, device=dev),
                "bias": torch.zeros((dim,), dtype=torch.float32,
                                    device=dev)}, in_shape

    def apply(self, params, x, *, training=False, generator=None):
        return F.layer_norm(x, x.shape[-1:], params["scale"].to(x.dtype),
                            params["bias"].to(x.dtype), self.epsilon)

    def get_config(self):
        return {"epsilon": self.epsilon}

    def weight_names(self):
        return ["scale", "bias"]


@register_layer
class BatchNorm(Layer):
    """Batch normalisation over every axis but the last.

    The moving statistics are leaves of the params dict (``moving_mean``
    / ``moving_var``, named by ``state_names``), advanced by the trainers
    through ``apply_with_state``; the optimizer never sees them.  Training
    normalises with the batch statistics (biased variance), inference
    with the moving ones — Keras ``BatchNormalization``.
    """

    def __init__(self, momentum=0.99, epsilon=1e-3):
        super().__init__()
        self.momentum = float(momentum)
        self.epsilon = float(epsilon)

    def init(self, generator, in_shape):
        dim = in_shape[-1]
        dev = generator.device

        def full(v):
            return torch.full((dim,), v, dtype=torch.float32, device=dev)

        return {"gamma": full(1.0), "beta": full(0.0),
                "moving_mean": full(0.0), "moving_var": full(1.0)}, in_shape

    def _stats(self, params, x, training):
        if training:
            axes = tuple(range(x.ndim - 1))
            return (x.mean(dim=axes),
                    x.var(dim=axes, unbiased=False))
        return params["moving_mean"], params["moving_var"]

    def _norm(self, params, x, mu, var):
        y = (x - mu.to(x.dtype)) * torch.rsqrt(var.to(x.dtype) + self.epsilon)
        return y * params["gamma"].to(x.dtype) + params["beta"].to(x.dtype)

    def apply(self, params, x, *, training=False, generator=None):
        mu, var = self._stats(params, x, training)
        return self._norm(params, x, mu, var)

    def apply_with_state(self, params, x, *, training=False,
                         generator=None):
        mu, var = self._stats(params, x, training)
        y = self._norm(params, x, mu, var)
        if not training:
            return y, {}
        # blend in f32 whatever the compute dtype: at momentum 0.99 the
        # per-batch increment is below bf16's resolution
        m = self.momentum
        new_mean = (m * params["moving_mean"].float()
                    + (1.0 - m) * mu.float())
        new_var = (m * params["moving_var"].float()
                   + (1.0 - m) * var.float())
        return y, {"moving_mean": new_mean.detach(),
                   "moving_var": new_var.detach()}

    def get_config(self):
        return {"momentum": self.momentum, "epsilon": self.epsilon}

    def weight_names(self):
        return ["gamma", "beta", "moving_mean", "moving_var"]

    def state_names(self):
        return ("moving_mean", "moving_var")


@register_layer
class Embedding(Layer):
    def __init__(self, input_dim, output_dim):
        super().__init__()
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)

    def init(self, generator, in_shape):
        table = torch.randn((self.input_dim, self.output_dim),
                            generator=generator,
                            device=generator.device) * 0.02
        return {"embeddings": table}, (*in_shape, self.output_dim)

    def apply(self, params, x, *, training=False, generator=None):
        return F.embedding(x.long(), params["embeddings"])

    def get_config(self):
        return {"input_dim": self.input_dim, "output_dim": self.output_dim}

    def weight_names(self):
        return ["embeddings"]
