"""Eager Layer library (the torch counterpart of paddle_tpu/imperative/nn.py:
Conv2D / Pool2D / FC / BatchNorm / Embedding / LayerNorm and the eager
optimizers, each layer a Layer subclass whose forward is torch math, so
tape.backward() and jit() work unchanged).

The layers follow the JAX package's math, where torch's own layers differ:
BatchNorm and LayerNorm take the biased variance; an average Pool2D is
exclusive (padded positions do not count in the divisor) and a max Pool2D
pads with -inf, at any padding; Embedding(padding_idx=) zeroes the output
rows of that id; AdamOptimizer steps p - lr_t * m / (sqrt(v) + eps) with
lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t).
"""

import numpy as np
import torch
import torch.nn.functional as F

from .base import as_tensor
from .layers import Layer

__all__ = [
    "FC",
    "Conv2D",
    "Pool2D",
    "BatchNorm",
    "Embedding",
    "LayerNorm",
    "SGDOptimizer",
    "AdamOptimizer",
]


class FC(Layer):
    """Eager fully-connected (graph analog: layers.fc / mul+elementwise_add).
    Flattens trailing dims like num_flatten_dims=1."""

    def __init__(self, size, input_dim, act=None, bias_attr=True, dtype="float32"):
        super().__init__(dtype=dtype)
        self._size = size
        self._act = act
        self.weight = self.create_parameter([input_dim, size])
        self.bias = self.create_parameter([size], initializer=0.0) if bias_attr else None

    def forward(self, x, *params):
        w = params[0]
        b = params[1] if self.bias is not None else None
        x2 = x.reshape(x.shape[0], -1)
        y = torch.matmul(x2, w)
        if b is not None:
            y = y + b
        return _apply_act(y, self._act)


def _apply_act(y, act):
    if act is None:
        return y
    if act == "relu":
        return torch.relu(y)
    if act == "tanh":
        return torch.tanh(y)
    if act == "sigmoid":
        return torch.sigmoid(y)
    if act == "softmax":
        return torch.softmax(y, dim=-1)
    raise ValueError("unsupported act %r" % act)


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * 2


class Conv2D(Layer):
    """Eager NCHW conv (graph analog: layers.conv2d / conv2d op)."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, groups=1, act=None, bias_attr=True, dtype="float32"):
        super().__init__(dtype=dtype)
        fs = _pair(filter_size)
        self._stride, self._padding, self._groups, self._act = (
            _pair(stride), _pair(padding), groups, act)
        self.weight = self.create_parameter(
            [num_filters, num_channels // groups, fs[0], fs[1]]
        )
        self.bias = (
            self.create_parameter([num_filters], initializer=0.0) if bias_attr else None
        )

    def forward(self, x, *params):
        y = F.conv2d(x, params[0], stride=self._stride, padding=self._padding,
                     groups=self._groups)
        if self.bias is not None:
            y = y + params[1][None, :, None, None]
        return _apply_act(y, self._act)


class Pool2D(Layer):
    """Eager pool (graph analog: layers.pool2d / pool2d op)."""

    def __init__(self, pool_size=2, pool_type="max", pool_stride=None,
                 pool_padding=0, global_pooling=False, dtype="float32"):
        super().__init__(dtype=dtype)
        self._size = (pool_size,) * 2 if np.isscalar(pool_size) else tuple(pool_size)
        self._stride = (
            self._size if pool_stride is None
            else ((pool_stride,) * 2 if np.isscalar(pool_stride) else tuple(pool_stride))
        )
        self._pad = (pool_padding,) * 2 if np.isscalar(pool_padding) else tuple(pool_padding)
        self._type = pool_type
        self._global = global_pooling

    def forward(self, x):
        if self._global:
            return x.mean(dim=(2, 3), keepdim=True) if self._type == "avg" \
                else x.amax(dim=(2, 3), keepdim=True)
        # explicit padding, then an unpadded window: F.max_pool2d /
        # avg_pool2d refuse padding past half the window, which the JAX
        # package's reduce_window takes
        pad = (self._pad[1], self._pad[1], self._pad[0], self._pad[0])
        if self._type == "max":
            return F.max_pool2d(F.pad(x, pad, value=float("-inf")), self._size, self._stride)
        s = F.avg_pool2d(F.pad(x, pad), self._size, self._stride, divisor_override=1)
        # exclusive average like the graph pool2d op's default: padded
        # positions don't count toward the divisor
        ones = F.pad(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                                device=x.device), pad)
        cnt = F.avg_pool2d(ones, self._size, self._stride, divisor_override=1)
        return s / cnt


class Embedding(Layer):
    """Eager embedding lookup (graph analog: layers.embedding / lookup_table).
    With padding_idx, the output rows of that id are zero (a mask, as the
    JAX package's; F.embedding's padding_idx only stops the gradient)."""

    def __init__(self, size, padding_idx=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(list(size))

    def forward(self, ids, *params):
        w = params[0]
        ids = ids.reshape(ids.shape[0], -1).long()
        out = F.embedding(ids, w)
        if self._padding_idx is not None:
            mask = (ids != self._padding_idx)[..., None]
            out = out * mask.to(out.dtype)
        return out


def _biased_var(x, dims, keepdim=False):
    return torch.var(x, dim=dims, correction=0, keepdim=keepdim)


class BatchNorm(Layer):
    """Eager batch norm over NCHW/NC (graph analog: batch_norm op). Train
    mode normalizes with the batch statistics (biased variance) and keeps
    running statistics as non-trainable buffers updated OUTSIDE the tape
    (reduced on the device, only the [C] results brought to the host);
    eval mode uses the running statistics."""

    def __init__(self, num_channels, momentum=0.9, epsilon=1e-5, dtype="float32"):
        super().__init__(dtype=dtype)
        self._momentum, self._eps = momentum, epsilon
        self.scale = self.create_parameter([num_channels], initializer=1.0)
        self.shift = self.create_parameter([num_channels], initializer=0.0)
        self._mean = np.zeros(num_channels, dtype)
        self._var = np.ones(num_channels, dtype)
        self.training = True

    def forward(self, x, *params):
        scale, shift = params
        dims = (0,) + tuple(range(2, x.ndim))
        if self.training:
            mean = x.mean(dim=dims)
            var = _biased_var(x, dims)
        else:
            mean = torch.as_tensor(self._mean, device=x.device)
            var = torch.as_tensor(self._var, device=x.device)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + self._eps)
        return y * scale.reshape(shape) + shift.reshape(shape)

    def __call__(self, *inputs):
        out = super().__call__(*inputs)
        if self.training:
            x = as_tensor(inputs[0])
            dims = (0,) + tuple(range(2, x.ndim))
            m = self._momentum
            with torch.no_grad():
                stats = torch.stack([x.mean(dim=dims), _biased_var(x, dims)]).cpu().numpy()
            self._mean = m * self._mean + (1 - m) * stats[0]
            self._var = m * self._var + (1 - m) * stats[1]
        return out

    def eval(self):
        self.training = False
        return self

    def train(self):
        self.training = True
        return self


class LayerNorm(Layer):
    """Eager layer norm over the last dim (graph analog: layer_norm op)."""

    def __init__(self, normalized_shape, epsilon=1e-5, dtype="float32"):
        super().__init__(dtype=dtype)
        self._eps = epsilon
        n = int(np.prod(np.atleast_1d(normalized_shape)))
        self.scale = self.create_parameter([n], initializer=1.0)
        self.shift = self.create_parameter([n], initializer=0.0)

    def forward(self, x, *params):
        scale, shift = params
        mean = x.mean(dim=-1, keepdim=True)
        var = _biased_var(x, -1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self._eps) * scale + shift


class SGDOptimizer:
    """Eager SGD over Layer.parameters() (graph analog: optimizer.SGD; a
    step() consuming each parameter's tape gradient)."""

    def __init__(self, parameters, learning_rate=0.01):
        self._params = list(parameters)
        self._lr = learning_rate

    def step(self):
        for p in self._params:
            if p._grad is not None:
                p.value = p.value - self._lr * p._grad

    def clear_gradients(self):
        for p in self._params:
            p.clear_gradient()


class AdamOptimizer:
    """Eager Adam (graph analog: optimizer.Adam; the adam op lowering's
    update, eps outside the square root of the corrected second moment)."""

    def __init__(self, parameters, learning_rate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8):
        self._params = list(parameters)
        self._lr, self._b1, self._b2, self._eps = learning_rate, beta1, beta2, epsilon
        self._m = [torch.zeros_like(p.value) for p in self._params]
        self._v = [torch.zeros_like(p.value) for p in self._params]
        self._t = 0

    def step(self):
        self._t += 1
        b1, b2 = self._b1, self._b2
        lr_t = self._lr * (1 - b2 ** self._t) ** 0.5 / (1 - b1 ** self._t)
        for i, p in enumerate(self._params):
            g = p._grad
            if g is None:
                continue
            self._m[i] = b1 * self._m[i] + (1 - b1) * g
            self._v[i] = b2 * self._v[i] + (1 - b2) * torch.square(g)
            p.value = p.value - lr_t * self._m[i] / (torch.sqrt(self._v[i]) + self._eps)

    def clear_gradients(self):
        for p in self._params:
            p.clear_gradient()
