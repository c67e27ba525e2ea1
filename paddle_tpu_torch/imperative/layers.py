"""Eager Layer / PyLayer bases (the torch counterpart of
paddle_tpu/imperative/layers.py; reference imperative/layers.py:25 PyLayer).

Layer.forward is written against torch tensors; __call__ traces the whole
body as one tape node (see base.Tape.trace), so backward() differentiates
it through autograd, and `jit()` compiles it without user changes."""

import numpy as np
import torch

from ..ops.registry import torch_dtype
from . import base
from .base import Variable, to_numpy, to_variable


class Layer:
    """Compose parameters and a torch forward (reference imperative Layer).

    Subclass contract: create parameters in __init__ via create_parameter;
    implement forward(self, *tensors) taking and returning torch tensors
    (NOT eager Variables: the tape passes values in and wraps values out)."""

    def __init__(self, name_scope=None, dtype="float32"):
        self._dtype = dtype
        self._params = []
        self._sublayers = []

    def create_parameter(self, shape, dtype=None, initializer=None, name=None):
        """A parameter on the current device. Its initial value comes from
        numpy's global state by the JAX package's rule (uniform within
        1/sqrt(fan_in)), so a seeded script makes the same weights in both
        packages."""
        dtype = dtype or self._dtype
        if initializer is None:
            fan_in = int(np.prod(shape[:-1])) or 1
            init = np.random.uniform(
                -1.0 / np.sqrt(fan_in), 1.0 / np.sqrt(fan_in), shape
            ).astype(dtype)
        elif callable(initializer):
            init = np.asarray(initializer(shape)).astype(dtype)
        else:
            init = np.full(shape, float(initializer), dtype)
        p = Variable(init, name=name)
        self._params.append(p)
        return p

    def add_sublayer(self, layer):
        self._sublayers.append(layer)
        return layer

    def parameters(self):
        out = list(self._params)
        for sub in self._sublayers:
            out.extend(sub.parameters())
        return out

    def forward(self, *args):
        raise NotImplementedError

    def _fn(self):
        return self.forward

    def __call__(self, *inputs):
        tape = base.current_tape()
        vars_in = [to_variable(v) for v in inputs]
        params = self.parameters()
        fn = self._fn()

        def run(*vals):
            xs = vals[: len(vars_in)]
            ps = vals[len(vars_in):]
            return fn(*xs, *ps) if params else fn(*xs)

        if tape is None:
            with torch.no_grad():
                out = run(*[v.value for v in vars_in], *[p.value for p in params])
            outs = [Variable(o) for o in (out if isinstance(out, tuple) else (out,))]
        else:
            outs = tape.trace(run, vars_in + params)
        return outs[0] if len(outs) == 1 else outs

    def jit(self):
        """Compile forward with torch.compile: the same values and tape
        rules (a traced call still differentiates through autograd), one
        compiled body a call. On the card the backend is inductor, which
        generates Triton kernels for the forward and its backward; on the
        CPU it is aot_eager, the same graph capture (dynamo, and the
        backward through AOTAutograd) run by eager kernels, so the CPU
        exercises the capture without a C++ build of the graph. A capture
        is made for each input signature (static shapes)."""
        params = self.parameters()
        device = params[0].value.device if params else base.current_device()
        backend = "inductor" if device.type == "cuda" else "aot_eager"
        self._jitted = torch.compile(self.forward, backend=backend, dynamic=False)
        self._fn = lambda: self._jitted
        return self


def _out_tensor(o, device):
    if isinstance(o, torch.Tensor):
        return o.to(device)
    a = np.asarray(o)
    return torch.as_tensor(np.ascontiguousarray(a), device=device, dtype=torch_dtype(a.dtype))


def _autograd_function(cls):
    """The torch.autograd.Function of a PyLayer class (made once a class):
    its forward and backward run the class's numpy ones on host copies, and
    the backward's gradients, one per input by position, come back on the
    input's device."""
    fn = cls.__dict__.get("_autograd_fn")
    if fn is not None:
        return fn

    class _PyLayerFunction(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *xs):
            ctx.devices = [x.device for x in xs]
            out = cls.forward(*[to_numpy(x) for x in xs])
            outs = out if isinstance(out, tuple) else (out,)
            res = tuple(_out_tensor(o, xs[0].device) for o in outs)
            return res if len(res) > 1 else res[0]

        @staticmethod
        def backward(ctx, *douts):
            gs = cls.backward(*[to_numpy(d) for d in douts])
            gs = gs if isinstance(gs, tuple) else (gs,)
            return tuple(
                _out_tensor(g, dev) if need else None
                for g, dev, need in zip(gs, ctx.devices, ctx.needs_input_grad)
            )

    cls._autograd_fn = _PyLayerFunction
    return _PyLayerFunction


class PyLayer:
    """Custom-python forward/backward pair (reference imperative/layers.py
    PyLayer: static forward/backward over numpy)."""

    @staticmethod
    def forward(*inputs):
        raise NotImplementedError

    @staticmethod
    def backward(*douts):
        raise NotImplementedError

    @classmethod
    def __call__(cls, *a):
        return cls.apply(*a)

    @classmethod
    def apply(cls, *inputs):
        tape = base.current_tape()
        vars_in = [to_variable(v) for v in inputs]
        fn = _autograd_function(cls)
        if tape is None or all(v.stop_gradient for v in vars_in):
            with torch.no_grad():
                out = fn.apply(*[v.value for v in vars_in])
            outs = [Variable(o) for o in (out if isinstance(out, tuple) else (out,))]
            return outs[0] if len(outs) == 1 else outs
        # every float input takes part (the user backward returns one grad
        # per input positionally); Tape.backward drops the grads of
        # stop_gradient inputs
        vals, pos = [], []
        for i, v in enumerate(vars_in):
            if v.value.is_floating_point():
                vals.append(v.value.detach().requires_grad_())
                pos.append(i)
            else:
                vals.append(v.value)
        with torch.enable_grad():
            out = fn.apply(*vals)
        outs_t = out if isinstance(out, tuple) else (out,)
        outs = [Variable(o) for o in outs_t]
        tape.nodes.append(base._Node(base._vjp(outs_t, [vals[i] for i in pos]),
                                     [vars_in[i] for i in pos], outs))
        return outs[0] if len(outs) == 1 else outs
