"""Eager variables and the gradient tape (the torch counterpart of
paddle_tpu/imperative/base.py; see the package docstring).

The JAX tape records one node a traced call with `jax.vjp` and walks the
nodes in reverse. Here a traced call runs under torch autograd on detached
copies of its differentiable inputs, and the node keeps the call's outputs
with their autograd graph; `backward()` walks the nodes in reverse and asks
each one for its inputs' gradients with one `torch.autograd.grad` (the
graph retained, since a node may be walked again), under the JAX tape's
rules:

- a call outside `guard()` records nothing (it runs under torch.no_grad());
- only float inputs with stop_gradient=False are leaves;
- gradients accumulate across backward() calls until clear_gradient(), and
  so do the cotangents held by a node's outputs: a node that any earlier
  backward() reached is walked again by a later one on the same tape (the
  JAX tape's rule, kept exactly);
- a node that no cotangent reached is skipped.
"""

import contextlib

import numpy as np
import torch

from ..ops.registry import card_math, torch_dtype
from ..place import to_device

_state = {"tape": None, "device": None}


def enabled():
    return _state["tape"] is not None


@contextlib.contextmanager
def guard(place=None):
    """`with fluid.imperative.guard():` activates eager tracing on `place`
    (the card unless a CPUPlace is given): the eager values made inside it
    live on that device. On the card it takes the executor's math settings
    (registry.card_math: no TF32, deterministic cuDNN)."""
    prev = (_state["tape"], _state["device"])
    device = to_device(place)
    if device.type == "cuda":
        card_math()
    _state["tape"] = Tape()
    _state["device"] = device
    try:
        yield
    finally:
        _state["tape"], _state["device"] = prev


def current_tape():
    return _state["tape"]


def current_device():
    """The device new eager values are made on: the innermost guard's, or
    outside every guard the card (to_device(None), which raises with no
    CUDA device)."""
    device = _state["device"]
    return device if device is not None else to_device(None)


def as_tensor(value):
    """An eager value as a tensor: a tensor as it is (detached, on its
    device), anything else through numpy onto the current device in its
    framework dtype (float64 and int64 narrow, as jnp.asarray's do)."""
    if isinstance(value, Variable):
        return value.value
    if isinstance(value, torch.Tensor):
        return value.detach()
    a = np.asarray(value)
    return torch.as_tensor(np.ascontiguousarray(a), device=current_device(),
                           dtype=torch_dtype(a.dtype))


def to_numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


class Variable:
    """Eager value: a tensor and its accumulated gradient (the reference's
    VarBase, imperative/layers.h)."""

    def __init__(self, value, stop_gradient=False, name=None):
        self.value = as_tensor(value)
        self.stop_gradient = stop_gradient
        self.name = name
        self._grad = None

    @property
    def shape(self):
        return tuple(self.value.shape)

    @property
    def dtype(self):
        return str(self.value.dtype).replace("torch.", "")

    def numpy(self):
        return to_numpy(self.value)

    def gradient(self):
        return None if self._grad is None else to_numpy(self._grad)

    def clear_gradient(self):
        self._grad = None

    def _accum(self, g):
        self._grad = g if self._grad is None else self._grad + g

    def backward(self):
        """Reverse the tape from this (scalar) variable (reference
        tracer.cc's backward pass over the recorded ops)."""
        tape = current_tape()
        if tape is None:
            raise RuntimeError("backward() outside imperative.guard()")
        if self.value.numel() != 1:
            raise ValueError("backward() needs a scalar loss")
        tape.backward(self)

    def __repr__(self):
        return "imperative.Variable(shape=%s, dtype=%s)" % (self.shape, self.dtype)


def to_variable(value, block=None, name=None):
    if isinstance(value, Variable):
        return value
    return Variable(value, name=name)


class _Node:
    __slots__ = ("vjp_fn", "inputs", "outputs")

    def __init__(self, vjp_fn, inputs, outputs):
        self.vjp_fn = vjp_fn
        self.inputs = inputs
        self.outputs = outputs


def _vjp(outs, wrt):
    """vjp_fn(cotangents) -> the gradients of `wrt` (zeros where no path
    reaches one, as jax.vjp gives), through the autograd graph of `outs`,
    which is kept for the next walk."""

    def vjp_fn(cots):
        pairs = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
        grads = [None] * len(wrt)
        if pairs:
            grads = torch.autograd.grad([o for o, _ in pairs], list(wrt),
                                        grad_outputs=[c for _, c in pairs],
                                        retain_graph=True, allow_unused=True)
        return tuple(torch.zeros_like(w) if g is None else g for w, g in zip(wrt, grads))

    return vjp_fn


def leaf_inputs(inputs):
    """(tensors, leaf positions) of a traced call's inputs: a leaf's (float,
    not stop_gradient) tensor as a detached copy that requires grad, one a
    position (a variable passed twice gets both gradients), the others as
    they are."""
    vals, pos = [], []
    for i, v in enumerate(inputs):
        if not v.stop_gradient and v.value.is_floating_point():
            vals.append(v.value.detach().requires_grad_())
            pos.append(i)
        else:
            vals.append(v.value)
    return vals, pos


class Tape:
    def __init__(self):
        self.nodes = []

    def trace(self, fn, inputs):
        """Run fn(*tensors) under autograd, record the node, return eager
        Variables. Differentiable leaves are the float inputs with
        stop_gradient=False."""
        vals, pos = leaf_inputs(inputs)
        with torch.enable_grad():
            out = fn(*vals)
        outs_t = out if isinstance(out, tuple) else (out,)
        outs = [Variable(o) for o in outs_t]
        if pos:
            self.nodes.append(_Node(_vjp(outs_t, [vals[i] for i in pos]),
                                    [inputs[i] for i in pos], outs))
        return outs

    def backward(self, root):
        root._accum(torch.ones_like(root.value))
        for node in reversed(self.nodes):
            if all(o._grad is None for o in node.outputs):
                continue  # no cotangent reached this node
            cots = tuple(
                o._grad if o._grad is not None else torch.zeros_like(o.value)
                for o in node.outputs
            )
            grads = node.vjp_fn(cots)
            for v, g in zip(node.inputs, grads):
                # PyLayer nodes list ALL inputs (the user backward returns
                # grads positionally); stop_gradient inputs discard theirs
                if g is not None and not v.stop_gradient:
                    v._accum(g)
