"""Carry scope state between the JAX package and the port.

Names are explicit and shared between the two packages (the GPTDecoder's
`param_names()`; for a training program, `persistable_names`: parameters,
Adam moments, beta pows and the learning rate), so the copy is by name:
every name, shape and dtype is checked and a missing or extra name raises.
Arrays travel as numpy (`{name: np.asarray(jax_scope.vars[name])}`), so
neither side imports the other; `scope_to_numpy` carries the port's scope
back, so that both packages' state can be compared after N steps.

Eager layers (imperative.Layer) carry their state by position instead:
`load_imperative` copies a JAX Layer's `parameters()`, given in order as
numpy arrays, into the port's Layer of the same structure, with the
running statistics of its BatchNorms (`running_stats`, which reads them
from either package's layer tree).
"""

import numpy as np
import torch

from .ops.registry import torch_dtype

__all__ = ["load_imperative", "load_into_scope", "params_from_jax", "persistable_names",
           "running_stats", "scope_to_numpy"]


def params_from_jax(arrays, device):
    """{name: np.ndarray} -> {name: torch.Tensor on `device`}, each in the
    framework dtype of its numpy dtype (float64/int64 narrow as in both
    packages' framework)."""
    out = {}
    for name, a in arrays.items():
        a = np.array(a)  # a writable host copy (JAX hands out read-only views)
        try:
            dt = torch_dtype(a.dtype)
        except (KeyError, ValueError) as e:
            raise TypeError("%s: unsupported dtype %s" % (name, a.dtype)) from e
        if dt == torch.bfloat16:
            a = a.astype(np.float32)  # numpy's bfloat16 has no torch view; exact
        out[name] = torch.from_numpy(a).to(device=device, dtype=dt)
    return out


def persistable_names(program):
    """Sorted names of the program's persistable vars that its ops read or
    write: the parameters and the optimizer state (moments, beta pows,
    learning rate) that a training step carries from step to step."""
    block = program.global_block()
    used = set()
    for op in block.ops:
        used.update(op.input_arg_names)
        used.update(op.output_arg_names)
    return sorted(
        n for n in used
        if block.has_var_recursive(n) and block._var_recursive(n).persistable
    )


def scope_to_numpy(scope, names):
    """{name: np.ndarray} copies of the scope's tensors (bfloat16 widened to
    float32, which is exact); a name the scope lacks raises."""
    out = {}
    for name in names:
        t = scope.vars.get(name)
        if t is None:
            raise KeyError("%s is not in the scope" % name)
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.to("cpu", copy=True).numpy()
    return out


def load_into_scope(scope, arrays, names):
    """Copy `arrays` ({name: np.ndarray}) into the scope's existing tensors,
    in place, so callables built over the scope (engine variants) see the
    new values. `names` is the exact set expected (e.g. a model's
    param_names()): a missing or extra name raises, as does a name the scope
    lacks or a shape or dtype that differs from the scope's tensor."""
    want, got = set(names), set(arrays)
    if want != got:
        raise KeyError(
            "parameter names differ: missing %s, extra %s"
            % (sorted(want - got), sorted(got - want))
        )
    tensors = params_from_jax(arrays, scope.device)
    for name in sorted(want):
        cur = scope.vars.get(name)
        if cur is None:
            raise KeyError("%s is not in the scope" % name)
        new = tensors[name]
        if tuple(new.shape) != tuple(cur.shape) or new.dtype != cur.dtype:
            raise ValueError(
                "%s: got %s %s, the scope holds %s %s"
                % (name, tuple(new.shape), new.dtype, tuple(cur.shape), cur.dtype)
            )
    with torch.no_grad():
        for name in sorted(want):
            scope.vars[name].copy_(tensors[name])


def _stat_layers(layer):
    """The layers of an eager layer tree (pre-order: a layer, then its
    sublayers) that keep running statistics (BatchNorm's `_mean`, `_var`),
    in either package."""
    out = [layer] if hasattr(layer, "_mean") and hasattr(layer, "_var") else []
    for sub in getattr(layer, "_sublayers", ()):
        out.extend(_stat_layers(sub))
    return out


def running_stats(layer):
    """[(mean, var)] numpy copies of the running statistics of every
    BatchNorm in an eager layer tree of either package, in tree order."""
    return [(np.array(np.asarray(s._mean)), np.array(np.asarray(s._var)))
            for s in _stat_layers(layer)]


def load_imperative(layer, arrays, stats=None):
    """Copy `arrays` (numpy, in the order of the source layer's
    parameters()) into the port's eager `layer`'s parameters, on each
    parameter's device, and `stats` (running_stats of the source, or None
    to leave them) into its BatchNorms. The count, every shape and every
    dtype must match; returns the layer."""
    params = layer.parameters()
    if len(arrays) != len(params):
        raise ValueError("%d arrays for %d parameters" % (len(arrays), len(params)))
    for i, (p, a) in enumerate(zip(params, arrays)):
        a = np.array(a)
        dt = torch_dtype(a.dtype)
        if tuple(a.shape) != tuple(p.value.shape) or dt != p.value.dtype:
            raise ValueError("parameter %d: got %s %s, the layer holds %s %s"
                             % (i, a.shape, dt, tuple(p.value.shape), p.value.dtype))
        p.value = torch.from_numpy(a).to(device=p.value.device, dtype=dt)
    if stats is not None:
        layers = _stat_layers(layer)
        if len(stats) != len(layers):
            raise ValueError("%d running statistics for %d BatchNorms"
                             % (len(stats), len(layers)))
        for bn, (mean, var) in zip(layers, stats):
            bn._mean = np.array(mean, dtype=bn._mean.dtype)
            bn._var = np.array(var, dtype=bn._var.dtype)
    return layer
