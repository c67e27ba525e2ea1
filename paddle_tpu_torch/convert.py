"""Carry parameters from the JAX package into the port.

Parameter names are explicit and shared between the two packages (the
GPTDecoder's `param_names()`), so the copy is by name: every name, shape and
dtype is checked and a missing or extra name raises. Arrays travel as numpy
(`{name: np.asarray(jax_scope.vars[name])}`), so neither side imports the
other.
"""

import numpy as np
import torch

from .ops.registry import torch_dtype

__all__ = ["params_from_jax", "load_into_scope"]


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
        out[name] = torch.from_numpy(a).to(device=device, dtype=dt)
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
