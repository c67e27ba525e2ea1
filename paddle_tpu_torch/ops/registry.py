"""Operator registry: lowering and shape inference (the torch counterpart of
paddle_tpu/ops/registry.py).

- **lowering**: `lower(ctx, ins, attrs) -> outs` maps slot-name -> [torch
  tensors] to slot-name -> [torch tensors]. The executor (executor.py)
  interprets a block by calling each op's lowering in program order on one
  device; PyTorch runs them eagerly.
- **shape inference**: the lowering itself, run on ``device="meta"`` tensors
  (shapes and dtypes, no data), where the JAX package uses jax.eval_shape. A
  dynamic (-1) dim is substituted with a sentinel extent and mapped back.

The generic vjp-derived `{type}_grad` ops, the fused-kernel run dispatch and
the fusion-group scopes of the JAX registry belong to the training slice and
are not here yet.
"""

import numpy as np
import torch

from .. import framework

# Sentinel extent substituted for -1 (dynamic batch) dims during shape
# inference; any output dim equal to it is mapped back to -1.
_DYN_SENTINEL = 8191

EMPTY_VAR_NAME = "@EMPTY@"  # reference core.kEmptyVarName

_TORCH_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int32": torch.int32,
    "int16": torch.int16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "bool": torch.bool,
}
_FRAMEWORK_DTYPES = {v: k for k, v in _TORCH_DTYPES.items()}
_FRAMEWORK_DTYPES[torch.int64] = "int32"
_FRAMEWORK_DTYPES[torch.float64] = "float32"


def torch_dtype(dtype):
    """torch dtype of a framework dtype spec (after the framework's
    canonicalization: int64 -> int32, float64 -> float32)."""
    return _TORCH_DTYPES[framework.convert_np_dtype(dtype)]


class OpDef:
    def __init__(self, type, lower=None, no_grad=False, stochastic=False,
                 skip_exec=False):
        self.type = type
        self.lower = lower
        self.no_grad = no_grad
        self.stochastic = stochastic
        self.skip_exec = skip_exec  # executor ignores (feed/fetch markers)


OPS = {}


def register(type, **kwargs):
    """Decorator: @register("matmul") def lower(ctx, ins, attrs): ..."""

    def deco(fn):
        OPS[type] = OpDef(type, lower=fn, **kwargs)
        return fn

    return deco


def register_no_lower(type, **kwargs):
    OPS[type] = OpDef(type, lower=None, skip_exec=True, **kwargs)


def get(type):
    d = OPS.get(type)
    if d is None:
        raise KeyError("no op registered for type %r" % type)
    return d


def is_registered(type):
    return type in OPS


class LowerCtx:
    """Per-run context handed to lowerings: the device new tensors go to,
    and an explicit torch.Generator in place of the JAX package's threaded
    PRNG key. Stochastic ops draw from `generator` (a CPU generator, so a
    seed gives the same values whatever the device) and move the result to
    `device`."""

    def __init__(self, device, generator=None, is_test=False):
        self.device = torch.device(device)
        self.generator = generator
        self.is_test = is_test
        self.op = None


def gather_op_inputs(op, env):
    """Resolve an op's input slots from the run env."""
    ins = {}
    for slot, names in op.inputs.items():
        if names:
            ins[slot] = [
                env[n] if n != EMPTY_VAR_NAME else None for n in names
            ]
    return ins


def scatter_op_outputs(op, outs, env):
    """Bind an op's output slots back into the run env."""
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        for name, val in zip(names, vals):
            if val is not None and name != EMPTY_VAR_NAME:
                env[name] = val


def lower_ops(ctx, ops, env):
    """Run a list of ops over an env (name -> tensor), rebinding outputs —
    the reference's Executor::RunPreparedContext loop (executor.cc:389-396)."""
    for op in ops:
        opdef = get(op.type)
        if opdef.skip_exec:
            continue
        ctx.op = op
        outs = opdef.lower(ctx, gather_op_inputs(op, env), op.attrs)
        ctx.op = None
        scatter_op_outputs(op, outs, env)
    return env


# ---------------------------------------------------------------------------
# shape inference (reference: per-op InferShape, operator.cc:705; here the
# lowering itself on meta tensors)
# ---------------------------------------------------------------------------


def infer_shape(op, block):
    try:
        opdef = get(op.type)
    except KeyError:
        return  # unknown ops get shapes from custom layer code or stay None
    if opdef.lower is None or opdef.skip_exec:
        return

    meta_ins = {}
    for slot, names in op.inputs.items():
        vals = []
        for name in names:
            if name == EMPTY_VAR_NAME:
                vals.append(None)
                continue
            v = block._var_recursive(name)
            if v.shape is None or v.dtype is None:
                return  # cannot infer yet (e.g. fed later) — leave outputs as-is
            shape = tuple(_DYN_SENTINEL if d == -1 else d for d in v.shape)
            vals.append(torch.empty(shape, dtype=torch_dtype(v.dtype), device="meta"))
        meta_ins[slot] = vals

    ctx = LowerCtx("meta", is_test=bool(op.attrs.get("is_test", False)))
    try:
        outs = opdef.lower(ctx, meta_ins, dict(op.attrs))
    except Exception as e:  # surface shape errors at build time, like InferShape
        raise ValueError("shape inference failed for op %s: %s" % (op, e)) from e

    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        for name, val in zip(names, vals):
            if val is None or name == EMPTY_VAR_NAME:
                continue
            v = block._var_recursive(name)
            v.shape = tuple(-1 if d == _DYN_SENTINEL else int(d) for d in val.shape)
            v.dtype = _FRAMEWORK_DTYPES[val.dtype]


# ---------------------------------------------------------------------------
# shared helpers for lowerings
# ---------------------------------------------------------------------------


def bcast_y(x, y, axis):
    """Paddle elementwise broadcast: align y's dims to x starting at `axis`
    (reference operators/elementwise/elementwise_op_function.h). axis=-1 means
    align trailing dims (NumPy style after right-padding)."""
    if x.dim() == y.dim():
        return y
    if axis == -1:
        axis = x.dim() - y.dim()
    # trim trailing 1s in y (paddle allows y shape (..., 1, 1))
    yshape = list(y.shape)
    while yshape and yshape[-1] == 1 and len(yshape) > 1 and axis + len(yshape) > x.dim():
        yshape.pop()
    new_shape = [1] * x.dim()
    for i, d in enumerate(yshape):
        new_shape[axis + i] = d
    return y.reshape(new_shape)


def prod(shape):
    return int(np.prod(shape)) if len(shape) else 1
