"""Operator registry: lowering, shape inference and gradients (the torch
counterpart of paddle_tpu/ops/registry.py).

- **lowering**: `lower(ctx, ins, attrs) -> outs` maps slot-name -> [torch
  tensors] to slot-name -> [torch tensors]. The executor (executor.py)
  interprets a block by calling each op's lowering in program order on one
  device; PyTorch runs them eagerly.
- **shape inference**: the lowering itself, run on ``device="meta"`` tensors
  (shapes and dtypes, no data), where the JAX package uses jax.eval_shape. A
  dynamic (-1) dim is substituted with a sentinel extent and mapped back.
- **gradients**: unless an op registers a custom grad maker or an explicit
  `{type}_grad` lowering, `{type}_grad` is derived with `torch.func.vjp`
  over the forward lowering, where the JAX package uses jax.vjp.
  append_backward (backward.py) emits the grad ops into the program.
- **fused runs**: the kernel-substitution passes (passes/builtin.py) tag
  contiguous op runs with a group id and a kernel family; lower_ops hands a
  tagged run to the family's fused lowering (ops/fused.py), which launches a
  hand-written kernel or declines, and a declined run lowers op by op.
"""

import numpy as np
import torch

from .. import framework

# Sentinel extent substituted for -1 (dynamic batch) dims during shape
# inference; any output dim equal to it is mapped back to -1.
_DYN_SENTINEL = 8191

_GRAD_SUFFIX = "@GRAD"

# meta attrs attached by backward.py to generic grad ops
FWD_IN_SLOTS_ATTR = "__fwd_in_slots__"
FWD_OUT_SLOTS_ATTR = "__fwd_out_slots__"

_META_ATTRS = (
    FWD_IN_SLOTS_ATTR,
    FWD_OUT_SLOTS_ATTR,
    framework.OpRole.OP_ROLE_KEY,
    framework.OpRole.OP_ROLE_VAR_KEY,
)

EMPTY_VAR_NAME = "@EMPTY@"  # reference core.kEmptyVarName

# passes.builtin.FuseElemwiseActPass tags matmul/conv+add[+act] chains with
# this attr. The JAX package lowers such a run inside one named scope as an
# XLA fusion hint; an eager interpreter has nothing to fuse, so here the run
# lowers op by op. The attr string is program data shared with the JAX
# package.
FUSION_GROUP_ATTR = "__fusion_group__"

# Kernel-substitution tier: the fuse_gemm_epilogue / fuse_layer_norm /
# fuse_optimizer passes tag op runs with a group id and a kernel family name;
# lower_ops hands a contiguous same-group run to the family's registered
# FUSED lowering instead of lowering op by op. A fused lowering may DECLINE
# (shapes its kernel does not cover, unsupported attrs) by returning False —
# the run then lowers per op with identical semantics. The tags are attrs
# only: def-use, op order and count are untouched. Same strings as the JAX
# package (program data).
PALLAS_GROUP_ATTR = "__pallas_group__"
PALLAS_KERNEL_ATTR = "__pallas_kernel__"

# kernel family name -> fused lowering fn(ctx, ops, env) -> bool (True when
# the run was handled and its outputs written into env)
FUSED_LOWERINGS = {}

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
    def __init__(self, type, lower=None, grad=None, no_grad=False,
                 stochastic=False, skip_exec=False):
        self.type = type
        self.lower = lower
        # grad: fn(op, block, grad_name_map) -> list of op-spec dicts, or None
        # for the generic vjp-derived gradient
        self.grad = grad
        self.no_grad = no_grad
        self.stochastic = stochastic
        self.skip_exec = skip_exec  # executor ignores (feed/fetch markers)

    @property
    def is_host(self):
        # the JAX package's host ops (RPC, listen_and_serv) are not ported;
        # the passes read this flag
        return False


OPS = {}


def register(type, **kwargs):
    """Decorator: @register("matmul") def lower(ctx, ins, attrs): ..."""

    def deco(fn):
        OPS[type] = OpDef(type, lower=fn, **kwargs)
        return fn

    return deco


def register_no_lower(type, **kwargs):
    OPS[type] = OpDef(type, lower=None, skip_exec=True, **kwargs)


def register_fused(family):
    """Decorator: @register_fused("gemm_epilogue")
    def lower_run(ctx, ops, env) -> bool: ..."""

    def deco(fn):
        FUSED_LOWERINGS[family] = fn
        return fn

    return deco


def get(type):
    d = OPS.get(type)
    if d is not None:
        return d
    if type.endswith("_grad"):
        base = OPS.get(type[: -len("_grad")])
        if base is not None and base.lower is not None:
            d = OpDef(type, lower=_make_generic_grad(base), no_grad=True)
            OPS[type] = d
            return d
    raise KeyError("no op registered for type %r" % type)


def is_registered(type):
    try:
        get(type)
        return True
    except KeyError:
        return False


class LowerCtx:
    """Per-run context handed to lowerings: the device new tensors go to,
    and explicit torch.Generators in place of the JAX package's threaded
    PRNG key. Initializers draw from `generator`, a CPU generator, so a seed
    gives the same parameters whatever the device; stochastic ops of a
    training step (dropout) draw on the run's device from
    `device_generator`."""

    def __init__(self, device, generator=None, is_test=False,
                 device_generator=None):
        self.device = torch.device(device)
        self.generator = generator
        self.device_generator = device_generator
        self.is_test = is_test
        self.op = None
        if self.device.type == "cuda":
            # full f32 products on the card, whatever the default or a
            # caller set: the parity tolerances assume no TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False


def _clean_attrs(attrs):
    return {k: v for k, v in attrs.items() if k not in _META_ATTRS}


def _make_generic_grad(fwd_def):
    """The vjp-derived lowering for `{type}_grad` (the JAX package's
    _make_generic_grad with torch.func.vjp in place of jax.vjp).

    The grad op's inputs follow the reference convention (grad_op_desc_maker.h
    DefaultGradOpDescMaker): forward input slots, forward output slots, and
    `<out-slot>@GRAD` cotangents. Outputs are `<in-slot>@GRAD`.
    Differentiable leaves are the floating-point forward inputs; everything
    else rides in the closure. Missing cotangents become zeros. The forward
    is replayed inside the vjp: an eager interpreter has no CSE to share it
    with the forward op, so a generic grad costs one more forward."""

    def lower(ctx, ins, attrs):
        in_slots = list(attrs[FWD_IN_SLOTS_ATTR])
        out_slots = list(attrs[FWD_OUT_SLOTS_ATTR])
        fwd_attrs = _clean_attrs(attrs)
        fwd_ins = {s: list(ins[s]) for s in in_slots if s in ins}

        leaves, spec = [], []
        for s in in_slots:
            for i, v in enumerate(fwd_ins.get(s, [])):
                if v is not None and torch.is_floating_point(v):
                    leaves.append(v)
                    spec.append((s, i))

        def f(*leaf_vals):
            d = {s: list(vs) for s, vs in fwd_ins.items()}
            for (s, i), v in zip(spec, leaf_vals):
                d[s][i] = v
            outs = fwd_def.lower(ctx, d, fwd_attrs)
            return tuple(tuple(outs.get(s, ())) for s in out_slots)

        primals, vjp_fn = torch.func.vjp(f, *leaves)

        cots = []
        for s, pvals in zip(out_slots, primals):
            gs = ins.get(s + _GRAD_SUFFIX)
            row = []
            for i, p in enumerate(pvals):
                g = gs[i] if gs is not None and i < len(gs) and gs[i] is not None else None
                row.append(g.to(p.dtype) if g is not None else torch.zeros_like(p))
            cots.append(tuple(row))
        grads = vjp_fn(tuple(cots))

        out = {}
        for (s, i), g in zip(spec, grads):
            out.setdefault(s + _GRAD_SUFFIX, {})[i] = g
        return {s: [d.get(i) for i in range(max(d) + 1)] for s, d in out.items()}

    return lower


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


def _lower_one(ctx, op, env):
    """Lower a single op into env (see lower_ops)."""
    opdef = get(op.type)
    if opdef.skip_exec:
        return
    ctx.op = op
    outs = opdef.lower(ctx, gather_op_inputs(op, env), op.attrs)
    ctx.op = None
    scatter_op_outputs(op, outs, env)


def _lower_pallas_run(ctx, run, env):
    """Try the registered fused lowering for a tagged run; fall back to
    per-op lowering when the family is unknown or the lowering declines."""
    fused = FUSED_LOWERINGS.get(run[0].attrs.get(PALLAS_KERNEL_ATTR))
    if fused is not None and fused(ctx, run, env):
        return
    for member in run:
        _lower_one(ctx, member, env)


def lower_ops(ctx, ops, env):
    """Run a list of ops over an env (name -> tensor), rebinding outputs —
    the reference's Executor::RunPreparedContext loop (executor.cc:389-396).

    Contiguous runs sharing a PALLAS_GROUP_ATTR value (tagged by the
    fuse_gemm_epilogue / fuse_layer_norm / fuse_optimizer passes) are handed
    to the family's fused lowering (FUSED_LOWERINGS); a decline falls back
    to per-op lowering. FUSION_GROUP_ATTR runs lower op by op."""
    i, n = 0, len(ops)
    while i < n:
        pg = ops[i].attrs.get(PALLAS_GROUP_ATTR)
        if pg is None:
            _lower_one(ctx, ops[i], env)
            i += 1
            continue
        j = i
        while j < n and ops[j].attrs.get(PALLAS_GROUP_ATTR) == pg:
            j += 1
        _lower_pallas_run(ctx, ops[i:j], env)
        i = j
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


def reduce_grad_to_shape(g, shape):
    """Sum-reduce a broadcasted gradient back to `shape` (for custom grads)."""
    if tuple(g.shape) == tuple(shape):
        return g
    extra = g.dim() - len(shape)
    if extra > 0:
        g = g.sum(dim=tuple(range(extra)))
    axes = tuple(i for i, d in enumerate(shape) if d == 1 and g.shape[i] != 1)
    if axes:
        g = g.sum(dim=axes, keepdim=True)
    return g.reshape(shape)


def prod(shape):
    return int(np.prod(shape)) if len(shape) else 1
