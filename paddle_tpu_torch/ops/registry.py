"""Operator registry: lowering, shape inference and gradients (the torch
counterpart of paddle_tpu/ops/registry.py).

- **lowering**: `lower(ctx, ins, attrs) -> outs` maps slot-name -> [torch
  tensors] to slot-name -> [torch tensors]. The executor (executor.py)
  interprets a block by calling each op's lowering in program order on one
  device; PyTorch runs them eagerly.
- **shape inference**: the lowering itself, run on ``device="meta"`` tensors
  (shapes and dtypes, no data), where the JAX package uses jax.eval_shape. A
  dynamic (-1) dim is substituted with a sentinel extent and mapped back. An
  op that cannot be run on meta tensors (a sub-block op, a tensor-array op)
  registers its own `infer_shape(op, block)`, as in the JAX package.
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

# cuDNN restricted to deterministic algorithms on the card (LowerCtx); a
# measurement may clear it to time what the restriction costs
CUDNN_DETERMINISTIC = True

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
    def __init__(self, type, lower=None, infer_shape=None, grad=None, no_grad=False,
                 stochastic=False, skip_exec=False, host_fn=None, host_effect=False):
        self.type = type
        self.lower = lower
        # infer_shape: fn(op, block), used in place of the meta-tensor run
        self.custom_infer_shape = infer_shape
        # grad: fn(op, block, grad_name_map) -> list of op-spec dicts, or None
        # for the generic vjp-derived gradient
        self.grad = grad
        self.no_grad = no_grad
        self.stochastic = stochastic
        self.skip_exec = skip_exec  # executor ignores (feed/fetch markers)
        # host ops run outside any captured graph, between device segments
        # (save / load, detection_map: the reference's non-kernel
        # OperatorBase ops). Signature: host_fn(op, scope). The executor
        # splits a block at host ops (executor.py _SegmentedBlock).
        self.host_fn = host_fn
        # a device op whose lowering has a host side effect (print): the
        # passes treat it as any device op, but the executor runs it between
        # graph segments, so it takes effect on every run and not once at a
        # capture
        self.host_effect = host_effect

    @property
    def is_host(self):
        return self.host_fn is not None

    @property
    def splits_graph(self):
        """Whether the executor runs this op between device segments."""
        return self.host_fn is not None or self.host_effect


OPS = {}


def register(type, **kwargs):
    """Decorator: @register("matmul") def lower(ctx, ins, attrs): ..."""

    def deco(fn):
        OPS[type] = OpDef(type, lower=fn, **kwargs)
        return fn

    return deco


def register_no_lower(type, **kwargs):
    OPS[type] = OpDef(type, lower=None, skip_exec=True, **kwargs)


def register_host(type, **kwargs):
    """Decorator: @register_host("save") def run(op, scope): ... Host ops are
    no-grad and contribute no shape inference."""

    def deco(fn):
        OPS[type] = OpDef(type, lower=None, no_grad=True, host_fn=fn, **kwargs)
        return fn

    return deco


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
            d = OpDef(type, lower=_make_generic_grad(base), infer_shape=_generic_grad_infer,
                      no_grad=True)
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
    PRNG key. With `host_random` (a startup program's run, and the default)
    the random ops draw from `generator`, a CPU generator, so a seed gives
    the same parameters whatever the device. Without it (every other
    block) they draw on the run's device from `device_generator`, as
    dropout always does: a captured CUDA graph draws there, and cannot copy
    from the host."""

    def __init__(self, device, generator=None, is_test=False,
                 device_generator=None, cache=None, host_random=True, mesh=None,
                 sharding=None, layout=None, autograd=False):
        self.device = torch.device(device)
        # this rank's parallel.Mesh under a ParallelExecutor (None: one
        # device): the mesh-aware lowerings (batch_norm's dp statistics,
        # ring attention over sp, the ep-sharded table) read it
        self.mesh = mesh
        # the sharding rules bound to the mesh (parallel.sharding_rules.
        # Resolver, None without rules): the fused families decline on a
        # run they place
        self.sharding = sharding
        # the run's layouts (sharding_rules.Layouts, None when no value is
        # split over tp or fsdp): every op lowers through it, on this
        # rank's pieces
        self.layout = layout
        # a pipeline stage's forward, differentiated by torch.autograd:
        # flash_attention takes its autograd form, which keeps the lse
        # inside (elsewhere the program's grad op reads the Lse output)
        self.autograd = autograd
        self.generator = generator
        self.device_generator = device_generator
        self.host_random = host_random
        self.is_test = is_test
        self.op = None
        # per-op values that outlive one run (a prepared block passes its
        # own dict): constants uploaded once, pinned-seed generators
        self.cache = {} if cache is None else cache
        if self.device.type == "cuda":
            card_math()

    def op_constant(self, make, tag=None):
        """The current op's constant tensor (or tuple of them; `tag` tells
        an op's several apart), made by `make()` at the op's first run and
        kept: a replayed CUDA graph cannot upload from the host, and a
        constant need not be uploaded every run."""
        key = ("const", id(self.op), tag)
        val = self.cache.get(key)
        if val is None:
            val = self.cache[key] = make()
        return val

    def seeded_generator(self, seed):
        """The current op's own generator for a pinned seed, on the run's
        device, restarted from `seed`, so that every run draws the same
        numbers. The generator is made at the op's first run and kept in
        the cache, where a CUDA graph that draws from it finds it to
        register it and to restart it before each replay."""
        key = ("seed", id(self.op))
        entry = self.cache.get(key)
        if entry is None:
            entry = self.cache[key] = (torch.Generator(device=self.device), int(seed))
        # restarting with the seed it has is a no-op while a capture is under
        # way; the graph restarts it before each replay
        return entry[0].manual_seed(entry[1])


def card_math():
    """The card's math settings, which every run on it (a block's and an
    eager guard's) takes: full f32 products, whatever the default or a
    caller set (the parity tolerances assume no TF32); cuDNN's algorithms
    chosen by its heuristics, never by timing, and only deterministic ones
    (no atomic sums in dgrad or wgrad), so a step gives the same bits on
    the graph path and op by op."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = CUDNN_DETERMINISTIC


def mesh_over(ctx, axis):
    """ctx's mesh when its `axis` has extent above 1 (the lowering then
    takes its distributed form), else None."""
    return ctx.mesh if ctx.mesh is not None and ctx.mesh.axis_size(axis) > 1 else None


def seeded_generators(cache):
    """[(generator, seed)] of the pinned-seed generators a LowerCtx cache
    holds."""
    return [v for k, v in cache.items() if k[0] == "seed"]


def _clean_attrs(attrs):
    return {k: v for k, v in attrs.items() if k not in _META_ATTRS}


def set_var_meta(block, name, shape, dtype=None):
    """Build-time shape (and dtype) of a var, for an op's own infer_shape;
    the empty name and names the block lacks are skipped."""
    if name == EMPTY_VAR_NAME or not block.has_var_recursive(name):
        return
    v = block._var_recursive(name)
    if shape is not None:
        v.shape = tuple(shape)
    if dtype is not None:
        v.dtype = dtype


def _generic_grad_infer(op, block):
    """A generic grad's `<slot>@GRAD` outputs take the shapes and dtypes of
    the forward inputs they differentiate (no replay of the forward on meta
    tensors: a loop over a dynamic time dim would run its sentinel extent)."""
    for slot, names in op.outputs.items():
        if not slot.endswith(_GRAD_SUFFIX):
            continue
        for name, src in zip(names, op.inputs.get(slot[: -len(_GRAD_SUFFIX)], ())):
            if src != EMPTY_VAR_NAME and block.has_var_recursive(src):
                s = block._var_recursive(src)
                set_var_meta(block, name, s.shape, s.dtype)


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
                # tensor arrays ((buffer, size) pairs) ride in the closure
                if isinstance(v, torch.Tensor) and torch.is_floating_point(v):
                    leaves.append(v)
                    spec.append((s, i))

        # the differentiable outputs: the floating ones (an int output, a
        # length, has no cotangent)
        out_spec = []

        def f(*leaf_vals):
            d = {s: list(vs) for s, vs in fwd_ins.items()}
            for (s, i), v in zip(spec, leaf_vals):
                d[s][i] = v
            outs = fwd_def.lower(ctx, d, fwd_attrs)
            flat = []
            out_spec.clear()
            for s in out_slots:
                for i, v in enumerate(outs.get(s, ())):
                    if isinstance(v, torch.Tensor) and torch.is_floating_point(v):
                        flat.append(v)
                        out_spec.append((s, i))
            return tuple(flat)

        primals, vjp_fn = torch.func.vjp(f, *leaves)

        cots = []
        for (s, i), p in zip(out_spec, primals):
            gs = ins.get(s + _GRAD_SUFFIX)
            g = gs[i] if gs is not None and i < len(gs) and gs[i] is not None else None
            cots.append(g.to(p.dtype) if g is not None else torch.zeros_like(p))
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
    if ctx.layout is not None:
        ctx.layout.lower_one(ctx, op, env, opdef)
        return
    lower_op(ctx, op, env, opdef)


def lower_op(ctx, op, env, opdef, attrs=None):
    """Lower `op` through `opdef` over env (its attrs, or `attrs` in their
    place), binding its outputs."""
    # a sub-block op lowers inside its parent op's lowering: restore the
    # parent afterwards
    parent, ctx.op = ctx.op, op
    try:
        outs = opdef.lower(ctx, gather_op_inputs(op, env), op.attrs if attrs is None else attrs)
    finally:
        ctx.op = parent
    scatter_op_outputs(op, outs, env)


def _lower_pallas_run(ctx, run, env):
    """Try the registered fused lowering for a tagged run; fall back to
    per-op lowering when the family is unknown or the lowering declines."""
    fused = FUSED_LOWERINGS.get(run[0].attrs.get(PALLAS_KERNEL_ATTR))
    if fused is not None and fused(ctx, run, env):
        return
    for member in run:
        _lower_one(ctx, member, env)


def op_runs(ops):
    """The units lower_ops runs, in order: a single op, or a contiguous run
    of ops sharing a PALLAS_GROUP_ATTR value (tagged by the
    fuse_gemm_epilogue / fuse_layer_norm / fuse_optimizer passes)."""
    i, n = 0, len(ops)
    while i < n:
        pg = ops[i].attrs.get(PALLAS_GROUP_ATTR)
        j = i + 1
        if pg is not None:
            while j < n and ops[j].attrs.get(PALLAS_GROUP_ATTR) == pg:
                j += 1
        yield ops[i:j]
        i = j


def lower_run(ctx, run, env):
    """Lower one unit of op_runs: a tagged run goes to the family's fused
    lowering (FUSED_LOWERINGS), and a decline falls back to per-op
    lowering; an untagged op lowers alone."""
    if run[0].attrs.get(PALLAS_GROUP_ATTR) is None:
        _lower_one(ctx, run[0], env)
    else:
        _lower_pallas_run(ctx, run, env)


def dead_after(runs, keep=()):
    """For each unit of `runs` (op_runs' units), the names no later unit
    reads or writes, so a block that runs them can drop its references
    once the unit has run: an intermediate lives from its op to its last
    reader, as in a compiled step's buffer assignment, and a captured
    graph's pool reuses its memory. Names in `keep` (fetches, state written
    back) are never dropped."""
    last = {}
    for i, run in enumerate(runs):
        for op in run:
            for n in op.input_arg_names + op.output_arg_names:
                last[n] = i
    dead = [[] for _ in runs]
    for n, i in last.items():
        if n not in keep and n != EMPTY_VAR_NAME:
            dead[i].append(n)
    return dead


def lower_ops(ctx, ops, env):
    """Run a list of ops over an env (name -> tensor), rebinding outputs —
    the reference's Executor::RunPreparedContext loop (executor.cc:389-396),
    one unit of op_runs at a time. FUSION_GROUP_ATTR runs lower op by op."""
    for run in op_runs(ops):
        lower_run(ctx, run, env)
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
    if opdef.custom_infer_shape is not None:
        opdef.custom_infer_shape(op, block)
        return
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
