"""Fused lowerings of the kernel-substitution tier: the counterpart of the
register_fused half of paddle_tpu/ops/pallas_kernels.py.

registry.lower_ops hands each run tagged by the fuse_gemm_epilogue /
fuse_layer_norm / fuse_optimizer passes to its family here:

- `gemm_epilogue`: mul|matmul -> elementwise_add [-> act] through
  gemm_epilogue.gemm_bias_act;
- `layer_norm`: [elementwise_add ->] layer_norm through
  layer_norm.fused_layer_norm;
- `layer_norm_grad`: layer_norm_grad through layer_norm.fused_layer_norm_grad;
- `multi_adam`: a run of adam ops through multi_adam.multi_tensor_adam, one
  launch per dtype group, with lr_t computed on the device;
- `gemm_int8`: int8_mul -> fake_dequantize x2 [-> elementwise_add [-> act]]
  (the inference_int8 chains) through quant_gemm.quant_gemm_bias_act, the
  two dequant multiplies collapsed into one combined scale.

A lowering declines (returns False, and the run lowers op by op) exactly
where the JAX one does: the path predicates below are copies of the JAX
package's (`gemm_path_taken`, `_auto_block`, `_ln_blocks` /
`ln_path_taken`, `adam_path_taken`), so both packages run the same ops
through the same families. Under ZeRO-1 the ParallelExecutor lowers the
optimizer ops one by one, so multi_adam declines there as in the JAX
package (a run of one); and each family declines where a sharding rule places one of the run's operands or results
on the mesh (`_rules_sharded`, the JAX package's check of the same name):
the kernels take whole local tensors, and the declined ops lower one by
one through the layout-aware path (parallel/sharding_rules.py).
On the card an accepted run always launches its kernel; a build or launch
failure raises.

KERNEL_DISPATCHES counts the runs each family accepted (the JAX package's
counter of the same name); `stats()` adds the kernel launches of the
wrappers, which only a run on the card makes, the flash attention kernels'
(ops/flash_attention.py, reached through their own ops) among them.
"""

import numpy as np
import torch

from .. import flags as _flags
from . import flash_attention, gemm_epilogue, layer_norm, multi_adam, paged_flash, quant_gemm
from .registry import bcast_y, gather_op_inputs, register_fused, scatter_op_outputs

__all__ = [
    "KERNEL_DISPATCHES",
    "GRAPHS",
    "OP_BY_OP",
    "SEGMENTS",
    "adam_path_taken",
    "counter_dicts",
    "gemm_path_taken",
    "ln_path_taken",
    "note_dispatch",
    "note_graph",
    "note_op_by_op",
    "note_segment",
    "quant_gemm_path_taken",
    "reset_stats",
    "stats",
]

# family -> number of times its fused lowering ACCEPTED a tagged run
KERNEL_DISPATCHES = {}


# reason -> runs of blocks the card ran op by op instead of capturing
# (the executor's _CompiledBlock counts them: "creates_persistables",
# "open_ended_while", "host_op")
OP_BY_OP = {}

# what the executor ran of blocks split at host ops: "device" segments run,
# "host" op calls, "inline" device ops with a host effect (print) run
# between segments
SEGMENTS = {}

# CUDA graphs the executor's blocks captured and replayed
GRAPHS = {}

# collectives that layouts and pipelines issued, by kind and axes
# (parallel/collectives.py note), e.g. "all_reduce:tp"
COLLECTIVES = {}


def note_dispatch(family):
    KERNEL_DISPATCHES[family] = KERNEL_DISPATCHES.get(family, 0) + 1


def note_op_by_op(reason):
    OP_BY_OP[reason] = OP_BY_OP.get(reason, 0) + 1


def note_segment(kind):
    SEGMENTS[kind] = SEGMENTS.get(kind, 0) + 1


def note_graph(event):
    GRAPHS[event] = GRAPHS.get(event, 0) + 1


_KERNEL_MODULES = (flash_attention, gemm_epilogue, layer_norm, multi_adam, quant_gemm)


def stats():
    """{"dispatches": runs accepted per family, "launches": kernel launches
    per wrapper}."""
    launches = {}
    for mod in _KERNEL_MODULES:
        launches.update(mod.kernel_launches())
    return {"dispatches": dict(KERNEL_DISPATCHES), "launches": launches}


def reset_stats():
    KERNEL_DISPATCHES.clear()
    OP_BY_OP.clear()
    SEGMENTS.clear()
    GRAPHS.clear()
    COLLECTIVES.clear()
    for mod in _KERNEL_MODULES:
        mod.reset_kernel_launches()


def counter_dicts():
    """Every launch and dispatch counter of the package, as the dicts the
    wrappers and fused lowerings increment (the paged kernels' among them):
    a CUDA graph takes what its capture added back out, and adds it again
    at every replay."""
    return [KERNEL_DISPATCHES, COLLECTIVES] + [m._LAUNCHES for m in _KERNEL_MODULES + (paged_flash,)]


# ---------------------------------------------------------------------------
# path predicates: copies of the JAX package's, so that both packages decline
# the same shapes (their block sizes are the TPU kernels' tiling, kept here
# as data: they decide which ops take the fused path, not how the CUDA
# kernels tile)
# ---------------------------------------------------------------------------

_DEF_GEMM_BLOCK_M = 512
_DEF_GEMM_BLOCK_N = 512
_DEF_GEMM_BLOCK_K = 512
_LANES = 128
_DEF_LN_BLOCK_ROWS = 128
_LN_VMEM_BUDGET = 12 * 1024 * 1024


def _auto_block(t, target):
    """Largest power-of-two-scaled block <= target that divides t, else t
    itself when a single whole tile fits; 0 for ragged shapes."""
    c = target
    while c >= 128:
        if t % c == 0:
            return c
        c //= 2
    return t if t <= target else 0


def gemm_path_taken(m, n, k, block_m=None, block_n=None, block_k=None):
    """Whether the gemm_epilogue family takes an (m, k) @ (k, n) chain."""
    if m <= 0 or n <= 0 or k <= 0:
        return False
    return (
        _auto_block(m, block_m or _DEF_GEMM_BLOCK_M) > 0
        and _auto_block(n, block_n or _DEF_GEMM_BLOCK_N) > 0
        and _auto_block(k, block_k or _DEF_GEMM_BLOCK_K) > 0
    )


def _ln_blocks(rows, cols, itemsize):
    """The JAX kernel's row-block size for a (rows, cols) view, or 0 for
    shapes it declines: rows % 128, cols % 128, or a block too large."""
    if rows <= 0 or cols <= 0 or rows % _LANES or cols % _LANES:
        return 0
    br = _auto_block(rows, _DEF_LN_BLOCK_ROWS)
    while br > 8 and br * cols * (4 * itemsize + 16) > _LN_VMEM_BUDGET:
        br //= 2
    if not br or br * cols * (4 * itemsize + 16) > _LN_VMEM_BUDGET:
        return 0
    return br


def ln_path_taken(rows, cols, itemsize=4):
    """Whether the layer_norm families take a (rows, cols) view."""
    return _ln_blocks(rows, cols, itemsize) > 0


_QUANT_GEMM_DTYPES = (torch.int8, torch.float8_e4m3fn)


def quant_gemm_path_taken(m, n, k, dtype, block_m=None, block_n=None, block_k=None):
    """Whether the gemm_int8 family takes an (m, k) @ (k, n) chain of
    `dtype` operands: FLAGS_quantized_gemm "off" declines every chain;
    otherwise int8 or e4m3 operands, the f32 GEMM's tile feasibility, and
    the TPU's (32, 128) low-precision granule (bm % 32, bn and bk % 128),
    exactly as the JAX package decides under "on". The granule is kept
    although the CUDA kernel does not need it, so that both packages run
    the same chains through their kernels (a 16-wide classifier head
    declines in both)."""
    if _flags.get_flags("quantized_gemm")["quantized_gemm"] == "off":
        return False
    if dtype not in _QUANT_GEMM_DTYPES or not gemm_path_taken(m, n, k, block_m, block_n,
                                                              block_k):
        return False
    bm = _auto_block(m, block_m or _DEF_GEMM_BLOCK_M)
    bn = _auto_block(n, block_n or _DEF_GEMM_BLOCK_N)
    bk = _auto_block(k, block_k or _DEF_GEMM_BLOCK_K)
    return not (bm % 32 or bn % _LANES or bk % _LANES)


def _rules_sharded(ctx, ops):
    """True when the sharding rules bound to this run (ctx.sharding, a
    parallel.sharding_rules.Resolver) place any of the run's operands or
    results on this mesh (the JAX package's check, pallas_kernels.py:2094):
    a kernel takes whole local tensors, so the run declines and its ops
    lower one by one, each on this rank's pieces."""
    sharding = getattr(ctx, "sharding", None)
    if sharding is None:
        return False
    for op in ops:
        for name in list(op.input_arg_names) + list(op.output_arg_names):
            if name and sharding.rule_spec(name) is not None:
                return True
    return False


def adam_path_taken(n_params, zero1=False, sharded=False):
    """Whether the multi_adam family takes a run of n_params adam ops: a
    degenerate group and the sharded tiers (ZeRO-1, rule-sharded params)
    decline."""
    return n_params >= 2 and not zero1 and not sharded


# ---------------------------------------------------------------------------
# the lowerings' calls of the GEMM epilogue and layer_norm kernels: a plain
# forward where no input requires grad, and differentiable by torch.autograd
# (a pipeline stage's forward) through the same kernels' launches
# ---------------------------------------------------------------------------


class _GemmBiasAct(torch.autograd.Function):
    """gemm_bias_act's (z, y) with their backward: dz = dz_in + dy *
    act'(z), dx = dz w^T, dw = x^T dz, db = the column sums of dz."""

    @staticmethod
    def forward(ctx, x2, w2, brow, act):
        z, y = gemm_epilogue.gemm_bias_act(x2, w2, brow, act=act)
        ctx.save_for_backward(x2, w2, z)
        ctx.act = act
        ctx.brow_shape = brow.shape
        return (z, y) if y is not None else (z, z.detach())

    @staticmethod
    def backward(ctx, dz, dy):
        x2, w2, z = ctx.saved_tensors
        g = torch.zeros_like(z, dtype=torch.float32) if dz is None else dz.float()
        if ctx.act is not None and dy is not None:
            with torch.enable_grad():
                zz = z.detach().float().requires_grad_(True)
                (ga,) = torch.autograd.grad(gemm_epilogue.ACT_F32[ctx.act](zz), zz, dy.float())
            g = g + ga
        g = g.to(x2.dtype)
        return (g @ w2.t(), x2.t() @ g, g.float().sum(0).reshape(ctx.brow_shape).to(x2.dtype),
                None)


class _LayerNorm(torch.autograd.Function):
    """fused_layer_norm's (s, y, mean, var), differentiable in x, the
    residual, scale and bias; its backward launches fused_layer_norm_grad."""

    @staticmethod
    def forward(ctx, x2, r2, scale, bias, eps):
        s, y, mean, var = layer_norm.fused_layer_norm(x2, r2, scale, bias, eps)
        ctx.save_for_backward(x2 if s is None else s, scale, mean, var)
        ctx.eps, ctx.residual, ctx.has_bias = eps, r2 is not None, bias is not None
        ctx.mark_non_differentiable(mean, var)
        return (x2 if s is None else s), y, mean, var

    @staticmethod
    def backward(ctx, ds, dy, dmean, dvar):
        xin, scale, mean, var = ctx.saved_tensors
        dx, dsc, db = layer_norm.fused_layer_norm_grad(
            xin, scale, mean, var, dy.to(xin.dtype).contiguous(), ctx.eps)
        if ds is not None:
            dx = dx + ds
        return (dx, dx if ctx.residual else None,
                None if scale is None else dsc.reshape(scale.shape).to(scale.dtype),
                db.reshape(-1).to(xin.dtype) if ctx.has_bias else None, None)


# ---------------------------------------------------------------------------
# fused lowerings
# ---------------------------------------------------------------------------


class _Shape2:
    """A shape standing in for a tensor in bcast_y."""

    def __init__(self, shape):
        self.shape = tuple(shape)

    def dim(self):
        return len(self.shape)


def _gemm_chain_views(prod, x, w):
    """(m, n, k, out_shape, split) 2-D views of the producer's operands, or
    None when the op form is outside the kernel's contract."""
    if prod.type in ("mul", "int8_mul"):
        xnc = int(prod.attrs.get("x_num_col_dims", 1))
        ync = int(prod.attrs.get("y_num_col_dims", 1))
        m = int(np.prod(x.shape[:xnc], dtype=np.int64)) if xnc else 1
        kx = x.numel() // max(m, 1)
        kw = int(np.prod(w.shape[:ync], dtype=np.int64)) if ync else 1
        n = w.numel() // max(kw, 1)
        out_shape = tuple(x.shape[:xnc]) + tuple(w.shape[ync:])
        split = xnc
    else:  # matmul
        if prod.attrs.get("transpose_X", False) or prod.attrs.get("transpose_Y", False):
            return None
        if float(prod.attrs.get("alpha", 1.0)) != 1.0:
            return None
        if x.dim() != 2 or w.dim() != 2:
            return None
        m, kx = x.shape
        kw, n = w.shape
        out_shape = (m, n)
        split = 1
    if kx != kw or m <= 0 or n <= 0 or kx <= 0:
        return None
    return m, n, kx, out_shape, split


@register_fused("gemm_epilogue")
def _fused_gemm_epilogue(ctx, ops, env):
    """mul|matmul -> elementwise_add [-> act] through gemm_bias_act. The
    intermediate env entries stay live for other consumers: the producer's
    Out is rebuilt as z - bias (grad ops list it as an input) and the add's
    Out is the kernel's exact pre-activation z."""
    if len(ops) not in (2, 3) or ops[0].type not in ("mul", "matmul"):
        return False
    if _rules_sharded(ctx, ops):
        return False
    prod, add = ops[0], ops[1]
    act_op = ops[2] if len(ops) == 3 else None
    if add.type != "elementwise_add":
        return False
    if act_op is not None and act_op.type not in gemm_epilogue.ACT_F32:
        return False
    if (
        add.input("X")[0] != prod.output("Out")[0]
        or (act_op is not None and act_op.input("X")[0] != add.output("Out")[0])
    ):
        return False
    x = env.get(prod.input("X")[0])
    w = env.get(prod.input("Y")[0])
    bias = env.get(add.input("Y")[0])
    if x is None or w is None or bias is None:
        return False
    if x.dtype != w.dtype or not torch.is_floating_point(x):
        return False
    views = _gemm_chain_views(prod, x, w)
    if views is None:
        return False
    m, n, k, out_shape, split = views
    if not gemm_path_taken(m, n, k):
        return False
    bview = bcast_y(_Shape2(out_shape), bias, int(add.attrs.get("axis", -1)))
    if any(d != 1 for d in bview.shape[:split]):
        return False  # bias varying over GEMM rows is outside the epilogue
    brow = bview.expand((1,) * split + tuple(out_shape[split:])).reshape(1, n)
    act = act_op.type if act_op is not None else None
    z2, y2 = _GemmBiasAct.apply(x.reshape(m, k), w.reshape(k, n), brow, act)
    env[add.output("Out")[0]] = z2.reshape(out_shape)
    env[prod.output("Out")[0]] = (
        (z2.float() - brow.float()).to(z2.dtype).reshape(out_shape)
    )
    if act_op is not None:
        env[act_op.output("Out")[0]] = y2.reshape(out_shape)
    note_dispatch("gemm_epilogue")
    return True


@register_fused("gemm_int8")
def _fused_quant_gemm(ctx, ops, env):
    """int8_mul -> fake_dequantize x2 [-> elementwise_add [-> act]] through
    quant_gemm_bias_act: the two chained per-tensor dequant multiplies
    collapse into ONE combined scale (computed on the device) applied to the
    i32 sums, and the bias and activation ride the same epilogue. The
    intermediate env entries are rebuilt algebraically from z (f32 inverses
    of the epilogue), so consumers outside the run stay correct."""
    if len(ops) not in (3, 4, 5) or ops[0].type != "int8_mul":
        return False
    if _rules_sharded(ctx, ops):
        return False
    prod, d1, d2 = ops[0], ops[1], ops[2]
    if (
        d1.type != "fake_dequantize_max_abs"
        or d2.type != "fake_dequantize_max_abs"
        or d1.input("X") != [prod.output("Out")[0]]
        or d2.input("X") != [d1.output("Out")[0]]
    ):
        return False
    add_op = act_op = None
    if len(ops) >= 4:
        add_op = ops[3]
        if add_op.type != "elementwise_add" or add_op.input("X") != [d2.output("Out")[0]]:
            return False
    if len(ops) == 5:
        act_op = ops[4]
        if (act_op.type not in gemm_epilogue.ACT_F32
                or act_op.input("X") != [add_op.output("Out")[0]]):
            return False
    x = env.get(prod.input("X")[0])
    w = env.get(prod.input("Y")[0])
    s1 = env.get(d1.input("Scale")[0])
    s2 = env.get(d2.input("Scale")[0])
    if x is None or w is None or s1 is None or s2 is None:
        return False
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        return False
    views = _gemm_chain_views(prod, x, w)
    if views is None:
        return False
    m, n, k, out_shape, split = views
    if not quant_gemm_path_taken(m, n, k, x.dtype):
        return False
    r1 = float(d1.attrs.get("max_range", 127.0))
    r2 = float(d2.attrs.get("max_range", 127.0))
    w_part = s2.reshape(()).float() / r2
    combined = (s1.reshape(()).float() / r1) * w_part
    brow = None
    if add_op is not None:
        bias = env.get(add_op.input("Y")[0])
        if bias is None:
            return False
        bview = bcast_y(_Shape2(out_shape), bias, int(add_op.attrs.get("axis", -1)))
        if any(d != 1 for d in bview.shape[:split]):
            return False
        brow = bview.expand((1,) * split + tuple(out_shape[split:])).reshape(1, n)
    z2, y2 = quant_gemm.quant_gemm_bias_act(
        x.reshape(m, k), w.reshape(k, n), combined, brow,
        act=act_op.type if act_op is not None else None,
    )
    pre = z2 if brow is None else z2 - brow.float()
    env[prod.output("Out")[0]] = (pre / combined).reshape(out_shape)
    env[d1.output("Out")[0]] = (pre / torch.clamp(w_part, min=1e-30)).reshape(out_shape)
    env[d2.output("Out")[0]] = pre.reshape(out_shape)
    if add_op is not None:
        env[add_op.output("Out")[0]] = z2.reshape(out_shape)
    if act_op is not None:
        env[act_op.output("Out")[0]] = y2.reshape(out_shape)
    note_dispatch("gemm_int8")
    return True


def _ln_view(op, x):
    bna = int(op.attrs.get("begin_norm_axis", 1))
    rows = int(np.prod(x.shape[:bna], dtype=np.int64)) if bna else 1
    return rows, x.numel() // max(rows, 1)


@register_fused("layer_norm")
def _fused_layer_norm(ctx, ops, env):
    """[elementwise_add ->] layer_norm through fused_layer_norm. The residual
    form requires strictly equal operand shapes (the pre_post_process "dan"
    chain); anything else declines to per-op."""
    ln = ops[-1]
    if ln.type != "layer_norm" or len(ops) > 2:
        return False
    if _rules_sharded(ctx, ops):
        return False
    add = ops[0] if len(ops) == 2 else None
    if add is not None:
        if add.type != "elementwise_add" or add.output("Out")[0] != ln.input("X")[0]:
            return False
        x_full = env.get(add.input("X")[0])
        residual_full = env.get(add.input("Y")[0])
        if (
            x_full is None or residual_full is None
            or x_full.shape != residual_full.shape
            or x_full.dtype != residual_full.dtype
        ):
            return False
    else:
        x_full = env.get(ln.input("X")[0])
        residual_full = None
        if x_full is None:
            return False
    rows, cols = _ln_view(ln, x_full)
    if not ln_path_taken(rows, cols, x_full.element_size()):
        return False
    # NOT gather_op_inputs: in the residual form, ln's X is the add's Out,
    # which by design has no env entry yet (the fused kernel produces it)
    scale_names = ln.inputs.get("Scale") or []
    bias_names = ln.inputs.get("Bias") or []
    scale = env.get(scale_names[0]) if scale_names else None
    bias = env.get(bias_names[0]) if bias_names else None
    args = (x_full.reshape(rows, cols),
            None if residual_full is None else residual_full.reshape(rows, cols),
            scale, bias, ln.attrs.get("epsilon", 1e-5))
    s2, y2, mean, var = _LayerNorm.apply(*args)
    if add is not None:
        env[add.output("Out")[0]] = s2.reshape(x_full.shape)
    outs = {"Y": [y2.reshape(x_full.shape)], "Mean": [mean], "Variance": [var]}
    scatter_op_outputs(ln, outs, env)
    note_dispatch("layer_norm")
    return True


@register_fused("layer_norm_grad")
def _fused_layer_norm_grad(ctx, ops, env):
    """layer_norm_grad through the explicit backward kernel against the saved
    Mean/Variance. Declines when someone differentiates through the stats
    themselves (Mean@GRAD / Variance@GRAD cotangents)."""
    if len(ops) != 1 or ops[0].type != "layer_norm_grad":
        return False
    if _rules_sharded(ctx, ops):
        return False
    op = ops[0]
    ins = gather_op_inputs(op, env)
    if (
        ins.get("Mean@GRAD", [None])[0] is not None
        or ins.get("Variance@GRAD", [None])[0] is not None
    ):
        return False
    x = ins.get("X", [None])[0]
    dy = ins.get("Y@GRAD", [None])[0]
    mean = ins.get("Mean", [None])[0]
    var = ins.get("Variance", [None])[0]
    if x is None or dy is None or mean is None or var is None:
        return False
    rows, cols = _ln_view(op, x)
    if not ln_path_taken(rows, cols, x.element_size()):
        return False
    scale = ins.get("Scale", [None])[0]
    dx, ds, db = layer_norm.fused_layer_norm_grad(
        x.reshape(rows, cols), scale, mean, var,
        dy.reshape(rows, cols).to(x.dtype), op.attrs.get("epsilon", 1e-5),
    )
    outs = {"X@GRAD": [dx.reshape(x.shape)]}
    if scale is not None and "Scale@GRAD" in op.outputs:
        outs["Scale@GRAD"] = [ds.reshape(scale.shape).to(scale.dtype)]
    bias = ins.get("Bias", [None])[0]
    if bias is not None and "Bias@GRAD" in op.outputs:
        outs["Bias@GRAD"] = [db.reshape(bias.shape).to(bias.dtype)]
    scatter_op_outputs(op, outs, env)
    note_dispatch("layer_norm_grad")
    return True


_ADAM_SLOTS = ("Param", "Grad", "Moment1", "Moment2", "LearningRate", "Beta1Pow", "Beta2Pow")
_ADAM_INPLACE = (("ParamOut", "Param"), ("Moment1Out", "Moment1"), ("Moment2Out", "Moment2"))


@register_fused("multi_adam")
def _fused_multi_adam(ctx, ops, env):
    """A contiguous run of dense adam ops through ONE multi_tensor_adam call
    per (param, grad, moment) dtype signature. lr_t (bias correction) is
    computed on the device with the exact _adam expressions,
    lr * sqrt(1 - beta2_pow) / (1 - beta1_pow), for the whole run at once:
    no host sync. Params and moments are updated in place where ParamOut /
    MomentOut name the input vars, as AdamOptimizer always emits them; an
    op whose outputs name other vars updates copies."""
    if _rules_sharded(ctx, ops):
        return False
    if len(ops) < 2 or any(op.type != "adam" for op in ops):
        return False
    a0 = ops[0].attrs
    b1 = a0.get("beta1", 0.9)
    b2 = a0.get("beta2", 0.999)
    eps = a0.get("epsilon", 1e-8)
    recs = []
    for op in ops:
        a = op.attrs
        if (
            a.get("beta1", 0.9) != b1
            or a.get("beta2", 0.999) != b2
            or a.get("epsilon", 1e-8) != eps
        ):
            return False
        ins = gather_op_inputs(op, env)
        vals = [ins.get(s, [None])[0] for s in _ADAM_SLOTS]
        if any(v is None for v in vals):
            return False
        recs.append((op, vals))
    if not adam_path_taken(len(recs)):
        return False
    lr, b1p, b2p = (
        torch.cat([v[i].reshape(1).float() for _, v in recs]) for i in (4, 5, 6)
    )
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    by_dtype = {}
    for i, (op, (p, g, m1, m2, _, _, _)) in enumerate(recs):
        state = []
        for (out_slot, in_slot), t in zip(_ADAM_INPLACE, (p, m1, m2)):
            inplace = op.output(out_slot)[0] == op.input(in_slot)[0]
            state.append(t if inplace and t.is_contiguous() else t.clone(
                memory_format=torch.contiguous_format))
        key = (p.dtype, g.dtype, m1.dtype, m2.dtype)
        by_dtype.setdefault(key, []).append((op, i, state, g.contiguous()))
    for dkey, group in by_dtype.items():
        # a group's lr_t rows and pointer table are uploaded once, into the
        # prepared block's cache, where a replayed CUDA graph finds them
        cache = ctx.cache.setdefault(("multi_adam", id(ops[0]), dkey), {})
        lr_g = lr_t
        if len(group) != len(recs):
            idx = cache.get("idx")
            if idx is None:
                idx = cache["idx"] = torch.tensor([r[1] for r in group], device=lr_t.device)
            lr_g = lr_t[idx]
        multi_adam.multi_tensor_adam(
            [r[2][0] for r in group], [r[3] for r in group],
            [r[2][1] for r in group], [r[2][2] for r in group],
            lr_g, b1, b2, eps, table_cache=cache.setdefault("table", {}),
        )
        for op, _, (po, m1o, m2o), _ in group:
            scatter_op_outputs(
                op, {"ParamOut": [po], "Moment1Out": [m1o], "Moment2Out": [m2o]}, env
            )
    note_dispatch("multi_adam")
    return True
