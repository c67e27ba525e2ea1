"""Core operator lowerings: the ops the GPTDecoder programs, the Transformer
and CNN training programs and their startup programs emit (the torch
counterparts of paddle_tpu/ops/core_ops.py): dense math, the elementwise
ops and activations, losses, metrics, tensor ops, conv2d / pool2d /
batch_norm, and the optimizers from sgd through ftrl.

Each lowering is a plain function over slot-keyed torch tensors; the
executor calls them in program order. `mul`, `matmul` and `conv2d` stay
library calls (torch.matmul, cuDNN): the JAX package computes them outside
any Pallas kernel too. Under FLAGS_fp8_matmul the products take
quant_gemm.fp8_matmul (hand-written e4m3 kernels on the card), as the JAX
package's take pallas_kernels.fp8_matmul. f32 products run in full f32:
every run on the card turns TF32 off and asks cuDNN for deterministic
algorithms (registry.LowerCtx), and the parity tolerances and the
graph-against-op-by-op bit identity assume it.

Gradients: most ops use the registry's generic torch.func.vjp grad. Custom
grads exist where the JAX package has them: dropout reuses its sampled Mask,
softmax_with_cross_entropy differentiates from the saved Softmax, and
lookup_table and embedding scatter their cotangent rows in f32 (or, with
is_sparse, emit a SelectedRows pair: ops/sparse_ops.py). conv2d and
batch_norm have explicit grads (one aten backward call each, without
replaying the forward), which XLA's CSE gives the JAX package for free.

Dtype policy: float64 -> float32 and int64 -> int32 are canonicalized at the
framework boundary, as in the JAX package, so the same Program declares the
same var dtypes in both.
"""

import functools

import numpy as np
import torch

from .gemm_epilogue import ACT_F32
from .registry import EMPTY_VAR_NAME, bcast_y, prod, register, register_no_lower, torch_dtype

register_no_lower("feed")
register_no_lower("fetch")


def _shape(attrs):
    return [int(s) for s in attrs["shape"]]


def _random(ctx, attrs, sample):
    """Fill an f32 tensor by `sample(t, generator)` and cast it. In a
    startup program (ctx.host_random) t lies on the CPU and the values move
    to the run's device, so a seed gives the same parameters on every
    device; the generator is the run's, or a new one when the op pins a
    seed. In any other block t lies on the run's device and the generator
    is the run's device generator, or the op's own when it pins a seed
    (restarted every run), as for dropout: a replayed CUDA graph draws
    fresh values there, where a host draw could not be copied in. Shape
    inference (meta device) draws nothing."""
    shape = _shape(attrs)
    dt = torch_dtype(attrs.get("dtype", "float32"))
    if ctx.device.type == "meta":
        return {"Out": [torch.empty(shape, dtype=dt, device="meta")]}
    seed = int(attrs.get("seed", 0) or 0)
    if ctx.host_random:
        gen = torch.Generator().manual_seed(seed) if seed else ctx.generator
        out = sample(torch.empty(shape), gen)
    else:
        gen = ctx.seeded_generator(seed) if seed else ctx.device_generator
        out = sample(torch.empty(shape, device=ctx.device), gen)
    return {"Out": [out.to(device=ctx.device, dtype=dt)]}


# ---------------------------------------------------------------------------
# creation / random ops (reference: fill_constant_op.cc, uniform_random_op.cc,
# gaussian_random_op.cc, truncated_gaussian_random_op.cc, assign_value_op.cc)
# ---------------------------------------------------------------------------


@register("fill_constant", no_grad=True)
def _fill_constant(ctx, ins, attrs):
    dt = torch_dtype(attrs.get("dtype", "float32"))
    out = torch.full(_shape(attrs), attrs.get("value", 0.0), dtype=dt, device=ctx.device)
    return {"Out": [out]}


@register("uniform_random", no_grad=True, stochastic=True)
def _uniform_random(ctx, ins, attrs):
    lo, hi = float(attrs.get("min", -1.0)), float(attrs.get("max", 1.0))
    return _random(
        ctx, attrs,
        lambda t, g: t.uniform_(lo, hi, generator=g),
    )


@register("gaussian_random", no_grad=True, stochastic=True)
def _gaussian_random(ctx, ins, attrs):
    mean, std = float(attrs.get("mean", 0.0)), float(attrs.get("std", 1.0))
    return _random(
        ctx, attrs,
        lambda t, g: t.normal_(mean, std, generator=g),
    )


@register("truncated_gaussian_random", no_grad=True, stochastic=True)
def _truncated_gaussian_random(ctx, ins, attrs):
    # standard normal truncated to [-2, 2], then scaled: the JAX package's
    # jax.random.truncated_normal(-2, 2) contract
    mean, std = float(attrs.get("mean", 0.0)), float(attrs.get("std", 1.0))
    return _random(
        ctx, attrs,
        lambda t, g: mean + std * torch.nn.init.trunc_normal_(
            t, 0.0, 1.0, -2.0, 2.0, generator=g
        ),
    )


@register("assign_value", no_grad=True)
def _assign_value(ctx, ins, attrs):
    dt = torch_dtype(attrs.get("dtype", "float32"))
    vals = np.asarray(attrs["values"]).reshape(_shape(attrs))
    if ctx.device.type == "meta":
        return {"Out": [torch.empty(vals.shape, dtype=dt, device="meta")]}
    # uploaded at the op's first run only: a replayed graph reads it there
    return {"Out": [ctx.op_constant(
        lambda: torch.as_tensor(vals).to(device=ctx.device, dtype=dt))]}


@register("assign")
def _assign(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [x]}


@register("fill_zeros_like", no_grad=True)
def _fill_zeros_like(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [torch.zeros_like(x)]}


@register("fill_constant_batch_size_like", no_grad=True)
def _fill_constant_bsl(ctx, ins, attrs):
    (ref,) = ins["Input"]
    shape = _shape(attrs)
    shape[int(attrs.get("output_dim_idx", 0))] = ref.shape[int(attrs.get("input_dim_idx", 0))]
    dt = torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.full(shape, attrs.get("value", 0.0), dtype=dt, device=ref.device)]}


@register("cast")
def _cast(ctx, ins, attrs):
    (x,) = ins["X"]
    # a float to int cast truncates toward zero, as astype does
    return {"Out": [x.to(torch_dtype(attrs["out_dtype"]))]}


@register("shape", no_grad=True)
def _shape_op(ctx, ins, attrs):
    (x,) = ins["Input"]
    # filled on the device, element by element: a replayed graph cannot
    # copy a host list in
    out = torch.empty((x.dim(),), dtype=torch.int32, device=x.device)
    for i, d in enumerate(x.shape):
        out[i] = int(d)
    return {"Out": [out]}


@register("increment")
def _increment(ctx, ins, attrs):
    (x,) = ins["X"]
    step = attrs.get("step", 1.0)
    return {"Out": [x + (step if torch.is_floating_point(x) else int(step))]}


@register("clip")
def _clip(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [torch.clamp(x, attrs["min"], attrs["max"])]}


@register("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs):
    (x,) = ins["X"]
    max_norm = attrs["max_norm"]
    x32 = x.float()
    norm = torch.sqrt(torch.sum(x32 ** 2))
    scale = torch.where(norm > max_norm, max_norm / torch.clamp(norm, min=1e-12),
                        torch.ones_like(norm))
    return {"Out": [(x32 * scale).to(x.dtype)]}


@register("squared_l2_norm")
def _squared_l2_norm(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [torch.sum(x.float() ** 2).reshape((1,)).to(x.dtype)]}


# ---------------------------------------------------------------------------
# dense math (reference: mul_op.cc, matmul_op.cc)
# ---------------------------------------------------------------------------


def _fp8_matmul_taken(x, y):
    """FLAGS_fp8_matmul dtype policy of the dense product lowerings (the JAX
    package's): floating operands contract as float8_e4m3fn with f32 sums
    (quant_gemm.fp8_matmul); integer and bool operands keep the native
    product whatever the flag."""
    from .. import flags as _flags

    if not _flags.get_flags("fp8_matmul")["fp8_matmul"]:
        return False
    return torch.is_floating_point(x) and torch.is_floating_point(y)


def _product(ctx, x, y):
    """x @ y, through fp8_matmul where the flag takes the operands (each such
    product one matmul_fp8 dispatch, as in the JAX package)."""
    if ctx.device.type != "meta" and _fp8_matmul_taken(x, y):
        from . import fused, quant_gemm

        fused.note_dispatch("matmul_fp8")
        return quant_gemm.fp8_matmul(x, y)
    return torch.matmul(x, y)


@register("mul")
def _mul(ctx, ins, attrs):
    (x,) = ins["X"]
    (y,) = ins["Y"]
    xnc = int(attrs.get("x_num_col_dims", 1))
    ync = int(attrs.get("y_num_col_dims", 1))
    x2 = x.reshape(prod(x.shape[:xnc]), -1)
    y2 = y.reshape(prod(y.shape[:ync]), -1)
    out = _product(ctx, x2, y2)
    return {"Out": [out.reshape(tuple(x.shape[:xnc]) + tuple(y.shape[ync:]))]}


@register("matmul")
def _matmul(ctx, ins, attrs):
    (x,) = ins["X"]
    (y,) = ins["Y"]
    alpha = attrs.get("alpha", 1.0)
    if x.dim() == 1:
        x = x[None, :]
    if y.dim() == 1:
        y = y[:, None]
    if attrs.get("transpose_X", False):
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False):
        y = y.transpose(-1, -2)
    out = _product(ctx, x, y)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}


# ---------------------------------------------------------------------------
# elementwise binary with paddle axis-broadcast, activations, softmax
# ---------------------------------------------------------------------------


def _register_elementwise(name, fn):
    @register(name)
    def _lower(ctx, ins, attrs, _fn=fn):
        (x,) = ins["X"]
        (y,) = ins["Y"]
        y = bcast_y(x, y, int(attrs.get("axis", -1)))
        return {"Out": [_fn(x, y)]}


_register_elementwise("elementwise_add", torch.add)
_register_elementwise("elementwise_sub", torch.sub)
_register_elementwise("elementwise_mul", torch.mul)
_register_elementwise("elementwise_div", torch.div)
_register_elementwise("elementwise_min", torch.minimum)
_register_elementwise("elementwise_max", torch.maximum)
_register_elementwise("elementwise_pow", torch.pow)
# jnp.mod and jnp.floor_divide round toward minus infinity, as these do
_register_elementwise("elementwise_mod", torch.remainder)
_register_elementwise("elementwise_floordiv", torch.floor_divide)


@register("sum")
def _sum(ctx, ins, attrs):
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@register("scale")
def _scale(ctx, ins, attrs):
    (x,) = ins["X"]
    s, b = attrs.get("scale", 1.0), attrs.get("bias", 0.0)
    if not torch.is_floating_point(x):
        # jnp.asarray(value, int dtype) truncates toward zero
        s, b = int(s), int(b)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * s + b]}
    return {"Out": [(x + b) * s]}


@register("mean")
def _mean(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [torch.mean(x).reshape((1,))]}


def _register_reduce(name, fn):
    @register(name)
    def _lower(ctx, ins, attrs, _fn=fn):
        (x,) = ins["X"]
        dims = attrs.get("dim", [0])
        if isinstance(dims, int):
            dims = [dims]
        if attrs.get("reduce_all", False):
            return {"Out": [_fn(x, None, False).reshape((1,))]}
        out = _fn(x, tuple(d % x.dim() for d in dims), bool(attrs.get("keep_dim", False)))
        if out.dim() == 0:
            out = out.reshape((1,))
        return {"Out": [out]}


def _reduce_prod(x, dims, keep):
    if dims is None:
        return torch.prod(x)
    for d in sorted(dims, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keep)
    return x


def _all_dims(fn):
    return lambda x, dims, keep: fn(x) if dims is None else fn(x, dim=dims, keepdim=keep)


_register_reduce("reduce_sum", _all_dims(torch.sum))
_register_reduce("reduce_mean", _all_dims(torch.mean))
_register_reduce("reduce_max", _all_dims(torch.amax))
_register_reduce("reduce_min", _all_dims(torch.amin))
_register_reduce("reduce_prod", _reduce_prod)


def _register_act(name, fn):
    @register(name)
    def _lower(ctx, ins, attrs, _fn=fn):
        (x,) = ins["X"]
        return {"Out": [_fn(x, attrs)]}


# the activations the fused GEMM epilogue also applies, from one table
# (gelu is the erf form, jax.nn.gelu(approximate=False))
for _name, _fn in ACT_F32.items():
    _register_act(_name, lambda x, a, _f=_fn: _f(x))


def _where0(cond, x):
    return torch.where(cond, x, torch.zeros((), dtype=x.dtype, device=x.device))


# the rest of the JAX package's _register_act table (core_ops.py:282-332),
# the same expressions and attr defaults
_register_act("logsigmoid", lambda x, a: torch.nn.functional.logsigmoid(x))
_register_act("tanh_shrink", lambda x, a: x - torch.tanh(x))
_register_act("sqrt", lambda x, a: torch.sqrt(x))
_register_act("abs", lambda x, a: torch.abs(x))
_register_act("ceil", lambda x, a: torch.ceil(x))
_register_act("floor", lambda x, a: torch.floor(x))
_register_act("cos", lambda x, a: torch.cos(x))
_register_act("sin", lambda x, a: torch.sin(x))
_register_act("round", lambda x, a: torch.round(x))  # half to even, as jnp.round
_register_act("reciprocal", lambda x, a: 1.0 / x)
_register_act("exp", lambda x, a: torch.exp(x))
_register_act("log", lambda x, a: torch.log(x))
_register_act("square", lambda x, a: torch.square(x))
# jax.nn.softplus is logaddexp(x, 0), with no linear cut-off past a threshold
_register_act("softplus", lambda x, a: torch.logaddexp(x, torch.zeros_like(x)))
_register_act("softsign", lambda x, a: x / (1 + torch.abs(x)))
_register_act("softshrink", lambda x, a: torch.sign(x) * torch.clamp(
    torch.abs(x) - a.get("lambda", 0.5), min=0))
_register_act("hard_shrink", lambda x, a: _where0(torch.abs(x) > a.get("threshold", 0.5), x))
_register_act("brelu", lambda x, a: torch.clamp(x, a.get("t_min", 0.0), a.get("t_max", 24.0)))
_register_act("leaky_relu", lambda x, a: torch.where(x >= 0, x, x * a.get("alpha", 0.02)))
_register_act("soft_relu", lambda x, a: torch.log1p(torch.exp(torch.clamp(
    x, -a.get("threshold", 40.0), a.get("threshold", 40.0)))))
_register_act("elu", lambda x, a: torch.where(
    x >= 0, x, a.get("alpha", 1.0) * (torch.exp(x) - 1)))
_register_act("relu6", lambda x, a: torch.clamp(x, 0, a.get("threshold", 6.0)))
_register_act("pow", lambda x, a: torch.pow(x, a.get("factor", 1.0)))
_register_act("stanh", lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
    a.get("scale_a", 0.67) * x))
_register_act("hard_sigmoid", lambda x, a: torch.clamp(
    a.get("slope", 0.2) * x + a.get("offset", 0.5), 0.0, 1.0))
_register_act("swish", lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x))
_register_act("thresholded_relu", lambda x, a: _where0(x > a.get("threshold", 1.0), x))
_register_act("rsqrt", lambda x, a: torch.rsqrt(x))
_register_act("sign", lambda x, a: torch.sign(x))


@register("softmax")
def _softmax(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [torch.softmax(x, dim=-1)]}


def _softmax_ce_grad_maker(op, block, grad_map):
    outputs = {}
    logits_g = grad_map.get(op.input("Logits")[0])
    if logits_g:
        outputs["Logits@GRAD"] = [logits_g]
    # soft labels are float and may carry gradient (e.g. via label_smooth)
    lbl_g = (
        grad_map.get(op.input("Label")[0])
        if op.attrs.get("soft_label", False)
        else None
    )
    if lbl_g:
        outputs["Label@GRAD"] = [lbl_g]
    if not outputs:
        return []
    inputs = {
        "Softmax": [op.output("Softmax")[0]],
        "Label": [op.input("Label")[0]],
    }
    # Loss may carry no gradient (only the Softmax output consumed
    # downstream); the grad lowering treats a missing dloss as zeros
    loss_g = grad_map.get(op.output("Loss")[0])
    if loss_g:
        inputs["Loss@GRAD"] = [loss_g]
    # a downstream consumer of the Softmax output contributes through the
    # softmax Jacobian as well
    sm_g = grad_map.get(op.output("Softmax")[0])
    if sm_g:
        inputs["Softmax@GRAD"] = [sm_g]
    return [
        {
            "type": "softmax_with_cross_entropy_grad",
            "inputs": inputs,
            "outputs": outputs,
            "attrs": {k: v for k, v in op.attrs.items()},
        }
    ]


@register("softmax_with_cross_entropy", grad=_softmax_ce_grad_maker)
def _softmax_with_ce(ctx, ins, attrs):
    """Numerically safe CE in the input dtype, from the log-partition
    z = max + lse and a gather on the raw logits (the JAX lowering's
    expressions). With smooth_eps, exact uniform label smoothing without a
    [N, V] one-hot: (1-eps)(z - logit_y) + eps (z - mean_j logit_j)."""
    (logits,) = ins["Logits"]
    (label,) = ins["Label"]
    m = torch.amax(logits, dim=-1, keepdim=True)
    sh = (logits - m).float()
    lse = torch.log(torch.sum(torch.exp(sh), dim=-1, keepdim=True))
    softmax = torch.exp(sh - lse).to(logits.dtype)
    z = m.float() + lse  # log partition
    if attrs.get("soft_label", False):
        s_lbl = torch.sum(label.float(), dim=-1, keepdim=True)
        s_ll = torch.sum(label.float() * logits.float(), dim=-1, keepdim=True)
        loss = z * s_lbl - s_ll
    else:
        lbl = label.reshape(label.shape[:-1]).long()
        picked = torch.gather(logits, -1, lbl[..., None].clamp(min=0)).float()
        eps = float(attrs.get("smooth_eps", 0.0) or 0.0)
        if eps:
            mean_l = torch.mean(logits.float(), dim=-1, keepdim=True)
            loss = (1.0 - eps) * (z - picked) + eps * (z - mean_l)
        else:
            loss = z - picked
        ignore = int(attrs.get("ignore_index", -100))
        loss = torch.where(lbl[..., None] == ignore, torch.zeros_like(loss), loss)
    return {"Softmax": [softmax], "Loss": [loss.to(logits.dtype)]}


@register("softmax_with_cross_entropy_grad", no_grad=True)
def _softmax_with_ce_grad(ctx, ins, attrs):
    """Closed-form CE backward from the SAVED Softmax (reference
    softmax_with_cross_entropy_op.h CrossEntropyGrad): dlogits =
    dloss * (softmax - target), no forward recompute."""
    dloss = ins.get("Loss@GRAD", [None])[0]  # [N, 1] or absent (zeros)
    (softmax,) = ins["Softmax"]  # [N, V]
    (label,) = ins["Label"]
    dsm = ins.get("Softmax@GRAD", [None])[0]
    v = softmax.shape[-1]
    result = {}
    if attrs.get("soft_label", False):
        s_lbl = torch.sum(label, dim=-1, keepdim=True).to(softmax.dtype)
        d = softmax * s_lbl - label.to(softmax.dtype)
        # dloss/dlabel_j = -logp_j, from the saved softmax
        neg_logp = -torch.log(torch.clamp(softmax.float(), min=1e-38))
        dl32 = (
            dloss.float()
            if dloss is not None
            else torch.zeros(softmax.shape[:-1] + (1,), device=softmax.device)
        )
        result["Label@GRAD"] = [(dl32 * neg_logp).to(label.dtype)]
    else:
        lbl = label.reshape(label.shape[:-1]).long()
        iota = torch.arange(v, device=softmax.device)
        onehot = iota == lbl[..., None]
        eps = float(attrs.get("smooth_eps", 0.0) or 0.0)
        if eps:
            tgt = (1.0 - eps) * onehot.float() + eps / v
            d = (softmax.float() - tgt).to(softmax.dtype)
        else:
            d = softmax - onehot.to(softmax.dtype)
        ignore = int(attrs.get("ignore_index", -100))
        d = torch.where((lbl != ignore)[..., None], d, torch.zeros_like(d))
    out = d * dloss.to(d.dtype) if dloss is not None else torch.zeros_like(softmax)
    if dsm is not None:
        # Jacobian of softmax applied to the Softmax output's own cotangent:
        # J^T dS = s * (dS - <dS, s>)
        s32 = softmax.float()
        dsm32 = dsm.float()
        inner = torch.sum(dsm32 * s32, dim=-1, keepdim=True)
        out = out + (s32 * (dsm32 - inner)).to(out.dtype)
    result["Logits@GRAD"] = [out]
    return result


@register("log_softmax")
def _log_softmax(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [torch.log_softmax(x, dim=int(attrs.get("axis", -1)))]}


@register("cross_entropy")
def _cross_entropy(ctx, ins, attrs):
    """-log of the probability at the label (or the soft-label sum), the
    probabilities clamped at 1e-20 (the JAX lowering)."""
    (x,) = ins["X"]
    (label,) = ins["Label"]
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * torch.log(torch.clamp(x, min=1e-20)), dim=-1, keepdim=True)
    else:
        lbl = label.reshape(label.shape[:-1]).long()
        picked = torch.gather(x, -1, lbl[..., None])
        loss = -torch.log(torch.clamp(picked, min=1e-20))
    return {"Y": [loss]}


@register("sigmoid_cross_entropy_with_logits")
def _sigmoid_ce(ctx, ins, attrs):
    """max(x, 0) - x * label + log1p(exp(-|x|)), the stable form; 0 where
    label == ignore_index."""
    (x,) = ins["X"]
    (label,) = ins["Label"]
    loss = torch.clamp(x, min=0) - x * label + torch.log1p(torch.exp(-torch.abs(x)))
    ignore = attrs.get("ignore_index", -100)
    loss = torch.where(label == ignore, torch.zeros((), dtype=loss.dtype, device=loss.device),
                       loss)
    return {"Out": [loss]}


@register("square_error_cost")
def _square_error_cost(ctx, ins, attrs):
    (x,) = ins["X"]
    (y,) = ins["Y"]
    return {"Out": [torch.square(x - y)]}


# ---------------------------------------------------------------------------
# argmax / top_k / sort / cumsum and the metrics (reference arg_max_op.cc,
# top_k_op.cc, argsort_op.cc, cumsum_op.cc, metrics/accuracy_op.cc,
# metrics/auc_op.cc)
# ---------------------------------------------------------------------------


@register("arg_max", no_grad=True)
def _arg_max(ctx, ins, attrs):
    (x,) = ins["X"]
    # the first index of the largest value, as jnp.argmax
    return {"Out": [torch.argmax(x, dim=int(attrs.get("axis", -1))).to(torch.int32)]}


@register("arg_min", no_grad=True)
def _arg_min(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [torch.argmin(x, dim=int(attrs.get("axis", -1))).to(torch.int32)]}


def stable_top_k(x, k):
    """(values, indices) of the k largest along the last axis, tied values
    in index order (as lax.top_k; torch.topk leaves the order of ties
    open), from a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register("top_k", no_grad=True)
def _top_k(ctx, ins, attrs):
    (x,) = ins["X"]
    vals, idx = stable_top_k(x, int(attrs["k"]))
    return {"Out": [vals], "Indices": [idx.to(torch.int32)]}


@register("argsort", no_grad=True)
def _argsort(ctx, ins, attrs):
    (x,) = ins["X"]
    vals, idx = torch.sort(x, dim=int(attrs.get("axis", -1)), stable=True)
    return {"Out": [vals], "Indices": [idx.to(torch.int32)]}


@register("cumsum")
def _cumsum(ctx, ins, attrs):
    (x,) = ins["X"]
    axis = int(attrs.get("axis", -1)) % x.dim()
    rev = attrs.get("reverse", False)
    out = torch.cumsum(torch.flip(x, (axis,)) if rev else x, dim=axis)
    if rev:
        out = torch.flip(out, (axis,))
    if attrs.get("exclusive", False):
        pad = [0, 0] * (x.dim() - 1 - axis) + [1, 0]
        out = torch.nn.functional.pad(out, pad).narrow(axis, 0, x.shape[axis])
    return {"Out": [out]}


@register("accuracy", no_grad=True)
def _accuracy(ctx, ins, attrs):
    """Top-k accuracy from top_k's Indices: Accuracy (f32), Correct and
    Total (int32), each of shape [1]."""
    (indices,) = ins["Indices"]
    (label,) = ins["Label"]
    correct = torch.any(indices == label.to(indices.dtype), dim=-1)
    num_correct = torch.sum(correct.float())
    total = indices.shape[0]
    return {
        "Accuracy": [(num_correct / total).reshape((1,))],
        "Correct": [num_correct.to(torch.int32).reshape((1,))],
        "Total": [torch.full((1,), total, dtype=torch.int32, device=indices.device)],
    }


@register("auc", no_grad=True)
def _auc(ctx, ins, attrs):
    """Streaming AUC (reference metrics/auc_op.cc, the JAX lowering's
    expressions): positives and negatives histogrammed into threshold
    buckets and added to StatPos / StatNeg, the area by the trapezoidal
    rule over the descending cumulative counts."""
    (predict,) = ins["Predict"]
    (label,) = ins["Label"]
    stat_pos, stat_neg = ins["StatPos"][0], ins["StatNeg"][0]
    n = int(attrs.get("num_thresholds", 4095))
    bucket = torch.clamp((predict[:, -1] * n).to(torch.int32), 0, n).long()
    is_pos = (label.reshape(-1) > 0).float()
    zeros = torch.zeros(n + 1, dtype=torch.float32, device=predict.device)
    pos_hist = zeros.index_put((bucket,), is_pos, accumulate=True)
    neg_hist = zeros.index_put((bucket,), 1.0 - is_pos, accumulate=True)
    sp = stat_pos + pos_hist
    sn = stat_neg + neg_hist
    tp = torch.cumsum(torch.flip(sp, (0,)), 0)
    fp = torch.cumsum(torch.flip(sn, (0,)), 0)
    tot_pos, tot_neg = tp[-1], fp[-1]
    tp0 = torch.cat([zeros[:1], tp[:-1]])
    fp0 = torch.cat([zeros[:1], fp[:-1]])
    area = torch.sum((fp - fp0) * (tp + tp0) / 2.0)
    auc = torch.where(tot_pos * tot_neg > 0, area / (tot_pos * tot_neg + 1e-12),
                      torch.zeros_like(area))
    return {"AUC": [auc.reshape((1,))], "StatPosOut": [sp], "StatNegOut": [sn]}


# ---------------------------------------------------------------------------
# shape manipulation and lookup (reference: reshape_op.cc, transpose_op.cc,
# gather_op.cc, lookup_table_op.cc)
# ---------------------------------------------------------------------------


def _reshape_shape(x, shape_attr):
    shape = [int(s) for s in shape_attr]
    # paddle semantics: 0 means copy input dim at that position
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    return shape


def _xshape(x):
    return x.new_zeros((0,) + tuple(x.shape))


@register("reshape")
def _reshape(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [x.reshape(_reshape_shape(x, attrs["shape"]))]}


@register("reshape2")
def _reshape2(ctx, ins, attrs):
    (x,) = ins["X"]
    out = x.reshape(_reshape_shape(x, attrs["shape"]))
    return {"Out": [out], "XShape": [_xshape(x)]}


@register("transpose")
def _transpose(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [x.permute(*attrs["axis"])]}


@register("transpose2")
def _transpose2(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [x.permute(*attrs["axis"])], "XShape": [_xshape(x)]}


@register("concat")
def _concat(ctx, ins, attrs):
    return {"Out": [torch.cat(list(ins["X"]), dim=int(attrs.get("axis", 0)))]}


@register("flatten")
def _flatten(ctx, ins, attrs):
    (x,) = ins["X"]
    axis = int(attrs.get("axis", 1))
    lead = prod(x.shape[:axis]) if axis > 0 else 1
    return {"Out": [x.reshape(lead, -1)]}


@register("flatten2")
def _flatten2(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": _flatten(ctx, ins, attrs)["Out"], "XShape": [_xshape(x)]}


@register("one_hot", no_grad=True)
def _one_hot(ctx, ins, attrs):
    """f32 rows; an id outside [0, depth) gives a zero row, as
    jax.nn.one_hot does."""
    (x,) = ins["X"]
    depth = int(attrs["depth"])
    flat = x.reshape(x.shape[:-1]) if x.shape[-1] == 1 else x
    iota = torch.arange(depth, device=x.device)
    return {"Out": [(flat.long()[..., None] == iota).float()]}


_XXH_PRIMES = (2654435761, 2246822519, 3266489917, 668265263, 374761393)
_U32 = 0xFFFFFFFF


def _mul_u32(a, p):
    """(a * p) mod 2^32 for int64 tensors a in [0, 2^32) and a constant p,
    without int64 overflow: p split into 16-bit halves."""
    lo, hi = p & 0xFFFF, p >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _U32


def _rotl_u32(v, r):
    return ((v << r) | (v >> (32 - r))) & _U32


@register("hash", no_grad=True)
def _hash(ctx, ins, attrs):
    """Feature hashing of integer id rows (reference hash_op.cc): ids ->
    num_hash buckets in [0, mod_by), the JAX package's XXH32 (the <16-byte
    tail path: a per-4-byte-lane mix and the avalanche) computed in int64
    tensors masked to 32 bits after every multiply and add, bit for bit the
    JAX op's wrapped uint32 arithmetic. Each id hashes as 8 bytes: its low
    32 bits, then `col >> 32` for an int64 column and 0 for an int32 one
    (the executor's int64 -> int32 canonicalization makes that 0), as in
    the JAX op."""
    (x,) = ins["X"]
    num_hash = int(attrs.get("num_hash", 1))
    mod_by = int(attrs.get("mod_by", 1))
    _, p2, p3, p4, p5 = _XXH_PRIMES
    ids = x.reshape(x.shape[0], -1)
    lanes = []
    for c in range(ids.shape[1]):
        col = ids[:, c].long()
        lo = col & _U32  # two's complement low 4 bytes, as astype(uint32)
        hi = (col >> 32) & _U32 if x.dtype == torch.int64 else torch.zeros_like(col)
        lanes += [lo, hi]
    nbytes = 8 * ids.shape[1]
    outs = []
    for seed in range(num_hash):
        h = torch.full((ids.shape[0],), (seed + p5 + nbytes) & _U32, dtype=torch.int64,
                       device=x.device)
        for w in lanes:
            h = _mul_u32(_rotl_u32((h + _mul_u32(w, p3)) & _U32, 17), p4)
        h = _mul_u32(h ^ (h >> 15), p2)
        h = _mul_u32(h ^ (h >> 13), p3)
        h = h ^ (h >> 16)
        outs.append((h % mod_by).to(x.dtype))
    return {"Out": [torch.stack(outs, dim=1).reshape(x.shape[0], num_hash, 1)]}


@register("reverse")
def _reverse(ctx, ins, attrs):
    (x,) = ins["X"]
    axes = attrs["axis"]
    if isinstance(axes, int):
        axes = [axes]
    return {"Out": [torch.flip(x, tuple(int(a) for a in axes))]}


@register("gather")
def _gather(ctx, ins, attrs):
    (x,) = ins["X"]
    (idx,) = ins["Index"]
    return {"Out": [torch.index_select(x, 0, idx.reshape(-1))]}


# the grad maker (sparse or dense per op instance) is attached by
# ops/sparse_ops.py, as in the JAX package
@register("lookup_table")
def _lookup_table(ctx, ins, attrs):
    (w,) = ins["W"]
    (ids,) = ins["Ids"]
    padding_idx = int(attrs.get("padding_idx", -1))
    flat = ids.reshape(-1)
    out = torch.index_select(w, 0, flat.clamp(min=0))
    # negative ids are padding/masked slots: zero rows (the JAX lowering's
    # contract)
    dead = flat < 0
    if padding_idx != -1:
        pad = padding_idx if padding_idx >= 0 else padding_idx + w.shape[0]
        dead = dead | (flat == pad)
    out = torch.where(dead[:, None], torch.zeros((), dtype=out.dtype, device=out.device), out)
    # ids carry a trailing 1 dim (the lookup_table LoD convention)
    out_shape = tuple(ids.shape[:-1]) + (w.shape[1],)
    if ids.shape[-1] != 1:
        out_shape = tuple(ids.shape) + (w.shape[1],)
    return {"Out": [out.reshape(out_shape)]}


@register("lookup_table_grad", no_grad=True)
def _lookup_table_grad(ctx, ins, attrs):
    """Explicit grad: scatter-add of the cotangent rows accumulated in f32,
    cast once to the cotangent's dtype at the end (repeated ids stay exact
    under bf16, as in the JAX lowering). Negative and padding ids add
    nothing. W is read for its shape only. The accumulating index_put_
    sums a repeated id's rows in one order every run (on the card it sorts
    the ids first; atomic adds would sum them in the order they land), so
    a step gives the same bits every time it runs."""
    (w,) = ins["W"]
    (ids,) = ins["Ids"]
    (dout,) = ins["Out@GRAD"]
    padding_idx = int(attrs.get("padding_idx", -1))
    flat = ids.reshape(-1).long()
    d2 = dout.reshape(-1, w.shape[1])
    mask = flat >= 0
    if padding_idx != -1:
        pad = padding_idx if padding_idx >= 0 else padding_idx + w.shape[0]
        mask = mask & (flat != pad)
    rows = torch.where(mask[:, None], d2, torch.zeros((), dtype=d2.dtype, device=d2.device))
    dw = torch.zeros(tuple(w.shape), dtype=torch.float32, device=d2.device)
    dw.index_put_((torch.where(mask, flat, torch.zeros_like(flat)),), rows.float(),
                  accumulate=True)
    return {"W@GRAD": [dw.to(d2.dtype)]}


# ---------------------------------------------------------------------------
# convolution / pooling / batch_norm (reference conv_op.cc, pool_op.cc,
# batch_norm_op.cc; the JAX package lowers them to lax.conv_general_dilated
# and lax.reduce_window outside any Pallas kernel, so here they are library
# calls: cuDNN on the card)
# ---------------------------------------------------------------------------


def _conv_args(attrs):
    return dict(
        stride=[int(v) for v in attrs.get("strides", [1, 1])],
        padding=[int(v) for v in attrs.get("paddings", [0, 0])],
        dilation=[int(v) for v in attrs.get("dilations", [1, 1])],
        groups=int(attrs.get("groups", 1) or 1),
    )


@register("conv2d")
def _conv2d(ctx, ins, attrs):
    """NCHW input, OIHW filter (I = C / groups), symmetric paddings."""
    (x,) = ins["Input"]
    (w,) = ins["Filter"]
    return {"Output": [torch.nn.functional.conv2d(x, w, None, **_conv_args(attrs))]}


@register("depthwise_conv2d")
def _depthwise_conv2d(ctx, ins, attrs):
    return _conv2d(ctx, ins, attrs)


def _grad_wanted(ctx, slot):
    """Whether the grad op being lowered writes `slot` (a lowering called
    with no op, as in shape inference, computes every grad)."""
    op = ctx.op
    if op is None or slot not in op.outputs:
        return op is None
    return any(n != EMPTY_VAR_NAME for n in op.outputs[slot])


def _conv2d_grad(ctx, ins, attrs):
    """Explicit grad of conv2d: dgrad and wgrad from the saved input and
    filter in one convolution_backward, without running the forward again
    (the generic grad replays it under torch.func.vjp), and each only where
    the grad op writes it (a first layer's input takes no dgrad)."""
    (x,) = ins["Input"]
    (w,) = ins["Filter"]
    (dy,) = ins["Output@GRAD"]
    a = _conv_args(attrs)
    want_x, want_w = _grad_wanted(ctx, "Input@GRAD"), _grad_wanted(ctx, "Filter@GRAD")
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dy.to(x.dtype), x, w, None, a["stride"], a["padding"], a["dilation"], False,
        [0, 0], a["groups"], [want_x, want_w, False])
    out = {}
    if want_x:
        out["Input@GRAD"] = [dx]
    if want_w:
        out["Filter@GRAD"] = [dw]
    return out


register("conv2d_grad", no_grad=True)(_conv2d_grad)
register("depthwise_conv2d_grad", no_grad=True)(_conv2d_grad)


def _pool_window(x, attrs):
    ksize = [int(k) for k in attrs.get("ksize", [2, 2])]
    strides = [int(v) for v in attrs.get("strides", ksize)]
    paddings = [int(v) for v in attrs.get("paddings", [0, 0])]
    if attrs.get("global_pooling", False) or (
        attrs.get("adaptive", False) and list(attrs.get("ksize")) == [1, 1]
    ):
        ksize = [x.shape[2], x.shape[3]]
        strides, paddings = ksize, [0, 0]
    return ksize, strides, paddings


@register("pool2d")
def _pool2d(ctx, ins, attrs):
    """The JAX lowering's contract (lax.reduce_window over symmetric
    paddings, floor output sizes, no ceil_mode): max pads with -inf and its
    grad goes to the first maximum of a window in row-major order (as the
    select-and-scatter of reduce_window's vjp); avg divides by the window's
    size, or by its in-bounds count when `exclusive` and padded. Global and
    adaptive [1, 1] pooling take the whole map. Paddings past half a window,
    which the library calls refuse, are applied explicitly first."""
    (x,) = ins["X"]
    F = torch.nn.functional
    ksize, strides, paddings = _pool_window(x, attrs)
    max_pool = attrs.get("pooling_type", "max") == "max"
    exclusive = bool(attrs.get("exclusive", True)) and any(paddings)
    pad = [0, 0]
    if paddings[0] * 2 > ksize[0] or paddings[1] * 2 > ksize[1]:
        pad = [paddings[1], paddings[1], paddings[0], paddings[0]]
        paddings = [0, 0]
    if max_pool:
        if any(pad):
            x = F.pad(x, pad, value=float("-inf"))
        return {"Out": [F.max_pool2d(x, ksize, strides, paddings)]}
    if not any(pad):
        return {"Out": [F.avg_pool2d(x, ksize, strides, paddings,
                                     count_include_pad=not exclusive)]}
    s = F.avg_pool2d(F.pad(x, pad), ksize, strides, 0, divisor_override=1)
    if not exclusive:
        return {"Out": [s / (ksize[0] * ksize[1])]}
    ones = F.pad(torch.ones_like(x[:1, :1]), pad)
    cnt = F.avg_pool2d(ones, ksize, strides, 0, divisor_override=1)
    return {"Out": [s / cnt]}


@register("batch_norm")
def _batch_norm(ctx, ins, attrs):
    """The JAX lowering's batch_norm (core_ops.py:1346-1390), not
    torch.nn.functional.batch_norm: in training the batch variance is the
    biased E[x^2] - E[x]^2 in f32, the running variance moves toward that
    biased value, and SavedVariance is the inverse std; with is_test or
    use_global_stats the running stats normalize and pass through.
    MeanOut / VarianceOut are the persistable Mean / Variance, written back
    every step."""
    (x,) = ins["X"]
    (scale,) = ins["Scale"]
    (bias,) = ins["Bias"]
    (mean,) = ins["Mean"]
    (var,) = ins["Variance"]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    is_test = bool(attrs.get("is_test", False)) or bool(attrs.get("use_global_stats", False))
    c_axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != c_axis)
    cshape = [1] * x.dim()
    cshape[c_axis] = x.shape[c_axis]
    if is_test:
        use_mean, use_var = mean, var
        saved_mean, saved_var, mean_out, var_out = mean, var, mean, var
    else:
        xf = x.float()
        bmean = torch.mean(xf, dim=axes)
        bvar = torch.mean(torch.square(xf), dim=axes) - torch.square(bmean)
        use_mean, use_var = bmean, bvar
        saved_mean = bmean
        saved_var = 1.0 / torch.sqrt(bvar + eps)
        mean_out = mean * momentum + bmean * (1 - momentum)
        var_out = var * momentum + bvar * (1 - momentum)
    inv = torch.rsqrt(use_var.reshape(cshape) + eps)
    y = (x - use_mean.reshape(cshape)) * inv * scale.reshape(cshape) + bias.reshape(cshape)
    return {
        "Y": [y.to(x.dtype)],
        "MeanOut": [mean_out],
        "VarianceOut": [var_out],
        "SavedMean": [saved_mean],
        "SavedVariance": [saved_var],
    }


def _batch_norm_grad(ctx, ins, attrs):
    """Explicit grad of batch_norm: one native_batch_norm_backward from the
    saved batch statistics (SavedMean, and SavedVariance, which is already
    the inverse std), without running the forward again (the generic grad
    replays it under torch.func.vjp), and only the grads the grad op writes
    (the output mask). With is_test or use_global_stats the running Mean
    and Variance normalized the forward, and the backward takes them
    (train=False). NHWC (channels last) moves the channel axis to 1 and
    back. The sums run in f32 over f32 copies of a lower-precision X and
    Y@GRAD, as the generic grad's do, and X@GRAD takes X's dtype."""
    (x,) = ins["X"]
    (scale,) = ins["Scale"]
    (dy,) = ins["Y@GRAD"]
    eps = float(attrs.get("epsilon", 1e-5))
    is_test = bool(attrs.get("is_test", False)) or bool(attrs.get("use_global_stats", False))
    nhwc = attrs.get("data_layout", "NCHW") != "NCHW" and x.dim() > 2
    want = [_grad_wanted(ctx, s) for s in ("X@GRAD", "Scale@GRAD", "Bias@GRAD")]
    xf, dyf = x.float(), dy.float()
    if nhwc:
        xf, dyf = xf.movedim(-1, 1), dyf.movedim(-1, 1)
    if is_test:
        (mean,) = ins["Mean"]
        (var,) = ins["Variance"]
        mean, var = mean.float(), var.float()
        # the saved statistics too: the card's backward reads them where it
        # writes no X@GRAD, whatever `train` says
        running, saved = (mean, var), (mean, 1.0 / torch.sqrt(var + eps))
    else:
        running = (None, None)
        saved = (ins["SavedMean"][0].float(), ins["SavedVariance"][0].float())
    dx, dscale, dbias = torch.ops.aten.native_batch_norm_backward(
        dyf, xf, scale.float(), running[0], running[1], saved[0], saved[1], not is_test, eps,
        want)
    out = {}
    if want[0]:
        out["X@GRAD"] = [(dx.movedim(1, -1) if nhwc else dx).to(x.dtype)]
    if want[1]:
        out["Scale@GRAD"] = [dscale.to(scale.dtype)]
    if want[2]:
        out["Bias@GRAD"] = [dbias.to(ins["Bias"][0].dtype)]
    return out


register("batch_norm_grad", no_grad=True)(_batch_norm_grad)


@register("layer_norm")
def _layer_norm(ctx, ins, attrs):
    (x,) = ins["X"]
    eps = float(attrs.get("epsilon", 1e-5))
    bna = int(attrs.get("begin_norm_axis", 1))
    x2 = x.reshape(prod(x.shape[:bna]), -1).float()
    var, mean = torch.var_mean(x2, dim=1, unbiased=False)
    y = (x2 - mean[:, None]) * torch.rsqrt(var[:, None] + eps)
    if "Scale" in ins:
        y = y * ins["Scale"][0].reshape(-1)[None, :]
    if "Bias" in ins:
        y = y + ins["Bias"][0].reshape(-1)[None, :]
    return {
        "Y": [y.reshape(x.shape).to(x.dtype)],
        "Mean": [mean],
        "Variance": [var],
    }


# ---------------------------------------------------------------------------
# dropout — custom grad: must reuse the forward-sampled mask, so the generic
# vjp-replay grad does not apply (reference dropout_op.cc keeps Mask for grad)
# ---------------------------------------------------------------------------


def _dropout_grad_maker(op, block, grad_map):
    return [
        {
            "type": "dropout_grad",
            "inputs": {
                "Out@GRAD": [grad_map[op.output("Out")[0]]],
                "Mask": [op.output("Mask")[0]],
            },
            "outputs": {"X@GRAD": [grad_map[op.input("X")[0]]]},
            "attrs": {k: v for k, v in op.attrs.items()},
        }
    ]


@register("dropout", stochastic=True, grad=_dropout_grad_maker)
def _dropout(ctx, ins, attrs):
    """keep ~ Bernoulli(1 - p) as uniform < 1 - p (jax.random.bernoulli's
    form), drawn on the input's device from the run's device generator, or
    from a generator of the op's own when it pins a seed (restarted every
    run, so every step draws the same mask, as in the JAX package)."""
    (x,) = ins["X"]
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False):
        mask = torch.ones_like(x)
        out = x * (1.0 - p) if impl == "downgrade_in_infer" else x
        return {"Out": [out], "Mask": [mask]}
    if x.device.type == "meta":
        u = torch.empty(x.shape, device="meta")
    else:
        seed = int(attrs.get("seed", 0) or 0)
        gen = ctx.seeded_generator(seed) if seed else ctx.device_generator
        u = torch.rand(x.shape, generator=gen, device=x.device)
    keep = u < (1.0 - p)
    mask = keep.to(x.dtype)
    if impl == "upscale_in_train":
        mask = mask / (1.0 - p)
    return {"Out": [x * mask], "Mask": [mask]}


@register("dropout_grad", no_grad=True)
def _dropout_grad(ctx, ins, attrs):
    (dout,) = ins["Out@GRAD"]
    (mask,) = ins["Mask"]
    return {"X@GRAD": [dout * mask]}


# ---------------------------------------------------------------------------
# optimizer ops (reference operators/optimizers/adam_op.cc). Each consumes
# Param (+state) and emits ParamOut (+state outs) under the SAME variable
# names; the executor writes them back to the scope.
# ---------------------------------------------------------------------------


def _opt_f32(fn):
    """Optimizer-lowering dtype fidelity: compute the update in f32 (bf16
    grads and states upcast), then cast every `<Slot>Out` back to its
    `<Slot>` input's dtype (the JAX package's _opt_f32, without its
    sharding constraints: the port has no mesh yet)."""

    @functools.wraps(fn)
    def wrapped(ctx, ins, attrs):
        orig_dt = {}
        ins32 = {}
        for slot, vals in ins.items():
            up = []
            for a in vals:
                if a is not None and torch.is_floating_point(a):
                    orig_dt.setdefault(slot, a.dtype)
                    up.append(a.float())
                else:
                    up.append(a)
            ins32[slot] = up
        res = fn(ctx, ins32, attrs)
        out = {}
        for slot, vals in res.items():
            base = slot[:-3] if slot.endswith("Out") else slot
            dt = orig_dt.get(base, orig_dt.get("Param"))
            out[slot] = [
                v.to(dt) if dt is not None and torch.is_floating_point(v) else v
                for v in vals
            ]
        return out

    return wrapped


def _p(ins, slot):
    return ins[slot][0]


@register("sgd", no_grad=True)
@_opt_f32
def _sgd(ctx, ins, attrs):
    p, g, lr = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "LearningRate")
    return {"ParamOut": [p - lr.reshape(()).to(p.dtype) * g]}


@register("momentum", no_grad=True)
@_opt_f32
def _momentum(ctx, ins, attrs):
    """v = mu v + g; p -= lr v, or with Nesterov p -= (g + mu v) lr (the
    JAX lowering's forms and operand order)."""
    p, g, v, lr = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "Velocity"), _p(ins, "LearningRate")
    mu = attrs["mu"]
    lr = lr.reshape(()).to(p.dtype)
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}


@register("lars_momentum", no_grad=True)
@_opt_f32
def _lars_momentum(ctx, ins, attrs):
    p, g, v, lr = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "Velocity"), _p(ins, "LearningRate")
    mu = attrs["mu"]
    lars_coeff = attrs.get("lars_coeff", 0.001)
    lars_wd = attrs.get("lars_weight_decay", 0.0005)
    lr = lr.reshape(()).float()
    pn = torch.sqrt(torch.sum(torch.square(p.float())))
    gn = torch.sqrt(torch.sum(torch.square(g.float())))
    local_lr = torch.where((pn > 0) & (gn > 0), lr * lars_coeff * pn / (gn + lars_wd * pn), lr)
    v_out = mu * v + local_lr * (g + lars_wd * p)
    return {"ParamOut": [p - v_out], "VelocityOut": [v_out]}


@register("adam", no_grad=True)
@_opt_f32
def _adam(ctx, ins, attrs):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = lr.reshape(())
    m1o = b1 * m1 + (1 - b1) * g
    m2o = b2 * m2 + (1 - b2) * torch.square(g)
    lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    p_out = p - lr_t * m1o / (torch.sqrt(m2o) + eps)
    return {"ParamOut": [p_out], "Moment1Out": [m1o], "Moment2Out": [m2o]}


@register("adagrad", no_grad=True)
@_opt_f32
def _adagrad(ctx, ins, attrs):
    p, g, lr, mom = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "LearningRate"), _p(ins, "Moment")
    eps = attrs.get("epsilon", 1e-6)
    mom_out = mom + torch.square(g)
    p_out = p - lr.reshape(()) * g / (torch.sqrt(mom_out) + eps)
    return {"ParamOut": [p_out], "MomentOut": [mom_out]}


@register("decayed_adagrad", no_grad=True)
@_opt_f32
def _decayed_adagrad(ctx, ins, attrs):
    p, g, lr, mom = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "LearningRate"), _p(ins, "Moment")
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mom_out = decay * mom + (1 - decay) * torch.square(g)
    p_out = p - lr.reshape(()) * g / (torch.sqrt(mom_out) + eps)
    return {"ParamOut": [p_out], "MomentOut": [mom_out]}


@register("rmsprop", no_grad=True)
@_opt_f32
def _rmsprop(ctx, ins, attrs):
    p, g, lr = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "LearningRate")
    ms, mom = _p(ins, "MeanSquare"), _p(ins, "Moment")
    eps = attrs.get("epsilon", 1e-10)
    decay = attrs.get("decay", 0.9)
    momentum = attrs.get("momentum", 0.0)
    lr = lr.reshape(())
    ms_out = decay * ms + (1 - decay) * torch.square(g)
    if attrs.get("centered", False):
        mg = _p(ins, "MeanGrad")
        mg_out = decay * mg + (1 - decay) * g
        mom_out = momentum * mom + lr * g / torch.sqrt(ms_out - torch.square(mg_out) + eps)
        return {"ParamOut": [p - mom_out], "MeanSquareOut": [ms_out],
                "MomentOut": [mom_out], "MeanGradOut": [mg_out]}
    mom_out = momentum * mom + lr * g / torch.sqrt(ms_out + eps)
    return {"ParamOut": [p - mom_out], "MeanSquareOut": [ms_out], "MomentOut": [mom_out]}


@register("adadelta", no_grad=True)
@_opt_f32
def _adadelta(ctx, ins, attrs):
    p, g = _p(ins, "Param"), _p(ins, "Grad")
    avg_sq_g, avg_sq_u = _p(ins, "AvgSquaredGrad"), _p(ins, "AvgSquaredUpdate")
    rho, eps = attrs.get("rho", 0.95), attrs.get("epsilon", 1e-6)
    asg = rho * avg_sq_g + (1 - rho) * torch.square(g)
    update = -torch.sqrt((avg_sq_u + eps) / (asg + eps)) * g
    asu = rho * avg_sq_u + (1 - rho) * torch.square(update)
    return {"ParamOut": [p + update], "AvgSquaredGradOut": [asg],
            "AvgSquaredUpdateOut": [asu]}


@register("adamax", no_grad=True)
@_opt_f32
def _adamax(ctx, ins, attrs):
    p, g, lr = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "LearningRate")
    mom, inf_norm, b1p = _p(ins, "Moment"), _p(ins, "InfNorm"), _p(ins, "Beta1Pow")
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    mom_out = b1 * mom + (1 - b1) * g
    inf_out = torch.maximum(b2 * inf_norm, torch.abs(g))
    lr_t = lr.reshape(()) / (1 - b1p.reshape(()))
    p_out = p - lr_t * mom_out / (inf_out + eps)
    return {"ParamOut": [p_out], "MomentOut": [mom_out], "InfNormOut": [inf_out]}


@register("ftrl", no_grad=True)
@_opt_f32
def _ftrl(ctx, ins, attrs):
    p, g, lr = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "LearningRate")
    sq_acc, lin_acc = _p(ins, "SquaredAccumulator"), _p(ins, "LinearAccumulator")
    l1, l2 = attrs.get("l1", 0.0), attrs.get("l2", 0.0)
    lr_power = attrs.get("lr_power", -0.5)
    lr = lr.reshape(())
    new_acc = sq_acc + torch.square(g)
    if lr_power == -0.5:
        sigma = (torch.sqrt(new_acc) - torch.sqrt(sq_acc)) / lr
        x_den = l2 + torch.sqrt(new_acc) / lr
    else:
        sigma = (torch.pow(new_acc, -lr_power) - torch.pow(sq_acc, -lr_power)) / lr
        x_den = l2 + torch.pow(new_acc, -lr_power) / lr
    lin_out = lin_acc + g - sigma * p
    p_out = (torch.clamp(lin_out, -l1, l1) - lin_out) / x_den
    return {"ParamOut": [p_out], "SquaredAccumOut": [new_acc], "LinearAccumOut": [lin_out]}


# ---------------------------------------------------------------------------
# comparisons, logical ops, where and the shape ops the sequence and
# control-flow layers emit (reference compare_op.cc, logical_op.cc,
# squeeze_op.cc, unsqueeze_op.cc, expand_op.cc, where_op.cc) and chunk_eval
# (chunk_eval_op.cc)
# ---------------------------------------------------------------------------


def _register_compare(name, fn):
    @register(name, no_grad=True)
    def _lower(ctx, ins, attrs, _fn=fn):
        (x,) = ins["X"]
        (y,) = ins["Y"]
        y = bcast_y(x, y, int(attrs.get("axis", -1)))
        return {"Out": [_fn(x, y)]}


_register_compare("less_than", torch.lt)
_register_compare("less_equal", torch.le)
_register_compare("greater_than", torch.gt)
_register_compare("greater_equal", torch.ge)
_register_compare("equal", torch.eq)
_register_compare("not_equal", torch.ne)


def _register_logical(name, fn, unary=False):
    @register(name, no_grad=True)
    def _lower(ctx, ins, attrs, _fn=fn, _unary=unary):
        (x,) = ins["X"]
        if _unary:
            return {"Out": [_fn(x)]}
        (y,) = ins["Y"]
        return {"Out": [_fn(x, y)]}


_register_logical("logical_and", torch.logical_and)
_register_logical("logical_or", torch.logical_or)
_register_logical("logical_xor", torch.logical_xor)
_register_logical("logical_not", torch.logical_not, unary=True)


@register("where")
def _where(ctx, ins, attrs):
    (cond,) = ins["Condition"]
    (x,) = ins["X"]
    (y,) = ins["Y"]
    return {"Out": [torch.where(cond.to(torch.bool), x, y)]}


def _xshape(x):
    return torch.zeros((0,) + tuple(x.shape), dtype=x.dtype, device=x.device)


def _squeeze_axes(x, axes):
    if axes:
        return tuple(a % x.dim() for a in axes if x.shape[a % x.dim()] == 1)
    return tuple(i for i, d in enumerate(x.shape) if d == 1)


def _squeezed(x, axes):
    keep = set(_squeeze_axes(x, axes))
    return x.reshape(tuple(d for i, d in enumerate(x.shape) if i not in keep))


def _unsqueezed(x, axes):
    for a in sorted(axes):
        x = x.unsqueeze(a)
    return x


@register("squeeze2")
def _squeeze2(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [_squeezed(x, attrs.get("axes", []))], "XShape": [_xshape(x)]}


@register("unsqueeze2")
def _unsqueeze2(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [_unsqueezed(x, attrs["axes"])], "XShape": [_xshape(x)]}


@register("expand")
def _expand(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [x.repeat(*[int(t) for t in attrs["expand_times"]])]}


def _chunk_flags(y, n_types, scheme, excluded, seqlen):
    """Per-position chunk (start, end, type) flags of a padded [b, t] int tag
    grid under one of the conlleval schemes (the JAX package's
    _chunk_flags): label = chunk_type * num_tag_types + tag_type, any label
    outside [0, n_types * num_tag_types) is the O tag."""
    ntag = {"plain": 1, "IOB": 2, "IOE": 2, "IOBES": 4}[scheme]
    typ = torch.div(y, ntag, rounding_mode="floor")
    tag = torch.remainder(y, ntag)
    valid = (y >= 0) & (y < n_types * ntag)
    for ex in excluded:
        valid = valid & (typ != int(ex))
    t = y.shape[1]
    if seqlen is not None:
        pos = torch.arange(t, device=y.device)[None, :]
        valid = valid & (pos < seqlen.reshape(-1, 1))
    pad_col = torch.zeros((y.shape[0], 1), dtype=y.dtype, device=y.device)
    pad_f = torch.zeros((y.shape[0], 1), dtype=torch.bool, device=y.device)
    p_valid = torch.cat([pad_f, valid[:, :-1]], 1)
    p_typ = torch.cat([pad_col, typ[:, :-1]], 1)
    p_tag = torch.cat([pad_col, tag[:, :-1]], 1)
    n_valid = torch.cat([valid[:, 1:], pad_f], 1)
    n_typ = torch.cat([typ[:, 1:], pad_col], 1)
    n_tag = torch.cat([tag[:, 1:], pad_col], 1)
    boundary_in = ~p_valid | (p_typ != typ)
    boundary_out = ~n_valid | (n_typ != typ)
    if scheme == "plain":
        start = end = valid
    elif scheme == "IOB":
        start = valid & ((tag == 0) | boundary_in)
        end = valid & (boundary_out | (n_tag == 0))
    elif scheme == "IOE":
        start = valid & (boundary_in | (p_tag == 1))
        end = valid & ((tag == 1) | boundary_out)
    else:  # IOBES
        start = valid & ((tag == 0) | (tag == 3) | boundary_in | (p_tag >= 2))
        end = valid & ((tag >= 2) | boundary_out | (n_tag == 0) | (n_tag == 3))
    return start, end, typ


def _chunk_endpos(end):
    """For each position, the index of the next chunk end at or after it."""
    t = end.shape[1]
    cand = torch.where(end, torch.arange(t, device=end.device)[None, :],
                       torch.full((), t, device=end.device))
    return torch.flip(torch.cummin(torch.flip(cand, (1,)), dim=1).values, (1,))


@register("chunk_eval", no_grad=True)
def _chunk_eval(ctx, ins, attrs):
    """Chunk-level precision / recall / F1 of padded [b, t] tag grids (the
    JAX package's vectorized conlleval count)."""
    (inference,) = ins["Inference"]
    (label,) = ins["Label"]
    seqlen = (ins.get("SeqLength") or [None])[0]
    scheme = str(attrs.get("chunk_scheme", "IOB"))
    if scheme not in ("plain", "IOB", "IOE", "IOBES"):
        raise ValueError("chunk_eval: unknown chunk_scheme %r" % scheme)
    n_types = int(attrs["num_chunk_types"])
    excluded = tuple(attrs.get("excluded_chunk_types", ()) or ())
    inf = inference.reshape(inference.shape[0], -1).long()
    lab = label.reshape(label.shape[0], -1).long()
    i_start, i_end, i_typ = _chunk_flags(inf, n_types, scheme, excluded, seqlen)
    l_start, l_end, l_typ = _chunk_flags(lab, n_types, scheme, excluded, seqlen)
    n_inf = i_start.sum()
    n_lab = l_start.sum()
    n_cor = (i_start & l_start & (i_typ == l_typ)
             & (_chunk_endpos(i_end) == _chunk_endpos(l_end))).sum()
    fi, fl, fc = (v.float() for v in (n_inf, n_lab, n_cor))
    zero = torch.zeros((), device=fi.device)
    precision = torch.where(fi > 0, fc / torch.clamp(fi, min=1.0), zero)
    recall = torch.where(fl > 0, fc / torch.clamp(fl, min=1.0), zero)
    f1 = torch.where(precision + recall > 0,
                     2.0 * precision * recall / torch.clamp(precision + recall, min=1e-38),
                     zero)
    return {
        "Precision": [precision.reshape((1,))],
        "Recall": [recall.reshape((1,))],
        "F1-Score": [f1.reshape((1,))],
        "NumInferChunks": [n_inf.to(torch.int32).reshape((1,))],
        "NumLabelChunks": [n_lab.to(torch.int32).reshape((1,))],
        "NumCorrectChunks": [n_cor.to(torch.int32).reshape((1,))],
    }


# ---------------------------------------------------------------------------
# the rest of the JAX package's core ops: prelu, the ranking / regression
# losses, positive_negative_pair, the shape ops (split, stack, unstack,
# squeeze, unsqueeze, slice, pad, pad2d), scatter, embedding, label_smooth,
# norm, the interpolations, lod_reset and lrn (reference prelu_op.cc,
# smooth_l1_loss_op.cc, log_loss_op.cc, hinge_loss_op.cc,
# positive_negative_pair_op.cc, split_op.cc, stack_op.cc, unstack_op.cc,
# squeeze_op.cc, unsqueeze_op.cc, slice_op.cc, scatter_op.cc, pad_op.cc,
# pad2d_op.cc, lookup_table_op.cc, label_smooth_op.cc, norm_op.cc,
# interpolate_op.cc, lod_reset_op.cc, lrn_op.cc). Each takes the generic
# grad, as in the JAX package; positive_negative_pair has none.
# ---------------------------------------------------------------------------


@register("prelu")
def _prelu(ctx, ins, attrs):
    (x,) = ins["X"]
    (alpha,) = ins["Alpha"]
    mode = attrs.get("mode", "all")
    if mode == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    elif mode == "all":
        alpha = alpha.reshape(())
    return {"Out": [torch.where(x >= 0, x, x * alpha)]}


@register("smooth_l1_loss")
def _smooth_l1(ctx, ins, attrs):
    """Out: the per-row sum of the smooth L1 of (x - y) * InsideWeight,
    times OutsideWeight; Diff: the weighted difference."""
    (x,) = ins["X"]
    (y,) = ins["Y"]
    sigma = attrs.get("sigma", 1.0)
    s2 = sigma * sigma
    diff = x - y
    if "InsideWeight" in ins:
        diff = diff * ins["InsideWeight"][0]
    ad = torch.abs(diff)
    val = torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff, ad - 0.5 / s2)
    if "OutsideWeight" in ins:
        val = val * ins["OutsideWeight"][0]
    out = torch.sum(val.reshape(val.shape[0], -1), dim=1, keepdim=True)
    return {"Out": [out], "Diff": [diff]}


@register("log_loss")
def _log_loss(ctx, ins, attrs):
    (p,) = ins["Predicted"]
    (label,) = ins["Labels"]
    eps = attrs.get("epsilon", 1e-4)
    out = -label * torch.log(p + eps) - (1 - label) * torch.log(1 - p + eps)
    return {"Loss": [out]}


@register("hinge_loss")
def _hinge_loss(ctx, ins, attrs):
    (logits,) = ins["Logits"]
    (labels,) = ins["Labels"]
    return {"Loss": [torch.clamp(1.0 - (2.0 * labels - 1.0) * logits, min=0.0)]}


@register("positive_negative_pair", no_grad=True)
def _positive_negative_pair(ctx, ins, attrs):
    """Pairwise ranking counts (the LETOR evaluation): over each unordered
    within-query pair with differing labels, positive when the higher-
    labeled item scores higher, negative when lower, neutral on a tie; a
    Weight weighs a pair by the mean of its two weights, and the
    Accumulate* inputs are added. The JAX lowering's O(N^2) masked form."""
    (score,) = ins["Score"]
    (label,) = ins["Label"]
    (qid,) = ins["QueryID"]
    col = int(attrs.get("column", -1))
    s = score.reshape(score.shape[0], -1)[:, col].float()
    lab = label.reshape(-1).float()
    q = qid.reshape(-1)
    n = s.shape[0]
    order = torch.arange(n, device=s.device)
    pair = ((q[:, None] == q[None, :]) & (order[:, None] < order[None, :])
            & (lab[:, None] != lab[None, :])).float()
    if ins.get("Weight"):
        w = ins["Weight"][0].reshape(-1).float()
        pair = pair * 0.5 * (w[:, None] + w[None, :])
    d = (s[:, None] - s[None, :]) * torch.sign(lab[:, None] - lab[None, :])
    counts = {"Positive": torch.sum(pair * (d > 0)), "Negative": torch.sum(pair * (d < 0)),
              "Neutral": torch.sum(pair * (d == 0))}
    out = {}
    for kind, v in counts.items():
        acc = ins.get("Accumulate%sPair" % kind)
        if acc:
            v = v + acc[0].reshape(())
        out["%sPair" % kind] = [v.reshape((1,))]
    return out


@register("split")
def _split(ctx, ins, attrs):
    """`sections` cuts at their running sums (the last section takes the
    rest), else `num` equal parts, as jnp.split."""
    (x,) = ins["X"]
    axis = int(attrs.get("axis", 0))
    sections = attrs.get("sections", [])
    if sections:
        cuts = [int(c) for c in np.cumsum(sections[:-1])]
        return {"Out": list(torch.tensor_split(x, cuts, dim=axis))}
    num = int(attrs.get("num", 0))
    if x.shape[axis] % num:
        raise ValueError("split: axis %d of extent %d does not divide into %d parts"
                         % (axis, x.shape[axis], num))
    return {"Out": list(torch.split(x, x.shape[axis] // num, dim=axis))}


@register("stack")
def _stack(ctx, ins, attrs):
    return {"Y": [torch.stack(list(ins["X"]), dim=int(attrs.get("axis", 0)))]}


@register("unstack")
def _unstack(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Y": list(torch.unbind(x, dim=int(attrs.get("axis", 0))))}


@register("squeeze")
def _squeeze(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [_squeezed(x, attrs.get("axes", []))]}


@register("unsqueeze")
def _unsqueeze(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [_unsqueezed(x, attrs["axes"])]}


@register("slice")
def _slice(ctx, ins, attrs):
    """starts / ends per axis, negative ones from the end, both clamped to
    the axis."""
    (x,) = ins["Input"]
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    return {"Out": [x[tuple(idx)]]}


@register("scatter")
def _scatter(ctx, ins, attrs):
    """Rows of X at Ids replaced by (overwrite) or added to the rows of
    Updates; a negative id counts from the end and one out of range is
    dropped, as in the JAX lowering's x.at[ids]. Where an id repeats, the
    overwrite takes its last update (the JAX lowering's order), chosen by
    a max over the update positions, so the result does not depend on the
    order the device writes in; the add sums them in one order every run
    (index_put_ with accumulate)."""
    (x,) = ins["X"]
    (ids,) = ins["Ids"]
    (updates,) = ins["Updates"]
    rows = x.shape[0]
    ids = ids.reshape(-1).long()
    ids = torch.where(ids < 0, ids + rows, ids)
    # ids out of range go to a spare row past the end
    ids = torch.where((ids >= 0) & (ids < rows), ids, torch.full_like(ids, rows))
    if attrs.get("overwrite", True):
        pos = torch.arange(ids.shape[0], device=ids.device)
        last = torch.full((rows + 1,), -1, dtype=torch.long, device=ids.device)
        last = last.scatter_reduce(0, ids, pos, reduce="amax")[:rows]
        taken = updates[last.clamp(min=0)]
        hit = (last >= 0).reshape((rows,) + (1,) * (x.dim() - 1))
        return {"Out": [torch.where(hit, taken, x)]}
    spare = torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    out = torch.cat([x, spare]).index_put((ids,), updates, accumulate=True)
    return {"Out": [out[:rows]]}


@register("pad")
def _pad(ctx, ins, attrs):
    """`paddings` holds (before, after) for each axis, first axis first."""
    (x,) = ins["X"]
    p = [int(v) for v in attrs["paddings"]]
    pairs = []
    for i in reversed(range(x.dim())):
        pairs += [p[2 * i], p[2 * i + 1]]
    return {"Out": [torch.nn.functional.pad(x, pairs, value=float(attrs.get("pad_value", 0.0)))]}


@register("pad2d")
def _pad2d(ctx, ins, attrs):
    """NCHW, paddings [top, bottom, left, right]; modes constant, reflect
    and (any other) edge, as the JAX lowering."""
    (x,) = ins["X"]
    p = [int(v) for v in attrs["paddings"]]
    pairs = [p[2], p[3], p[0], p[1]]
    mode = attrs.get("mode", "constant")
    F = torch.nn.functional
    if mode == "constant":
        return {"Out": [F.pad(x, pairs, value=float(attrs.get("pad_value", 0.0)))]}
    return {"Out": [F.pad(x, pairs, mode="reflect" if mode == "reflect" else "replicate")]}


# the same lowering as lookup_table; ops/sparse_ops.py attaches the same
# grad maker (dense or SelectedRows), since this module registers it first
@register("embedding")
def _embedding(ctx, ins, attrs):
    return _lookup_table(ctx, ins, attrs)


@register("label_smooth")
def _label_smooth(ctx, ins, attrs):
    (x,) = ins["X"]
    eps = attrs.get("epsilon", 0.1)
    if "PriorDist" in ins:
        return {"Out": [(1 - eps) * x + eps * ins["PriorDist"][0].reshape(-1)]}
    return {"Out": [(1 - eps) * x + eps / x.shape[-1]]}


@register("norm")
def _norm(ctx, ins, attrs):
    (x,) = ins["X"]
    axis = int(attrs.get("axis", 1))
    eps = attrs.get("epsilon", 1e-10)
    norm = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True) + eps)
    return {"Out": [x / norm], "Norm": [norm]}


def _interp(x, attrs, mode):
    """jax.image.resize's contract, whatever align_corners says: half-pixel
    centres, bilinear as a triangle filter widened by the ratio when
    downscaling (antialiased), nearest rounding half-pixel centres
    (torch's "nearest-exact", not "nearest")."""
    size = (int(attrs["out_h"]), int(attrs["out_w"]))
    F = torch.nn.functional
    if mode == "bilinear":
        return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=True)
    return F.interpolate(x, size=size, mode="nearest-exact")


@register("bilinear_interp")
def _bilinear_interp(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [_interp(x, attrs, "bilinear")]}


@register("nearest_interp")
def _nearest_interp(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [_interp(x, attrs, "nearest")]}


@register("lod_reset")
def _lod_reset(ctx, ins, attrs):
    """Padded tensors carry their lengths beside them, so the values pass
    through (the JAX lowering)."""
    (x,) = ins["X"]
    return {"Out": [x]}


@register("lrn")
def _lrn(ctx, ins, attrs):
    """Local response normalization across channels (NCHW): MidOut = k +
    alpha * the sum of squares over a window of n channels, zero-padded at
    the ends; Out = X / MidOut ** beta."""
    (x,) = ins["X"]
    n = int(attrs.get("n", 5))
    k = attrs.get("k", 1.0)
    alpha = attrs.get("alpha", 1e-4)
    beta = attrs.get("beta", 0.75)
    half = n // 2
    sq = torch.nn.functional.pad(torch.square(x), (0, 0, 0, 0, half, half))
    c = x.shape[1]
    acc = sq[:, 0:c]
    for i in range(1, n):
        acc = acc + sq[:, i:i + c]
    mid = k + alpha * acc
    return {"Out": [x / torch.pow(mid, beta)], "MidOut": [mid]}
