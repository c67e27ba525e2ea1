"""Core operator lowerings: the ops the GPTDecoder programs, the Transformer
training program and their startup programs emit (the torch counterparts of
paddle_tpu/ops/core_ops.py).

Each lowering is a plain function over slot-keyed torch tensors; the
executor calls them in program order. `mul` and `matmul` stay torch.matmul:
the JAX package computes them outside any Pallas kernel too. They run in
full f32: every run on the card turns TF32 off (registry.LowerCtx), and
the parity tolerances assume it.

Gradients: most ops use the registry's generic torch.func.vjp grad. Custom
grads exist where the JAX package has them: dropout reuses its sampled Mask,
softmax_with_cross_entropy differentiates from the saved Softmax, and
lookup_table scatters its cotangent rows in f32.

Dtype policy: float64 -> float32 and int64 -> int32 are canonicalized at the
framework boundary, as in the JAX package, so the same Program declares the
same var dtypes in both.
"""

import functools

import numpy as np
import torch

from ..framework import OpRole
from .gemm_epilogue import ACT_F32
from .registry import bcast_y, prod, register, register_no_lower, torch_dtype

register_no_lower("feed")
register_no_lower("fetch")


def _shape(attrs):
    return [int(s) for s in attrs["shape"]]


def _generator(ctx, attrs):
    """The op's own generator when it pins a seed, else the run's."""
    seed = int(attrs.get("seed", 0) or 0)
    if seed:
        return torch.Generator().manual_seed(seed)
    return ctx.generator


def _random(ctx, attrs, sample):
    """Draw `sample(shape, generator)` on the CPU in f32 and move it to the
    run's device: a seed gives the same values on every device. Shape
    inference (meta device) draws nothing."""
    shape = _shape(attrs)
    dt = torch_dtype(attrs.get("dtype", "float32"))
    if ctx.device.type == "meta":
        return {"Out": [torch.empty(shape, dtype=dt, device="meta")]}
    out = sample(shape, _generator(ctx, attrs))
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
        lambda shape, g: torch.empty(shape).uniform_(lo, hi, generator=g),
    )


@register("gaussian_random", no_grad=True, stochastic=True)
def _gaussian_random(ctx, ins, attrs):
    mean, std = float(attrs.get("mean", 0.0)), float(attrs.get("std", 1.0))
    return _random(
        ctx, attrs,
        lambda shape, g: torch.empty(shape).normal_(mean, std, generator=g),
    )


@register("truncated_gaussian_random", no_grad=True, stochastic=True)
def _truncated_gaussian_random(ctx, ins, attrs):
    # standard normal truncated to [-2, 2], then scaled: the JAX package's
    # jax.random.truncated_normal(-2, 2) contract
    mean, std = float(attrs.get("mean", 0.0)), float(attrs.get("std", 1.0))
    return _random(
        ctx, attrs,
        lambda shape, g: mean + std * torch.nn.init.trunc_normal_(
            torch.empty(shape), 0.0, 1.0, -2.0, 2.0, generator=g
        ),
    )


@register("assign_value", no_grad=True)
def _assign_value(ctx, ins, attrs):
    dt = torch_dtype(attrs.get("dtype", "float32"))
    vals = np.asarray(attrs["values"]).reshape(_shape(attrs))
    return {"Out": [torch.as_tensor(vals).to(device=ctx.device, dtype=dt)]}


@register("assign")
def _assign(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [x]}


@register("fill_zeros_like", no_grad=True)
def _fill_zeros_like(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [torch.zeros_like(x)]}


# ---------------------------------------------------------------------------
# dense math (reference: mul_op.cc, matmul_op.cc)
# ---------------------------------------------------------------------------


@register("mul")
def _mul(ctx, ins, attrs):
    (x,) = ins["X"]
    (y,) = ins["Y"]
    xnc = int(attrs.get("x_num_col_dims", 1))
    ync = int(attrs.get("y_num_col_dims", 1))
    x2 = x.reshape(prod(x.shape[:xnc]), -1)
    y2 = y.reshape(prod(y.shape[:ync]), -1)
    out = torch.matmul(x2, y2)
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
    out = torch.matmul(x, y)
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


@register("reduce_sum")
def _reduce_sum(ctx, ins, attrs):
    (x,) = ins["X"]
    dims = attrs.get("dim", [0])
    if isinstance(dims, int):
        dims = [dims]
    if attrs.get("reduce_all", False):
        return {"Out": [torch.sum(x).reshape((1,))]}
    out = torch.sum(x, dim=tuple(d % x.dim() for d in dims),
                    keepdim=bool(attrs.get("keep_dim", False)))
    if out.dim() == 0:
        out = out.reshape((1,))
    return {"Out": [out]}


def _register_act(name, fn):
    @register(name)
    def _lower(ctx, ins, attrs, _fn=fn):
        (x,) = ins["X"]
        return {"Out": [_fn(x)]}


# the activations the fused GEMM epilogue also applies, from one table
# (gelu is the erf form, jax.nn.gelu(approximate=False))
for _name, _fn in ACT_F32.items():
    _register_act(_name, _fn)


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


@register("gather")
def _gather(ctx, ins, attrs):
    (x,) = ins["X"]
    (idx,) = ins["Index"]
    return {"Out": [torch.index_select(x, 0, idx.reshape(-1))]}


def _lookup_grad_maker(op, block, grad_map):
    """The JAX package's lookup_table grad maker (ops/sparse_ops.py), dense
    form: lookup_table_grad over W, Ids and Out@GRAD. Its SelectedRows form
    (is_sparse=True, lookup_table_grad_sparse) is not ported yet."""
    if op.attrs.get("is_sparse", False):
        raise NotImplementedError(
            "lookup_table with is_sparse=True: SelectedRows grads are not ported yet"
        )
    w_name = op.inputs["W"][0]
    g_out = grad_map.get(op.outputs["Out"][0])
    g_w = grad_map.get(w_name)
    if g_out is None or g_w is None:
        return []
    return [
        {
            "type": "lookup_table_grad",
            "inputs": {"W": [w_name], "Ids": [op.inputs["Ids"][0]], "Out@GRAD": [g_out]},
            "outputs": {"W@GRAD": [g_w]},
            "attrs": {
                "padding_idx": int(op.attrs.get("padding_idx", -1)),
                "param": w_name,
                OpRole.OP_ROLE_VAR_KEY: [w_name, g_w],
            },
        }
    ]


@register("lookup_table", grad=_lookup_grad_maker)
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
    nothing. W is read for its shape only."""
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
    dw.index_add_(0, torch.where(mask, flat, torch.zeros_like(flat)), rows.float())
    return {"W@GRAD": [dw.to(d2.dtype)]}


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
    from a generator of the op's own when it pins a seed."""
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
        gen = (
            torch.Generator(device=x.device).manual_seed(seed)
            if seed else ctx.device_generator
        )
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
