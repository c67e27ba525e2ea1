"""Core operator lowerings: the ops the GPTDecoder programs and their startup
programs emit (the torch counterparts of paddle_tpu/ops/core_ops.py).

Each lowering is a plain function over slot-keyed torch tensors; the
executor calls them in program order. `mul` and `matmul` stay torch.matmul:
the JAX package computes them outside any Pallas kernel too.

Dtype policy: float64 -> float32 and int64 -> int32 are canonicalized at the
framework boundary, as in the JAX package, so the same Program declares the
same var dtypes in both.
"""

import numpy as np
import torch

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
_register_elementwise("elementwise_min", torch.minimum)


@register("relu")
def _relu(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [torch.relu(x)]}


@register("softmax")
def _softmax(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [torch.softmax(x, dim=-1)]}


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
