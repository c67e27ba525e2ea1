"""Secondary NN, vision and tensor ops (the torch counterparts of
paddle_tpu/ops/nn_extra_ops.py): conv3d and the transposed convolutions,
pool3d, max pooling with an index mask and its grad, unpool, spp, maxout,
group_norm, affine_channel, bilinear_tensor_product, grid_sampler,
affine_grid and the small math and tensor ops.

None of them has a Pallas kernel in the JAX package: its lowerings are XLA
ops, and here they are torch calls (cuDNN's convolutions and pooling,
grid_sample on the card). Each keeps the JAX lowering's contract:

- the transposed convolutions take the (C_in, C_out / groups, *k) filter
  and give (H - 1) s - 2p + d (k - 1) + 1 outputs, which is
  conv_transpose{2,3}d's own size with no output padding;
- max_pool{2,3}d_with_index's `Mask` is the winning element's flat index
  within its input plane, ties going to the first element in window order
  (jnp.argmax) and padding reading -inf: the mask is computed here over the
  stacked windows with torch.argmax, which returns the first maximum on
  every device, and its grad scatters through it (unpool reads the same
  mask);
- grid_sampler and affine_grid are corner-aligned with zero padding
  (grid_sample's align_corners=True, padding_mode="zeros");
- random_crop draws one offset per cropped dimension for the whole batch,
  from the run's generators (the JAX package's PRNG key draws other
  numbers), and passes Seed through as SeedOut.

Gradients come from the registry's generic torch.func.vjp grad, but for
the max-pool masks, whose grad ops scatter through the saved index, as in
the JAX package.
"""

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from .registry import register

_NEG_INF = float("-inf")


def _norm_list(v, n, default):
    if v is None:
        v = default
    v = [int(x) for x in (v if isinstance(v, (list, tuple)) else [v])]
    if len(v) == 1:
        v = v * n
    return v


def _conv_nd(x, w, attrs, nd, transpose=False):
    strides = _norm_list(attrs.get("strides"), nd, [1] * nd)
    paddings = _norm_list(attrs.get("paddings"), nd, [0] * nd)
    dilations = _norm_list(attrs.get("dilations"), nd, [1] * nd)
    groups = int(attrs.get("groups", 1) or 1)
    if not transpose:
        conv = getattr(F, "conv%dd" % nd)
        return conv(x, w, None, strides, paddings, dilations, groups)
    conv_t = getattr(F, "conv_transpose%dd" % nd)
    return conv_t(x, w, None, strides, paddings, 0, groups, dilations)


def _pool_nd(x, attrs, nd):
    """The JAX lowering's _pool_nd: reduce_window over symmetric paddings
    (max pads -inf), floor output sizes; avg divides by the window's size,
    or by its in-bounds count when `exclusive` and padded. Paddings past
    half a window, which the library calls refuse, are applied first."""
    ptype = attrs.get("pooling_type", "max")
    ksize = _norm_list(attrs.get("ksize"), nd, [2] * nd)
    strides = _norm_list(attrs.get("strides"), nd, ksize)
    paddings = _norm_list(attrs.get("paddings"), nd, [0] * nd)
    if attrs.get("global_pooling", False):
        ksize = list(x.shape[2:])
        strides = ksize
        paddings = [0] * nd
    return _pool(x, ptype, ksize, strides, paddings, bool(attrs.get("exclusive", True)))


def _pool(x, ptype, ksize, strides, paddings, exclusive):
    nd = len(ksize)
    exclusive = exclusive and any(paddings)
    pad = []
    if any(2 * p > k for p, k in zip(paddings, ksize)):
        pad = [v for p in reversed(paddings) for v in (p, p)]
        paddings = [0] * nd
    if ptype == "max":
        if pad:
            x = F.pad(x, pad, value=_NEG_INF)
        return getattr(F, "max_pool%dd" % nd)(x, ksize, strides, paddings)
    avg = getattr(F, "avg_pool%dd" % nd)
    if not pad:
        return avg(x, ksize, strides, paddings, count_include_pad=not exclusive)
    s = avg(F.pad(x, pad), ksize, strides, 0, divisor_override=1)
    if not exclusive:
        return s / float(np.prod(ksize))
    ones = F.pad(torch.ones_like(x[:1, :1]), pad)
    return s / avg(ones, ksize, strides, 0, divisor_override=1)


def _window_stack(x, ksize, strides, paddings):
    """Stack pooling windows: (N, C, *S) -> (N, C, prod(k), *out) over the
    -inf-padded input, plus each window element's flat index within the
    input plane at every output position, (prod(k), *out)."""
    nd = len(ksize)
    spatial = x.shape[2:]
    out = [(spatial[i] + 2 * paddings[i] - ksize[i]) // strides[i] + 1 for i in range(nd)]
    xp = F.pad(x, [v for p in reversed(paddings) for v in (p, p)], value=_NEG_INF)
    slabs, gidx = [], []
    for offs in itertools.product(*[range(k) for k in ksize]):
        idx = (slice(None), slice(None)) + tuple(
            slice(offs[i], offs[i] + (out[i] - 1) * strides[i] + 1, strides[i])
            for i in range(nd))
        slabs.append(xp[idx])
        coord = [torch.arange(out[i], device=x.device) * strides[i] - paddings[i] + offs[i]
                 for i in range(nd)]
        flat = coord[0]
        for i in range(1, nd):
            flat = flat[..., None] * spatial[i] + coord[i]
        gidx.append(flat)
    return torch.stack(slabs, dim=2), torch.stack(gidx, dim=0), out


def _max_pool_with_index(ctx, ins, attrs, nd):
    (x,) = ins["X"]
    ksize = _norm_list(attrs.get("ksize"), nd, [2] * nd)
    strides = _norm_list(attrs.get("strides"), nd, ksize)
    paddings = _norm_list(attrs.get("paddings"), nd, [0] * nd)
    if attrs.get("global_pooling", False):
        ksize = list(x.shape[2:])
        strides = ksize
        paddings = [0] * nd
    win, gidx, _ = _window_stack(x, ksize, strides, paddings)
    val, amax = win.amax(dim=2), torch.argmax(win, dim=2)
    gflat = gidx.reshape(gidx.shape[0], -1)  # (K, P)
    aflat = amax.reshape(amax.shape[0], amax.shape[1], -1)  # (N, C, P)
    pos = torch.arange(gflat.shape[1], device=x.device)
    mask = gflat[aflat, pos[None, None, :]].reshape(val.shape)
    return {"Out": [val], "Mask": [mask.to(torch.int32)]}


def _pool_index_grad_maker(op, block, grad_map):
    return [
        {
            "type": op.type + "_grad",
            "inputs": {
                "X": [op.input("X")[0]],
                "Mask": [op.output("Mask")[0]],
                "Out@GRAD": [grad_map[op.output("Out")[0]]],
            },
            "outputs": {"X@GRAD": [grad_map[op.input("X")[0]]]},
            "attrs": dict(op.attrs),
        }
    ]


# ---------------------------------------------------------------------------
# conv3d / pool3d family
# ---------------------------------------------------------------------------


@register("conv3d")
def _conv3d(ctx, ins, attrs):
    return {"Output": [_conv_nd(ins["Input"][0], ins["Filter"][0], attrs, 3)]}


@register("conv3d_transpose")
def _conv3d_transpose(ctx, ins, attrs):
    return {"Output": [_conv_nd(ins["Input"][0], ins["Filter"][0], attrs, 3, transpose=True)]}


@register("conv2d_transpose")
def _conv2d_transpose(ctx, ins, attrs):
    """The gradient of conv2d with respect to its input:
    out[oc, i*s + ki*d - p, j*s + kj*d - p] += x[ic, i, j] * w[ic, oc, ki, kj]."""
    return {"Output": [_conv_nd(ins["Input"][0], ins["Filter"][0], attrs, 2, transpose=True)]}


@register("depthwise_conv2d_transpose")
def _depthwise_conv2d_transpose(ctx, ins, attrs):
    return {"Output": [_conv_nd(ins["Input"][0], ins["Filter"][0], attrs, 2, transpose=True)]}


@register("pool3d")
def _pool3d(ctx, ins, attrs):
    return {"Out": [_pool_nd(ins["X"][0], attrs, 3)]}


@register("max_pool2d_with_index", grad=_pool_index_grad_maker)
def _max_pool2d_with_index(ctx, ins, attrs):
    return _max_pool_with_index(ctx, ins, attrs, 2)


@register("max_pool3d_with_index", grad=_pool_index_grad_maker)
def _max_pool3d_with_index(ctx, ins, attrs):
    return _max_pool_with_index(ctx, ins, attrs, 3)


@register("max_pool2d_with_index_grad", no_grad=True)
def _max_pool2d_with_index_grad(ctx, ins, attrs):
    """Out@GRAD summed into the input plane at the saved flat indices."""
    (x,) = ins["X"]
    (mask,) = ins["Mask"]
    (dout,) = ins["Out@GRAD"]
    n, c = dout.shape[:2]
    plane = int(np.prod(x.shape[2:]))
    flat = torch.zeros((n * c, plane), dtype=dout.dtype, device=dout.device)
    flat.scatter_add_(1, mask.reshape(n * c, -1).long(), dout.reshape(n * c, -1))
    return {"X@GRAD": [flat.reshape(x.shape)]}


register("max_pool3d_with_index_grad", no_grad=True)(_max_pool2d_with_index_grad)


@register("unpool")
def _unpool(ctx, ins, attrs):
    """Each value written at its index within an output plane of
    (h - 1) s - 2p + k per side, zeros elsewhere."""
    (x,) = ins["X"]
    (indices,) = ins["Indices"]
    ksize = _norm_list(attrs.get("ksize"), 2, [2, 2])
    strides = _norm_list(attrs.get("strides"), 2, ksize)
    paddings = _norm_list(attrs.get("paddings"), 2, [0, 0])
    n, c, h, w = x.shape
    oh = (h - 1) * strides[0] - 2 * paddings[0] + ksize[0]
    ow = (w - 1) * strides[1] - 2 * paddings[1] + ksize[1]
    out = torch.zeros((n * c, oh * ow), dtype=x.dtype, device=x.device)
    out = out.scatter(1, indices.reshape(n * c, -1).long(), x.reshape(n * c, -1))
    return {"Out": [out.reshape(n, c, oh, ow)]}


@register("spp")
def _spp(ctx, ins, attrs):
    """Spatial pyramid pooling: level p pools 2^p x 2^p bins with ceil-sized
    kernels and strides and centred padding, flattened and concatenated."""
    (x,) = ins["X"]
    height = int(attrs.get("pyramid_height", 1))
    ptype = attrs.get("pooling_type", "max")
    n, _, h, w = x.shape
    pieces = []
    for p in range(height):
        bins = 2 ** p
        kh, kw = -(-h // bins), -(-w // bins)
        ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
        pooled = _pool(x, ptype, [kh, kw], [kh, kw], [ph, pw], False)
        pieces.append(pooled.reshape(n, -1))
    return {"Out": [torch.cat(pieces, dim=1)]}


@register("maxout")
def _maxout(ctx, ins, attrs):
    (x,) = ins["X"]
    g = int(attrs["groups"])
    n, c = x.shape[:2]
    return {"Out": [x.reshape((n, c // g, g) + tuple(x.shape[2:])).amax(dim=2)]}


# ---------------------------------------------------------------------------
# normalization / channel transforms
# ---------------------------------------------------------------------------


@register("group_norm")
def _group_norm(ctx, ins, attrs):
    """Statistics over each (sample, group) in f32, the population
    variance; Mean and Variance are (n, groups)."""
    (x,) = ins["X"]
    eps = float(attrs.get("epsilon", 1e-5))
    groups = int(attrs.get("groups", 1))
    n, c = x.shape[:2]
    xg = x.reshape(n, groups, -1).float()
    mean = xg.mean(dim=2)
    var = xg.var(dim=2, unbiased=False)
    y = ((xg - mean[:, :, None]) * torch.rsqrt(var[:, :, None] + eps)).reshape(x.shape)
    cshape = (1, c) + (1,) * (x.dim() - 2)
    if "Scale" in ins:
        y = y * ins["Scale"][0].reshape(cshape)
    if "Bias" in ins:
        y = y + ins["Bias"][0].reshape(cshape)
    return {"Y": [y.to(x.dtype)], "Mean": [mean], "Variance": [var]}


@register("affine_channel")
def _affine_channel(ctx, ins, attrs):
    (x,) = ins["X"]
    c_axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    cshape = [1] * x.dim()
    cshape[c_axis] = x.shape[c_axis]
    return {"Out": [x * ins["Scale"][0].reshape(cshape) + ins["Bias"][0].reshape(cshape)]}


@register("bilinear_tensor_product")
def _bilinear_tensor_product(ctx, ins, attrs):
    (x,) = ins["X"]
    (y,) = ins["Y"]
    (w,) = ins["Weight"]
    out = torch.einsum("bm,kmn,bn->bk", x, w, y)
    if "Bias" in ins:
        out = out + ins["Bias"][0].reshape(1, -1)
    return {"Out": [out]}


# ---------------------------------------------------------------------------
# spatial samplers
# ---------------------------------------------------------------------------


@register("grid_sampler")
def _grid_sampler(ctx, ins, attrs):
    """Bilinear sampling at (g + 1) / 2 * (size - 1), corners outside the
    map reading zero."""
    (x,) = ins["X"]
    (grid,) = ins["Grid"]
    return {"Output": [F.grid_sample(x, grid.to(x.dtype), mode="bilinear",
                                     padding_mode="zeros", align_corners=True)]}


@register("affine_grid")
def _affine_grid(ctx, ins, attrs):
    """(n, h, w, 2) sampling grid: theta applied to the corner-aligned base
    grid [x, y, 1] over linspace(-1, 1). An OutputShape input is read on
    the host."""
    (theta,) = ins["Theta"]
    if "OutputShape" in ins and ins["OutputShape"][0] is not None:
        oshape = [int(d) for d in ins["OutputShape"][0].reshape(-1).tolist()]
    else:
        oshape = [int(d) for d in attrs["output_shape"]]
    _, _, h, w = oshape
    xs = torch.linspace(-1.0, 1.0, w, device=theta.device)
    ys = torch.linspace(-1.0, 1.0, h, device=theta.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # (h, w)
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # (h, w, 3)
    out = torch.einsum("hwk,nck->nhwc", base, theta.float())
    return {"Output": [out.to(theta.dtype)]}


# ---------------------------------------------------------------------------
# small math / tensor ops
# ---------------------------------------------------------------------------


@register("minus")
def _minus(ctx, ins, attrs):
    return {"Out": [ins["X"][0] - ins["Y"][0]]}


@register("l1_norm")
def _l1_norm(ctx, ins, attrs):
    return {"Out": [ins["X"][0].abs().sum().reshape(1)]}


@register("squared_l2_distance")
def _squared_l2_distance(ctx, ins, attrs):
    (x,) = ins["X"]
    (y,) = ins["Y"]
    if y.shape[0] == 1 and x.shape[0] > 1:
        y = y.expand(x.shape)
    sub = x - y
    return {"sub_result": [sub],
            "Out": [sub.reshape(sub.shape[0], -1).square().sum(dim=1, keepdim=True)]}


@register("selu")
def _selu(ctx, ins, attrs):
    (x,) = ins["X"]
    scale = float(attrs.get("scale", 1.0507009873554804934193349852946))
    alpha = float(attrs.get("alpha", 1.6732632423543772848170429916717))
    return {"Out": [scale * torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))]}


@register("fill", no_grad=True)
def _fill(ctx, ins, attrs):
    """The `value` attr (a flat list) as a tensor of `shape` and `dtype`,
    uploaded at the op's first run."""
    from .registry import torch_dtype

    shape = [int(d) for d in attrs["shape"]]
    dt = torch_dtype(attrs.get("dtype", "float32"))
    if ctx.device.type == "meta":
        return {"Out": [torch.empty(shape, dtype=dt, device="meta")]}
    value = np.asarray(attrs["value"], dtype=np.float64).reshape(shape)
    return {"Out": [ctx.op_constant(lambda: torch.as_tensor(value).to(ctx.device, dt))]}


@register("is_empty", no_grad=True)
def _is_empty(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [torch.full((1,), x.numel() == 0, dtype=torch.bool, device=x.device)]}


@register("multiplex")
def _multiplex(ctx, ins, attrs):
    """Row i of the output is row i of X[Ids[i]]."""
    stacked = torch.stack(list(ins["X"]), dim=0)  # (k, n, ...)
    (ids,) = ins["Ids"]
    rows = ids.reshape(-1).long()
    return {"Out": [stacked[rows, torch.arange(stacked.shape[1], device=stacked.device)]]}


@register("crop")
def _crop(ctx, ins, attrs):
    """A window of X of Y's shape (or the `shape` attr) at the offsets of
    the Offsets input (read on the host) or the `offsets` attr."""
    (x,) = ins["X"]
    if "Y" in ins and ins["Y"][0] is not None:
        shape = list(ins["Y"][0].shape)
    else:
        shape = [int(d) for d in attrs["shape"]]
    offs = ins.get("Offsets")
    if offs and offs[0] is not None:
        # the output's shape does not depend on them: shape inference skips
        # the read
        offsets = ([0] * x.dim() if offs[0].device.type == "meta"
                   else [int(o) for o in offs[0].reshape(-1).tolist()])
    else:
        offsets = [int(o) for o in attrs.get("offsets", [0] * x.dim())]
    return {"Out": [x[tuple(slice(o, o + s) for o, s in zip(offsets, shape))]]}


@register("pad_constant_like")
def _pad_constant_like(ctx, ins, attrs):
    """Y padded at the end of each dim to X's shape with pad_value."""
    (x,) = ins["X"]
    (y,) = ins["Y"]
    pads = [v for i in reversed(range(x.dim())) for v in (0, x.shape[i] - y.shape[i])]
    return {"Out": [F.pad(y, pads, value=float(attrs.get("pad_value", 0.0)))]}


@register("random_crop", no_grad=True, stochastic=True)
def _random_crop(ctx, ins, attrs):
    """A window of `shape` over X's last dims at one offset per cropped dim,
    shared by the whole batch, drawn on the device (a CUDA graph draws
    afresh every replay) from the op's own generator when it pins a seed,
    else from the run's; the offsets stay on the device (an index_select
    each), so a run reads nothing on the host."""
    (x,) = ins["X"]
    shape = [int(d) for d in attrs["shape"]]
    lead = x.dim() - len(shape)
    out = x
    if x.device.type != "meta":
        seed = int(attrs.get("seed", 0) or 0)
        if ctx.host_random:
            gen = torch.Generator().manual_seed(seed) if seed else ctx.generator
        else:
            gen = ctx.seeded_generator(seed) if seed else ctx.device_generator
        for i, s in enumerate(shape):
            hi = x.shape[lead + i] - s
            start = torch.randint(0, hi + 1, (1,), generator=gen, device=gen.device)
            idx = start.to(x.device) + torch.arange(s, device=x.device)
            out = out.index_select(lead + i, idx)
    else:
        out = x[(slice(None),) * lead + tuple(slice(0, s) for s in shape)]
    outs = {"Out": [out]}
    if "Seed" in ins and ins["Seed"][0] is not None:
        outs["SeedOut"] = [ins["Seed"][0]]
    return outs


@register("space_to_depth")
def _space_to_depth(ctx, ins, attrs):
    """Blocks of b x b pixels into channels, in (bh, bw, c) order."""
    (x,) = ins["X"]
    b = int(attrs["blocksize"])
    n, c, h, w = x.shape
    out = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return {"Out": [out.reshape(n, c * b * b, h // b, w // b)]}


@register("conv_shift")
def _conv_shift(ctx, ins, attrs):
    """Circular correlation of each row of X (B, M) with Y (B, N), N odd."""
    (x,) = ins["X"]
    (y,) = ins["Y"]
    half = y.shape[1] // 2
    out = torch.zeros_like(x)
    for j in range(y.shape[1]):
        out = out + y[:, j:j + 1] * torch.roll(x, half - j, dims=1)
    return {"Out": [out]}


@register("add_position_encoding")
def _add_position_encoding(ctx, ins, attrs):
    """alpha * x + beta * [sin | cos](pos / 10000^(k / (half - 1)))."""
    (x,) = ins["X"]  # (B, T, D)
    alpha = float(attrs.get("alpha", 1.0))
    beta = float(attrs.get("beta", 1.0))
    _, t, d = x.shape
    half = d // 2
    pos = torch.arange(t, dtype=torch.float32, device=x.device)[:, None]
    k = torch.arange(half, dtype=torch.float32, device=x.device)[None, :]
    denom = torch.pow(10000.0, k / (half - 1)) if half > 1 else torch.ones_like(k)
    val = pos / denom
    enc = torch.cat([torch.sin(val), torch.cos(val)], dim=1)  # (T, D)
    return {"Out": [alpha * x + beta * enc[None].to(x.dtype)]}


def _count(index, nc, valid):
    """int32 counts of `index` over nc classes where `valid` (the JAX
    package's scatter-add with mode="drop", out-of-range indices dropped)."""
    keep = valid & (index >= 0) & (index < nc)
    slot = torch.where(keep, index, torch.full_like(index, nc))
    counts = torch.zeros(nc + 1, dtype=torch.int32, device=index.device)
    counts.scatter_add_(0, slot, torch.ones_like(slot, dtype=torch.int32))
    return counts[:nc]


@register("mean_iou", no_grad=True)
def _mean_iou(ctx, ins, attrs):
    """Per-class correct and wrong counts (int32) and the mean IoU over
    classes that occur, plus the In* accumulators."""
    (pred,) = ins["Predictions"]
    (label,) = ins["Labels"]
    nc = int(attrs["num_classes"])
    p = pred.reshape(-1).long()
    lab = label.reshape(-1).long()
    eq = p == lab
    correct = _count(p, nc, eq)
    wrong = _count(lab, nc, ~eq) + _count(p, nc, ~eq)
    for extra in ins.get("InCorrects", []) or []:
        correct = correct + extra.to(torch.int32)
    for extra in ins.get("InWrongs", []) or []:
        wrong = wrong + extra.to(torch.int32)
    denom = wrong + correct
    valid = (denom > 0).sum()
    iou_sum = (correct.float() / torch.clamp(denom, min=1).float()).sum()
    mean_iou = (iou_sum / valid.float()).reshape(1)
    for extra in ins.get("InMeanIou", []) or []:
        mean_iou = mean_iou + extra
    return {"OutMeanIou": [mean_iou], "OutWrong": [wrong], "OutCorrect": [correct]}


@register("similarity_focus", no_grad=True)
def _similarity_focus(ctx, ins, attrs):
    """For each selected channel of the focus axis, min(a, b) greedy picks
    of the largest cell whose row and column are still free (first in
    row-major order on ties); the union of picks, broadcast over the focus
    axis, as 0 / 1 in X's dtype."""
    (x,) = ins["X"]  # (N, d1, d2, d3)
    axis = int(attrs["axis"])
    indexes = [int(i) for i in attrs["indexes"]]
    perm = {1: (0, 1, 2, 3), 2: (0, 2, 1, 3), 3: (0, 3, 1, 2)}[axis]
    xt = x.permute(perm)
    n, _, a, b = xt.shape
    rows = torch.arange(n, device=x.device)
    mask = torch.zeros((n, a, b), dtype=torch.bool, device=x.device)
    for idx in indexes:
        s = xt[:, idx]
        rowtag = torch.zeros((n, a), dtype=torch.bool, device=x.device)
        coltag = torch.zeros((n, b), dtype=torch.bool, device=x.device)
        for _ in range(min(a, b)):
            masked = torch.where(rowtag[:, :, None] | coltag[:, None, :],
                                 torch.full_like(s, _NEG_INF), s)
            flat = torch.argmax(masked.reshape(n, -1), dim=1)
            i, j = flat // b, flat % b
            rowtag = rowtag.index_put((rows, i), torch.ones_like(i, dtype=torch.bool))
            coltag = coltag.index_put((rows, j), torch.ones_like(j, dtype=torch.bool))
            mask = mask.index_put((rows, i, j), torch.ones_like(i, dtype=torch.bool))
    out = mask[:, None].expand(xt.shape).to(x.dtype)
    return {"Out": [out.permute(tuple(np.argsort(perm).tolist()))]}
