"""Sequence (ragged) ops and the recurrent layers' ops (the torch
counterparts of paddle_tpu/ops/sequence_ops.py).

Ragged batches are padded dense tensors (batch, time, ...) with a `SeqLen`
(batch,) int companion, as in the JAX package, and every op masks the
padding explicitly. Where the JAX package scans over time with lax.scan,
dynamic_lstm and dynamic_gru here are Python loops over the static time
axis carrying (h, c): each step is a few eager torch calls with no read of
a tensor on the host, so a block holding them captures as one CUDA graph.
With is_reverse the loop runs from the last padded step down, through the
padding first, which the masks hold at the initial state. Gradients come
from the registry's generic torch.func.vjp grad, which differentiates
through the loop.

Gate layouts match the JAX package (and so the reference kernels):
dynamic_lstm gates are (c, i, f, o) [candidate, input, forget, output],
with the peepholes (w_ic, w_fc, w_oc) in the bias's last 3h; dynamic_gru
gates are (u, r, c) with h = (1 - u) * h_prev + u * c, its weight [:, :2h]
update/reset and [:, 2h:] candidate.
"""

import torch
import torch.nn.functional as F

from .registry import register, set_var_meta, torch_dtype


def _in_var(op, block, slot):
    names = op.inputs.get(slot) or ()
    if not names or not block.has_var_recursive(names[0]):
        return None
    v = block._var_recursive(names[0])
    return v if v.shape is not None else None


def _lens(seqlen):
    return seqlen.reshape(-1).long()


def _valid_mask(x, lens):
    """(b, t) validity mask in x's dtype."""
    t = x.shape[1]
    return (torch.arange(t, device=x.device)[None, :] < lens.reshape(-1, 1)).to(x.dtype)


def _bcast(m, x):
    """A (b, t) mask reshaped to broadcast against (b, t, ...)."""
    return m.reshape(tuple(m.shape) + (1,) * (x.dim() - 2))


def _masked(x, lens):
    return x * _bcast(_valid_mask(x, lens), x)


def _take_t(x, src):
    """x[b, src[b, j], ...] along the time axis (jnp.take_along_axis with a
    (b, t') index broadcast over x's trailing dims)."""
    idx = src.reshape(tuple(src.shape) + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(tuple(src.shape) + tuple(x.shape[2:])))


@register("sequence_pool")
def _sequence_pool(ctx, ins, attrs):
    (x,) = ins["X"]
    (seqlen,) = ins["SeqLen"]
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    lens = _lens(seqlen)
    mexp = _bcast(_valid_mask(x, lens), x)
    if ptype == "SUM":
        out = torch.sum(x * mexp, dim=1)
    elif ptype == "AVERAGE":
        out = torch.sum(x * mexp, dim=1) / torch.clamp(lens, min=1).reshape(-1, 1).to(x.dtype)
    elif ptype == "SQRT":
        out = torch.sum(x * mexp, dim=1) / torch.sqrt(
            torch.clamp(lens, min=1).to(x.dtype)).reshape(-1, 1)
    elif ptype == "MAX":
        neg = (torch.finfo(x.dtype).min if torch.is_floating_point(x) else -(2 ** 30))
        out = torch.amax(torch.where(mexp > 0, x, torch.full((), neg, dtype=x.dtype,
                                                               device=x.device)), dim=1)
    elif ptype == "LAST":
        idx = torch.clamp(lens - 1, min=0)
        out = _take_t(x, idx.reshape(-1, 1)).squeeze(1)
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError("unknown pooltype %r" % ptype)
    return {"Out": [out]}


@register("sequence_softmax")
def _sequence_softmax(ctx, ins, attrs):
    (x,) = ins["X"]
    (seqlen,) = ins["SeqLen"]
    lens = _lens(seqlen)
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    v = x.reshape(x.shape[:2]) if squeeze else x
    m = _valid_mask(v, lens)
    logits = torch.where(m > 0, v, torch.full((), -1e9, dtype=v.dtype, device=v.device))
    sm = torch.softmax(logits, dim=1) * m
    sm = sm / torch.clamp(torch.sum(sm, dim=1, keepdim=True), min=1e-9)
    return {"Out": [sm.reshape(x.shape) if squeeze else sm]}


@register("sequence_conv")
def _sequence_conv(ctx, ins, attrs):
    """Context-window projection over time: for each position, concat
    context_length steps from context_start, zero outside the sequence, and
    project with Filter (ctx_len * d_in, d_out)."""
    (x,) = ins["X"]
    (w,) = ins["Filter"]
    (seqlen,) = ins["SeqLen"]
    ctx_len = int(attrs.get("contextLength", attrs.get("context_length", 3)))
    ctx_start = int(attrs.get("contextStart", attrs.get("context_start", -((ctx_len - 1) // 2))))
    lens = _lens(seqlen)
    xm = _masked(x, lens)
    t = xm.shape[1]
    pos = torch.arange(t, device=x.device)
    cols = []
    for k in range(ctx_len):
        off = ctx_start + k
        shifted = torch.roll(xm, -off, dims=1)
        ok = ((pos + off >= 0) & (pos + off < t)).to(x.dtype).reshape(1, t, 1)
        cols.append(shifted * ok)
    out = torch.matmul(torch.cat(cols, dim=-1), w)
    return {"Out": [_masked(out, lens)]}


@register("sequence_reverse")
def _sequence_reverse(ctx, ins, attrs):
    (x,) = ins["X"]
    (seqlen,) = ins["SeqLen"]
    lens = _lens(seqlen)[:, None]
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    # position i maps to len-1-i within the valid prefix; padding stays put
    src = torch.where(pos < lens, lens - 1 - pos, pos)
    return {"Y": [_take_t(x, src)]}


@register("sequence_expand")
def _sequence_expand(ctx, ins, attrs):
    """Each row of X tiled along Y's time axis."""
    (x,) = ins["X"]
    (y,) = ins["Y"]
    if x.dim() == y.dim() - 1:
        out = x[:, None].expand((x.shape[0], y.shape[1]) + tuple(x.shape[1:]))
    else:
        out = x.expand(tuple(y.shape[:2]) + tuple(x.shape[2:]))
    return {"Out": [out]}


# ---------------------------------------------------------------------------
# recurrent layers: Python loops over the static time axis
# ---------------------------------------------------------------------------


def _time_order(t, reverse):
    return range(t - 1, -1, -1) if reverse else range(t)


def _rnn_infer(op, block):
    """Hidden (and Cell) are (b, t, h) with h the weight's first dim (an
    infer_shape of its own: the loop over a dynamic time dim's sentinel
    extent on meta tensors would take seconds)."""
    x = _in_var(op, block, "Input")
    w = _in_var(op, block, "Weight")
    if x is None or w is None:
        return
    shape = tuple(x.shape[:2]) + (w.shape[0],)
    for slot in ("Hidden", "Cell"):
        for n in op.outputs.get(slot, ()):
            set_var_meta(block, n, shape, x.dtype)


def _initial(ins, slot, b, h, x):
    v = ins.get(slot)
    if v and v[0] is not None:
        return v[0].to(x.dtype)
    return torch.zeros((b, h), dtype=x.dtype, device=x.device)


@register("dynamic_lstm", infer_shape=_rnn_infer)
def _dynamic_lstm(ctx, ins, attrs):
    """LSTM over padded (b, t, 4h) gate pre-activations (the input already
    projected by an fc). Peepholes with use_peepholes (the bias then holds
    7h). A step past a row's length keeps that row's (h, c)."""
    (x,) = ins["Input"]
    (w,) = ins["Weight"]  # (h, 4h) recurrent weights
    (seqlen,) = ins["SeqLen"]
    bias = ins["Bias"][0] if "Bias" in ins else None
    use_peepholes = bool(attrs.get("use_peepholes", True))
    b, t, h4 = x.shape
    h = h4 // 4
    lens = _lens(seqlen)

    w_ic = w_fc = w_oc = None
    if bias is not None:
        flat = bias.reshape(-1)
        # the gate bias joins the projected input once, before the loop
        x = x + flat[: 4 * h]
        if use_peepholes and flat.shape[0] >= 7 * h:
            w_ic, w_fc, w_oc = flat[4 * h:5 * h], flat[5 * h:6 * h], flat[6 * h:7 * h]
    valid = _valid_mask(x, lens)  # (b, t)
    h_prev = _initial(ins, "H0", b, h, x)
    c_prev = _initial(ins, "C0", b, h, x)
    hs, cs = [None] * t, [None] * t
    for ti in _time_order(t, bool(attrs.get("is_reverse", False))):
        gates = torch.addmm(x[:, ti], h_prev, w)
        # reference layout: candidate, input gate, forget gate, output gate
        gc, gi, gf, go = gates.chunk(4, dim=-1)
        if w_ic is not None:
            gi = gi + c_prev * w_ic
            gf = gf + c_prev * w_fc
        c_new = torch.sigmoid(gf) * c_prev + torch.sigmoid(gi) * torch.tanh(gc)
        if w_oc is not None:
            go = go + c_new * w_oc
        h_new = torch.sigmoid(go) * torch.tanh(c_new)
        m = valid[:, ti:ti + 1]
        h_prev = m * h_new + (1 - m) * h_prev
        c_prev = m * c_new + (1 - m) * c_prev
        hs[ti], cs[ti] = h_prev, c_prev
    hidden = torch.stack(hs, dim=1) * valid[:, :, None]
    cell = torch.stack(cs, dim=1) * valid[:, :, None]
    return {"Hidden": [hidden], "Cell": [cell]}


@register("dynamic_gru", infer_shape=_rnn_infer)
def _dynamic_gru(ctx, ins, attrs):
    """GRU over padded (b, t, 3h) pre-activations. Weight (h, 3h): [:, :2h]
    update/reset recurrent weights, [:, 2h:] candidate."""
    (x,) = ins["Input"]
    (w,) = ins["Weight"]
    (seqlen,) = ins["SeqLen"]
    bias = ins["Bias"][0] if "Bias" in ins else None
    b, t, h3 = x.shape
    h = h3 // 3
    lens = _lens(seqlen)
    if bias is not None:
        x = x + bias.reshape(-1)
    w_ur, w_c = w[:, :2 * h], w[:, 2 * h:]
    valid = _valid_mask(x, lens)
    h_prev = _initial(ins, "H0", b, h, x)
    hs = [None] * t
    for ti in _time_order(t, bool(attrs.get("is_reverse", False))):
        xt = x[:, ti]
        g_ur = torch.addmm(xt[:, :2 * h], h_prev, w_ur)
        u = torch.sigmoid(g_ur[:, :h])
        r = torch.sigmoid(g_ur[:, h:])
        c = torch.tanh(torch.addmm(xt[:, 2 * h:], r * h_prev, w_c))
        # reference gru_finalOutput: h = (1-u)*h_prev + u*c
        h_new = (1 - u) * h_prev + u * c
        m = valid[:, ti:ti + 1]
        h_prev = m * h_new + (1 - m) * h_prev
        hs[ti] = h_prev
    return {"Hidden": [torch.stack(hs, dim=1) * valid[:, :, None]]}


@register("lstm_unit")
def _lstm_unit(ctx, ins, attrs):
    """One LSTM step, gate layout (i, f, o, g): X (b, 4h), C_prev (b, h)."""
    (x,) = ins["X"]
    (c_prev,) = ins["C_prev"]
    forget_bias = attrs.get("forget_bias", 0.0)
    gi, gf, go, gg = x.chunk(4, dim=-1)
    c = torch.sigmoid(gf + forget_bias) * c_prev + torch.sigmoid(gi) * torch.tanh(gg)
    return {"C": [c], "H": [torch.sigmoid(go) * torch.tanh(c)]}


@register("gru_unit")
def _gru_unit(ctx, ins, attrs):
    """One GRU step (reference gru_unit_op.cc)."""
    (x,) = ins["Input"]
    (h_prev,) = ins["HiddenPrev"]
    (w,) = ins["Weight"]
    bias = ins["Bias"][0] if "Bias" in ins else None
    h = h_prev.shape[-1]
    if bias is not None:
        x = x + bias.reshape(-1)
    g_ur = x[:, :2 * h] + h_prev @ w[:, :2 * h]
    u = torch.sigmoid(g_ur[:, :h])
    r = torch.sigmoid(g_ur[:, h:])
    c = torch.tanh(x[:, 2 * h:] + (r * h_prev) @ w[:, 2 * h:])
    h_new = (1 - u) * h_prev + u * c
    return {"Hidden": [h_new], "ResetHiddenPrev": [r * h_prev],
            "Gate": [torch.cat([u, r, c], -1)]}


# ---------------------------------------------------------------------------
# padding / reshaping / editing ops: masked gathers over the padded form
# ---------------------------------------------------------------------------


@register("sequence_pad")
def _sequence_pad(ctx, ins, attrs):
    """Set the capacity to padded_length and fill the padding with PadValue;
    Length is the lengths clamped to that capacity."""
    (x,) = ins["X"]
    (pad_value,) = ins["PadValue"]
    (seqlen,) = ins["SeqLen"]
    lens = seqlen.reshape(-1).to(torch.int32)
    maxlen = int(attrs.get("padded_length", -1))
    t = x.shape[1]
    if maxlen > 0 and maxlen != t:
        if maxlen < t:
            x = x[:, :maxlen]
            lens = torch.clamp(lens, max=maxlen)
        else:
            pad = torch.zeros((x.shape[0], maxlen - t) + tuple(x.shape[2:]),
                              dtype=x.dtype, device=x.device)
            x = torch.cat([x, pad], dim=1)
    t = x.shape[1]
    m = torch.arange(t, device=x.device)[None, :] < lens[:, None]
    if pad_value.numel() == 1:
        pv = pad_value.reshape((1,) * x.dim())
    else:
        pv = pad_value.reshape((1, 1) + tuple(pad_value.shape))
    out = torch.where(_bcast(m, x), x, pv.to(x.dtype))
    return {"Out": [out], "Length": [lens]}


@register("sequence_unpad")
def _sequence_unpad(ctx, ins, attrs):
    (x,) = ins["X"]
    (length,) = ins["Length"]
    return {"Out": [_masked(x, _lens(length))]}


@register("sequence_mask", no_grad=True)
def _sequence_mask(ctx, ins, attrs):
    (x,) = ins["X"]  # lengths
    maxlen = int(attrs.get("maxlen", -1))
    if maxlen <= 0:
        raise ValueError("sequence_mask requires a static maxlen")
    m = torch.arange(maxlen, device=x.device)[None, :] < x.reshape(-1, 1)
    return {"Y": [m.to(torch_dtype(attrs.get("out_dtype", "int64")))]}


@register("sequence_concat")
def _sequence_concat(ctx, ins, attrs):
    """Row b = x1[b, :l1] ++ x2[b, :l2] ++ ..., then padding."""
    xs = ins["X"]
    lens_list = [_lens(v) for v in ins["SeqLen"]]
    b = xs[0].shape[0]
    t_out = sum(x.shape[1] for x in xs)
    dev = xs[0].device
    pos = torch.arange(t_out, device=dev)[None, :]
    out = torch.zeros((b, t_out) + tuple(xs[0].shape[2:]), dtype=xs[0].dtype, device=dev)
    offset = torch.zeros((b, 1), dtype=torch.long, device=dev)
    for x, lens in zip(xs, lens_list):
        rel = pos - offset
        inside = (rel >= 0) & (rel < lens[:, None])
        gathered = _take_t(x, torch.clamp(rel, 0, x.shape[1] - 1))
        out = torch.where(_bcast(inside, x), gathered, out)
        offset = offset + lens[:, None]
    return {"Out": [out], "OutLen": [offset.reshape(-1).to(torch.int32)]}


@register("sequence_expand_as")
def _sequence_expand_as(ctx, ins, attrs):
    (x,) = ins["X"]
    (seqlen,) = ins["SeqLen"]  # lengths of Y
    (y,) = ins["Y"]
    out = x[:, None].expand((x.shape[0], y.shape[1]) + tuple(x.shape[1:]))
    return {"Out": [_masked(out, _lens(seqlen))]}


@register("sequence_slice")
def _sequence_slice(ctx, ins, attrs):
    """Per-row [offset, offset + length), moved to position 0 of each row."""
    (x,) = ins["X"]
    (offset,) = ins["Offset"]
    (length,) = ins["Length"]
    off = _lens(offset)
    ln = _lens(length)
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    gathered = _take_t(x, torch.clamp(pos + off[:, None], 0, t - 1))
    inside = pos < ln[:, None]
    out = torch.where(_bcast(inside, x), gathered,
                      torch.zeros((), dtype=x.dtype, device=x.device))
    return {"Out": [out], "OutLen": [ln.to(torch.int32)]}


@register("sequence_erase")
def _sequence_erase(ctx, ins, attrs):
    """Drop the listed tokens and move the rest to the front of each row."""
    (x,) = ins["X"]
    (seqlen,) = ins["SeqLen"]
    lens = _lens(seqlen)
    squeeze = x.dim() == 3
    v = x.reshape(x.shape[:2]) if squeeze else x
    pos = torch.arange(v.shape[1], device=x.device)[None, :]
    keep = pos < lens[:, None]
    for tok in attrs.get("tokens", []):
        keep = keep & (v != tok)
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    compacted = torch.gather(v, 1, order)
    out_len = keep.sum(dim=1).to(torch.int32)
    out = torch.where(pos < out_len[:, None], compacted, torch.zeros_like(compacted))
    if squeeze:
        out = out[:, :, None]
    return {"Out": [out.to(x.dtype)], "OutLen": [out_len]}


@register("sequence_reshape")
def _sequence_reshape(ctx, ins, attrs):
    """Each row's (len, d) payload as (len * d / new_dim, new_dim)."""
    (x,) = ins["X"]
    (seqlen,) = ins["SeqLen"]
    new_dim = int(attrs["new_dim"])
    b, t, d = x.shape
    lens = _lens(seqlen)
    out = _masked(x, lens).reshape(b, t * d // new_dim, new_dim)
    return {"Out": [out], "OutLen": [(lens * d // new_dim).to(torch.int32)]}


@register("sequence_scatter")
def _sequence_scatter(ctx, ins, attrs):
    """out[b, ids[b, j]] += updates[b, j] for the valid j."""
    (x,) = ins["X"]  # [B, N]
    (ids,) = ins["Ids"]
    (upd,) = ins["Updates"]
    (seqlen,) = ins["SeqLen"]
    lens = _lens(seqlen)
    b = x.shape[0]
    iv = ids.reshape(b, -1).long()
    uv = upd.reshape(b, -1).to(x.dtype)
    valid = torch.arange(iv.shape[1], device=x.device)[None, :] < lens[:, None]
    uv = torch.where(valid, uv, torch.zeros((), dtype=uv.dtype, device=uv.device))
    iv = torch.where(valid, iv, torch.zeros_like(iv))
    rows = torch.arange(b, device=x.device)[:, None].expand(iv.shape)
    return {"Out": [x.index_put((rows, iv), uv, accumulate=True)]}


@register("sequence_enumerate", no_grad=True)
def _sequence_enumerate(ctx, ins, attrs):
    """Sliding windows of ids: out[b, t] = x[b, t:t + win], pad_value past
    the row's length."""
    (x,) = ins["X"]
    (seqlen,) = ins["SeqLen"]
    win = int(attrs["win_size"])
    pad = int(attrs.get("pad_value", 0))
    lens = _lens(seqlen)
    v = x.reshape(x.shape[:2]) if x.dim() == 3 else x
    t = v.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    padv = torch.full((), pad, dtype=v.dtype, device=v.device)
    cols = []
    for k in range(win):
        g = torch.gather(v, 1, torch.clamp(pos + k, 0, t - 1).expand(v.shape))
        cols.append(torch.where((pos + k) < lens[:, None], g, padv))
    out = torch.stack(cols, dim=2)
    out = torch.where((pos < lens[:, None])[:, :, None], out, padv)
    return {"Out": [out.to(x.dtype)]}


@register("im2sequence")
def _im2sequence(ctx, ins, attrs):
    """Image -> patch sequence: each output row is one flattened kernel
    window, row-major over (out_h, out_w). With Y (per-image real sizes)
    each image keeps its top-left valid sub-grid, moved to a row-major
    prefix, and OutLen carries the lengths (the JAX package's real-size
    mode, which a single image does not enter)."""
    (x,) = ins["X"]  # [B, C, H, W]
    kh, kw = [int(k) for k in attrs["kernels"]]
    sh, sw = [int(s) for s in attrs.get("strides", [1, 1])]
    pads = [int(p) for p in attrs.get("paddings", [0, 0, 0, 0])]
    xp = F.pad(x, (pads[1], pads[3], pads[0], pads[2]))
    oh = (xp.shape[2] - kh) // sh + 1
    ow = (xp.shape[3] - kw) // sw + 1
    patches = F.unfold(xp, (kh, kw), stride=(sh, sw))  # [B, C*kh*kw, OH*OW]
    b = x.shape[0]
    out = patches.transpose(1, 2)
    y = ins.get("Y", [None])[0]
    if y is None:
        return {"Out": [out]}
    if b == 1:
        return {"Out": [out], "OutLen": [torch.full((b,), oh * ow, dtype=torch.int32,
                                                    device=x.device)]}
    osh, osw = [int(s) for s in attrs.get("out_stride", [1, 1])]
    real = y.reshape(b, 2).long()
    rh = -torch.div(-real[:, 0], osh, rounding_mode="floor")
    rw = -torch.div(-real[:, 1], osw, rounding_mode="floor")
    oh_i = torch.clamp(torch.div(rh + pads[0] + pads[2] - kh, sh, rounding_mode="floor") + 1,
                       0, oh)
    ow_i = torch.clamp(torch.div(rw + pads[1] + pads[3] - kw, sw, rounding_mode="floor") + 1,
                       0, ow)
    lens = oh_i * ow_i
    p = torch.arange(oh * ow, device=x.device)[None, :]
    ow_safe = torch.clamp(ow_i, min=1)[:, None]
    src = torch.where(p < lens[:, None],
                      torch.div(p, ow_safe, rounding_mode="floor") * ow
                      + torch.remainder(p, ow_safe), p)
    out = _take_t(out, src)
    out = out * (p < lens[:, None])[..., None].to(out.dtype)
    return {"Out": [out], "OutLen": [lens.to(torch.int32)]}


@register("row_conv")
def _row_conv(ctx, ins, attrs):
    """Lookahead convolution: out[b, t] = sum_k x[b, t + k] * filter[k]."""
    (x,) = ins["X"]  # [B, T, D]
    (w,) = ins["Filter"]  # [future_ctx + 1, D]
    (seqlen,) = ins["SeqLen"]
    lens = _lens(seqlen)
    xm = _masked(x, lens)
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :, None]
    out = torch.zeros_like(xm)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    for k in range(w.shape[0]):
        shifted = torch.where((pos + k) < t, torch.roll(xm, -k, dims=1), zero)
        out = out + shifted * w[k][None, None, :]
    return {"Out": [_masked(out, lens)]}
