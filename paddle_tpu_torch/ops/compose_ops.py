"""Fused and composite ops (the torch counterparts of
paddle_tpu/ops/compose_ops.py): fc, fused_elemwise_activation,
fusion_transpose_flatten_concat, the `lstm` / `gru` aliases of
dynamic_lstm / dynamic_gru, lstmp, cudnn_lstm, the fusion_* recurrent ops,
attention_lstm and conv2d_fusion.

They exist so that programs written with the reference's fused op names
run; each is composed of the same torch calls as its unfused ops, and none
has a Pallas kernel in the JAX package. Sequence inputs are padded dense
tensors with a SeqLen companion, as in ops/sequence_ops.py. The recurrent
ops are Python loops over the static time axis, as dynamic_lstm is there,
so a block holding them captures as one CUDA graph; they infer their
outputs' shapes without running the loop (a dynamic time dim's sentinel
extent would take seconds on meta tensors).

cudnn_lstm keeps the JAX package's flat weight layout, not cuDNN's: per
(layer, direction), [Wx (d_in, 4h) | Wh (h, 4h) | b (4h)], gates in the
order i, f, c, o; the input and Out are sequence-major (T, N, D), the
initial and last states (layers * dirs, N, h).
"""

import torch

from . import sequence_ops
from .registry import OPS, bcast_y, prod, register, set_var_meta

__all__ = ["cudnn_lstm_weight_size"]


def _opt(ins, slot):
    """An optional slot's tensor, or None when absent or empty."""
    vals = ins.get(slot)
    return vals[0] if vals and vals[0] is not None else None


_ACT = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "identity": lambda x: x,
    "": lambda x: x,
}

_BINOPS = {
    "elementwise_add": torch.add,
    "elementwise_sub": torch.sub,
    "elementwise_mul": torch.mul,
}

_UNOPS = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh}


def _var(op, block, slot):
    """The var of an input slot's first name, when it has a shape."""
    names = op.inputs.get(slot) or ()
    if not names or not block.has_var_recursive(names[0]):
        return None
    v = block._var_recursive(names[0])
    return v if v.shape is not None else None


def _set_outs(op, block, shapes, dtype):
    """shapes: {slot: shape} of the op's outputs."""
    for slot, shape in shapes.items():
        for n in op.outputs.get(slot, ()):
            set_var_meta(block, n, shape, dtype)


# ---------------------------------------------------------------------------
# fc + elementwise fusions
# ---------------------------------------------------------------------------


@register("fc")
def _fc(ctx, ins, attrs):
    """The sum of Input[i] @ W[i] (+ Bias), then activation_type: the
    reference's inference-pass fc fusion."""
    in_num_col_dims = int(attrs.get("in_num_col_dims", 1))
    out = None
    for x, w in zip(ins["Input"], ins["W"]):
        term = x.reshape(prod(x.shape[:in_num_col_dims]), -1) @ w
        out = term if out is None else out + term
    bias = _opt(ins, "Bias")
    if bias is not None:
        out = out + bias.reshape(1, -1)
    if attrs.get("activation_type"):
        out = _ACT[attrs["activation_type"]](out)
    x0 = ins["Input"][0]
    return {"Out": [out.reshape(tuple(x0.shape[:in_num_col_dims]) + (out.shape[-1],))]}


@register("fused_elemwise_activation")
def _fused_elemwise_activation(ctx, ins, attrs):
    """functor_list[0] is the outer function: [binary, unary] gives
    binary(x, unary(y)), [unary, binary] gives unary(binary(x, y));
    IntermediateOut is the inner result either way."""
    (x,) = ins["X"]
    (y,) = ins["Y"]
    functors = [f.lower() for f in attrs["functor_list"]]
    axis = int(attrs.get("axis", -1))
    scale = float(attrs.get("scale", 0.0))

    def unary(name, v):
        return v * scale if name == "scale" else _UNOPS[name](v)

    if functors[0] in _BINOPS:
        inter = unary(functors[1], y)
        out = _BINOPS[functors[0]](x, bcast_y(x, inter, axis))
    else:
        inter = _BINOPS[functors[1]](x, bcast_y(x, y, axis))
        out = unary(functors[0], inter)
    return {"Out": [out], "IntermediateOut": [inter]}


@register("fusion_transpose_flatten_concat")
def _fusion_transpose_flatten_concat(ctx, ins, attrs):
    trans = [int(a) for a in attrs["trans_axis"]]
    flat_axis = int(attrs["flatten_axis"])
    concat_axis = int(attrs["concat_axis"])
    pieces = []
    for x in ins["X"]:
        t = x.permute(trans)
        pieces.append(t.reshape(prod(t.shape[:flat_axis]), -1))
    return {"Out": [torch.cat(pieces, dim=concat_axis)]}


# ---------------------------------------------------------------------------
# recurrent composites. "lstm" / "gru" are the reference's op names for
# dynamic_lstm / dynamic_gru: the same lowering, shape inference and grad
# ---------------------------------------------------------------------------

for _alias, _base in (("lstm", "dynamic_lstm"), ("gru", "dynamic_gru")):
    _d = OPS[_base]
    register(_alias, infer_shape=_d.custom_infer_shape, grad=_d.grad)(_d.lower)


def _lstmp_infer(op, block):
    x, wp = _var(op, block, "Input"), _var(op, block, "ProjWeight")
    if x is None or wp is None:
        return
    b, t = x.shape[:2]
    h = x.shape[2] // 4
    _set_outs(op, block, {"Projection": (b, t, wp.shape[1]), "Cell": (b, t, h),
                          "Hidden": (b, t, h)}, x.dtype)


@register("lstmp", infer_shape=_lstmp_infer)
def _lstmp(ctx, ins, attrs):
    """LSTM with a recurrent projection: the recurrence reads
    r = proj_act(h @ ProjWeight) in place of h. Input (b, t, 4h) holds the
    projected input; Weight is (p, 4h), ProjWeight (h, p); gates (c, i, f,
    o) as dynamic_lstm's."""
    (x,) = ins["Input"]
    (w,) = ins["Weight"]
    (wp,) = ins["ProjWeight"]
    (seqlen,) = ins["SeqLen"]
    bias = _opt(ins, "Bias")
    b, t, h4 = x.shape
    h = h4 // 4
    p = wp.shape[1]
    valid = sequence_ops._valid_mask(x, sequence_ops._lens(seqlen))  # (b, t)
    proj_act = _ACT[attrs.get("proj_activation", "identity")]
    gate_bias = bias.reshape(-1)[:4 * h] if bias is not None else None
    r_prev = torch.zeros((b, p), dtype=x.dtype, device=x.device)
    c_prev = torch.zeros((b, h), dtype=x.dtype, device=x.device)
    rs, cs, hs = [], [], []
    for ti in range(t):
        gates = x[:, ti] + r_prev @ w
        if gate_bias is not None:
            gates = gates + gate_bias
        gc, gi, gf, go = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(gf) * c_prev + torch.sigmoid(gi) * torch.tanh(gc)
        h_new = torch.sigmoid(go) * torch.tanh(c_new)
        r_new = proj_act(h_new @ wp)
        m = valid[:, ti:ti + 1]
        r_prev = m * r_new + (1 - m) * r_prev
        c_prev = m * c_new + (1 - m) * c_prev
        rs.append(r_prev)
        cs.append(c_prev)
        hs.append(m * h_new)
    mask = valid[:, :, None]
    return {"Projection": [torch.stack(rs, dim=1) * mask],
            "Cell": [torch.stack(cs, dim=1) * mask],
            "Hidden": [torch.stack(hs, dim=1) * mask]}


def cudnn_lstm_weight_size(input_size, hidden_size, num_layers=1, is_bidirec=False):
    """The flat blob's length in cudnn_lstm's layout (see the module
    docstring)."""
    num_dir = 2 if is_bidirec else 1
    total = 0
    d_in = input_size
    for _ in range(num_layers):
        total += num_dir * (d_in * 4 * hidden_size + hidden_size * 4 * hidden_size
                            + 4 * hidden_size)
        d_in = hidden_size * num_dir
    return total


def _cudnn_lstm_infer(op, block):
    x = _var(op, block, "Input")
    if x is None:
        return
    h = int(op.attrs["hidden_size"])
    dirs = 2 if op.attrs.get("is_bidirec", False) else 1
    states = (int(op.attrs.get("num_layers", 1)) * dirs, x.shape[1], h)
    _set_outs(op, block, {"Out": (x.shape[0], x.shape[1], h * dirs), "last_h": states,
                          "last_c": states}, x.dtype)


@register("cudnn_lstm", infer_shape=_cudnn_lstm_infer)
def _cudnn_lstm(ctx, ins, attrs):
    """Stacked, optionally bidirectional LSTM over a sequence-major (T, N, D)
    input, every step of every row (no lengths). A bidirectional layer
    concatenates its forward and backward hidden states. Dropout between
    layers (dropout_prob, not in test mode) keeps a mask fixed across runs,
    drawn from the op's own generator restarted from its seed attr every
    run, as the JAX package derives it from the seed (its numbers differ):
    the generic grad's replay must draw the same mask."""
    (x,) = ins["Input"]
    (w,) = ins["W"]
    h = int(attrs["hidden_size"])
    num_layers = int(attrs.get("num_layers", 1))
    bidirec = bool(attrs.get("is_bidirec", False))
    num_dir = 2 if bidirec else 1
    _, n, d = x.shape
    flat = w.reshape(-1)
    expected = cudnn_lstm_weight_size(d, h, num_layers, bidirec)
    if flat.shape[0] != expected:
        raise ValueError(
            "cudnn_lstm: W has %d elements but the documented layout needs %d "
            "(input=%d, hidden=%d, layers=%d, bidirec=%s) -- see cudnn_lstm_weight_size"
            % (flat.shape[0], expected, d, h, num_layers, bidirec))
    h0_all, c0_all = _opt(ins, "InitH"), _opt(ins, "InitC")
    dropout_prob = float(attrs.get("dropout_prob", 0.0) or 0.0)
    is_test = bool(attrs.get("is_test", False))
    pos = 0
    cur = x
    last_h, last_c = [], []
    gen = None
    for layer in range(num_layers):
        if layer > 0 and dropout_prob and not is_test and x.device.type != "meta":
            if gen is None:
                gen = ctx.seeded_generator(int(attrs.get("seed", 0) or 0))
            keep = torch.rand(cur.shape, generator=gen, device=cur.device) < 1.0 - dropout_prob
            cur = cur * keep.to(cur.dtype) / (1.0 - dropout_prob)
        d_in = cur.shape[-1]
        outs = []
        for direction in range(num_dir):
            wx = flat[pos:pos + d_in * 4 * h].reshape(d_in, 4 * h)
            pos += d_in * 4 * h
            wh = flat[pos:pos + h * 4 * h].reshape(h, 4 * h)
            pos += h * 4 * h
            bias = flat[pos:pos + 4 * h]
            pos += 4 * h
            idx = layer * num_dir + direction
            h_prev = (h0_all.reshape(-1, n, h)[idx] if h0_all is not None
                      else torch.zeros((n, h), dtype=x.dtype, device=x.device))
            c_prev = (c0_all.reshape(-1, n, h)[idx] if c0_all is not None
                      else torch.zeros((n, h), dtype=x.dtype, device=x.device))
            proj = torch.matmul(cur, wx) + bias  # (T, N, 4h), every step at once
            order = range(cur.shape[0] - 1, -1, -1) if direction == 1 else range(cur.shape[0])
            hs = [None] * cur.shape[0]
            for ti in order:
                gates = proj[ti] + h_prev @ wh
                gi, gf, gc, go = gates.chunk(4, dim=-1)
                c_prev = torch.sigmoid(gf) * c_prev + torch.sigmoid(gi) * torch.tanh(gc)
                h_prev = torch.sigmoid(go) * torch.tanh(c_prev)
                hs[ti] = h_prev
            outs.append(torch.stack(hs, dim=0))
            last_h.append(h_prev)
            last_c.append(c_prev)
        cur = outs[0] if num_dir == 1 else torch.cat(outs, dim=-1)
    return {"Out": [cur], "last_h": [torch.stack(last_h)], "last_c": [torch.stack(last_c)]}


def _project_then(ins, wx_slot, extra):
    (x,) = ins["X"]
    (wx,) = ins[wx_slot]
    sub = dict(extra)
    sub["Input"] = [torch.einsum("btd,dg->btg", x, wx)]
    sub["SeqLen"] = ins["SeqLen"]
    for slot in ("H0", "C0", "Bias"):
        if _opt(ins, slot) is not None:
            sub[slot] = ins[slot]
    return sub


def _fusion_rnn_infer(op, block):
    """Hidden (and Cell) are (b, t, h), h the recurrent weight's first dim;
    the batch and time dims are those of X (Ids for the embedding form)."""
    x = _var(op, block, "X") if "X" in op.inputs else _var(op, block, "Ids")
    w = _var(op, block, "WeightH")
    if x is None or w is None:
        return
    shape = tuple(x.shape[:2]) + (w.shape[0],)
    dtype = w.dtype
    _set_outs(op, block, {"Hidden": shape, "Cell": shape}, dtype)


@register("fusion_lstm", infer_shape=_fusion_rnn_infer)
def _fusion_lstm(ctx, ins, attrs):
    """x @ WeightX, then dynamic_lstm's recurrence."""
    sub = _project_then(ins, "WeightX", {"Weight": ins["WeightH"]})
    return OPS["dynamic_lstm"].lower(ctx, sub, attrs)


@register("fusion_gru", infer_shape=_fusion_rnn_infer)
def _fusion_gru(ctx, ins, attrs):
    sub = _project_then(ins, "WeightX", {"Weight": ins["WeightH"]})
    return OPS["dynamic_gru"].lower(ctx, sub, attrs)


@register("fused_embedding_fc_lstm", infer_shape=_fusion_rnn_infer)
def _fused_embedding_fc_lstm(ctx, ins, attrs):
    """An embedding lookup of rows already multiplied by the fc weight, then
    dynamic_lstm's recurrence."""
    (ids,) = ins["Ids"]  # (b, t) or (b, t, 1)
    (emb,) = ins["Embeddings"]  # (vocab, 4h)
    sub = {"Input": [emb[ids.reshape(ids.shape[0], -1).long()]],
           "Weight": ins["WeightH"], "SeqLen": ins["SeqLen"]}
    for slot in ("H0", "C0", "Bias"):
        if _opt(ins, slot) is not None:
            sub[slot] = ins[slot]
    return OPS["dynamic_lstm"].lower(ctx, sub, attrs)


@register("fusion_seqconv_eltadd_relu")
def _fusion_seqconv_eltadd_relu(ctx, ins, attrs):
    """sequence_conv, + Bias, relu, with the padding masked to zero again."""
    out = sequence_ops._sequence_conv(
        ctx, {"X": ins["X"], "Filter": ins["Filter"], "SeqLen": ins["SeqLen"]}, attrs)["Out"][0]
    out = torch.relu(out + ins["Bias"][0].reshape(1, 1, -1))
    return {"Out": [sequence_ops._masked(out, sequence_ops._lens(ins["SeqLen"][0]))]}


@register("fusion_seqexpand_concat_fc")
def _fusion_seqexpand_concat_fc(ctx, ins, attrs):
    """X[0] is the full sequence (b, t, d0); the rest are per-sequence
    vectors broadcast over time; concat, fc and fc_activation."""
    xs = ins["X"]
    (w,) = ins["FCWeight"]
    seq = xs[0]
    b, t = seq.shape[:2]
    parts = [seq] + [v[:, None, :].expand(b, t, v.shape[-1]) for v in xs[1:]]
    out = torch.einsum("btd,do->bto", torch.cat(parts, dim=-1), w)
    fc_bias = _opt(ins, "FCBias")
    if fc_bias is not None:
        out = out + fc_bias.reshape(1, 1, -1)
    return {"Out": [_ACT[attrs.get("fc_activation", "identity")](out)]}


def _attention_lstm_infer(op, block):
    x, lw = _var(op, block, "X"), _var(op, block, "LSTMWeight")
    if x is None or lw is None:
        return
    shape = tuple(x.shape[:2]) + (lw.shape[1] // 4,)
    _set_outs(op, block, {"Hidden": shape, "Cell": shape}, x.dtype)


@register("attention_lstm", infer_shape=_attention_lstm_infer)
def _attention_lstm(ctx, ins, attrs):
    """Every step: scores fc([x_t, h_prev]) over the row's valid steps,
    softmax, the attended vector and h_prev into one LSTM step (gates c,
    i, f, o)."""
    (x,) = ins["X"]  # (b, t, d)
    (seqlen,) = ins["SeqLen"]
    (aw,) = ins["AttentionWeight"]  # (d + h, 1)
    (lw,) = ins["LSTMWeight"]  # (d + h, 4h)
    lstm_bias = _opt(ins, "LSTMBias")
    lb = lstm_bias.reshape(-1) if lstm_bias is not None else 0.0
    atten_bias = _opt(ins, "AttentionBias")
    scalar = _opt(ins, "AttentionScalar")
    scalar_bias = _opt(ins, "AttentionScalarBias")
    b, t, d = x.shape
    h = lw.shape[1] // 4
    valid = sequence_ops._valid_mask(x, sequence_ops._lens(seqlen)) > 0  # (b, t)
    h_prev = _opt(ins, "H0")
    h_prev = torch.zeros((b, h), dtype=x.dtype, device=x.device) if h_prev is None else h_prev
    c_prev = _opt(ins, "C0")
    c_prev = torch.zeros((b, h), dtype=x.dtype, device=x.device) if c_prev is None else c_prev
    aw_x, aw_h = aw[:d, 0], aw[d:, 0]
    x_score = x @ aw_x  # (b, t): the same every step
    neg_inf = torch.full_like(x_score, float("-inf"))
    hs, cs = [], []
    for _ in range(t):
        score = x_score + (h_prev @ aw_h[:, None]).reshape(b, 1)
        if atten_bias is not None:
            score = score + atten_bias.reshape(-1)
        if scalar is not None:
            score = score * scalar.reshape(())
            if scalar_bias is not None:
                score = score + scalar_bias.reshape(())
        alpha = torch.softmax(torch.where(valid, score, neg_inf), dim=1)
        atted = torch.einsum("bt,btd->bd", alpha, x)
        gates = torch.cat([atted, h_prev], dim=-1) @ lw + lb
        gc, gi, gf, go = gates.chunk(4, dim=-1)
        c_prev = torch.sigmoid(gf) * c_prev + torch.sigmoid(gi) * torch.tanh(gc)
        h_prev = torch.sigmoid(go) * torch.tanh(c_prev)
        hs.append(h_prev)
        cs.append(c_prev)
    mask = valid.to(x.dtype)[..., None]
    return {"Hidden": [torch.stack(hs, dim=1) * mask], "Cell": [torch.stack(cs, dim=1) * mask]}


@register("conv2d_fusion")
def _conv2d_fusion(ctx, ins, attrs):
    """conv2d + Bias + ResidualData, then `activation` (relu by default)."""
    from .core_ops import _conv2d

    out = _conv2d(ctx, ins, attrs)["Output"][0]
    bias = _opt(ins, "Bias")
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    residual = _opt(ins, "ResidualData")
    if residual is not None:
        out = out + residual
    act = attrs.get("activation", "relu")
    if act and act != "identity":
        out = _ACT[act](out)
    return {"Output": [out]}

