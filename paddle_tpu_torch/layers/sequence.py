"""Sequence layers over the padded+lengths representation (reference
python/paddle/fluid/layers/nn.py: dynamic_lstm, dynamic_gru, sequence_pool,
sequence_softmax, sequence_conv, sequence_first/last_step, gru_unit); a copy
of paddle_tpu/layers/sequence.py, whose ops lower in ops/sequence_ops.py.

A ragged variable carries `_len_name` pointing at its `<name>@LEN` companion
(created by layers.data(lod_level=1) / propagated by sequence-aware layers)."""

from ..framework import Variable
from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = [
    "dynamic_lstm",
    "dynamic_gru",
    "gru_unit",
    "sequence_pool",
    "sequence_softmax",
    "sequence_conv",
    "sequence_first_step",
    "sequence_last_step",
    "sequence_reverse",
    "sequence_expand",
    "sequence_expand_as",
    "sequence_pad",
    "sequence_unpad",
    "sequence_mask",
    "sequence_concat",
    "sequence_slice",
    "sequence_erase",
    "sequence_reshape",
    "sequence_scatter",
    "sequence_enumerate",
    "im2sequence",
    "row_conv",
]


def seq_len_of(var):
    name = getattr(var, "_len_name", None)
    if name is None:
        raise ValueError(
            "variable %r has no sequence-length companion; build ragged inputs "
            "with layers.data(..., lod_level=1) or propagate through sequence "
            "layers" % var.name
        )
    return name


def _propagate(dst, src):
    if getattr(src, "_len_name", None):
        dst._len_name = src._len_name
    return dst


def dynamic_lstm(
    input,
    size,
    h_0=None,
    c_0=None,
    param_attr=None,
    bias_attr=None,
    use_peepholes=True,
    is_reverse=False,
    gate_activation="sigmoid",
    cell_activation="tanh",
    candidate_activation="tanh",
    dtype="float32",
    name=None,
):
    """reference layers/nn.py dynamic_lstm → lstm op. `input` is the fc
    projection (b, t, 4*hidden); returns (hidden, cell) sequences. h_0/c_0
    are optional (batch, hidden) warm-start states (reference nn.py:362: both
    must be given together)."""
    if (h_0 is None) != (c_0 is None):
        raise ValueError(
            "dynamic_lstm needs h_0 and c_0 together (reference layers/nn.py "
            "dynamic_lstm contract)"
        )
    helper = LayerHelper("lstm", **locals())
    hidden_size = size // 4
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[hidden_size, 4 * hidden_size], dtype=dtype
    )
    bias_size = [1, 7 * hidden_size] if use_peepholes else [1, 4 * hidden_size]
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=bias_size, dtype=dtype, is_bias=True
    )
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    inputs = {
        "Input": [input.name],
        "Weight": [weight.name],
        "Bias": [bias.name],
        "SeqLen": [seq_len_of(input)],
    }
    if h_0 is not None:
        inputs["H0"] = [h_0.name]
        inputs["C0"] = [c_0.name]
    helper.append_op(
        type="dynamic_lstm",
        inputs=inputs,
        outputs={"Hidden": [hidden.name], "Cell": [cell.name]},
        attrs={
            "use_peepholes": use_peepholes,
            "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "cell_activation": cell_activation,
            "candidate_activation": candidate_activation,
        },
    )
    _propagate(hidden, input)
    _propagate(cell, input)
    return hidden, cell


def dynamic_gru(
    input,
    size,
    param_attr=None,
    bias_attr=None,
    is_reverse=False,
    gate_activation="sigmoid",
    candidate_activation="tanh",
    h_0=None,
    name=None,
):
    helper = LayerHelper("gru", **locals())
    dtype = input.dtype
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[size, 3 * size], dtype=dtype
    )
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=[1, 3 * size], dtype=dtype, is_bias=True
    )
    hidden = helper.create_variable_for_type_inference(dtype)
    inputs = {
        "Input": [input.name],
        "Weight": [weight.name],
        "Bias": [bias.name],
        "SeqLen": [seq_len_of(input)],
    }
    if h_0 is not None:
        # (batch, hidden) warm-start state (reference layers/nn.py:453)
        inputs["H0"] = [h_0.name]
    helper.append_op(
        type="dynamic_gru",
        inputs=inputs,
        outputs={"Hidden": [hidden.name]},
        attrs={
            "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "activation": candidate_activation,
        },
    )
    return _propagate(hidden, input)


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None, activation="tanh", gate_activation="sigmoid"):
    helper = LayerHelper("gru_unit", **locals())
    dtype = input.dtype
    hidden_size = size // 3
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[hidden_size, 3 * hidden_size], dtype=dtype
    )
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=[1, 3 * hidden_size], dtype=dtype, is_bias=True
    )
    gate = helper.create_variable_for_type_inference(dtype)
    reset_hidden = helper.create_variable_for_type_inference(dtype)
    updated = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="gru_unit",
        inputs={
            "Input": [input.name],
            "HiddenPrev": [hidden.name],
            "Weight": [weight.name],
            "Bias": [bias.name],
        },
        outputs={
            "Gate": [gate.name],
            "ResetHiddenPrev": [reset_hidden.name],
            "Hidden": [updated.name],
        },
        attrs={"activation": activation, "gate_activation": gate_activation},
    )
    return updated, reset_hidden, gate


def sequence_pool(input, pool_type):
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="sequence_pool",
        inputs={"X": [input.name], "SeqLen": [seq_len_of(input)]},
        outputs={"Out": [out.name]},
        attrs={"pooltype": pool_type.upper()},
    )
    return out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def sequence_softmax(input, use_cudnn=False, name=None):
    helper = LayerHelper("sequence_softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="sequence_softmax",
        inputs={"X": [input.name], "SeqLen": [seq_len_of(input)]},
        outputs={"Out": [out.name]},
    )
    return _propagate(out, input)


def sequence_conv(
    input,
    num_filters,
    filter_size=3,
    filter_stride=1,
    padding=None,
    bias_attr=None,
    param_attr=None,
    act=None,
    name=None,
):
    helper = LayerHelper("sequence_conv", **locals())
    dtype = input.dtype
    d_in = input.shape[-1]
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[filter_size * d_in, num_filters], dtype=dtype
    )
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="sequence_conv",
        inputs={
            "X": [input.name],
            "Filter": [w.name],
            "SeqLen": [seq_len_of(input)],
        },
        outputs={"Out": [out.name]},
        attrs={
            "contextLength": filter_size,
            "contextStart": -((filter_size - 1) // 2),
            "contextStride": filter_stride,
        },
    )
    _propagate(out, input)
    pre_act = helper.append_bias_op(out, dim_start=2)
    _propagate(pre_act, input)
    result = helper.append_activation(pre_act)
    return _propagate(result, input)


def sequence_reverse(x, name=None):
    helper = LayerHelper("sequence_reverse", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sequence_reverse",
        inputs={"X": [x.name], "SeqLen": [seq_len_of(x)]},
        outputs={"Y": [out.name]},
    )
    return _propagate(out, x)


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sequence_expand",
        inputs={"X": [x.name], "Y": [y.name]},
        outputs={"Out": [out.name]},
        attrs={"ref_level": ref_level},
    )
    return _propagate(out, y)


def _new_len_var(helper, out):
    """Create the `<out>@LEN` companion var (before the op that writes it is
    appended, so shape inference can resolve it) and attach it."""
    len_name = out.name + "@LEN"
    helper.main_program.current_block().create_var(
        name=len_name, shape=(-1,), dtype="int32"
    )
    out._len_name = len_name
    return len_name


def sequence_pad(x, pad_value, maxlen=None, name=None):
    """reference layers/nn.py sequence_pad → sequence_pad_op.cc. Returns
    (padded, lengths); the padded-dense rep makes this mostly a pad-value
    fill plus optional capacity change."""
    helper = LayerHelper("sequence_pad", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    # the op's Length output (clamped to the capacity) becomes the companion,
    # NOT the input lengths — they diverge when maxlen truncates
    len_name = _new_len_var(helper, out)
    helper.append_op(
        type="sequence_pad",
        inputs={
            "X": [x.name],
            "PadValue": [pad_value.name],
            "SeqLen": [seq_len_of(x)],
        },
        outputs={"Out": [out.name], "Length": [len_name]},
        attrs={"padded_length": -1 if maxlen is None else int(maxlen)},
    )
    return out, helper.main_program.current_block().var(len_name)


def sequence_unpad(x, length, name=None):
    """reference layers/nn.py sequence_unpad → sequence_unpad_op.cc; output
    carries `length` as its ragged companion."""
    helper = LayerHelper("sequence_unpad", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sequence_unpad",
        inputs={"X": [x.name], "Length": [length.name]},
        outputs={"Out": [out.name]},
    )
    out._len_name = length.name
    return out


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """reference layers/nn.py sequence_mask → sequence_mask_op.cc. maxlen is
    required (static shapes, as in the JAX package)."""
    if maxlen is None:
        raise ValueError("sequence_mask requires maxlen (static shapes)")
    helper = LayerHelper("sequence_mask", **locals())
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="sequence_mask",
        inputs={"X": [x.name]},
        outputs={"Y": [out.name]},
        attrs={"maxlen": int(maxlen), "out_dtype": dtype},
    )
    out.stop_gradient = True
    return out


def sequence_concat(input, name=None):
    """reference layers/nn.py sequence_concat → sequence_concat_op.cc:
    per-row concatenation along time."""
    helper = LayerHelper("sequence_concat", **locals())
    out = helper.create_variable_for_type_inference(input[0].dtype)
    len_name = _new_len_var(helper, out)
    helper.append_op(
        type="sequence_concat",
        inputs={
            "X": [v.name for v in input],
            "SeqLen": [seq_len_of(v) for v in input],
        },
        outputs={"Out": [out.name], "OutLen": [len_name]},
    )
    return out


def sequence_expand_as(x, y, name=None):
    """reference layers/nn.py sequence_expand_as → sequence_expand_as_op.cc."""
    helper = LayerHelper("sequence_expand_as", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sequence_expand_as",
        inputs={"X": [x.name], "Y": [y.name], "SeqLen": [seq_len_of(y)]},
        outputs={"Out": [out.name]},
    )
    out._len_name = seq_len_of(y)
    return out


def sequence_slice(input, offset, length, name=None):
    """reference layers/nn.py sequence_slice → sequence_slice_op.h."""
    helper = LayerHelper("sequence_slice", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    len_name = _new_len_var(helper, out)
    helper.append_op(
        type="sequence_slice",
        inputs={
            "X": [input.name],
            "Offset": [offset.name],
            "Length": [length.name],
        },
        outputs={"Out": [out.name], "OutLen": [len_name]},
    )
    return out


def sequence_erase(input, tokens, name=None):
    """reference sequence_erase_op.cc: drop listed tokens, re-compact."""
    helper = LayerHelper("sequence_erase", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    len_name = _new_len_var(helper, out)
    helper.append_op(
        type="sequence_erase",
        inputs={"X": [input.name], "SeqLen": [seq_len_of(input)]},
        outputs={"Out": [out.name], "OutLen": [len_name]},
        attrs={"tokens": list(tokens)},
    )
    return out


def sequence_reshape(input, new_dim):
    """reference sequence_reshape_op.cc."""
    helper = LayerHelper("sequence_reshape", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    len_name = _new_len_var(helper, out)
    helper.append_op(
        type="sequence_reshape",
        inputs={"X": [input.name], "SeqLen": [seq_len_of(input)]},
        outputs={"Out": [out.name], "OutLen": [len_name]},
        attrs={"new_dim": int(new_dim)},
    )
    return out


def sequence_scatter(input, index, updates, name=None):
    """reference sequence_scatter_op.cc."""
    helper = LayerHelper("sequence_scatter", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="sequence_scatter",
        inputs={
            "X": [input.name],
            "Ids": [index.name],
            "Updates": [updates.name],
            "SeqLen": [seq_len_of(index)],
        },
        outputs={"Out": [out.name]},
    )
    return out


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    """reference sequence_enumerate_op.cc: sliding id windows."""
    helper = LayerHelper("sequence_enumerate", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="sequence_enumerate",
        inputs={"X": [input.name], "SeqLen": [seq_len_of(input)]},
        outputs={"Out": [out.name]},
        attrs={"win_size": int(win_size), "pad_value": int(pad_value)},
    )
    out._len_name = seq_len_of(input)
    return out


def im2sequence(
    input,
    filter_size=1,
    stride=1,
    padding=0,
    input_image_size=None,
    out_stride=1,
    name=None,
):
    """Image → patch sequence (reference layers/nn.py im2sequence →
    im2sequence_op.cc). Without input_image_size, output rows all share
    length out_h*out_w (emitted as a fill_constant_batch_size_like
    companion). With input_image_size — a (batch, 2) tensor of per-image
    (real_h, real_w) — each row's valid length follows the reference's
    real-size formula (im2sequence_op.h:52-110) via ceil(real/out_stride),
    and the op emits the ragged lengths itself."""
    from .nn import _pair
    from .tensor import fill_constant_batch_size_like

    if input_image_size is None and out_stride != 1:
        raise ValueError(
            "im2sequence out_stride is only meaningful with input_image_size "
            "(reference im2sequence_op.h real-size mode)"
        )
    helper = LayerHelper("im2sequence", **locals())
    kernels = _pair(filter_size)
    strides = _pair(stride)
    pads = padding if isinstance(padding, (list, tuple)) and len(padding) == 4 else _pair(padding) * 2
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": [input.name]}
    outputs = {"Out": [out.name]}
    attrs = {"kernels": kernels, "strides": strides, "paddings": list(pads)}
    if input_image_size is not None:
        inputs["Y"] = [input_image_size.name]
        attrs["out_stride"] = _pair(out_stride)
        outputs["OutLen"] = [_new_len_var(helper, out)]
    helper.append_op(
        type="im2sequence", inputs=inputs, outputs=outputs, attrs=attrs
    )
    if input_image_size is not None:
        return out
    h, w = input.shape[2], input.shape[3]
    oh = (h + pads[0] + pads[2] - kernels[0]) // strides[0] + 1
    ow = (w + pads[1] + pads[3] - kernels[1]) // strides[1] + 1
    lens = fill_constant_batch_size_like(
        input, shape=[-1], dtype="int32", value=oh * ow
    )
    out._len_name = lens.name
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Lookahead convolution (reference layers/nn.py row_conv →
    row_conv_op.cc)."""
    helper = LayerHelper("row_conv", **locals())
    dtype = helper.input_dtype()
    d = input.shape[-1]
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[future_context_size + 1, d], dtype=dtype
    )
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="row_conv",
        inputs={
            "X": [input.name],
            "Filter": [w.name],
            "SeqLen": [seq_len_of(input)],
        },
        outputs={"Out": [out.name]},
    )
    out._len_name = seq_len_of(input)
    return helper.append_activation(out)
