"""Neural-network layers: paddle_tpu/layers/nn.py's (reference
python/paddle/fluid/layers/nn.py). Each layer appends the same ops with
the same attrs as the JAX package's, so a model builder yields the same
Program in both packages.
`conv2d_transpose` builds its op, which ops/nn_extra_ops.py lowers."""

import numpy as np

from ..framework import Variable
from ..initializer import Constant, Normal
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = [
    "fc",
    "embedding",
    "layer_norm",
    "softmax",
    "matmul",
    "mul",
    "reshape",
    "transpose",
    "elementwise_add",
    "elementwise_sub",
    "elementwise_mul",
    "elementwise_div",
    "elementwise_min",
    "elementwise_max",
    "elementwise_pow",
    "dropout",
    "conv2d",
    "pool2d",
    "batch_norm",
    "softmax_with_cross_entropy",
    "cross_entropy",
    "square_error_cost",
    "sigmoid_cross_entropy_with_logits",
    "hash",
    "topk",
    "reduce_sum",
    "reduce_mean",
    "reduce_max",
    "reduce_min",
    "reduce_prod",
    "mean",
    "one_hot",
    "flatten",
    "gather",
    "shape",
    "clip",
    "clip_by_norm",
    "leaky_relu",
    "relu",
    "log",
    "kv_cache_write",
    "paged_attention",
    "ring_attention",
    "distributed_embedding",
    "flash_attention",
    "squeeze",
    "unsqueeze",
    "expand",
    "chunk_eval",
    "autoincreased_step_counter",
    "beam_search",
    "beam_search_decode",
    "conv2d_transpose",
    "smooth_l1",
    "log_loss",
    "split",
    "lrn",
    "pad",
    "pad2d",
    "label_smooth",
    "stack",
    "unstack",
    "scatter",
    "slice",
    "prelu",
    "l2_normalize",
    "image_resize",
    "resize_bilinear",
    "resize_nearest",
]


def fc(
    input,
    size,
    num_flatten_dims=1,
    param_attr=None,
    bias_attr=None,
    act=None,
    is_test=False,
    name=None,
):
    """Fully-connected layer (reference layers/nn.py fc): one mul op per
    input, their sum, bias and activation. A ragged input (one with a
    `_len_name`) is padded (b, t, d), so the default num_flatten_dims=1
    (per timestep, in the reference's packed LoD form) flattens the feature
    dim alone, and the output keeps the length companion."""
    helper = LayerHelper("fc", **locals())
    dtype = helper.input_dtype()
    all_inputs = helper.multiple_input()
    if num_flatten_dims == 1 and len(all_inputs) > 1:
        # mixed ragged and dense inputs would give mul results of two ranks
        out_ranks = {
            (len(v.shape) if getattr(v, "_len_name", None) else 2)
            for v in all_inputs
        }
        if len(out_ranks) > 1:
            raise ValueError(
                "fc with mixed ragged and non-ragged inputs is ambiguous; "
                "pass an explicit num_flatten_dims"
            )
    mul_results = []
    for input_var, param_attr in helper.iter_inputs_and_params():
        input_shape = input_var.shape
        nfd = num_flatten_dims
        if getattr(input_var, "_len_name", None) and num_flatten_dims == 1:
            nfd = len(input_shape) - 1
        w = helper.create_parameter(
            attr=param_attr,
            shape=[int(np.prod(input_shape[nfd:])), size],
            dtype=dtype,
            is_bias=False,
        )
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op(
            type="mul",
            inputs={"X": [input_var.name], "Y": [w.name]},
            outputs={"Out": [tmp.name]},
            attrs={"x_num_col_dims": nfd, "y_num_col_dims": 1},
        )
        if getattr(input_var, "_len_name", None):
            tmp._len_name = input_var._len_name
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op(
            type="sum",
            inputs={"X": [v.name for v in mul_results]},
            outputs={"Out": [pre_bias.name]},
        )
    pre_act = helper.append_bias_op(pre_bias, dim_start=nfd)
    out = helper.append_activation(pre_act)
    from .sequence import _propagate

    return _propagate(out, mul_results[0])


def embedding(
    input,
    size,
    is_sparse=False,
    is_distributed=False,
    padding_idx=None,
    param_attr=None,
    dtype="float32",
):
    """Embedding lookup (reference layers/nn.py embedding → lookup_table op).
    `is_distributed=True` row-shards the table over the mesh 'ep' axis via
    the EmbeddingEngine (distributed_embedding)."""
    if is_distributed:
        return distributed_embedding(
            input,
            size,
            param_attr=param_attr,
            dtype=dtype,
            is_sparse=is_sparse,
            padding_idx=padding_idx,
        )
    helper = LayerHelper("embedding", **locals())
    w = helper.create_parameter(
        attr=helper.param_attr, shape=size, dtype=dtype, is_bias=False
    )
    tmp = helper.create_variable_for_type_inference(dtype)
    padding_idx = (
        -1
        if padding_idx is None
        else padding_idx
        if padding_idx >= 0
        else (size[0] + padding_idx)
    )
    helper.append_op(
        type="lookup_table",
        inputs={"W": [w.name], "Ids": [input.name]},
        outputs={"Out": [tmp.name]},
        attrs={
            "is_sparse": is_sparse,
            "is_distributed": is_distributed,
            "padding_idx": padding_idx,
        },
    )
    if getattr(input, "_len_name", None):
        tmp._len_name = input._len_name
    return tmp


def hash(input, hash_size, num_hash=1, name=None):
    """Feature-hash integer ids into [0, hash_size) buckets (reference
    layers/nn.py hash -> hash op): Out is [N, num_hash, 1], one bucket id per
    hash seed, ready to feed `embedding`. See ops/core_ops.py _hash for the
    XXH32 scheme."""
    helper = LayerHelper("hash", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="hash",
        inputs={"X": [input.name]},
        outputs={"Out": [out.name]},
        attrs={"num_hash": num_hash, "mod_by": hash_size},
    )
    out.stop_gradient = True
    return out


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sigmoid_cross_entropy_with_logits",
        inputs={"X": [x.name], "Label": [label.name]},
        outputs={"Out": [out.name]},
        attrs={"ignore_index": ignore_index},
    )
    return out


def layer_norm(
    input,
    scale=True,
    shift=True,
    begin_norm_axis=1,
    epsilon=1e-5,
    param_attr=None,
    bias_attr=None,
    act=None,
    name=None,
):
    helper = LayerHelper("layer_norm", **locals())
    dtype = helper.input_dtype()
    param_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input.name]}
    if scale:
        s = helper.create_parameter(
            attr=helper.param_attr,
            shape=param_shape,
            dtype=dtype,
            default_initializer=Constant(1.0),
        )
        inputs["Scale"] = [s.name]
    if shift:
        b = helper.create_parameter(
            attr=helper.bias_attr, shape=param_shape, dtype=dtype, is_bias=True
        )
        inputs["Bias"] = [b.name]
    mean_out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    var_out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="layer_norm",
        inputs=inputs,
        outputs={"Y": [out.name], "Mean": [mean_out.name], "Variance": [var_out.name]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis},
    )
    return helper.append_activation(out)


def softmax(input, use_cudnn=True, name=None):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="softmax", inputs={"X": [input.name]}, outputs={"Out": [out.name]}
    )
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="matmul",
        inputs={"X": [x.name], "Y": [y.name]},
        outputs={"Out": [out.name]},
        attrs={
            "transpose_X": transpose_x,
            "transpose_Y": transpose_y,
            "alpha": float(alpha),
        },
    )
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="mul",
        inputs={"X": [x.name], "Y": [y.name]},
        outputs={"Out": [out.name]},
        attrs={"x_num_col_dims": x_num_col_dims, "y_num_col_dims": y_num_col_dims},
    )
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", name=name, act=act)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op(
        type="reshape2",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name], "XShape": [xshape.name]},
        attrs={"shape": [int(s) for s in shape]},
    )
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op(
        type="transpose2",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name], "XShape": [xshape.name]},
        attrs={"axis": list(perm)},
    )
    return out


def _elementwise(op_type, x, y, axis, act, name):
    helper = LayerHelper(op_type, name=name, act=act)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type=op_type,
        inputs={"X": [x.name], "Y": [y.name]},
        outputs={"Out": [out.name]},
        attrs={"axis": axis},
    )
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_max", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_pow", x, y, axis, act, name)


def dropout(
    x,
    dropout_prob,
    is_test=False,
    seed=None,
    name=None,
    dropout_implementation="downgrade_in_infer",
):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    mask = helper.create_variable_for_type_inference(dtype=x.dtype, stop_gradient=True)
    helper.append_op(
        type="dropout",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name], "Mask": [mask.name]},
        attrs={
            "dropout_prob": dropout_prob,
            "is_test": is_test,
            "seed": seed if seed is not None else 0,
            "dropout_implementation": dropout_implementation,
        },
    )
    return out


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def conv2d(
    input,
    num_filters,
    filter_size,
    stride=1,
    padding=0,
    dilation=1,
    groups=None,
    param_attr=None,
    bias_attr=None,
    use_cudnn=True,
    act=None,
    name=None,
):
    """2-D convolution, NCHW / OIHW (reference layers/nn.py conv2d): a
    conv2d op, a bias over the channel axis, the activation. The filter
    starts from N(0, sqrt(2 / fan_in)), as in the JAX package."""
    helper = LayerHelper("conv2d", **locals())
    dtype = helper.input_dtype()
    num_channels = input.shape[1]
    groups = groups or 1
    filter_size = _pair(filter_size)
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    fan_in = (num_channels // groups) * filter_shape[2] * filter_shape[3]
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=filter_shape,
        dtype=dtype,
        default_initializer=Normal(0.0, (2.0 / fan_in) ** 0.5),
    )
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d",
        inputs={"Input": [input.name], "Filter": [w.name]},
        outputs={"Output": [pre_bias.name]},
        attrs={
            "strides": stride,
            "paddings": padding,
            "dilations": dilation,
            "groups": groups,
            "use_cudnn": use_cudnn,
        },
    )
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(
    input,
    pool_size=-1,
    pool_type="max",
    pool_stride=1,
    pool_padding=0,
    global_pooling=False,
    use_cudnn=True,
    ceil_mode=False,
    name=None,
    exclusive=True,
):
    helper = LayerHelper("pool2d", **locals())
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op(
        type="pool2d",
        inputs={"X": [input.name]},
        outputs={"Out": [out.name]},
        attrs={
            "pooling_type": pool_type,
            "ksize": _pair(pool_size),
            "global_pooling": global_pooling,
            "strides": _pair(pool_stride),
            "paddings": _pair(pool_padding),
            "ceil_mode": ceil_mode,
            "exclusive": exclusive,
        },
    )
    return out


def batch_norm(
    input,
    act=None,
    is_test=False,
    momentum=0.9,
    epsilon=1e-5,
    param_attr=None,
    bias_attr=None,
    data_layout="NCHW",
    in_place=False,
    name=None,
    moving_mean_name=None,
    moving_variance_name=None,
    do_model_average_for_mean_and_var=False,
    use_global_stats=False,
):
    """Batch normalization (reference layers/nn.py batch_norm). The running
    mean and variance are persistable parameters that are not trained; the
    op writes them back itself (MeanOut / VarianceOut name the same
    variables)."""
    helper = LayerHelper("batch_norm", **locals())
    dtype = helper.input_dtype()
    channels = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    param_shape = [channels]
    scale = helper.create_parameter(
        attr=helper.param_attr,
        shape=param_shape,
        dtype=dtype,
        default_initializer=Constant(1.0),
    )
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=param_shape, dtype=dtype, is_bias=True
    )
    mean = helper.create_parameter(
        attr=ParamAttr(name=moving_mean_name, initializer=Constant(0.0), trainable=False),
        shape=param_shape,
        dtype=dtype,
    )
    variance = helper.create_parameter(
        attr=ParamAttr(name=moving_variance_name, initializer=Constant(1.0), trainable=False),
        shape=param_shape,
        dtype=dtype,
    )
    mean.stop_gradient = True
    variance.stop_gradient = True
    saved_mean = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    saved_variance = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    out = input if in_place else helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="batch_norm",
        inputs={
            "X": [input.name],
            "Scale": [scale.name],
            "Bias": [bias.name],
            "Mean": [mean.name],
            "Variance": [variance.name],
        },
        outputs={
            "Y": [out.name],
            "MeanOut": [mean.name],
            "VarianceOut": [variance.name],
            "SavedMean": [saved_mean.name],
            "SavedVariance": [saved_variance.name],
        },
        attrs={
            "momentum": momentum,
            "epsilon": epsilon,
            "is_test": is_test,
            "data_layout": data_layout,
            "use_global_stats": use_global_stats,
        },
    )
    return helper.append_activation(out)


def softmax_with_cross_entropy(
    logits,
    label,
    soft_label=False,
    ignore_index=-100,
    numeric_stable_mode=True,
    return_softmax=False,
    smooth_eps=0.0,
):
    """smooth_eps (hard labels only): uniform label smoothing fused into the
    CE — identical to label_smooth(one_hot(label, V), eps) + soft_label CE,
    without materializing the [N, V] one-hot."""
    if smooth_eps and soft_label:
        raise ValueError("smooth_eps applies to hard labels only")
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits.name], "Label": [label.name]},
        outputs={"Softmax": [softmax_out.name], "Loss": [loss.name]},
        attrs={
            "soft_label": soft_label,
            "ignore_index": ignore_index,
            "numeric_stable_mode": numeric_stable_mode,
            "smooth_eps": float(smooth_eps),
        },
    )
    if return_softmax:
        return loss, softmax_out
    return loss


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="cross_entropy",
        inputs={"X": [input.name], "Label": [label.name]},
        outputs={"Y": [out.name]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index},
    )
    return out


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="square_error_cost",
        inputs={"X": [input.name], "Y": [label.name]},
        outputs={"Out": [out.name]},
    )
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="top_k",
        inputs={"X": [input.name]},
        outputs={"Out": [values.name], "Indices": [indices.name]},
        attrs={"k": int(k)},
    )
    values.stop_gradient = True
    indices.stop_gradient = True
    return values, indices


def _reduce(op_type, input, dim, keep_dim, name):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is not None and not isinstance(dim, (list, tuple)):
        dim = [dim]
    helper.append_op(
        type=op_type,
        inputs={"X": [input.name]},
        outputs={"Out": [out.name]},
        attrs={
            "dim": dim if dim is not None else [0],
            "keep_dim": keep_dim,
            "reduce_all": dim is None,
        },
    )
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", input, dim, keep_dim, name)


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="mean", inputs={"X": [x.name]}, outputs={"Out": [out.name]})
    return out


def one_hot(input, depth):
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="one_hot",
        inputs={"X": [input.name]},
        outputs={"Out": [out.name]},
        attrs={"depth": depth},
    )
    return out


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op(
        type="flatten2",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name], "XShape": [xshape.name]},
        attrs={"axis": axis},
    )
    return out


def gather(input, index):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="gather",
        inputs={"X": [input.name], "Index": [index.name]},
        outputs={"Out": [out.name]},
    )
    return out


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="shape", inputs={"Input": [input.name]}, outputs={"Out": [out.name]}
    )
    return out


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="clip",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name]},
        attrs={"min": float(min), "max": float(max)},
    )
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="clip_by_norm",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name]},
        attrs={"max_norm": float(max_norm)},
    )
    return out


def leaky_relu(x, alpha=0.02, name=None):
    helper = LayerHelper("leaky_relu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="leaky_relu",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name]},
        attrs={"alpha": float(alpha)},
    )
    return out


def relu(x, name=None):
    helper = LayerHelper("relu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="relu", inputs={"X": [x.name]}, outputs={"Out": [out.name]})
    return out


def log(x, name=None):
    helper = LayerHelper("log", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="log", inputs={"X": [x.name]}, outputs={"Out": [out.name]})
    return out


def kv_cache_write(pool, rows, block_table, pos, page_size, scales=None,
                   name=None):
    """Scatter per-token K or V rows into a paged cache pool in place.

    ``pool`` is a persistable ``[n_pages * page_size, feat]`` tensor; each
    row of ``rows`` lands at ``block_table[pos // page_size] * page_size +
    pos % page_size``. The op's output IS the pool variable (the in-place
    idiom), so the serving lowering classifies the pool as written state
    and can donate its buffer across decode steps.

    ``scales`` (a persistable ``[n_pages * page_size]`` f32 tensor) turns
    on the int8 storage mode: rows quantize symmetrically per row on the
    scatter and the scale pool becomes a second in-place output, donated
    alongside the level pool."""
    helper = LayerHelper("kv_cache_write", name=name)
    inputs = {
        "Pool": [pool.name],
        "Rows": [rows.name],
        "BlockTable": [block_table.name],
        "Pos": [pos.name],
    }
    outputs = {"Out": [pool.name]}
    if scales is not None:
        inputs["Scales"] = [scales.name]
        outputs["OutScales"] = [scales.name]
    helper.append_op(
        type="kv_cache_write",
        inputs=inputs,
        outputs=outputs,
        attrs={"page_size": int(page_size)},
    )
    return pool


def paged_attention(q, k_pool, v_pool, block_table, pos, n_head, page_size,
                    sm_scale=None, k_scales=None, v_scales=None, name=None):
    """One-query-per-slot attention over a paged KV pool.

    ``q`` is ``[slots, n_head * d_head]`` (one decode token per slot),
    ``block_table`` ``[slots, pages_per_slot]`` int32, ``pos`` the query
    token's position; each slot attends to context positions 0..pos through
    its block table. Unused table entries point at the scratch page and are
    masked by the position bound. ``k_scales``/``v_scales`` (both or
    neither) read int8 pools: per-row f32 scales dequantize the gathered
    levels inline (see ops/generation_ops.py int8 pool mode)."""
    helper = LayerHelper("paged_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    attrs = {"n_head": int(n_head), "page_size": int(page_size)}
    if sm_scale is not None:
        attrs["sm_scale"] = float(sm_scale)
    inputs = {
        "Q": [q.name],
        "KPool": [k_pool.name],
        "VPool": [v_pool.name],
        "BlockTable": [block_table.name],
        "Pos": [pos.name],
    }
    if k_scales is not None:
        inputs["KScales"] = [k_scales.name]
        inputs["VScales"] = [v_scales.name]
    helper.append_op(
        type="paged_attention",
        inputs=inputs,
        outputs={"Out": [out.name]},
        attrs=attrs,
    )
    return out


def ring_attention(q, k, v, causal=False, axis_name="sp", name=None):
    """Exact attention with the sequence sharded over the mesh's `axis_name`
    (context parallelism; parallel/ring_attention.py). q/k/v: (b, heads,
    t, d)."""
    helper = LayerHelper("ring_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    helper.append_op(
        type="ring_attention",
        inputs={"Q": [q.name], "K": [k.name], "V": [v.name]},
        outputs={"Out": [out.name]},
        attrs={"causal": causal, "axis_name": axis_name},
    )
    return out


def distributed_embedding(input, size, param_attr=None, dtype="float32",
                          axis_name="ep", is_sparse=True, padding_idx=None,
                          name=None):
    """Row-sharded embedding (the reference's distributed lookup table,
    SURVEY.md §2.7.5) on the EmbeddingEngine (embedding/): the table shards
    over `axis_name`, the forward is a local gather + one all-reduce, and
    with `is_sparse` (default) the backward emits a SelectedRows pair that
    per-row optimizer updates with row-sharded moments consume."""
    from ..embedding import EmbeddingEngine

    engine = EmbeddingEngine(
        name=name,
        num_rows=size[0],
        dim=size[1],
        dtype=dtype,
        axis_name=axis_name,
        padding_idx=padding_idx,
        is_sparse=is_sparse,
        param_attr=param_attr,
    )
    return engine.lookup(input)


def flash_attention(q, k, v, causal=False, sm_scale=None, name=None):
    """Fused blockwise attention over (b, h, t, d) tensors: emits the
    flash_attention op, whose lowering launches the hand-written flash
    kernels on the card (ops/flash_attention.py)."""
    from ..ops.flash_attention import flash_path_taken

    helper = LayerHelper("flash_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    attrs = {"causal": bool(causal)}
    if sm_scale is not None:
        attrs["sm_scale"] = float(sm_scale)
    outputs = {"Out": [out.name]}
    # declare the logsumexp residual exactly where the JAX package does
    # (flash_path_taken mirrors its decision), so both packages build the
    # same program; flash_attention_grad then reads the saved lse instead of
    # running the forward again
    tq = q.shape[2] if q.shape is not None and len(q.shape) == 4 else -1
    tk = k.shape[2] if k.shape is not None and len(k.shape) == 4 else -1
    if flash_path_taken(tq, tk, causal=bool(causal)):
        lse = helper.create_variable_for_type_inference("float32")
        lse.stop_gradient = True
        outputs["Lse"] = [lse.name]
    helper.append_op(
        type="flash_attention",
        inputs={"Q": [q.name], "K": [k.name], "V": [v.name]},
        outputs=outputs,
        attrs=attrs,
    )
    return out


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    helper.append_op(
        type="squeeze2",
        inputs={"X": [input.name]},
        outputs={"Out": [out.name], "XShape": [xshape.name]},
        attrs={"axes": list(axes)},
    )
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    helper.append_op(
        type="unsqueeze2",
        inputs={"X": [input.name]},
        outputs={"Out": [out.name], "XShape": [xshape.name]},
        attrs={"axes": list(axes)},
    )
    return out


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="expand",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name]},
        attrs={"expand_times": list(expand_times)},
    )
    return out


def chunk_eval(
    input,
    label,
    chunk_scheme,
    num_chunk_types,
    excluded_chunk_types=None,
    seq_length=None,
):
    """Chunk-level precision / recall / F1 of padded [b, t] tag grids
    (reference layers/nn.py chunk_eval, the conlleval metric), `seq_length`
    [b] masking the padding. Returns (precision, recall, f1,
    num_infer_chunks, num_label_chunks, num_correct_chunks)."""
    helper = LayerHelper("chunk_eval")
    precision = helper.create_variable_for_type_inference(dtype="float32")
    recall = helper.create_variable_for_type_inference(dtype="float32")
    f1_score = helper.create_variable_for_type_inference(dtype="float32")
    num_infer = helper.create_variable_for_type_inference(dtype="int64")
    num_label = helper.create_variable_for_type_inference(dtype="int64")
    num_correct = helper.create_variable_for_type_inference(dtype="int64")
    inputs = {"Inference": [input.name], "Label": [label.name]}
    if seq_length is not None:
        inputs["SeqLength"] = [seq_length.name]
    helper.append_op(
        type="chunk_eval",
        inputs=inputs,
        outputs={
            "Precision": [precision.name],
            "Recall": [recall.name],
            "F1-Score": [f1_score.name],
            "NumInferChunks": [num_infer.name],
            "NumLabelChunks": [num_label.name],
            "NumCorrectChunks": [num_correct.name],
        },
        attrs={
            "chunk_scheme": chunk_scheme,
            "num_chunk_types": num_chunk_types,
            "excluded_chunk_types": list(excluded_chunk_types or []),
        },
    )
    for v in (precision, recall, f1_score, num_infer, num_label, num_correct):
        v.stop_gradient = True
    return precision, recall, f1_score, num_infer, num_label, num_correct


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """Global step counter (reference layers/nn.py
    autoincreased_step_counter): a persistable int var that an increment op
    prepended to the main program raises once per run; the learning-rate
    schedules read it. On the card it is state a captured graph updates,
    so every replay advances it."""
    helper = LayerHelper("global_step_counter")
    counter_name = counter_name or "@STEP_COUNTER@"
    counter = helper.create_or_get_global_variable(
        name=counter_name, dtype="int32", shape=[1], persistable=True
    )
    if not getattr(counter, "_step_counter_initialized", False):
        helper.set_variable_initializer(counter, Constant(value=float(begin - 1)))
        helper.main_program.global_block()._prepend_op(
            type="increment",
            inputs={"X": [counter.name]},
            outputs={"Out": [counter.name]},
            attrs={"step": float(step)},
        )
        counter._step_counter_initialized = True
        counter.stop_gradient = True
    return counter


def beam_search(
    pre_ids,
    pre_scores,
    ids,
    scores,
    beam_size,
    end_id,
    level=0,
    name=None,
    return_parent_idx=False,
):
    """One beam-search expansion step (reference layers/nn.py beam_search)
    in the dense [batch * beam] layout, with a flat parent_idx to gather
    the decoder state by (selected_ids._parent_idx holds it when
    return_parent_idx is False). Start pre_scores as [0, -inf, ...] per
    source so that identical initial beams do not crowd the beam."""
    helper = LayerHelper("beam_search", **locals())
    selected_ids = helper.create_variable_for_type_inference("int64")
    selected_scores = helper.create_variable_for_type_inference("float32")
    parent_idx = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="beam_search",
        inputs={
            "pre_ids": [pre_ids.name],
            "pre_scores": [pre_scores.name],
            "ids": [ids.name],
            "scores": [scores.name],
        },
        outputs={
            "selected_ids": [selected_ids.name],
            "selected_scores": [selected_scores.name],
            "parent_idx": [parent_idx.name],
        },
        attrs={"beam_size": beam_size, "end_id": end_id, "level": level},
    )
    selected_ids.stop_gradient = True
    selected_scores.stop_gradient = True
    parent_idx.stop_gradient = True
    selected_ids._parent_idx = parent_idx
    if return_parent_idx:
        return selected_ids, selected_scores, parent_idx
    return selected_ids, selected_scores


def beam_search_decode(ids, scores, beam_size, end_id, name=None, parents=None):
    """Backtrack the per-step beam selections (tensor arrays) into whole
    hypotheses (reference layers/nn.py beam_search_decode). Returns
    (sentence_ids [B, beam, T] best first, sentence_scores [B, beam]); the
    ids Variable carries each hypothesis' length in ._hyp_len."""
    helper = LayerHelper("beam_search_decode", **locals())
    sentence_ids = helper.create_variable_for_type_inference("int64")
    sentence_scores = helper.create_variable_for_type_inference("float32")
    hyp_len = helper.create_variable_for_type_inference("int32")
    inputs = {"Ids": [ids.name], "Scores": [scores.name]}
    if parents is not None:
        inputs["Parents"] = [parents.name]
    helper.append_op(
        type="beam_search_decode",
        inputs=inputs,
        outputs={
            "SentenceIds": [sentence_ids.name],
            "SentenceScores": [sentence_scores.name],
            "SentenceLength": [hyp_len.name],
        },
        attrs={"beam_size": beam_size, "end_id": end_id},
    )
    sentence_ids.stop_gradient = True
    sentence_scores.stop_gradient = True
    hyp_len.stop_gradient = True
    sentence_ids._hyp_len = hyp_len
    return sentence_ids, sentence_scores


def conv2d_transpose(
    input,
    num_filters,
    output_size=None,
    filter_size=None,
    padding=0,
    stride=1,
    dilation=1,
    groups=None,
    param_attr=None,
    bias_attr=None,
    use_cudnn=True,
    act=None,
    name=None,
):
    """Transposed 2-D convolution, NCHW, filter [C_in, num_filters /
    groups, kh, kw] (ops/nn_extra_ops.py lowers the op). The output's
    shape is set here, where the JAX package infers it from the lowering,
    so the bias takes its width."""
    helper = LayerHelper("conv2d_transpose", **locals())
    dtype = helper.input_dtype()
    num_channels = input.shape[1]
    groups = groups or 1
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    if filter_size is None:
        if output_size is None:
            raise ValueError("filter_size or output_size required")
        output_size = _pair(output_size)
        h_in, w_in = input.shape[2], input.shape[3]
        filter_size = [
            (output_size[0] - (h_in - 1) * stride[0] + 2 * padding[0] - 1) // dilation[0]
            + 1,
            (output_size[1] - (w_in - 1) * stride[1] + 2 * padding[1] - 1) // dilation[1]
            + 1,
        ]
    else:
        filter_size = _pair(filter_size)
    filter_shape = [num_channels, num_filters // groups] + filter_size
    w = helper.create_parameter(attr=helper.param_attr, shape=filter_shape, dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d_transpose",
        inputs={"Input": [input.name], "Filter": [w.name]},
        outputs={"Output": [pre_bias.name]},
        attrs={
            "strides": stride,
            "paddings": padding,
            "dilations": dilation,
            "groups": groups,
        },
    )
    if pre_bias.shape is None:
        spatial = [
            (d - 1) * s - 2 * p + dl * (k - 1) + 1 if d != -1 else -1
            for d, s, p, dl, k in zip(input.shape[2:], stride, padding, dilation, filter_size)
        ]
        pre_bias.shape = (input.shape[0], num_filters, *spatial)
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss")
    diff = helper.create_variable_for_type_inference(x.dtype)
    loss = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x.name], "Y": [y.name]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight.name]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight.name]
    helper.append_op(
        type="smooth_l1_loss",
        inputs=inputs,
        outputs={"Diff": [diff.name], "Out": [loss.name]},
        attrs={"sigma": sigma if sigma is not None else 1.0},
    )
    return loss


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper("log_loss", name=name)
    loss = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="log_loss",
        inputs={"Predicted": [input.name], "Labels": [label.name]},
        outputs={"Loss": [loss.name]},
        attrs={"epsilon": epsilon},
    )
    return loss


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        num = num_or_sections
        sections = []
    else:
        num = 0
        sections = [int(s) for s in num_or_sections]
    outs = [
        helper.create_variable_for_type_inference(input.dtype)
        for _ in range(num or len(sections))
    ]
    helper.append_op(
        type="split",
        inputs={"X": [input.name]},
        outputs={"Out": [o.name for o in outs]},
        attrs={"num": num, "sections": sections, "axis": dim},
    )
    return outs


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    mid = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    helper.append_op(
        type="lrn",
        inputs={"X": [input.name]},
        outputs={"Out": [out.name], "MidOut": [mid.name]},
        attrs={"n": n, "k": k, "alpha": alpha, "beta": beta},
    )
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="pad",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name]},
        attrs={"paddings": list(paddings), "pad_value": float(pad_value)},
    )
    return out


def pad2d(
    input, paddings=[0, 0, 0, 0], mode="constant", pad_value=0.0, data_format="NCHW", name=None
):
    helper = LayerHelper("pad2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="pad2d",
        inputs={"X": [input.name]},
        outputs={"Out": [out.name]},
        attrs={
            "paddings": list(paddings),
            "mode": mode,
            "pad_value": float(pad_value),
            "data_format": data_format,
        },
    )
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32", name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [label.name]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist.name]
    helper.append_op(
        type="label_smooth",
        inputs=inputs,
        outputs={"Out": [out.name]},
        attrs={"epsilon": float(epsilon)},
    )
    return out


def stack(x, axis=0):
    helper = LayerHelper("stack")
    if isinstance(x, Variable):
        x = [x]
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op(
        type="stack",
        inputs={"X": [v.name for v in x]},
        outputs={"Y": [out.name]},
        attrs={"axis": axis},
    )
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    if num is None:
        num = x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype) for _ in range(num)]
    helper.append_op(
        type="unstack",
        inputs={"X": [x.name]},
        outputs={"Y": [o.name for o in outs]},
        attrs={"axis": axis, "num": num},
    )
    return outs


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="scatter",
        inputs={"X": [input.name], "Ids": [index.name], "Updates": [updates.name]},
        outputs={"Out": [out.name]},
        attrs={"overwrite": overwrite},
    )
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="slice",
        inputs={"Input": [input.name]},
        outputs={"Out": [out.name]},
        attrs={"axes": list(axes), "starts": list(starts), "ends": list(ends)},
    )
    return out


def prelu(x, mode, param_attr=None, name=None):
    helper = LayerHelper("prelu", name=name)
    alpha_shape = [1]
    if mode == "channel":
        alpha_shape = [x.shape[1]]
    elif mode == "element":
        alpha_shape = list(x.shape[1:])
    alpha = helper.create_parameter(
        attr=helper.param_attr,
        shape=alpha_shape,
        dtype=x.dtype,
        default_initializer=Constant(0.25),
    )
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="prelu",
        inputs={"X": [x.name], "Alpha": [alpha.name]},
        outputs={"Out": [out.name]},
        attrs={"mode": mode},
    )
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    norm = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op(
        type="norm",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name], "Norm": [norm.name]},
        attrs={"axis": 1 if axis is None else axis, "epsilon": epsilon},
    )
    return out


def image_resize(input, out_shape=None, scale=None, name=None, resample="BILINEAR", actual_shape=None, align_corners=True, align_mode=1):
    """Resize NCHW maps to out_shape (or scale times the input's). The op
    computes jax.image.resize's half-pixel contract whatever align_corners
    says (ops/core_ops.py _interp); the attr is recorded."""
    helper = LayerHelper("image_resize", name=name)
    if out_shape is None:
        out_shape = [int(input.shape[2] * scale), int(input.shape[3] * scale)]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="bilinear_interp" if resample == "BILINEAR" else "nearest_interp",
        inputs={"X": [input.name]},
        outputs={"Out": [out.name]},
        attrs={
            "out_h": int(out_shape[0]),
            "out_w": int(out_shape[1]),
            "align_corners": align_corners,
        },
    )
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None, actual_shape=None, align_corners=True, align_mode=1):
    return image_resize(input, out_shape, scale, name, "BILINEAR", actual_shape, align_corners, align_mode)


def resize_nearest(input, out_shape=None, scale=None, name=None, actual_shape=None, align_corners=True):
    return image_resize(input, out_shape, scale, name, "NEAREST", actual_shape, align_corners)
