"""Neural-network layers: the subset of paddle_tpu/layers/nn.py that the
GPTDecoder programs use (reference python/paddle/fluid/layers/nn.py). Each
layer appends the same ops with the same attrs as the JAX package's, so a
model builder yields the same Program in both packages."""

import numpy as np

from ..layer_helper import LayerHelper
from ..initializer import Constant

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
    "elementwise_min",
    "gather",
    "relu",
    "kv_cache_write",
    "paged_attention",
    "distributed_embedding",
    "flash_attention",
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
    """Fully-connected layer (reference layers/nn.py fc): mul + bias +
    activation. One dense input; the JAX package's multi-input sum and
    ragged (LoD) forms come with the rest of the op library."""
    helper = LayerHelper("fc", **locals())
    dtype = helper.input_dtype()
    input_var = helper.input()
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[int(np.prod(input_var.shape[num_flatten_dims:])), size],
        dtype=dtype,
        is_bias=False,
    )
    tmp = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="mul",
        inputs={"X": [input_var.name], "Y": [w.name]},
        outputs={"Out": [tmp.name]},
        attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
    )
    pre_act = helper.append_bias_op(tmp, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


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
    `is_distributed=True` is the row-sharded EmbeddingEngine form, ported with
    the parallelism slice."""
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
    return tmp


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


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act, name)


def gather(input, index):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="gather",
        inputs={"X": [input.name], "Index": [index.name]},
        outputs={"Out": [out.name]},
    )
    return out


def relu(x, name=None):
    helper = LayerHelper("relu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="relu", inputs={"X": [x.name]}, outputs={"Out": [out.name]})
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


def distributed_embedding(input, size, param_attr=None, dtype="float32",
                          axis_name="ep", is_sparse=True, padding_idx=None,
                          name=None):
    """Row-sharded embedding (the JAX package's EmbeddingEngine): ported with
    the parallelism slice."""
    raise NotImplementedError(
        "distributed_embedding is ported with the parallelism slice "
        "(ROADMAP.md queue A7)"
    )


def flash_attention(q, k, v, causal=False, sm_scale=None, name=None):
    """Fused blockwise attention over (b, h, t, d) tensors: ported with its
    forward and backward kernels in the training slice."""
    raise NotImplementedError(
        "flash_attention is ported with the training slice (ROADMAP.md "
        "kernel table row 8)"
    )
