"""Tensor creation and manipulation layers (reference
python/paddle/fluid/layers/tensor.py), as in the JAX package."""

import numpy as np

from ..framework import Variable, convert_np_dtype
from ..layer_helper import LayerHelper
from ..initializer import Constant

__all__ = [
    "create_tensor",
    "create_parameter",
    "create_global_var",
    "cast",
    "concat",
    "sums",
    "assign",
    "fill_constant",
    "fill_constant_batch_size_like",
    "ones",
    "zeros",
    "scale",
    "increment",
    "argmax",
    "argmin",
    "argsort",
    "reverse",
]


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(name=helper.name, dtype=dtype, persistable=persistable)


def create_parameter(
    shape, dtype, name=None, attr=None, is_bias=False, default_initializer=None
):
    helper = LayerHelper("create_parameter", name=name)
    from ..param_attr import ParamAttr

    if attr is None:
        attr = ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias, default_initializer)


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False, name=None):
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(
        dtype=dtype, shape=shape, persistable=persistable, name=helper.name
    )
    helper.set_variable_initializer(var, Constant(value=float(value)))
    return var


def cast(x, dtype):
    helper = LayerHelper("cast")
    dtype = convert_np_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type="cast",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name]},
        attrs={"in_dtype": x.dtype, "out_dtype": dtype},
    )
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(dtype=helper.input_dtype())
    helper.append_op(
        type="concat",
        inputs={"X": [v.name for v in input]},
        outputs={"Out": [out.name]},
        attrs={"axis": axis},
    )
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=helper.input_dtype())
    helper.append_op(
        type="sum",
        inputs={"X": [v.name for v in input]},
        outputs={"Out": [out.name]},
    )
    return out


def assign(input, output=None):
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(dtype=input.dtype)
        helper.append_op(
            type="assign", inputs={"X": [input.name]}, outputs={"Out": [output.name]}
        )
    elif isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=convert_np_dtype(input.dtype)
            )
        helper.append_op(
            type="assign_value",
            outputs={"Out": [output.name]},
            attrs={
                "shape": list(input.shape),
                "dtype": output.dtype,
                "values": input.reshape(-1).tolist(),
            },
        )
    else:
        raise TypeError("assign expects Variable or ndarray")
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=convert_np_dtype(dtype))
    helper.append_op(
        type="fill_constant",
        outputs={"Out": [out.name]},
        attrs={
            "shape": [int(s) for s in shape],
            "dtype": convert_np_dtype(dtype),
            "value": float(value),
        },
    )
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(
    input, shape, dtype, value, input_dim_idx=0, output_dim_idx=0
):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype=convert_np_dtype(dtype))
    helper.append_op(
        type="fill_constant_batch_size_like",
        inputs={"Input": [input.name]},
        outputs={"Out": [out.name]},
        attrs={
            "shape": [int(s) for s in shape],
            "dtype": convert_np_dtype(dtype),
            "value": float(value),
            "input_dim_idx": input_dim_idx,
            "output_dim_idx": output_dim_idx,
        },
    )
    out.stop_gradient = True
    return out


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=0.0)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name, act=act)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="scale",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name]},
        attrs={
            "scale": float(scale),
            "bias": float(bias),
            "bias_after_scale": bias_after_scale,
        },
    )
    return helper.append_activation(out)


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="increment",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name]},
        attrs={"step": float(value)},
    )
    return out


def argmax(x, axis=0):
    helper = LayerHelper("arg_max")
    out = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="arg_max",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name]},
        attrs={"axis": axis},
    )
    return out


def argmin(x, axis=0):
    helper = LayerHelper("arg_min")
    out = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="arg_min",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name]},
        attrs={"axis": axis},
    )
    return out


def argsort(input, axis=-1, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    ids = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="argsort",
        inputs={"X": [input.name]},
        outputs={"Out": [out.name], "Indices": [ids.name]},
        attrs={"axis": axis},
    )
    return out, ids


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    if isinstance(axis, int):
        axis = [axis]
    helper.append_op(
        type="reverse",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name]},
        attrs={"axis": axis},
    )
    return out
