"""Tensor creation layers (reference python/paddle/fluid/layers/tensor.py):
the subset the GPTDecoder programs, the Transformer and the optimizers use."""

import numpy as np

from ..framework import Variable, convert_np_dtype
from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = ["assign", "create_global_var", "fill_constant", "scale"]


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


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False, name=None):
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(
        dtype=dtype, shape=shape, persistable=persistable, name=helper.name
    )
    helper.set_variable_initializer(var, Constant(value=float(value)))
    return var


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
