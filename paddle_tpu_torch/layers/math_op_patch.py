"""Operator-overloading support for Variable (reference
python/paddle/fluid/layers/math_op_patch.py — monkey_patch_variable). Called
from framework.Variable's dunder methods."""

from ..framework import Variable
from ..layer_helper import LayerHelper

_SCALAR_SCALE = {"elementwise_add", "elementwise_sub", "elementwise_mul", "elementwise_div"}


def binary_op(x, other, op_type, reverse=False):
    helper = LayerHelper(op_type)
    if not isinstance(other, Variable):
        val = float(other)
        if op_type in _SCALAR_SCALE and not reverse:
            # scalar fast path as a scale op (reference math_op_patch scale)
            attrs = {
                "elementwise_add": lambda: {"scale": 1.0, "bias": val},
                "elementwise_sub": lambda: {"scale": 1.0, "bias": -val},
                "elementwise_mul": lambda: {"scale": val, "bias": 0.0},
                "elementwise_div": lambda: {"scale": 1.0 / val, "bias": 0.0},
            }[op_type]()
            out = helper.create_variable_for_type_inference(x.dtype)
            helper.append_op(
                type="scale",
                inputs={"X": [x.name]},
                outputs={"Out": [out.name]},
                attrs=attrs,
            )
            return out
        # materialize scalar as a [1] tensor and broadcast
        const = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(
            type="fill_constant",
            outputs={"Out": [const.name]},
            attrs={"shape": [1], "dtype": x.dtype, "value": val},
        )
        other = const
    a, b = (other, x) if reverse else (x, other)
    out_dtype = x.dtype
    if op_type in ("less_than", "less_equal", "greater_than", "greater_equal", "equal", "not_equal"):
        out_dtype = "bool"
    out = helper.create_variable_for_type_inference(out_dtype)
    helper.append_op(
        type=op_type,
        inputs={"X": [a.name], "Y": [b.name]},
        outputs={"Out": [out.name]},
        attrs={"axis": -1},
    )
    return out
